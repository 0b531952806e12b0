"""Flax variables and a JAX ``TrainState`` -> the port's ``state_dict``s.

Takes the JAX package's pytrees with numpy leaves (the caller restores
them and converts to numpy; this module imports no JAX) and returns
``state_dict``s for :class:`die_e_tpu_torch.nets.resnet.PolicyValueNet`
and for its ``torch.optim.Adam``:

* conv kernels HWIO -> OIHW;
* dense kernels [in, out] -> [out, in] (both heads flatten NHWC in the
  port too, so no row permutation is needed);
* BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var;
* the optax chain's ``ScaleByAdamState`` -> Adam's per-parameter
  ``exp_avg`` (mu), ``exp_avg_sq`` (nu) and ``step`` (count); mu and nu
  have the params' tree and take the same layout rules.
"""

from __future__ import annotations

import numpy as np
import torch


def _layers(params):
    """(kind, port module name, flax path) of every layer, in net order."""
    yield "conv", "stem_conv", ("Conv_0",)
    yield "bn", "stem_bn", ("BatchNorm_0",)
    i = 0
    while f"ResBlock_{i}" in params:
        for j in range(2):
            yield "conv", f"blocks.{i}.conv{j}", (f"ResBlock_{i}", f"Conv_{j}")
            yield "bn", f"blocks.{i}.bn{j}", (f"ResBlock_{i}", f"BatchNorm_{j}")
        i += 1
    yield "conv", "policy_conv", ("Conv_1",)
    yield "bn", "policy_bn", ("BatchNorm_1",)
    yield "dense", "policy_fc", ("Dense_0",)
    yield "conv", "value_conv", ("Conv_2",)
    yield "bn", "value_bn", ("BatchNorm_2",)
    yield "dense", "value_fc", ("Dense_1",)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in d.items()}


def params_to_torch(params) -> dict:
    """A params-shaped tree (the params, or Adam's mu or nu) -> {port
    parameter name: tensor}."""
    out: dict = {}
    for kind, name, path in _layers(params):
        p = _at(params, path)
        if kind == "conv":
            out[f"{name}.weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))
        elif kind == "dense":
            out[f"{name}.weight"] = np.transpose(p["kernel"])
        else:
            out[f"{name}.weight"] = p["scale"]
        out[f"{name}.bias"] = p["bias"]
    return _tensors(out)


def flax_to_state_dict(variables) -> dict:
    """Convert flax ResNet variables (numpy leaves) to a torch state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out = params_to_torch(params)
    for kind, name, path in _layers(params):
        if kind == "bn":
            s = _at(stats, path)
            out.update(_tensors({
                f"{name}.running_mean": s["mean"],
                f"{name}.running_var": s["var"],
                f"{name}.num_batches_tracked": np.array(0, np.int64),
            }))
    return out


def adam_state_dict(opt: torch.optim.Adam, net, count, mu, nu) -> dict:
    """``opt``'s state_dict with the optax Adam moments in place of its
    state.  ``opt`` is the port's optimizer over ``net.parameters()`` (one
    parameter group, in the net's order), which fixes the indices."""
    sd = opt.state_dict()
    m, v = params_to_torch(mu), params_to_torch(nu)
    step = torch.tensor(float(count), dtype=torch.float32)
    sd["state"] = {
        i: {"step": step.clone(), "exp_avg": m[name], "exp_avg_sq": v[name]}
        for i, (name, _) in enumerate(net.named_parameters())
    }
    return sd


def load_flax_train_state(state, params, batch_stats, count, mu, nu, step):
    """Load a JAX TrainState, given as numpy trees and numbers, into the
    port's :class:`die_e_tpu_torch.train.learner.TrainState` in place."""
    state.net.load_state_dict(
        flax_to_state_dict({"params": params, "batch_stats": batch_stats}))
    state.opt.load_state_dict(adam_state_dict(state.opt, state.net, count, mu, nu))
    state.step = int(step)
    return state


def save_flax_train_state(path, spec, params, batch_stats, count, mu, nu, step,
                          lr: float, wd: float) -> None:
    """Write a JAX TrainState (numpy trees) as the port's full-state
    checkpoint at ``path`` (what ``learn --resume`` restores as
    ``latest_state``); ``lr`` and ``wd`` are the run's optimizer settings,
    which optax keeps out of its state."""
    from die_e_tpu_torch.train import checkpoint
    from die_e_tpu_torch.train.learner import create_train_state

    state = create_train_state(spec, 0, lr=lr, wd=wd, device="cpu")
    load_flax_train_state(state, params, batch_stats, count, mu, nu, step)
    checkpoint.save_state(state, path)
