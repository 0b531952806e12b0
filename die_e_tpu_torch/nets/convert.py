"""Flax variables -> the port's ``state_dict``.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` pytree with
numpy leaves (the caller restores it and converts to numpy; this module
imports no JAX) and returns a ``state_dict`` for
:class:`die_e_tpu_torch.nets.resnet.PolicyValueNet`:

* conv kernels HWIO -> OIHW;
* dense kernels [in, out] -> [out, in] (both heads flatten NHWC in the
  port too, so no row permutation is needed);
* BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(dst: dict, name: str, p: dict) -> None:
    dst[f"{name}.weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))
    dst[f"{name}.bias"] = p["bias"]


def _bn(dst: dict, name: str, p: dict, s: dict) -> None:
    dst[f"{name}.weight"] = p["scale"]
    dst[f"{name}.bias"] = p["bias"]
    dst[f"{name}.running_mean"] = s["mean"]
    dst[f"{name}.running_var"] = s["var"]
    dst[f"{name}.num_batches_tracked"] = np.array(0, np.int64)


def _dense(dst: dict, name: str, p: dict) -> None:
    dst[f"{name}.weight"] = np.transpose(p["kernel"])
    dst[f"{name}.bias"] = p["bias"]


def flax_to_state_dict(variables) -> dict:
    """Convert flax ResNet variables (numpy leaves) to a torch state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict = {}
    _conv(out, "stem_conv", params["Conv_0"])
    _bn(out, "stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    i = 0
    while f"ResBlock_{i}" in params:
        bp, bs = params[f"ResBlock_{i}"], stats[f"ResBlock_{i}"]
        for j in range(2):
            _conv(out, f"blocks.{i}.conv{j}", bp[f"Conv_{j}"])
            _bn(out, f"blocks.{i}.bn{j}", bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"])
        i += 1
    _conv(out, "policy_conv", params["Conv_1"])
    _bn(out, "policy_bn", params["BatchNorm_1"], stats["BatchNorm_1"])
    _dense(out, "policy_fc", params["Dense_0"])
    _conv(out, "value_conv", params["Conv_2"])
    _bn(out, "value_bn", params["BatchNorm_2"], stats["BatchNorm_2"])
    _dense(out, "value_fc", params["Dense_1"])
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}
