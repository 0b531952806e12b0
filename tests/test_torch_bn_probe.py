"""The port's BatchNorm-padding probe (``die_e_tpu_torch/scripts/
bn_padding_probe.py``) against the JAX package's, on the CPU.

The same flax variables (converted by ``nets/convert.py``) and the same
rows, made with numpy from a seed, go through the port's probe and
through the JAX script's two arms computed with the JAX package's
``train_step`` (32x2 backgammon net, batch 32, 3 steps, lr 2.5e-4, wd
1e-4: the script's defaults).  Tolerances, float32 throughout:

* the eval losses: 1e-5 relative (measured at most 1.0e-6 over 4 seeds);
* the deltas between the arms: 1e-3 relative, or 1e-6 absolute (measured:
  the statistics' delta 2e-6 relative, the parameters' 2.2e-4, whose conv
  biases take rounding-noise gradients under a training BatchNorm and so
  move differently in the two frameworks, ``tests/test_torch_learner.py``'s
  module doc; the eval-loss delta is ~1e-6 to 1e-5, the difference of two
  losses each within ~1e-6, so its absolute error, up to 2.6e-7, is what
  holds).

Also the counterpart of ``tests/test_train.py::
test_bn_padding_distortion_is_bounded`` on the port's learner, and the
script's command line on a tiny checkpoint and ``memory.npz``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.nets import resnet as jnet
from die_e_tpu.train import learner as jl
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.nets import resnet as tnet
from die_e_tpu_torch.nets.convert import flax_to_state_dict
from die_e_tpu_torch.scripts import bn_padding_probe as probe_mod
from die_e_tpu_torch.train import checkpoint as ckpt
from die_e_tpu_torch.train.replay import Memory, save_training_data
from tests.test_torch_learner import batch

JSPEC = dataclasses.replace(jbg.SPEC, n_filters=32, n_res_blocks=2)
TSPEC = dataclasses.replace(tbg.SPEC, n_filters=32, n_res_blocks=2)
STEPS, B, LR, WD = 3, 32, 2.5e-4, 1e-4
KEYS = ("rel_batch_stats_delta", "rel_params_delta", "eval_loss_padded",
        "eval_loss_natural", "eval_loss_rel_delta")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _variables(seed):
    """Flax's initial variables with non-trivial running statistics."""
    v = jnet.init_params(jnet.make_net(JSPEC), jax.random.PRNGKey(seed))
    key = jax.random.PRNGKey(100 + seed)
    stats = jax.tree_util.tree_map(
        lambda x: jax.random.uniform(key, x.shape, minval=0.5, maxval=1.5), v["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": stats})


def _rows(seed):
    obs, ps, outcome, _ = batch(probe_mod.rows_needed(STEPS, B), seed, zero_weight=0)
    return obs, ps, outcome


def _jax_probe(variables, obs, ps, outcome):
    """The two arms and the numbers of ``scripts/bn_padding_probe.py``,
    with the JAX package's ``train_step``."""
    net = jnet.make_net(JSPEC)
    tx = jl.make_optimizer(LR, WD)
    obs, ps, outcome = (jnp.asarray(x) for x in (obs, ps, outcome))
    half = B // 2

    def run(pad_last):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = jl.TrainState(
            params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        for i in range(STEPS):
            sl = slice(B * i, B * (i + 1))
            state, _ = jl.train_step(net, tx, state, obs[sl], ps[sl], outcome[sl],
                                     jnp.ones((B,)))
        lo = STEPS * B
        if pad_last:
            idx = jnp.concatenate([jnp.arange(lo, lo + half), jnp.arange(0, half)])
            w = jnp.concatenate([jnp.ones((half,)), jnp.zeros((half,))])
        else:
            idx, w = jnp.arange(lo, lo + half), jnp.ones((half,))
        state, _ = jl.train_step(net, tx, state, obs[idx], ps[idx], outcome[idx], w)
        return state

    s_pad, s_nat = run(True), run(False)

    def flat(tree):
        return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))

    sl = slice(STEPS * B + half, STEPS * B + half + B)

    def eval_loss(state):
        policy, value = net.apply({"params": state.params, "batch_stats": state.batch_stats},
                                  obs[sl], train=False)
        ce = -jnp.mean(jnp.sum(ps[sl] * jax.nn.log_softmax(policy, axis=-1), axis=-1))
        return float(ce + jnp.mean((value.squeeze(-1) - outcome[sl]) ** 2))

    l_pad, l_nat = eval_loss(s_pad), eval_loss(s_nat)
    return {"rel_batch_stats_delta": rel(flat(s_pad.batch_stats), flat(s_nat.batch_stats)),
            "rel_params_delta": rel(flat(s_pad.params), flat(s_nat.params)),
            "eval_loss_padded": l_pad, "eval_loss_natural": l_nat,
            "eval_loss_rel_delta": abs(l_pad - l_nat) / max(abs(l_nat), 1e-9)}


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_matches_the_jax_arms(seed):
    variables = _variables(seed)
    rows = _rows(seed)
    net = tnet.PolicyValueNet(TSPEC).eval()
    net.load_state_dict(flax_to_state_dict(variables))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    got = probe_mod.probe(net, *rows, steps=STEPS, batch=B, lr=LR, wd=WD)
    want = _jax_probe(variables, *rows)
    assert set(got) == set(KEYS)
    for k in ("eval_loss_padded", "eval_loss_natural"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("rel_batch_stats_delta", "rel_params_delta", "eval_loss_rel_delta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert got["rel_params_delta"] > 0 and got["rel_batch_stats_delta"] > 0
    # the probe leaves the restored net as it was
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_bn_padding_distortion_is_bounded():
    """Counterpart of ``tests/test_train.py::
    test_bn_padding_distortion_is_bounded`` on the port's learner: a fresh
    64x4 tic-tac-toe net, random rows, two identical full batches of 32,
    then 16 real rows padded with 16 wrapped rows at weight 0, or the 16
    alone; the bounds DIVERGENCES row 17 cites."""
    rng = np.random.default_rng(9)
    n = probe_mod.rows_needed(2, 32)
    obs = rng.normal(size=(n, 3, 3, 3)).astype(np.float32)
    logits = rng.normal(size=(n, 9))
    ps = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    outcome = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    net = tnet.make_net(tttt.SPEC, 0, "cpu")
    out = probe_mod.probe(net, obs, ps, outcome, steps=2, batch=32, lr=1e-3, wd=1e-4)
    assert 0 < out["rel_batch_stats_delta"] < 0.005, out
    assert 0 < out["rel_params_delta"] < 0.02, out
    assert out["eval_loss_rel_delta"] < 0.05, out


def test_probe_refuses_too_few_rows():
    net = tnet.make_net(dataclasses.replace(tttt.SPEC, n_filters=8, n_res_blocks=1), 0, "cpu")
    n = probe_mod.rows_needed(STEPS, B) - 1
    with pytest.raises(ValueError, match="memory too small"):
        probe_mod.probe(net, np.zeros((n, 3, 3, 3)), np.zeros((n, 9)), np.zeros(n))


def test_cli_prints_one_json_line(tmp_path, monkeypatch, capsys):
    """``python -m die_e_tpu_torch.scripts.bn_padding_probe`` on a tiny
    checkpoint and a ``memory.npz`` glob (the last match is used)."""
    spec = dataclasses.replace(tbg.SPEC, n_filters=8, n_res_blocks=1)
    monkeypatch.setattr(tbg, "SPEC", spec)
    model = tmp_path / "models" / "backgammon" / "model_0"
    ckpt.save_variables(tnet.make_net(spec, 1, "cpu").state_dict(), model)
    for sp, seed in (("sp-0", 3), ("sp-1", 4)):
        save_training_data(Memory(*_rows(seed)), tmp_path / "data" / "run-x" / "lrn-0" / sp)
    pattern = str(tmp_path / "data" / "run-*" / "lrn-*" / "sp-*" / "memory.npz")
    assert probe_mod.main(["--model-path", str(model), "--memory", pattern,
                           "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "bn_padding_probe" and row["model"] == str(model)
    assert row["memory"].endswith("sp-1/memory.npz")
    assert (row["steps"], row["batch"]) == (STEPS, B)
    assert all(np.isfinite(row[k]) for k in KEYS) and row["rel_params_delta"] > 0
    with pytest.raises(SystemExit, match="no memory file"):
        probe_mod.main(["--model-path", str(model), "--memory", str(tmp_path / "none*.npz"),
                        "--device", "cpu"])
