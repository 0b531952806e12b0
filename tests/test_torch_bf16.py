"""The port's bfloat16 inference policy against the JAX package's, on the
CPU.

``core/device.py::compute_dtype`` is the port of
``die_e_tpu/core/mesh.py::compute_dtype`` and the ``dtype`` of
``nets/resnet.py::forward`` the port of flax's ``make_net(spec,
dtype=jnp.bfloat16)``: convs and dense layers in bf16 with their f32
parameters cast at the call, BatchNorm in f32, f32 outputs.  The same flax
variables (converted by ``nets/convert.py``) and the same observations go
through both.  Tolerances, on softmax and value:

* the port's bf16 net against the JAX bf16 net: 1e-2 absolute on the small
  nets (tic-tac-toe 64x4 and backgammon 32x2 with non-trivial BatchNorm
  statistics; measured at most 2e-3, one bf16 ulp of a value near 0.4),
  3e-2 on the trained 256x19 checkpoint (measured 1.25e-2 policy, 2.1e-2
  value).  The two round to bf16 at different points: flax adds a conv's
  bias after rounding its output, torch's bf16 conv adds it before.
* the port's bf16 against its f32: JAX's own 0.05
  (``tests/test_resnet.py::TestBf16Inference``).
* training: bit for bit whatever the inference dtype.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu.nets import resnet as jnet
from die_e_tpu_torch.core import device as tdevice
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.nets import resnet as tnet
from die_e_tpu_torch.nets.convert import flax_to_state_dict
from die_e_tpu_torch.train import learner as tl
from tests.test_torch_resnet import _obs

BEST = Path(__file__).resolve().parents[1] / "runs/bg_full/models/backgammon/best"
SMALL = {
    "tictactoe": (jttt.SPEC, tttt.SPEC),
    "backgammon": (dataclasses.replace(jbg.SPEC, n_filters=32, n_res_blocks=2),
                   dataclasses.replace(tbg.SPEC, n_filters=32, n_res_blocks=2)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _variables(jspec, seed):
    """Flax's initial variables with non-trivial running statistics (means
    N(0, 0.1), variances U(0.8, 1.2)), as numpy arrays."""
    v = jnet.init_params(jnet.make_net(jspec), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def stat(path, x):
        if path[-1].key == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, v["batch_stats"])}


def _game_obs(name, n, seed):
    if name == "backgammon":
        return _obs(n, seed)
    rng = np.random.default_rng(seed)
    states = tttt.TttState(board=torch.tensor(rng.integers(-1, 2, (n, 9)), dtype=torch.int32),
                           player=torch.tensor(rng.choice([-1, 1], n), dtype=torch.int32))
    return tttt.observe(states).numpy()


def _port_net(tspec, variables):
    net = tnet.PolicyValueNet(tspec).eval()
    net.load_state_dict(flax_to_state_dict(variables))
    return net


def _jax_forward(jspec, variables, obs, dtype):
    return [np.asarray(x) for x in jnet.forward(jnet.make_net(jspec, dtype=dtype), variables,
                                                jnp.asarray(obs))]


def _port_forward(net, obs, dtype):
    p, v = tnet.forward(net, torch.tensor(obs), dtype=dtype)
    assert p.dtype == v.dtype == torch.float32  # outputs cast back to f32
    return p.numpy(), v.numpy()


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_bf16_net_matches_jax_bf16(name, seed):
    jspec, tspec = SMALL[name]
    variables = _variables(jspec, seed)
    obs = _game_obs(name, 16, seed)
    net = _port_net(tspec, variables)
    p16 = _port_forward(net, obs, torch.bfloat16)
    _close(p16, _jax_forward(jspec, variables, obs, jnp.bfloat16), atol=1e-2)
    _close(p16, _port_forward(net, obs, torch.float32), atol=0.05)


def test_trained_checkpoint_bf16_matches_jax_bf16():
    from die_e_tpu.train.checkpoint import restore_variables

    if not BEST.exists():
        pytest.fail(f"the trained checkpoint is missing at {BEST}")
    template = jnet.init_params(jnet.make_net(jbg.SPEC), jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, restore_variables(BEST, template))
    obs = _obs(8, 7)
    net = _port_net(tbg.SPEC, variables)
    p16 = _port_forward(net, obs, torch.bfloat16)
    _close(p16, _jax_forward(jbg.SPEC, variables, obs, jnp.bfloat16), atol=3e-2)
    _close(p16, _port_forward(net, obs, torch.float32), atol=0.05)


def test_net_eval_fn_passes_the_dtype():
    jspec, tspec = SMALL["backgammon"]
    net = _port_net(tspec, _variables(jspec, 0))
    obs = torch.tensor(_obs(4, 0))
    for dtype in (torch.float32, torch.bfloat16):
        p, v = tl.net_eval_fn(net, dtype)(obs)
        assert p.dtype == v.dtype == torch.float32
        want = tnet.forward(net, obs, dtype=dtype)
        assert torch.equal(p, want[0]) and torch.equal(v, want[1])
    # the default is f32
    assert torch.equal(tl.net_eval_fn(net)(obs)[0], tnet.forward(net, obs)[0])


def test_compute_dtype_is_f32_off_cuda(monkeypatch):
    """Counterpart of ``test_compute_dtype_is_f32_off_tpu``: bf16 only when
    asked for and on CUDA (the device is only named, not touched)."""
    monkeypatch.delenv("DIE_E_BF16", raising=False)
    assert tdevice.compute_dtype("cpu") == torch.float32
    assert tdevice.compute_dtype("cuda") == torch.float32
    monkeypatch.setenv("DIE_E_BF16", "1")
    assert tdevice.compute_dtype("cpu") == torch.float32
    assert tdevice.compute_dtype(torch.device("cpu")) == torch.float32
    assert tdevice.compute_dtype("cuda") == torch.bfloat16
    assert tdevice.compute_dtype(torch.device("cuda", 0)) == torch.bfloat16
    monkeypatch.setenv("DIE_E_BF16", "0")
    assert tdevice.compute_dtype("cuda") == torch.float32
    assert tdevice.COMPUTE_DTYPE == torch.float32  # training's dtype is unchanged


def test_training_is_bit_identical_whatever_the_inference_dtype():
    """forward_train and one train_step on a net that ran a bf16 inference
    forward equal those on a net that ran none, bit for bit."""
    _, tspec = SMALL["backgammon"]
    rng = np.random.default_rng(5)
    obs = torch.tensor(_obs(16, 5))
    ps = torch.tensor(rng.dirichlet(np.full(tspec.num_actions, 0.1), 16).astype(np.float32))
    outcome = torch.tensor(rng.choice([-1.0, 0.0, 1.0], 16).astype(np.float32))
    weight = torch.ones(16)
    states = [tl.create_train_state(tspec, 3, device="cpu") for _ in range(2)]
    tnet.forward(states[1].net, obs, dtype=torch.bfloat16)
    outs = []
    for st in states:
        logits, value = tnet.forward_train(st.net, obs)
        _, m = tl.train_step(st, obs, ps, outcome, weight)
        outs.append((logits, value, m["loss"], st.net.state_dict()))
    (l0, v0, loss0, sd0), (l1, v1, loss1, sd1) = outs
    assert l0.dtype == torch.float32
    assert torch.equal(l0, l1) and torch.equal(v0, v1) and torch.equal(loss0, loss1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_call_sites_pass_compute_dtype(tmp_path, monkeypatch, capsys):
    """learn's self-play and gate, the CLI's ``play`` and the ladder's (and
    so the tournament's) model players evaluate in ``compute_dtype(dev)``:
    here made to answer bf16 on the CPU."""
    from die_e_tpu_torch.cli import main as cli
    from die_e_tpu_torch.core.config import (
        AlphaZeroConfig,
        ArenaConfig,
        Config,
        MctsConfig,
        OptimizerParams,
    )
    from die_e_tpu_torch.core.metrics import Metrics
    from die_e_tpu_torch.scripts import strength_ladder
    from die_e_tpu_torch.train import checkpoint as ckpt
    from die_e_tpu_torch.train import learn as learn_mod

    seen = []
    real_forward = tl.forward

    def forward(net, obs, softmax_policy=True, dtype=torch.float32):
        seen.append(dtype)
        return real_forward(net, obs, softmax_policy, dtype)

    def bf16(dev):
        assert torch.device(dev).type == "cpu"
        return torch.bfloat16

    monkeypatch.setattr(tl, "forward", forward)
    for mod in (learn_mod, strength_ladder, tdevice):
        monkeypatch.setattr(mod, "compute_dtype", bf16)

    spec = dataclasses.replace(tttt.SPEC, n_filters=8, n_res_blocks=1)
    env = dataclasses.replace(tttt.ENV, spec=spec)
    config = Config(
        mcts=MctsConfig(iterations=4, simulate_round_limit=9),
        alphazero=AlphaZeroConfig(learn_iterations=2, self_play_iterations=1, num_epochs=1,
                                  training_batch_size=2048, num_self_play_batches=8),
        optimizer=OptimizerParams(), arena=ArenaConfig(num_games=4, round_limit=9))
    jsonl = tmp_path / "m.jsonl"
    learn_mod.learn(env, config, seed=0, data_base=str(tmp_path / "data"),
                    models_base=str(tmp_path / "models"),
                    metrics=Metrics(jsonl_path=str(jsonl), quiet=True), device="cpu")
    gates = [e for e in map(json.loads, jsonl.read_text().splitlines()) if e["event"] == "gate"]
    assert [g.get("games") for g in gates] == [None, 4]  # the second gate played
    assert seen and set(seen) == {torch.bfloat16}

    seen.clear()
    best = tmp_path / "models" / "tictactoe" / "best"
    monkeypatch.setattr(tttt, "SPEC", spec)
    monkeypatch.setattr(tttt, "ENV", env)
    cfg = tmp_path / "play.toml"
    cfg.write_text("iterations = 4\narena_round_limit = 9\n")
    assert cli.main(["--device", "cpu", "-c", str(cfg), "-g", "tictactoe", "play", "-1", "model",
                     "-2", "random", "--model1-path", str(best), "--num-games", "4"]) == 0
    assert "Number of Games: 4" in capsys.readouterr().out
    assert seen and set(seen) == {torch.bfloat16}

    seen.clear()
    bg_ckpt = tmp_path / "bg"
    bg_spec = dataclasses.replace(tbg.SPEC, n_filters=8, n_res_blocks=1)
    ckpt.save_variables(tnet.make_net(bg_spec, 0, "cpu").state_dict(), bg_ckpt)
    monkeypatch.setattr(tbg, "SPEC", bg_spec)
    player = strength_ladder.model_player(bg_ckpt, torch.device("cpu"))
    player.model(torch.tensor(_obs(2, 0)))
    assert seen == [torch.bfloat16]
