"""The port's checkpoints: round trips, the background saver and its swap
protocol (the cases of ``tests/test_async_ckpt.py``), and a JAX run's
full train state carried into the port.

Copies are compared bit for bit.  The converted trained net's forward is
held against flax's within 2e-4 absolute in float32, as in
``tests/test_torch_resnet.py`` (the logits of the trained 256x19 net reach
tens, and the frameworks sum the convolutions in different orders).
"""

import dataclasses
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.train import checkpoint as ckpt
from die_e_tpu_torch.train import learner as tl

ROOT = Path(__file__).resolve().parents[1]
LATEST = ROOT / "runs/bg_full/models/backgammon/latest_state"
SPEC = dataclasses.replace(tttt.SPEC, n_filters=8, n_res_blocks=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def trained_state(seed=3):
    """A state that has taken two steps, so the optimizer has moments."""
    state = tl.create_train_state(SPEC, seed, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(2):
        obs = torch.tensor(rng.integers(-1, 2, (8, *SPEC.obs_shape)), dtype=torch.float32)
        ps = torch.tensor(rng.dirichlet(np.ones(SPEC.num_actions), 8), dtype=torch.float32)
        tl.train_step(state, obs, ps, torch.tensor(rng.choice([-1.0, 1.0], 8),
                                                   dtype=torch.float32), torch.ones(8))
    return state


def assert_same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.net.state_dict().items(), b.net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert a.step == b.step


def fresh():
    return tl.create_train_state(SPEC, 99, device="cpu")


@pytest.fixture(scope="module")
def state():
    return trained_state()


def test_state_round_trip(state, tmp_path):
    ckpt.save_state(state, tmp_path / "s")
    assert_same_state(state, ckpt.restore_state(tmp_path / "s", fresh()))
    assert not (tmp_path / "s.tmp").exists()


def test_variables_round_trip_and_overwrite(state, tmp_path):
    ckpt.save_variables(fresh().net.state_dict(), tmp_path / "v")
    ckpt.save_variables(state.net.state_dict(), tmp_path / "v")  # replaces it
    net = ckpt.restore_variables(tmp_path / "v", fresh().net)
    for (k, a), (_, b) in zip(net.state_dict().items(), state.net.state_dict().items()):
        assert torch.equal(a, b), k


def test_restored_state_trains_on_like_the_original(tmp_path):
    a = trained_state()
    ckpt.save_state(a, tmp_path / "s")
    b = ckpt.restore_state(tmp_path / "s", fresh())
    obs = torch.zeros((4, *SPEC.obs_shape))
    ps = torch.full((4, SPEC.num_actions), 1.0 / SPEC.num_actions)
    for s in (a, b):
        tl.train_step(s, obs, ps, torch.zeros(4), torch.ones(4))
    assert_same_state(a, b)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_restore_places_moments_on_the_device_and_steps_on_the_host(device, tmp_path):
    """Adam's moments go to the parameters' device; its ``step`` counts
    stay CPU tensors, which its (non-capturable) update reads without a
    device sync."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ckpt.save_state(trained_state(), tmp_path / "s")
    b = ckpt.restore_state(tmp_path / "s", tl.create_train_state(SPEC, 99, device=device))
    assert b.step == 2
    for p in b.net.parameters():
        st = b.opt.state[p]
        assert st["step"].device.type == "cpu" and float(st["step"]) == 2.0
        assert st["exp_avg"].device == p.device and st["exp_avg_sq"].device == p.device


def test_bootstrap_order(state, tmp_path):
    net = fresh().net
    assert ckpt.bootstrap_variables(net, "g", None, str(tmp_path)) == "scratch"
    ckpt.save_variables(state.net.state_dict(), ckpt.best_model_path("g", str(tmp_path)))
    assert ckpt.bootstrap_variables(net, "g", None, str(tmp_path)).endswith("best")
    assert torch.equal(net.stem_conv.weight, state.net.stem_conv.weight)
    ckpt.save_variables(fresh().net.state_dict(), tmp_path / "explicit")
    assert ckpt.bootstrap_variables(net, "g", str(tmp_path / "explicit"),
                                    str(tmp_path)) == str(tmp_path / "explicit")
    assert torch.equal(net.stem_conv.weight, fresh().net.stem_conv.weight)


@pytest.fixture
def saver():
    s = ckpt.AsyncSaver()
    yield s
    s.close()


class TestAsyncSaver:
    def test_matches_sync_save(self, state, saver, tmp_path):
        saver.save_state(state, tmp_path / "async")
        saver.wait()
        ckpt.save_state(state, tmp_path / "sync")
        assert_same_state(ckpt.restore_state(tmp_path / "async", fresh()),
                          ckpt.restore_state(tmp_path / "sync", fresh()))

    def test_snapshot_taken_at_submission(self, saver, tmp_path):
        """Training may go on after the submission: the file holds the
        state as it was submitted."""
        a = trained_state()
        want = {k: v.clone() for k, v in a.net.state_dict().items()}
        ev = threading.Event()
        saver.submit(lambda: ev.wait(5))  # hold the worker
        t = threading.Thread(target=lambda: saver.save_state(a, tmp_path / "s"))
        t.start()
        time.sleep(0.05)
        ev.set()
        t.join(5)
        assert not t.is_alive()
        with torch.no_grad():
            a.net.stem_conv.weight.add_(1.0)
        saver.wait()
        got = torch.load(tmp_path / "s" / ckpt.STATE_FILE, weights_only=True)["net"]
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    def test_extra_variables_path_from_same_fetch(self, state, saver, tmp_path):
        saver.save_state(state, tmp_path / "full", extra_variables_path=tmp_path / "vars")
        saver.wait()
        net = ckpt.restore_variables(tmp_path / "vars", fresh().net)
        assert torch.equal(net.stem_conv.weight, state.net.stem_conv.weight)

    def test_on_committed_runs_after_checkpoint_exists(self, state, saver, tmp_path):
        seen = {}

        def cursor():
            seen["ckpt_exists"] = (tmp_path / "full" / ckpt.STATE_FILE).exists()
            (tmp_path / "meta.json").write_text(json.dumps({"next": 1}))

        saver.save_state(state, tmp_path / "full", on_committed=cursor)
        saver.wait()
        assert seen["ckpt_exists"] is True
        assert json.loads((tmp_path / "meta.json").read_text()) == {"next": 1}

    def test_wait_reraises_background_error(self, state, tmp_path):
        saver = ckpt.AsyncSaver()
        saver.submit(lambda: (_ for _ in ()).throw(RuntimeError("disk")))
        with pytest.raises(RuntimeError, match="disk"):
            saver.wait()
        saver.save_state(state, tmp_path / "after")
        saver.close()
        assert (tmp_path / "after").exists()

    def test_save_swaps_atomically_and_cleans_up(self, state, saver, tmp_path):
        target = tmp_path / "latest"
        saver.save_state(state, target)
        saver.wait()
        saver.save_state(state, target)
        saver.wait()
        assert target.exists()
        assert not (tmp_path / "latest.new").exists()
        assert not (tmp_path / "latest.old").exists()
        assert_same_state(ckpt.restore_state(target, fresh()), state)

    def test_saves_serialize_in_order(self):
        order = []
        ev = threading.Event()

        def slow():
            ev.wait(5)
            order.append("first")

        saver = ckpt.AsyncSaver()
        saver._pending = saver._executor.submit(slow)
        t = threading.Thread(target=lambda: saver.submit(lambda: order.append("second")))
        t.start()
        time.sleep(0.05)
        ev.set()
        t.join(5)
        assert not t.is_alive()
        saver.close()
        assert order == ["first", "second"]


class TestResolveStateDir:
    def test_heals_interrupted_swap(self, state, tmp_path):
        """A kill between the swap's two renames leaves only latest.new."""
        target = tmp_path / "latest"
        ckpt.save_state(state, tmp_path / "latest.new")
        assert ckpt.resolve_state_dir(target) == target
        assert_same_state(ckpt.restore_state(target, fresh()), state)

    def test_falls_back_to_old(self, state, tmp_path):
        """A kill after ``target -> .old`` and before ``.new -> target``
        with no complete .new: the previous state is healed into place."""
        target = tmp_path / "latest"
        ckpt.save_state(state, tmp_path / "latest.old")
        assert ckpt.resolve_state_dir(target) == target
        assert not (tmp_path / "latest.old").exists()
        assert_same_state(ckpt.restore_state(target, fresh()), state)

    def test_prefers_target_and_prunes(self, state, tmp_path):
        target = tmp_path / "latest"
        ckpt.save_state(state, target)
        (tmp_path / "latest.new").mkdir()  # torn unfinished save
        (tmp_path / "latest.old").mkdir()  # superseded state
        assert ckpt.resolve_state_dir(target) == target
        assert not (tmp_path / "latest.new").exists()
        assert not (tmp_path / "latest.old").exists()
        assert ckpt.resolve_state_dir(tmp_path / "absent") is None

    def test_torn_state_fails_to_restore(self, state, tmp_path):
        """A torn file raises, which the learn loop takes as "fall back"."""
        ckpt.save_state(state, tmp_path / "s")
        f = tmp_path / "s" / ckpt.STATE_FILE
        f.write_bytes(f.read_bytes()[:100])
        with pytest.raises(Exception):
            ckpt.restore_state(tmp_path / "s", fresh())


def test_jax_run_latest_state_converts_to_the_port(tmp_path):
    """``runs/bg_full``'s orbax ``latest_state``, restored by the JAX
    package as numpy, becomes a port checkpoint: the forward equals flax's
    and the Adam moments equal orbax's bit for bit."""
    import jax
    import jax.numpy as jnp

    from die_e_tpu.envs import backgammon as jbg
    from die_e_tpu.nets import resnet as jnet
    from die_e_tpu.train import checkpoint as jckpt
    from die_e_tpu.train import learner as jl
    from die_e_tpu_torch.envs import backgammon as tbg
    from die_e_tpu_torch.nets import resnet as tnet
    from die_e_tpu_torch.nets.convert import params_to_torch, save_flax_train_state
    from tests.test_torch_resnet import _obs

    if not LATEST.exists():
        pytest.fail(f"the tracked checkpoint is missing at {LATEST}")
    jnet_ = jnet.make_net(jbg.SPEC)
    template = jl.create_train_state(jnet_, jax.random.PRNGKey(0))
    js = jax.tree_util.tree_map(np.asarray, jckpt.restore_state(LATEST, template))
    adam = js.opt_state[1]
    assert int(adam.count) > 0
    lr, wd = 2.5e-4, 1e-4  # configs/bg_full.toml
    save_flax_train_state(tmp_path / "latest_state", tbg.SPEC, js.params,
                          js.batch_stats, adam.count, adam.mu, adam.nu, js.step, lr, wd)

    state = tl.create_train_state(tbg.SPEC, 0, lr=lr, wd=wd, device="cpu")
    ckpt.restore_state(tmp_path / "latest_state", state)
    assert state.step == int(js.step)
    mu, nu = params_to_torch(adam.mu), params_to_torch(adam.nu)
    opt_state = state.opt.state_dict()["state"]
    for i, (name, _) in enumerate(state.net.named_parameters()):
        assert int(opt_state[i]["step"]) == int(adam.count)
        assert torch.equal(opt_state[i]["exp_avg"], mu[name]), name
        assert torch.equal(opt_state[i]["exp_avg_sq"], nu[name]), name

    obs = _obs(3, 11)
    jp, jv = jnet.forward(jnet_, {"params": js.params, "batch_stats": js.batch_stats},
                          jnp.asarray(obs), softmax_policy=False)
    tp, tv = tnet.forward(state.net, torch.tensor(obs), softmax_policy=False)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-4, rtol=0)
