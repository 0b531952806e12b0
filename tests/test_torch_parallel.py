"""The port's multi-process layer (``parallel/``, ``core/prng.py``,
``core/mesh.py``, the cross-rank BatchNorm and the data-parallel step)
against one process and against the JAX package, on the CPU.

Two processes of ``tests/torch_mp_worker.py`` form one gloo group (a
``file://`` rendezvous in ``tmp_path``, one thread each, a timeout) and run
every scenario once; the tests read what they wrote.  Tolerances, float32:

* gathers, seeds and slices: exact;
* two processes against one, on the same global batch: every output,
  gradient, loss, BatchNorm statistic and Adam moment within ``ATOL`` =
  1e-6 of the largest magnitude of its tensor (at least 1), elementwise.
  Only the order of float32 sums differs, so the errors are a few ulps of
  the largest term; a step that got the global statistics or the global
  weight sum wrong is off by percents.  The parameters after Adam: each within
  1e-7 + 2 lr |dg| / (|g + wd p| + eps) of one process's, the most that
  Adam's first step can move apart two gradients that differ by |dg|.
  After an epoch of two steps, ``test_torch_learner.py``'s rules: the
  parameters within 5e-5, the convolutions' biases (whose gradients are
  rounding noise) each moved by at most lr a step, and the running
  statistics within 1e-6 + 2 * 0.01 * lr a step (the second step's batch
  means move with those biases);
* two processes against the JAX package's ``train_step`` on the same
  global batch, after ``nets/convert.py``: ``test_torch_learner.py``'s
  tolerances (loss 1e-5, parameters 5e-5, moments 2e-6, running statistics
  1e-5 + 2 * 0.01 * lr a step; the convolutions' biases, whose gradients
  are rounding noise, moved by at most lr).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.parallel import multihost as jmh
from die_e_tpu.train import learner as jl
from die_e_tpu_torch.core import mesh as tmesh
from die_e_tpu_torch.core import prng as tprng
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.nets.resnet import BN_MOMENTUM, BatchNorm
from die_e_tpu_torch.parallel import multihost as tmh
from die_e_tpu_torch.train import checkpoint as tckpt
from die_e_tpu_torch.train import learner as tl
from tests import torch_mp_worker as W
from tests.test_torch_learner import (
    LR,
    WD,
    _noise_driven,
    assert_states_close,
    batch,
    jax_state,
    port_state,
)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-6
SPEC = dataclasses.replace(tbg.SPEC, n_filters=8, n_res_blocks=1)
WORLD = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, one JAX state and its port copy, and the two processes'
    outputs: (jstate, global batch, in_dir, out_dir, [rank npz])."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("parallel")
    in_dir, out_dir = tmp / "in", tmp / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    _, jstate = jax_state()
    tckpt.save_state(port_state(jstate), in_dir / "state")
    obs, ps, outcome, w = batch(16, 21, zero_weight=5)  # weight 0 in rank 1's rows
    perm = np.random.default_rng(3).permutation(64)
    np.savez(in_dir / "batch.npz", obs=obs, ps=ps, outcome=outcome, weight=w,
             epoch_perm=perm)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mp_worker.py"), str(r), str(WORLD),
         f"file://{tmp}/rendezvous", str(in_dir), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-4000:]}"
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]
    return jstate, (obs, ps, outcome, w, perm), in_dir, out_dir, ranks


def close(got, want, err_msg=""):
    """Elementwise within ATOL of the largest magnitude of ``want`` (at
    least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0, err_msg=err_msg)


def _one_process_state(in_dir):
    return tckpt.restore_state(in_dir / "state", tl.create_train_state(SPEC, 1, device="cpu"))


# --- gathers, seeds, slices -------------------------------------------------


def test_allgather_memory_gives_every_rank_the_concatenation(run):
    *_, ranks = run
    want = [np.concatenate(x) for x in zip(*(W.memory(r) for r in range(WORLD)))]
    for out in ranks:
        assert str(out["backend"]) == "gloo"
        for k, x in zip(("obs", "ps", "outcome"), want):
            np.testing.assert_array_equal(out[f"dense/{k}"], x)
            assert out[f"dense/{k}"].dtype == x.dtype
        np.testing.assert_array_equal(out["winner"], want[3])  # per game, its own counts


def test_sparse_gather_equals_dense_bit_for_bit(run):
    *_, ranks = run
    for out in ranks:
        for k in ("obs", "ps", "outcome"):
            assert out[f"sparse/{k}"].dtype == np.float32
            np.testing.assert_array_equal(out[f"sparse/{k}"], out[f"dense/{k}"])
        assert 0 < int(out["bytes_wire"]) < int(out["bytes_dense"]) / 4


def test_allgather_memory_contract_error():
    """Arrays of different row counts in one call raise before any
    collective, as the JAX package's do."""
    obs, ps, _, winner = W.memory(0)
    for gather in (tmh.allgather_memory, jmh.allgather_memory):
        with pytest.raises(ValueError, match="must share the local row count"):
            gather(obs, winner)


def test_process_batch_slice_slices_as_jax(run, monkeypatch):
    """The same global set gives the same slices: rank i of H takes games
    [i*B/H, (i+1)*B/H), for every H; the global set is the same whatever
    the process count (JAX's seeds themselves cannot be reproduced)."""
    *_, ranks = run
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["slice"],
                                      tprng.per_game_seeds(5, 8)[4 * r:4 * (r + 1)])
    glob = np.arange(12, dtype=np.uint32) * 7 + 1
    monkeypatch.setattr("die_e_tpu.core.prng.per_game_seeds", lambda seed, n: glob[:n])
    monkeypatch.setattr(tmh, "per_game_seeds", lambda seed, n: glob[:n])
    for h in (1, 2, 3, 4):
        for i in range(h):
            monkeypatch.setattr(jax, "process_count", lambda h=h: h)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            np.testing.assert_array_equal(tmh.process_batch_slice(12, 0, i, h),
                                          jmh.process_batch_slice(12, 0))
    with pytest.raises(ValueError, match="not divisible"):
        tmh.process_batch_slice(10, 0, 0, 4)


def test_per_game_seeds_are_a_fixed_uint32_set():
    a = tprng.per_game_seeds(3, 1024)
    assert a.dtype == np.uint32 and a.shape == (1024,) and a.max() < 2 ** 31 - 1
    np.testing.assert_array_equal(a, tprng.per_game_seeds(3, 1024))
    np.testing.assert_array_equal(a[:10], tprng.per_game_seeds(3, 10))
    assert not np.array_equal(a, tprng.per_game_seeds(3, 1024, salt=1))


def test_batch_slice_and_mesh_rules():
    assert [tmh.batch_slice(256, r, 4) for r in range(4)] == [
        slice(0, 64), slice(64, 128), slice(128, 192), slice(192, 256)]
    with pytest.raises(ValueError, match="not divisible"):
        tmh.batch_slice(10, 0, 4)
    assert tmesh.make_mesh(-1, 1, 4) == {"data": 4, "model": 1}
    assert tmesh.make_mesh(2, 1, 2) == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="must equal the number of processes"):
        tmesh.make_mesh(4, 1, 2)
    with pytest.raises(ValueError, match="only mesh_model = 1"):
        tmesh.make_mesh(-1, 2, 2)


def test_backend_rule(monkeypatch):
    """NCCL only where every process on the host has a card of its own."""
    assert tmh.choose_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmh.choose_backend(torch.device("cuda"), 4) == "nccl"
    assert tmh.choose_backend(torch.device("cuda"), 2) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmh.choose_backend(torch.device("cuda"), 2) == "gloo"


def test_no_cluster_is_a_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.initialize_multihost(device="cpu") is None


# --- the cross-rank BatchNorm and the data-parallel step ---------------------


def test_cross_rank_batchnorm_equals_one_rank(run):
    *_, ranks = run
    x, g = W.bn_input()
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    bn.train()
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt)
    y.backward(torch.tensor(g))
    for r, out in enumerate(ranks):
        close(out["bn/y"], y.detach().numpy()[W.bn_rows(r)])
        close(out["bn/dx"], xt.grad.numpy()[W.bn_rows(r)])
        for k in ("running_mean", "running_var"):
            close(out[f"bn/{k}"], getattr(bn, k).numpy(), k)
    for k in ("dweight", "dbias"):  # each rank's own sums; the step adds them
        close(sum(out[f"bn/{k}"] for out in ranks), getattr(bn, k[1:]).grad.numpy(), k)


def test_one_rank_group_takes_the_single_process_path(run):
    *_, ranks = run
    assert bool(ranks[0]["one_rank_group_is_single_process"])


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _assert_two_equal_one(two: tl.TrainState, one: tl.TrainState, grads2=None):
    """Two processes' state against one process's (tolerances in the
    module doc)."""
    for k, v in _stats(one.net.state_dict()).items():
        close(two.net.state_dict()[k].numpy(), v.numpy(), k)
    opt1, opt2 = one.opt.state_dict()["state"], two.opt.state_dict()["state"]
    for i, (k, p1) in enumerate(one.net.named_parameters()):
        p2 = dict(two.net.named_parameters())[k]
        for m in ("exp_avg", "exp_avg_sq"):
            close(opt2[i][m].numpy(), opt1[i][m].numpy(), f"{m} {k}")
        # after one step Adam's first moment is 0.1 (g + wd p): the
        # gradient with the coupled decay, which the step divides by
        g1 = opt1[i]["exp_avg"] / 0.1
        dg = (opt2[i]["exp_avg"] - opt1[i]["exp_avg"]).abs() / 0.1
        bound = 1e-7 + 2 * LR * dg / (g1.abs() + 1e-8)
        assert bool(((p2 - p1).detach().abs() <= bound).all()), k
    if grads2 is not None:
        for k, p in one.net.named_parameters():
            close(grads2[k], p.grad.numpy(), k)
    assert two.step == one.step


def test_data_parallel_step_equals_one_process(run):
    _, (obs, ps, outcome, w, _), in_dir, out_dir, ranks = run
    one = _one_process_state(in_dir)
    _, m = tl.train_step(one, *map(torch.tensor, (obs, ps, outcome, w)))
    want = np.asarray([float(m[k]) for k in ("loss", "policy_loss", "value_loss")])
    for r, out in enumerate(ranks):
        close(out["step/loss"], want)
        two = tckpt.restore_state(out_dir / f"rank{r}_step",
                                  tl.create_train_state(SPEC, 2, device="cpu"))
        grads = {k[len("step/grad/"):]: v for k, v in out.items()
                 if k.startswith("step/grad/")}
        _assert_two_equal_one(two, one, grads)


def test_data_parallel_epoch_equals_one_process(run):
    """``train_epoch_device`` over the bucket-padded memory (2 batches of
    32, most rows weight-0 padding), each process on its half of every
    batch; the epoch's logged losses are the whole batches'."""
    _, (obs, ps, outcome, w, perm), in_dir, out_dir, ranks = run
    one = _one_process_state(in_dir)
    start = {k: p.detach().clone() for k, p in one.net.named_parameters()}
    data = tl.upload_epoch_data(obs, ps, outcome, 32, bucket=64, device="cpu")
    ms: list = []
    tl.train_epoch_device(one, data, 32, metrics_out=ms, perm=torch.tensor(perm))
    want = np.asarray([ms[0][k] for k in ("loss", "policy_loss", "value_loss")])
    for r, out in enumerate(ranks):
        close(out["epoch/loss"], want)
        two = tckpt.restore_state(out_dir / f"rank{r}_epoch",
                                  tl.create_train_state(SPEC, 2, device="cpu"))
        assert two.step == one.step == 2
        # after the first step the convolutions' biases (noise-driven) may
        # differ by up to lr, which moves the second step's batch means
        for k, p in two.net.named_parameters():
            if _noise_driven(k):
                for q in (p, dict(one.net.named_parameters())[k]):
                    assert float((q.detach() - start[k]).abs().max()) <= 2 * LR * (1 + 1e-3), k
            else:
                np.testing.assert_allclose(p.detach().numpy(), dict(
                    one.net.named_parameters())[k].detach().numpy(), atol=5e-5, rtol=0,
                    err_msg=k)
        for k, v in _stats(one.net.state_dict()).items():
            np.testing.assert_allclose(two.net.state_dict()[k].numpy(), v.numpy(),
                                       atol=ATOL + 2 * BN_MOMENTUM * LR * 2, rtol=0,
                                       err_msg=k)


def test_data_parallel_step_equals_jax_train_step(run):
    """The JAX package's single-device ``train_step`` on the whole global
    batch, and the port's step split over two processes."""
    jstate, (obs, ps, outcome, w, _), in_dir, out_dir, ranks = run
    net, _ = jax_state()
    start = {k: p.detach().clone()
             for k, p in _one_process_state(in_dir).net.named_parameters()}
    jstate, jm = jl.train_step(net, jl.make_optimizer(LR, WD), jstate,
                               *map(jnp.asarray, (obs, ps, outcome, w)))
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["step/loss"][0], float(jm["loss"]), atol=1e-5, rtol=0)
        two = tckpt.restore_state(out_dir / f"rank{r}_step",
                                  tl.create_train_state(SPEC, 2, device="cpu"))
        assert_states_close(jstate, two, 5e-5, start)
