"""One process of ``tests/test_torch_parallel.py``'s 2-process group (gloo
on the CPU).

    python tests/torch_mp_worker.py RANK WORLD INIT_URL IN_DIR OUT_DIR

Joins the group, runs every scenario on the inputs that the test wrote to
IN_DIR (and on :func:`memory`, made here and in the test from the same
seeds) and writes ``OUT_DIR/rank{RANK}.npz``.  Imports torch and the port
only, so that each process starts in about a second.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

A = 1352             # backgammon's actions
BN_ROWS = (3, 5)     # rows of the cross-rank BatchNorm input on each rank


def memory(rank: int):
    """Rank ``rank``'s self-play memory: (obs, ps, outcome, winner), with
    2 * rank + 3 fragments and rank + 4 games, int8-exact observations and
    sparse temperature-powered probability rows."""
    rng = np.random.default_rng(100 + rank)
    n = 2 * rank + 3
    obs = rng.integers(-3, 4, (n, 4, 6, 6)).astype(np.float32)
    ps = np.zeros((n, A), np.float32)
    for i in range(n):
        cols = rng.choice(A, size=int(rng.integers(1, 70)), replace=False)
        ps[i, cols] = (rng.random(len(cols)).astype(np.float32) + 0.1) ** np.float32(0.8)
    outcome = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    winner = rng.choice([-1, 0, 1], rank + 4).astype(np.int32)
    return obs, ps, outcome, winner


def bn_input():
    """(x [8, 6, 3, 3], upstream gradient g) of the BatchNorm scenario."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((sum(BN_ROWS), 6, 3, 3)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, g


def bn_rows(rank: int) -> slice:
    start = sum(BN_ROWS[:rank])
    return slice(start, start + BN_ROWS[rank])


def _state(in_dir, spec, group):
    from die_e_tpu_torch.train import checkpoint as ckpt
    from die_e_tpu_torch.train.learner import create_train_state, set_process_group

    st = ckpt.restore_state(Path(in_dir) / "state", create_train_state(spec, 1, device="cpu"))
    return set_process_group(st, group)


def _grads(st, prefix: str) -> dict:
    return {f"{prefix}grad/{k}": p.grad.numpy().copy() for k, p in st.net.named_parameters()}


def main(rank: int, world: int, init: str, in_dir: str, out_dir: str) -> None:
    import dataclasses

    import torch.distributed as dist

    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.nets.resnet import BatchNorm
    from die_e_tpu_torch.parallel import multihost as mh
    from die_e_tpu_torch.train import checkpoint as ckpt
    from die_e_tpu_torch.train import learner as tl

    torch.set_num_threads(1)
    cluster = mh.initialize_multihost(init, world, rank, device="cpu")
    out = {"backend": np.asarray(cluster.backend)}
    try:
        host = cluster.host_group
        obs, ps, outcome, winner = memory(rank)
        for k, v in zip(("obs", "ps", "outcome"), mh.allgather_memory(obs, ps, outcome,
                                                                         group=host)):
            out[f"dense/{k}"] = v
        stats: dict = {}
        for k, v in zip(("obs", "ps", "outcome"), mh.allgather_memory_sparse(
                obs, ps, outcome, obs_int8=True, stats=stats, group=host)):
            out[f"sparse/{k}"] = v
        out["bytes_wire"], out["bytes_dense"] = stats["bytes_wire"], stats["bytes_dense"]
        (out["winner"],) = mh.allgather_memory(winner, group=host)
        out["slice"] = mh.process_batch_slice(8, seed=5)

        # the cross-rank BatchNorm on this rank's rows of one input
        x, g = bn_input()
        bn = BatchNorm(6)
        bn.group = dist.group.WORLD
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
            bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
        bn.train()
        xr = torch.tensor(x[bn_rows(rank)], requires_grad=True)
        y = bn(xr)
        y.backward(torch.tensor(g[bn_rows(rank)]))
        out.update({"bn/y": y.detach().numpy(), "bn/dx": xr.grad.numpy(),
                    "bn/dweight": bn.weight.grad.numpy(), "bn/dbias": bn.bias.grad.numpy(),
                    "bn/running_mean": bn.running_mean.numpy(),
                    "bn/running_var": bn.running_var.numpy()})

        # a group of one rank is a single process: the plain BatchNorm path
        one = dist.new_group([0])
        if rank == 0:
            spec = dataclasses.replace(bg.SPEC, n_filters=8, n_res_blocks=1)
            st = _state(in_dir, spec, one)
            out["one_rank_group_is_single_process"] = np.asarray(
                st.group is None and all(m.group is None for m in st.net.modules()
                                         if isinstance(m, BatchNorm)))

        # one data-parallel train step and one epoch on the global batch
        spec = dataclasses.replace(bg.SPEC, n_filters=8, n_res_blocks=1)
        z = np.load(Path(in_dir) / "batch.npz")
        st = _state(in_dir, spec, dist.group.WORLD)
        mine = mh.batch_slice(len(z["weight"]), rank, world)
        n = torch.tensor(z["weight"]).sum().clamp_min(1.0)
        _, m = tl.train_step(st, *(torch.tensor(z[k][mine]) for k in
                                   ("obs", "ps", "outcome", "weight")), n)
        out["step/loss"] = mh.all_reduce_(torch.stack(
            [m["loss"], m["policy_loss"], m["value_loss"]])).numpy()
        out.update(_grads(st, "step/"))
        ckpt.save_state(st, Path(out_dir) / f"rank{rank}_step")

        st = _state(in_dir, spec, dist.group.WORLD)
        data = tl.upload_epoch_data(z["obs"], z["ps"], z["outcome"], 32, bucket=64,
                                    device="cpu")
        ms: list = []
        tl.train_epoch_device(st, data, 32, metrics_out=ms,
                              perm=torch.tensor(z["epoch_perm"]))
        out["epoch/loss"] = np.asarray([ms[0]["loss"], ms[0]["policy_loss"],
                                        ms[0]["value_loss"]])
        ckpt.save_state(st, Path(out_dir) / f"rank{rank}_epoch")
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        dist.barrier(group=host)
    finally:
        cluster.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
