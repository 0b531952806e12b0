"""Entry points of the port: the flagship forward and a multi-process dry
run, the port's counterpart of the JAX package's ``__graft_entry__.py``.

``entry()`` returns the flagship model's inference forward (the backgammon
256x19 policy/value ResNet) with an example batch.

``dryrun_multichip(n)`` starts ``n`` processes, one per card on the card
(NCCL) or ``n`` on the CPU (gloo), and runs in them every stage a
multi-process learn iteration runs, at small shapes (a 32x2 net with the
real backgammon observation and action spaces, 2 games a process):

1. the fused ``train_iteration`` over the ``n``-process group, its loss
   equal to one process's step on all the processes' games together within
   ``LOSS_RTOL`` (float32 sums in another order);
2. an asynchronous save by process 0, a restore in every process and one
   more fused step from the restored state;
3. one round of the gate arena (model against model) on process 0.

Usage:  python -m die_e_tpu_torch.entry [--device cpu] [--processes N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

LOSS_RTOL = 1e-5
GAMES_PER_PROCESS = 2
STEP_KW = dict(iterations=4, round_limit=4)
ROOT = Path(__file__).resolve().parents[1]


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` is the flagship ResNet's
    inference forward (softmax policy [8, 1352], value [8, 1]) on a batch of
    8 zero observations, on ``device`` (cuda unless the caller asks for the
    CPU)."""
    from die_e_tpu_torch.core.device import resolve_device
    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.nets.resnet import forward, make_net

    dev = resolve_device(device)
    net = make_net(bg.SPEC, 0, dev)
    return forward, (net, torch.zeros((8, *bg.SPEC.obs_shape), device=dev))


def _dryrun_process(world: int, rank: int, init: str, device: str, out_dir: str) -> None:
    """One process of :func:`dryrun_multichip`; process 0 writes
    ``result.json`` into ``out_dir``."""
    import torch.distributed as dist

    from die_e_tpu_torch.arena.versus import Agent, Player, play
    from die_e_tpu_torch.core.config import MctsConfig
    from die_e_tpu_torch.core.prng import seed_from
    from die_e_tpu_torch.envs import backgammon as bg
    from die_e_tpu_torch.parallel.distributed import flatten_trajectory, train_iteration
    from die_e_tpu_torch.parallel.multihost import batch_slice, initialize_multihost
    from die_e_tpu_torch.train import checkpoint as ckpt
    from die_e_tpu_torch.train.learner import (
        create_train_state,
        net_eval_fn,
        set_process_group,
        train_step,
    )
    from die_e_tpu_torch.train.self_play import self_play_from_states

    torch.set_num_threads(1)
    cluster = initialize_multihost(init, world, rank, device=device)
    try:
        dev = cluster.device
        spec = dataclasses.replace(bg.SPEC, n_filters=32, n_res_blocks=2)
        env = dataclasses.replace(bg.ENV, spec=spec)
        batch = GAMES_PER_PROCESS * world
        seeds = torch.arange(batch, dtype=torch.int64)

        def games(r):
            return env.init(seeds[batch_slice(batch, r, world)].to(dev), device=dev)

        def gen(r, salt):
            return torch.Generator(device=dev).manual_seed(seed_from(salt, r))

        def state(seed):
            return set_process_group(create_train_state(spec, seed, device=dev),
                                     dist.group.WORLD)

        # 1) the fused step over the group, and one process's step on all
        #    the processes' games (each played with its process's generator)
        st = state(0)
        st, m = train_iteration(env, st, net_eval_fn(st.net), games(rank), gen(rank, 1),
                                **STEP_KW)
        ref = create_train_state(spec, 0, device=dev)
        parts = [flatten_trajectory(self_play_from_states(
            env, net_eval_fn(ref.net), games(r), gen(r, 1), **STEP_KW), 1.25)
            for r in range(world)]
        _, m1 = train_step(ref, *(torch.cat(x) for x in zip(*parts)))

        # 2) save on process 0, restore everywhere, continue
        path = Path(out_dir) / "latest"
        if rank == 0:
            saver = ckpt.AsyncSaver()
            saver.save_state(st, path)
            saver.close()
        dist.barrier(group=cluster.host_group)
        restored = ckpt.restore_state(path, state(1))
        cont, m2 = train_iteration(env, restored, net_eval_fn(restored.net), games(rank),
                                   gen(rank, 2), **STEP_KW)
        if not (np.isfinite(m2["loss"]) and cont.step == 2 and restored.step == 2):
            raise AssertionError(f"continued step: loss {m2['loss']}, step {cont.step}")

        # 3) one round of the gate arena, candidate against the saved state
        if rank == 0:
            res = play(env, Player(Agent.MODEL, net_eval_fn(cont.net)),
                       Player(Agent.MODEL, net_eval_fn(st.net)), gen(rank, 3),
                       MctsConfig(iterations=4, simulate_round_limit=4),
                       num_games=batch, round_limit=1)
            result = {"processes": world, "backend": cluster.backend, "batch": batch,
                      "loss": m["loss"], "loss_one_process": float(m1["loss"]),
                      "fragments": m["fragments"],
                      "fragments_one_process": sum(float(p[3].sum()) for p in parts),
                      "resume_loss": m2["loss"], "resume_step": cont.step,
                      "gate_rounds": res.rounds,
                      "gate_games": res.wins_p1 + res.wins_p2 + res.draws}
            (Path(out_dir) / "result.json").write_text(json.dumps(result))
        dist.barrier(group=cluster.host_group)
    finally:
        cluster.close()


def dryrun_multichip(n: int, device=None, timeout: float = 600.0) -> dict:
    """Run the dry run in ``n`` processes on ``device`` (cuda unless the
    caller asks for the CPU); raises when a process fails or the group's
    loss differs from one process's by more than ``LOSS_RTOL``.  Returns
    process 0's result."""
    from die_e_tpu_torch.core.device import resolve_device

    dev = resolve_device(device).type
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "die_e_tpu_torch.entry", "--device", dev,
             "--processes", str(n), "--rank", str(r), "--init", f"file://{tmp}/rendezvous",
             "--out", tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"dry-run process {r} failed:\n{out[-4000:]}")
        result = json.loads((Path(tmp) / "result.json").read_text())
    if not abs(result["loss"] - result["loss_one_process"]) <= LOSS_RTOL * abs(
            result["loss_one_process"]):
        raise AssertionError(f"{n}-process loss {result['loss']} != one process's "
                             f"{result['loss_one_process']} (rtol {LOSS_RTOL})")
    if result["fragments"] != result["fragments_one_process"]:
        raise AssertionError(f"fragments {result}")
    print(f"dryrun_multichip ok: {n} processes ({result['backend']}), batch "
          f"{result['batch']}, loss {result['loss']:.6f} (= one process "
          f"{result['loss_one_process']:.6f}), fragments {result['fragments']:.0f}, "
          f"resume loss {result['resume_loss']:.6f} (step {result['resume_step']}), "
          f"gate rounds {result['gate_rounds']}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--processes", type=int, default=None,
                   help="dry-run processes (default: one per card, or 2 on the cpu)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:  # one process of a dry run
        _dryrun_process(args.processes, args.rank, args.init, args.device, args.out)
        return 0
    fn, example = entry(args.device)
    print("entry ok:", [tuple(o.shape) for o in fn(*example)])
    n = args.processes or (torch.cuda.device_count() if args.device == "cuda" else 2)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
