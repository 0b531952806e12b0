"""Seeded trajectory parity in bulk: N full backgammon games, the port's
env on the device against the C++ oracle; the port of
``scripts/parity_sweep.py``.

Both sides play the oracle's deterministic policy (the k-th legal action,
k from the salted seed stream) from the same per-game seeds,
``arange(1, N + 1) * 2654435761``.  The device side runs all games in
lockstep, one host round a step, until every game is done or at
``max_steps``, freezing finished games (``envs/base.py::freeze_where``);
it returns a rolling hash of each game's actions, its winner and its
move count.  The host side replays every game through
``parity/oracle.py::run_trajectory`` (imported when that side runs, so
the sweep runs from the root of a checkout) and compares the three.  All of it is
integer work: the hashes equal the JAX package's sweep bit for bit.

Exits 1 on any mismatch.

Usage:

    python -m die_e_tpu_torch.scripts.parity_sweep [N_GAMES=2048] [MAX_STEPS=1500]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.envs import backgammon as bg
from die_e_tpu_torch.envs.base import freeze_where

SEED_STRIDE = 2654435761
ACTION_SALT = 0xACC10000
HASH_STRIDE = 1353
_U32 = 0xFFFFFFFF


def game_seeds(n_games: int) -> np.ndarray:
    return np.arange(1, n_games + 1, dtype=np.uint32) * np.uint32(SEED_STRIDE)


def _mix_np(x: np.ndarray) -> np.ndarray:
    """murmur3's fmix32 on uint32 arrays (the oracle side's hash)."""
    x = x.astype(np.uint64)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _U32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _U32
    x ^= x >> 16
    return x.astype(np.uint32)


@torch.no_grad()
def device_side(seeds: np.ndarray, max_steps: int, device):
    """(hash uint32 [N], winner int32 [N], moves int32 [N]) of the games
    from ``seeds``, played on ``device``."""
    seed = torch.from_numpy(seeds.astype(np.int64)).to(device)
    states = bg.init(seed, device=device)
    done = bg.ENV.done(states)
    h = torch.zeros_like(seed)
    moves = torch.zeros(seed.shape, dtype=torch.int32, device=device)
    t = 0
    while t < max_steps and not bool(done.all()):
        legal = bg.legal_mask(states)
        n_legal = legal.sum(-1)
        # the oracle's action rule: the k-th legal action, k from the salted stream
        k = bg._mix32(seed ^ bg._mix32(torch.tensor(ACTION_SALT + t, device=device))) \
            % n_legal.clamp_min(1)
        pos = torch.cumsum(legal, -1) - 1
        action = (legal & (pos == k[:, None])).to(torch.int32).argmax(-1)
        h = torch.where(done, h, bg._mix32(h ^ (t * HASH_STRIDE + action)))
        moves += (~done).to(torch.int32)
        states = freeze_where(done, states, bg.step(states, action.to(torch.int32)))
        done = done | bg.ENV.done(states)
        t += 1
    winner = torch.where(done, bg.winner(states), 0)
    return (h.cpu().numpy().astype(np.uint32), winner.cpu().numpy().astype(np.int32),
            moves.cpu().numpy())


def oracle_side(seeds: np.ndarray, max_steps: int):
    """(hash, winner, moves) of the same games from the C++ oracle: the
    hash over each game's actions up to its terminal marker (-1), the
    winner from its last recorded state; the hash steps run over all
    games at once.  The oracle is the repo's top-level ``parity`` package,
    so this side runs from the root of a checkout."""
    from parity import oracle as cpp

    n = len(seeds)
    actions = np.full((n, max_steps), -1, np.int64)
    winner = np.zeros(n, np.int32)
    for i, seed in enumerate(seeds):
        traj = cpp.run_trajectory(int(seed), max_steps=max_steps)
        actions[i, :traj["n"]] = traj["actions"]
        off = traj["offs"][traj["n"] - 1]
        winner[i] = -1 if off[0] == 15 else (1 if off[1] == 15 else 0)
    ended = actions < 0
    moves = np.where(ended.any(1), ended.argmax(1), max_steps).astype(np.int32)
    h = np.zeros(n, np.uint32)
    for t in range(int(moves.max(initial=0))):
        live = t < moves
        step = t * HASH_STRIDE + np.where(live, actions[:, t], 0)
        h = np.where(live, _mix_np(h ^ step.astype(np.uint32)), h)
    return h, winner, moves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_games", nargs="?", type=int, default=2048)
    ap.add_argument("max_steps", nargs="?", type=int, default=1500)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    seeds = game_seeds(args.n_games)

    t0 = time.perf_counter()
    h_d, w_d, m_d = device_side(seeds, args.max_steps, dev)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_o, w_o, m_o = oracle_side(seeds, args.max_steps)
    t_oracle = time.perf_counter() - t0

    bad = np.flatnonzero((h_d != h_o) | (w_d != w_o) | (m_d != m_o))
    for i in bad[:5]:
        print(f"MISMATCH game {i} seed {seeds[i]}: hash {h_o[i]:#x} vs {h_d[i]:#x}, "
              f"winner {w_o[i]} vs {w_d[i]}, moves {m_o[i]} vs {m_d[i]}")
    print(f"games={args.n_games} max_steps={args.max_steps} "
          f"finished={int(np.sum(w_o != 0))} longest={int(m_o.max(initial=0))} "
          f"mismatches={len(bad)} "
          f"({dev.type} {t_dev:.1f}s, oracle {t_oracle:.1f}s)", flush=True)
    return 1 if len(bad) else 0


if __name__ == "__main__":
    sys.exit(main())
