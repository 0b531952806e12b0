"""Strength ladder: a trained model against fixed opponents; the port of
``scripts/strength_ladder.py``.

The model (a port checkpoint, by default ``models/backgammon/best``)
plays each rung in arena matches (``arena/versus.py::play``): N games,
half the openings each side, round-limit draws, temperature 0.3.  Rungs:

* ``random``: the sanity floor;
* ``mctsN``: the pure-rollout agent at N iterations a move, with its
  playouts capped at ``--rollout-limit`` steps.

The model searches with ``--sims`` simulations a move whatever the rung,
in bfloat16 under ``DIE_E_BF16=1`` on the card (:func:`model_player`, which
the tournament loads its models through too).
A rung plays in blocks of ``--block`` games and stops once the 95% Wilson
interval of its winrate lies above or below 0.5 after ``--min-games``
(``arena/elo.py::SequentialRung``), else at ``--games``; ``--block 0``
plays ``--games`` in one block.  Each block draws from its own generator,
seeded from (``--seed``, rung index, block index), so a run resumed from
``--resume-state`` replays the same schedule and skips finished rungs and
blocks.

Prints a ``ladder_block`` line to stderr after each block and one
``strength_ladder`` JSON row per rung to stdout (and ``--out``), as the
JAX script does.

Usage:

    python -m die_e_tpu_torch.scripts.strength_ladder [--model-path DIR]
        [--games 128] [--rungs random,mcts100,mcts400,mcts1000]
        [--round-limit 300] [--block 32] [--out ladder.jsonl]
        [--resume-state state.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from die_e_tpu_torch.arena.elo import SequentialRung
from die_e_tpu_torch.arena.versus import Agent, Player, play
from die_e_tpu_torch.core.config import MctsConfig
from die_e_tpu_torch.core.device import compute_dtype, resolve_device
from die_e_tpu_torch.core.prng import seed_from
from die_e_tpu_torch.envs import backgammon as bg
from die_e_tpu_torch.train import checkpoint as ckpt
from die_e_tpu_torch.train.learner import net_eval_fn

TEMPERATURE = 0.3  # near-greedy for strength measurement


def rung_player(rung: str, what: str = "rung") -> tuple[Player, Optional[int]]:
    """``random`` or ``mctsN`` -> (the opponent, its iterations or None)."""
    if rung == "random":
        return Player(Agent.RANDOM), None
    if rung.startswith("mcts"):
        return Player(Agent.MCTS), int(rung[4:])
    raise SystemExit(f"unknown {what} {rung!r}")


def arena_config(sims: int, round_limit: int, negamax: bool) -> MctsConfig:
    """The search settings the ladder and the tournament share, so that a
    ladder rung is an Elo match (``arena/elo.py::ladder_rows_to_match_records``)."""
    return MctsConfig(iterations=sims, c=2.0, simulate_round_limit=round_limit,
                      dirichlet_alpha=0.3, dirichlet_epsilon=0.25, negamax=negamax)


def model_player(path, dev) -> Player:
    """The model at ``path`` as a player, computing in ``dev``'s inference
    dtype (bf16 under ``DIE_E_BF16=1`` on the card)."""
    return Player(Agent.MODEL, net_eval_fn(ckpt.load_net(path, bg.SPEC, dev),
                                           compute_dtype(dev)))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-path", default=None,
                    help="checkpoint dir (default models/backgammon/best)")
    ap.add_argument("--name", default=None,
                    help="player name recorded in the output rows (default: the "
                    "checkpoint dir basename); `best` moves with each promotion, so "
                    "ladder the underlying model_N under its own name")
    ap.add_argument("--games", type=int, default=128)
    ap.add_argument("--rungs", default="random,mcts100,mcts400,mcts1000")
    ap.add_argument("--round-limit", type=int, default=300)
    ap.add_argument("--sims", type=int, default=100, help="model PUCT sims per move")
    ap.add_argument("--rollout-limit", type=int, default=60,
                    help="pure-MCTS playout depth cap (truncated playouts score 0, "
                    "like round-limit draws)")
    ap.add_argument("--block", type=int, default=32,
                    help="games per sequential block (0 = fixed --games, no early "
                    "stopping)")
    ap.add_argument("--min-games", type=int, default=32,
                    help="games before the sequential rule may stop")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--negamax", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here too")
    ap.add_argument("--resume-state", default=None,
                    help="JSON file of per-rung block tallies; relaunch with the same "
                    "flags and finished blocks and rungs are skipped")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    path = args.model_path or str(ckpt.best_model_path("backgammon"))
    model = model_player(path, dev)
    mcts_cfg = arena_config(args.sims, args.round_limit, args.negamax)
    state_path = Path(args.resume_state) if args.resume_state else None
    state: dict = {}
    if state_path and state_path.exists():
        state = json.loads(state_path.read_text())

    def save_state():
        if state_path:
            tmp = state_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(state))
            tmp.replace(state_path)

    for rung_i, rung in enumerate(args.rungs.split(",")):
        rung = rung.strip()
        opponent, mcts_iters = rung_player(rung)
        t0 = time.perf_counter()
        is_mcts = opponent.kind == Agent.MCTS
        block = args.block if args.block > 0 else args.games
        seq = SequentialRung(args.games, min_games=args.min_games)
        st = state.setdefault(rung, {
            "games": 0, "wins": 0, "losses": 0, "draws": 0,
            "blocks": 0, "secs": 0.0, "done": False})
        if st["done"]:
            print(json.dumps({"metric": "ladder_skip", "rung": rung,
                              "reason": "already done in resume state"}),
                  file=sys.stderr, flush=True)
            continue
        wins, losses, draws = st["wins"], st["losses"], st["draws"]
        n_blocks = st["blocks"]
        if st["games"]:
            seq.update(wins, st["games"])  # replay the tally into the stop rule
        while not seq.done:
            n = min(block, args.games - seq.games)
            gen = torch.Generator(device=dev).manual_seed(seed_from(args.seed, rung_i, n_blocks))
            res = play(
                bg.ENV, model, opponent, gen, mcts_cfg, temperature=TEMPERATURE,
                num_games=n, round_limit=args.round_limit, mcts_iterations=mcts_iters,
                mcts_rollout_limit=args.rollout_limit if is_mcts else None,
            )
            wins += res.wins_p1
            losses += res.wins_p2
            draws += res.draws
            n_blocks += 1
            seq.update(res.wins_p1, n)
            st.update(games=seq.games, wins=wins, losses=losses, draws=draws,
                      blocks=n_blocks, secs=round(st["secs"] + time.perf_counter() - t0, 1))
            t0 = time.perf_counter()
            save_state()
            print(json.dumps({
                "metric": "ladder_block", "rung": rung, "games": seq.games,
                "wins": wins, "wilson95": [round(x, 4) for x in seq.ci],
                "secs": st["secs"],
            }), file=sys.stderr, flush=True)
        st["done"] = True
        save_state()
        lo, hi = seq.ci
        line = {
            "metric": "strength_ladder", "model": path,
            "name": args.name or None, "rung": rung,
            "games": seq.games, "wins": wins, "losses": losses,
            "draws": draws, "winrate": seq.winrate,
            "wilson95": [round(lo, 4), round(hi, 4)],
            "model_sims": args.sims, "round_limit": args.round_limit,
            "secs": round(st["secs"] + time.perf_counter() - t0, 1),
            "early_stopped": seq.games < args.games,
            "verdict": seq.verdict,
        }
        if is_mcts:
            line["rollout_limit"] = args.rollout_limit
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
