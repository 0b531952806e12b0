"""Elo tournament: round-robin arena matches between checkpoints and
anchors; the port of ``scripts/elo_tournament.py``.

Every named player (port checkpoints, and fixed anchors: ``random`` and
the pure-rollout agent at ``mctsN`` iterations a move) plays every other
with the ladder's arena settings (``strength_ladder.arena_config``,
temperature 0.3).  Each match appends one ``elo_match`` row to ``--out``
as it is played.  Pairs already in ``--out`` are cached and not played
again, so the tournament grows across runs (add a checkpoint, re-run,
only its pairs play); a model is loaded only when one of its pairs has
to be played, through ``strength_ladder.model_player`` (bfloat16 under
``DIE_E_BF16=1`` on the card).  Two mcts anchors with different budgets
never meet (``play`` takes one pure-rollout budget a match).

The ratings are the Bradley-Terry fit (``arena/elo.py::compute_elo``)
anchored at ``random`` (else the first name), with 300 bootstrap
resamples for their 95% intervals (``bootstrap_elo``, ``--seed``),
printed and written to ``--out`` with its suffix replaced by
``.ratings.json``.

The k-th match played in a run draws from a generator seeded from
(``--seed``, k), the counterpart of the JAX script's k-th key split.

Usage:

    python -m die_e_tpu_torch.scripts.elo_tournament \\
        --models model_0=models/backgammon/model_0,best=models/backgammon/best \\
        [--anchors random,mcts100,mcts400] [--games 64] [--sims 100] \\
        [--out runs/bg_full/elo_matches.jsonl] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import torch

from die_e_tpu_torch.arena.elo import bootstrap_elo, compute_elo, matches_from_records
from die_e_tpu_torch.arena.versus import Agent, Player, play
from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.core.prng import seed_from
from die_e_tpu_torch.envs import backgammon as bg
from die_e_tpu_torch.scripts.strength_ladder import (
    TEMPERATURE,
    arena_config,
    model_player,
    rung_player,
)


def parse_models(spec: str) -> dict[str, str]:
    out = {}
    for item in spec.split(","):
        if not item.strip():
            continue
        name, _, path = item.partition("=")
        if not path:
            raise SystemExit(f"--models item {item!r} must be name=path")
        out[name.strip()] = path.strip()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", required=True, help="comma list of name=checkpoint_dir")
    ap.add_argument("--anchors", default="random,mcts100,mcts400",
                    help="comma list of random|mctsN rungs")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--sims", type=int, default=100, help="model PUCT sims per move")
    ap.add_argument("--round-limit", type=int, default=300)
    ap.add_argument("--rollout-limit", type=int, default=60,
                    help="pure-MCTS anchor playout depth cap")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--negamax", action="store_true")
    ap.add_argument("--skip-anchor-pairs", action="store_true",
                    help="only model-vs-model and model-vs-anchor pairs")
    ap.add_argument("--out", default="runs/bg_full/elo_matches.jsonl")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    model_paths = parse_models(args.models)
    # name -> (kind, pure-rollout iterations); models are loaded on first use
    players: dict[str, tuple[Agent, int | None]] = {
        name: (Agent.MODEL, None) for name in model_paths}
    for rung in args.anchors.split(","):
        rung = rung.strip()
        if rung:
            opponent, iters = rung_player(rung, "anchor")
            players[rung] = (opponent.kind, iters)
    loaded: dict[str, Player] = {}

    def player(name) -> Player:
        if name not in loaded:
            kind = players[name][0]
            loaded[name] = (model_player(model_paths[name], dev) if kind == Agent.MODEL
                            else Player(kind))
        return loaded[name]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    done_pairs = set()
    rows = []
    if out_path.exists():
        with open(out_path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    rows.append(rec)
                    done_pairs.add(frozenset((rec["player_a"], rec["player_b"])))

    mcts_cfg = arena_config(args.sims, args.round_limit, args.negamax)
    names = sorted(players)
    played = 0
    for a, b in itertools.combinations(names, 2):
        if frozenset((a, b)) in done_pairs:
            continue
        if args.skip_anchor_pairs and not (a in model_paths or b in model_paths):
            continue
        (kind_a, it_a), (kind_b, it_b) = players[a], players[b]
        if kind_a == Agent.MCTS and kind_b == Agent.MCTS and it_a != it_b:
            continue  # play() takes one pure-rollout budget a match
        mcts_iters = it_a if it_a is not None else it_b
        has_mcts = Agent.MCTS in (kind_a, kind_b)
        gen = torch.Generator(device=dev).manual_seed(seed_from(args.seed, played))
        played += 1
        t0 = time.perf_counter()
        res = play(
            bg.ENV, player(a), player(b), gen, mcts_cfg, temperature=TEMPERATURE,
            num_games=args.games, round_limit=args.round_limit,
            mcts_iterations=mcts_iters,
            mcts_rollout_limit=args.rollout_limit if has_mcts else None,
        )
        rec = {
            "metric": "elo_match", "player_a": a, "player_b": b,
            "wins_a": res.wins_p1, "wins_b": res.wins_p2,
            "draws": res.draws, "games": args.games,
            "model_sims": args.sims, "round_limit": args.round_limit,
            "secs": round(time.perf_counter() - t0, 1),
        }
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    anchor = "random" if "random" in players else names[0]
    match_list = matches_from_records(rows)
    ratings = compute_elo(match_list, anchor=anchor)
    cis = bootstrap_elo(match_list, anchor=anchor, n_boot=300, seed=args.seed)
    summary = {"metric": "elo_ratings", "anchor": anchor,
               "ratings": {k: round(v, 1) for k, v in sorted(
                   ratings.items(), key=lambda kv: -kv[1])},
               "ci95": {k: [round(lo, 1), round(hi, 1)]
                        for k, (lo, hi) in sorted(cis.items(), key=lambda kv: -kv[1][0])}}
    print(json.dumps(summary), flush=True)
    with open(out_path.with_suffix(".ratings.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
