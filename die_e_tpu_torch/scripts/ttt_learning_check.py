"""The tic-tac-toe exit check (BASELINE config 2): the AlphaZero learn
loop must reach > 95% non-loss against the random agent; the port of
``scripts/ttt_learning_check.py``.

Learns for 24 iterations (2 self-play runs of 256 games each, 64
simulations a move, negamax, 2 epochs at batch 256, a 128-game gate),
then plays the trained model (player 1, side -1) against ``random`` over
400 games at temperature 0.25.  Non-loss is wins plus draws.  Exits 0 iff
the non-loss rate is above 0.95.  The keyword arguments of :func:`main`
cut the run (the defaults are the check's own settings).

Usage:

    python -m die_e_tpu_torch.scripts.ttt_learning_check [WORKDIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

from die_e_tpu_torch.arena.versus import Agent, Player, play
from die_e_tpu_torch.core.config import (
    AlphaZeroConfig,
    ArenaConfig,
    Config,
    MctsConfig,
    OptimizerParams,
)
from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.core.metrics import Metrics
from die_e_tpu_torch.envs import tictactoe as ttt
from die_e_tpu_torch.train.learn import learn
from die_e_tpu_torch.train.learner import net_eval_fn

TARGET = 0.95


def build_parser(description: str, prefix: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("workdir", nargs="?", default=None,
                    help=f"where data/ and models/ go (default: a fresh {prefix}* temp dir)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None, *, iterations: int = 64, games: int = 256, learn_iterations: int = 24,
         self_play_iterations: int = 2) -> int:
    """``iterations``: simulations a move; ``games``: games a self-play
    run; ``learn_iterations`` and ``self_play_iterations``: the learn
    loop's."""
    args = build_parser(__doc__.split("\n")[0], "ttt_az_").parse_args(argv)
    dev = resolve_device(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="ttt_az_"))
    config = Config(
        mcts=MctsConfig(iterations=iterations, simulate_round_limit=9, negamax=True),
        alphazero=AlphaZeroConfig(
            temperature=1.25,
            learn_iterations=learn_iterations,
            self_play_iterations=self_play_iterations,
            num_epochs=2,
            training_batch_size=256,
            num_self_play_batches=games,
        ),
        optimizer=OptimizerParams(),
        arena=ArenaConfig(num_games=128, round_limit=9),
    )
    metrics = Metrics()
    state = learn(ttt.ENV, config, seed=0, data_base=str(work / "data"),
                  models_base=str(work / "models"), metrics=metrics, device=dev)
    result = play(
        ttt.ENV, Player(Agent.MODEL, net_eval_fn(state.net)), Player(Agent.RANDOM),
        torch.Generator(device=dev).manual_seed(123), config.mcts, temperature=0.25,
        num_games=400, round_limit=9, metrics=metrics,
    )
    non_loss = (result.wins_p1 + result.draws) / result.n_games
    print(result)
    print(f"NON-LOSS RATE vs random: {non_loss:.3f} (target > {TARGET})", flush=True)
    return 0 if non_loss > TARGET else 1


if __name__ == "__main__":
    sys.exit(main())
