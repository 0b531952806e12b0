"""The backgammon learning demo (BASELINE config 4, scaled down): AlphaZero
self-play and training on one card, then the trained model against the
random agent; the port of ``scripts/bg_learning_demo.py``.

Learns for 4 iterations (1 self-play run of 256 games each, 48
simulations a move, round limit 160, negamax, 2 epochs at batch 256,
64-game gates of 160 rounds) with the full 256x19 net, then plays the
trained model (player 1, side -1) against ``random`` over 128 games of at
most 200 rounds at temperature 0.5 and prints the tally.  The keyword
arguments of :func:`main` cut the run (the defaults are the demo's own
settings).

Usage:

    python -m die_e_tpu_torch.scripts.bg_learning_demo [WORKDIR] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path
from typing import Optional

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
from die_e_tpu_torch.envs import backgammon as bg
from die_e_tpu_torch.scripts.ttt_learning_check import build_parser
from die_e_tpu_torch.train.learn import learn
from die_e_tpu_torch.train.learner import net_eval_fn


def main(argv=None, *, iterations: int = 48, games: int = 256, learn_iterations: int = 4,
         round_limit: Optional[int] = None) -> int:
    """``iterations``: simulations a move; ``games``: games a self-play
    run; ``learn_iterations``: the learn loop's; ``round_limit``: the
    self-play, gate and final arena's round limit (default 160, 160 and
    200)."""
    args = build_parser(__doc__.split("\n")[0], "bg_az_").parse_args(argv)
    dev = resolve_device(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="bg_az_"))
    config = Config(
        mcts=MctsConfig(iterations=iterations, simulate_round_limit=round_limit or 160,
                        negamax=True),
        alphazero=AlphaZeroConfig(
            temperature=1.25,
            learn_iterations=learn_iterations,
            self_play_iterations=1,
            num_epochs=2,
            training_batch_size=256,
            num_self_play_batches=games,
        ),
        optimizer=OptimizerParams(),
        arena=ArenaConfig(num_games=64, round_limit=round_limit or 160),
    )
    metrics = Metrics()
    state = learn(bg.ENV, config, seed=0, data_base=str(work / "data"),
                  models_base=str(work / "models"), metrics=metrics, device=dev)
    result = play(
        bg.ENV, Player(Agent.MODEL, net_eval_fn(state.net)), Player(Agent.RANDOM),
        torch.Generator(device=dev).manual_seed(321), config.mcts, temperature=0.5,
        num_games=128, round_limit=round_limit or 200, metrics=metrics,
    )
    print("--- model vs random ---")
    print(result, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
