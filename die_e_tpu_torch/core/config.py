"""Config system: one flat TOML file parsed into three typed views.

The port's own copy of ``die_e_tpu/core/config.py`` (same TOML keys, same
typed views), so that the port imports nothing of the JAX package.

Mirrors the reference's `config` crate setup (reference src/main.rs:89-98) and
its three structs — MctsConfig (reference src/lib.rs:33-52), AlphaZeroConfig
(reference src/alphazero/alphazero.rs:24-45) and OptimizerParams
(reference src/alphazero/alphazero.rs:47-59) — with identical keys, plus a
TPU-specific mesh/topology section the reference has no analog for (its only
parallelism knob is --n-cpus sizing a rayon pool, reference src/main.rs:100-110).
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MctsConfig:
    """reference src/lib.rs:33-52; keys as in config-example.toml:10-15."""

    iterations: int = 100
    c: float = 2.0  # exploration_const
    simulate_round_limit: int = 400
    dirichlet_alpha: float = 0.3
    dirichlet_epsilon: float = 0.25
    # extension (not in the reference): score PUCT exploitation from the
    # perspective of the player to move instead of the reference's
    # cooperative uniform-value maximization (DIVERGENCES.md)
    negamax: bool = False


@dataclasses.dataclass(frozen=True)
class AlphaZeroConfig:
    """reference src/alphazero/alphazero.rs:24-45."""

    temperature: float = 1.25
    learn_iterations: int = 100
    self_play_iterations: int = 4
    num_epochs: int = 4
    training_batch_size: int = 256
    num_self_play_batches: int = 1024


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    """reference src/alphazero/alphazero.rs:47-59."""

    wd: float = 1e-4
    lr: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """TPU topology (no reference analog; replaces --n-cpus,
    reference src/main.rs:100-110).

    data axis shards the self-play game batch and training batch;
    model axis is kept in the sharding rules for a future larger net
    (the reference ResNet is small enough to replicate, SURVEY.md section 2
    row TP).
    """

    data: int = -1  # -1 = all available devices
    model: int = 1


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """Hardcoded in the reference: 400 games / 400-round draw limit
    (reference src/versus.rs:168-169), promote at >=0.55 winrate, keep best
    at <=0.45 (reference src/alphazero/alpha_versus.rs:74-77).

    ``gate_sequential`` (opt-in, DIVERGENCES.md): play the gate in
    ``gate_block`` game blocks and stop as soon as the fixed-``num_games``
    promote/keep decision is statistically determined (predictive
    curtailment at error ``gate_eps`` per stop) instead of always playing
    the full match — same thresholds, same decision in all but
    borderline-winrate gates, a fraction of the chip time."""

    num_games: int = 400
    round_limit: int = 400
    promote_threshold: float = 0.55
    keep_threshold: float = 0.45
    gate_sequential: bool = False
    gate_block: int = 100
    gate_eps: float = 0.02


@dataclasses.dataclass(frozen=True)
class Config:
    mcts: MctsConfig = MctsConfig()
    alphazero: AlphaZeroConfig = AlphaZeroConfig()
    optimizer: OptimizerParams = OptimizerParams()
    mesh: MeshConfig = MeshConfig()
    arena: ArenaConfig = ArenaConfig()


_KEYMAP = {
    # flat TOML key -> (section, field)
    "temperature": ("alphazero", "temperature"),
    "learn_iterations": ("alphazero", "learn_iterations"),
    "self_play_iterations": ("alphazero", "self_play_iterations"),
    "num_epochs": ("alphazero", "num_epochs"),
    "training_batch_size": ("alphazero", "training_batch_size"),
    "num_self_play_batches": ("alphazero", "num_self_play_batches"),
    "iterations": ("mcts", "iterations"),
    "exploration_const": ("mcts", "c"),
    "simulate_round_limit": ("mcts", "simulate_round_limit"),
    "dirichlet_alpha": ("mcts", "dirichlet_alpha"),
    "dirichlet_epsilon": ("mcts", "dirichlet_epsilon"),
    "negamax": ("mcts", "negamax"),
    "wd": ("optimizer", "wd"),
    "lr": ("optimizer", "lr"),
    "mesh_data": ("mesh", "data"),
    "mesh_model": ("mesh", "model"),
    "arena_num_games": ("arena", "num_games"),
    "arena_round_limit": ("arena", "round_limit"),
    "promote_threshold": ("arena", "promote_threshold"),
    "keep_threshold": ("arena", "keep_threshold"),
    "arena_gate_sequential": ("arena", "gate_sequential"),
    "arena_gate_block": ("arena", "gate_block"),
    "arena_gate_eps": ("arena", "gate_eps"),
}


def load_config(path: Optional[str] = None) -> Config:
    """Load the flat TOML config (default ./config, as in the reference,
    src/main.rs:92-98).  Missing file -> all defaults; unknown keys error."""
    if path is None:
        path = "./config"
        if not Path(path).exists():
            path = "./config.toml"
            if not Path(path).exists():
                return Config()
    raw = tomllib.loads(Path(path).read_text())
    sections: dict = {}
    for key, value in raw.items():
        if key not in _KEYMAP:
            raise KeyError(f"unknown config key {key!r} in {path}")
        section, field = _KEYMAP[key]
        sections.setdefault(section, {})[field] = value
    return Config(
        mcts=MctsConfig(**sections.get("mcts", {})),
        alphazero=AlphaZeroConfig(**sections.get("alphazero", {})),
        optimizer=OptimizerParams(**sections.get("optimizer", {})),
        mesh=MeshConfig(**sections.get("mesh", {})),
        arena=ArenaConfig(**sections.get("arena", {})),
    )
