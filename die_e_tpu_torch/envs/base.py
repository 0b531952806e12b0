"""Environment interface: a game as a bundle of batched tensor functions.

The port's own copy of ``die_e_tpu/envs/base.py``.  Where the JAX package
writes each function for one game and batches it with ``vmap``, the port
writes every function for a batch: a state is a dataclass of ``[B, ...]``
tensors, and ``init``/``step``/``legal_mask``/... take and return batches.
Per-game network hyperparameters live on :class:`GameSpec`, with the same
fields and values as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

State = Any  # a dataclass whose fields are [B, ...] tensors


def map_state(fn, *states: State) -> State:
    """Apply ``fn`` field by field across states of one dataclass type."""
    first = states[0]
    return dataclasses.replace(
        first,
        **{
            f.name: fn(*(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(first)
        },
    )


def batch_size(state: State) -> int:
    return getattr(state, dataclasses.fields(state)[0].name).shape[0]


def freeze_where(done, old_states: State, new_states: State) -> State:
    """Per-game select: keep ``old_states`` where ``done`` [B], else take
    ``new_states`` (the lockstep-batch freeze of finished games)."""

    def sel(old, new):
        mask = done.reshape(done.shape + (1,) * (old.dim() - 1))
        return torch.where(mask, old, new)

    return map_state(sel, old_states, new_states)


def compact_take(states: State, done, idx):
    """Re-pack a lockstep batch: rows ``idx`` [new_B] of every state field
    and of the done mask."""
    return map_state(lambda a: a.index_select(0, idx), states), done.index_select(0, idx)


def compaction_plan(done_h, min_batch: int):
    """The host half of batch compaction: from the done mask [B] (numpy
    bool), an int32 index array [new_B] that packs the live games first,
    padded with finished games (they step frozen), or None when the batch
    would not shrink.  new_B is the smallest ladder size >= max(live,
    min_batch) on the ladder {2^k} U {3*2^k} (..., 64, 96, 128, 192, 256,
    384, ...); the 3*2^k rungs roughly halve a power-of-two ladder's
    padding of finished games."""
    b = len(done_h)
    live_idx = np.nonzero(~done_h)[0]
    live = max(int(live_idx.size), 1, min_batch)
    pow2 = 1 << (live - 1).bit_length()          # smallest 2^k >= live
    new_b = pow2 if live > 3 * pow2 // 4 else 3 * pow2 // 4
    if new_b >= b:
        return None
    fill = np.nonzero(done_h)[0][: new_b - live_idx.size]
    return np.concatenate([live_idx, fill]).astype(np.int32)


class CompactionTracker:
    """Per-original-game done and winner bookkeeping for a round loop that
    re-packs live games (:func:`compaction_plan` + :func:`compact_take`).

    A compacted batch holds only the games it kept, so a finished game's
    winner must be merged before a compaction can drop it:

    * ``merge(done_h, winner_h, gmap)`` folds a done mask and winners,
      given in the game mapping ``gmap`` (default: the current mapping
      ``orig``), into the accumulators;
    * ``take(idx)`` applies a compaction plan to the mapping (the caller
      applies the same ``idx`` to its batch with ``compact_take``);
    * ``current_done()`` is the accumulated done mask in the current
      mapping;
    * ``final_winner()`` is the accumulated winner of each original game,
      0 where it never finished (a draw at the round limit).
    """

    def __init__(self, num_games: int):
        self.orig = np.arange(num_games)
        self._done = np.zeros(num_games, bool)
        self._winner = np.zeros(num_games, np.int32)

    def merge(self, done_h, winner_h, gmap=None) -> None:
        gmap = self.orig if gmap is None else gmap
        self._done[gmap] |= done_h
        fin = np.nonzero(done_h)[0]
        self._winner[gmap[fin]] = winner_h[fin]

    def take(self, idx) -> None:
        self.orig = self.orig[idx]

    def current_done(self):
        return self._done[self.orig]

    def final_winner(self):
        return np.where(self._done, self._winner, 0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class GameSpec:
    """Static per-game constants.  obs shape is NHWC, as in the JAX
    package, so observations compare directly."""

    name: str
    num_actions: int          # ACTION_SPACE_SIZE
    obs_shape: Tuple[int, int, int]  # (H, W, C); C == N_INPUT_CHANNELS
    conv_output_size: int     # CONV_OUTPUT_SIZE (flattened H*W)
    n_filters: int            # N_FILTERS
    n_res_blocks: int         # N_RES_BLOCKS
    is_deterministic: bool    # IS_DETERMINISTIC
    noop_action: int          # encode(EMPTY_MOVE)
    obs_int8: bool = False    # observations are small exact integers


@dataclasses.dataclass(frozen=True)
class Env:
    """A game as a bundle of batched functions.

    * ``init(seeds [B], device) -> state``
    * ``step(state, action [B]) -> state``
    * ``legal_mask(state) -> [B, A] bool``
    * ``observe(state) -> [B, H, W, C] float32``
    * ``winner(state) -> [B] int32`` (0 = no winner yet)
    * ``done(state) -> [B] bool``
    * ``player(state) -> [B] int32`` (-1 or +1)
    """

    spec: GameSpec
    init: Callable[..., State]
    step: Callable[[State, torch.Tensor], State]
    legal_mask: Callable[[State], torch.Tensor]
    observe: Callable[[State], torch.Tensor]
    winner: Callable[[State], torch.Tensor]
    player: Callable[[State], torch.Tensor]
    done: Callable[[State], torch.Tensor] = None  # defaults to winner != 0

    def __post_init__(self):
        if self.done is None:
            w = self.winner
            object.__setattr__(self, "done", lambda s: w(s) != 0)
