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
