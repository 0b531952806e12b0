"""Batched tic-tac-toe: the port of ``die_e_tpu/envs/tictactoe.py``, the
small deterministic game the search tests run on every reachable
position."""

from __future__ import annotations

import dataclasses

import torch

from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.envs.base import Env, GameSpec

NUM_ACTIONS = 9
NOOP_ACTION = 9  # one-past-the-board "skip" slot

SPEC = GameSpec(
    name="tictactoe",
    num_actions=NUM_ACTIONS,
    obs_shape=(3, 3, 3),
    conv_output_size=9,
    n_filters=64,
    n_res_blocks=4,
    is_deterministic=True,
    noop_action=NOOP_ACTION,
    obs_int8=True,  # cell planes are {-1, 0, 1}
)

# rows, columns, diagonals
_WIN_LINES = (
    (0, 1, 2), (3, 4, 5), (6, 7, 8),
    (0, 3, 6), (1, 4, 7), (2, 5, 8),
    (0, 4, 8), (2, 4, 6),
)


@dataclasses.dataclass
class TttState:
    board: torch.Tensor   # [B, 9] int32 in {-1, 0, 1}
    player: torch.Tensor  # [B] int32, -1 starts


def init(seeds, device=None) -> TttState:
    dev = resolve_device(device)
    b = len(seeds)
    return TttState(
        board=torch.zeros((b, 9), dtype=torch.int32, device=dev),
        player=torch.full((b,), -1, dtype=torch.int32, device=dev),
    )


def step(state: TttState, action) -> TttState:
    """Place the mover's mark; the noop slot (9) skips the turn."""
    action = action.to(torch.int64)
    valid = action < 9
    a = action.clamp(0, 8)[:, None]
    cell = state.board.gather(1, a)[:, 0]
    new = torch.where(valid, state.player, cell)
    board = state.board.scatter(1, a, new[:, None])
    return TttState(board=board, player=-state.player)


def legal_mask(state: TttState) -> torch.Tensor:
    return state.board == 0


def winner(state: TttState) -> torch.Tensor:
    """-1/+1 winner; 0 = draw or ongoing."""
    lines = torch.tensor(_WIN_LINES, device=state.board.device)
    vals = state.board[:, lines]  # [B, 8, 3]
    line_won = (
        (vals[..., 0] != 0) & (vals[..., 0] == vals[..., 1])
        & (vals[..., 1] == vals[..., 2])
    )
    w = torch.where(line_won, vals[..., 0], 0).sum(-1)
    return torch.sign(w).to(torch.int32)


def is_draw(state: TttState) -> torch.Tensor:
    return (winner(state) == 0) & (state.board != 0).all(-1)


def done(state: TttState) -> torch.Tensor:
    return (winner(state) != 0) | (state.board != 0).all(-1)


def observe(state: TttState) -> torch.Tensor:
    """One-hot planes (==-1, ==0, ==1), NHWC [B, 3, 3, 3]."""
    b = state.board.reshape(-1, 3, 3)
    return torch.stack([b == -1, b == 0, b == 1], dim=-1).to(torch.float32)


def player_of(state: TttState) -> torch.Tensor:
    return state.player


ENV = Env(
    spec=SPEC,
    init=init,
    step=step,
    legal_mask=legal_mask,
    observe=observe,
    winner=winner,
    player=player_of,
    done=done,
)


def pretty_str(state: TttState, game: int = 0) -> str:
    """Game ``game`` of a batched state as three rows of x, o and ., the
    same string as the JAX package's ``pretty_str`` gives for that game."""
    sym = {0: ".", -1: "x", 1: "o"}
    b = state.board[game].tolist()
    return "\n".join("|".join(sym[v] for v in b[i * 3: i * 3 + 3]) for i in range(3))
