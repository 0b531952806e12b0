"""Batched backgammon: the port of ``die_e_tpu/envs/backgammon.py``.

Same semantics, bit for bit: the same action codec (1352 actions, noop
1351), the same counter-based dice stream, the same three-stage legal mask
(single-move tables -> raw legality and exact resulting-state signatures ->
duplicate-state removal).  The JAX package writes each function for one
game and ``vmap``s it; here every function takes a batch, and the board
reads that the JAX package writes as one-hot reductions (a TPU cost cliff)
are plain ``gather``s.

Integer work is int64 inside the functions; the state keeps the JAX
package's int32 fields.  The dice seed is an int64 tensor holding the
uint32 value, because torch implements neither ``>>`` nor ``%`` for uint32
on the CPU: the uint32 arithmetic of the dice stream is done in int64 and
masked with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.envs.base import Env, GameSpec

NUM_ACTIONS = 1352
NOOP_ACTION = 1351  # encode(empty move)

# Static per-action index tables.  Action layout: id = f1 + 26*f2 (+676 if
# the low roll plays first); digit 24 = bar, second digit 25 = no second
# move.
_ACT = np.arange(NUM_ACTIONS, dtype=np.int64)
_HRF = _ACT < 676                      # high-roll-first block
_BASE = np.where(_HRF, _ACT, _ACT - 676)
_F1D = _BASE % 26                      # first-move from digit
_F2D = _BASE // 26                     # second-move from digit (25 = none)
_SINGLE = _F2D == 25
_DSEL = np.where(_HRF, 0, 1)           # die-attribution index
_F1M = np.where(_F1D == 24, -1, _F1D)
_F2M = np.where(_F2D == 24, -1, _F2D)

SPEC = GameSpec(
    name="backgammon",
    num_actions=NUM_ACTIONS,
    obs_shape=(4, 6, 6),
    conv_output_size=24,
    n_filters=256,
    n_res_blocks=19,
    is_deterministic=False,
    noop_action=NOOP_ACTION,
    obs_int8=True,
)

# Initial board.  Negative = player -1.
INITIAL_BOARD = (
    2, 0, 0, 0, 0, -5, 0, -3, 0, 0, 0, 5,
    -5, 0, 0, 0, 3, 0, 5, 0, 0, 0, 0, -2,
)

_U32 = 0xFFFFFFFF
_POW32 = (1, 32, 32 ** 2, 32 ** 3, 32 ** 4, 32 ** 5)  # signature packing


@dataclasses.dataclass
class BgState:
    """Batched backgammon state; the fields of the JAX ``BgState`` with a
    leading batch axis.

    board: [B, 24] int32 signed piece counts
    bar:   [B, 2] int32, bar[:, 0] = player -1's hit pieces
    off:   [B, 2] int32 borne-off counts
    roll:  [B, 2] int32 current dice (1..6)
    player: [B] int32 in {-1, +1}
    second: [B] bool, doubles second-play flag
    seed:  [B] int64 holding the uint32 dice-stream seed
    cnt:   [B] int32 dice stream cursor
    """

    board: torch.Tensor
    bar: torch.Tensor
    off: torch.Tensor
    roll: torch.Tensor
    player: torch.Tensor
    second: torch.Tensor
    seed: torch.Tensor
    cnt: torch.Tensor


@functools.cache
def _consts(device: torch.device) -> dict:
    """The static tables as tensors on ``device``, copied there once."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    return dict(
        act=t(_ACT), f1d=t(_F1D), f2d=t(_F2D), single=t(_SINGLE),
        dsel=t(_DSEL), f1m=t(_F1M), f2m=t(_F2M), pow32=t(_POW32),
        initial_board=t(INITIAL_BOARD).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Dice stream
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x):
    """murmur3 fmix32 finalizer on uint32 values held in int64."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def dice_from_stream(seed, cnt, salt) -> torch.Tensor:
    """[B, 2] int32 dice for (seed, cursor, salt), each [B]; the JAX
    package's counter-based stream, bit for bit.  Signed inputs are taken
    modulo 2**32, as the JAX package's ``astype(uint32)`` takes them."""
    seed, cnt, salt = (v.to(torch.int64) & _U32 for v in (seed, cnt, salt))
    base = _mix32(
        seed
        ^ _mix32(_mul32(cnt, 0x9E3779B9))
        ^ _mix32(_mul32(salt, 0x7F4A7C15))
    )
    d0 = base % 6 + 1
    d1 = _mix32(base ^ 0xDEADBEEF) % 6 + 1
    return torch.stack([d0, d1], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def init(seeds, device=None) -> BgState:
    """Fresh games with their first roll, one per uint32 seed in ``seeds``."""
    dev = resolve_device(device)
    seed = torch.as_tensor(seeds, device=dev).to(torch.int64) & _U32
    b = seed.shape[0]
    zeros = torch.zeros_like(seed)
    return BgState(
        board=_consts(dev)["initial_board"].expand(b, 24).clone(),
        bar=torch.zeros((b, 2), dtype=torch.int32, device=dev),
        off=torch.zeros((b, 2), dtype=torch.int32, device=dev),
        roll=dice_from_stream(seed, zeros, zeros),
        player=torch.full((b,), -1, dtype=torch.int32, device=dev),
        second=torch.zeros((b,), dtype=torch.bool, device=dev),
        seed=seed,
        cnt=torch.ones((b,), dtype=torch.int32, device=dev),
    )


def make_state(board, bar, off, roll, player, second=False, seed=0, cnt=1,
               device=None) -> BgState:
    """Batched positions from array-likes with a leading batch axis."""
    dev = resolve_device(device)
    i32 = lambda v: torch.as_tensor(np.asarray(v), device=dev).to(torch.int32)  # noqa: E731
    board = i32(board)
    b = board.shape[0]
    full = lambda v, dt: torch.as_tensor(np.broadcast_to(v, (b,)).copy(), device=dev).to(dt)  # noqa: E731
    return BgState(
        board=board, bar=i32(bar), off=i32(off), roll=i32(roll),
        player=full(player, torch.int32),
        second=full(second, torch.bool),
        seed=full(seed, torch.int64) & _U32,
        cnt=full(cnt, torch.int32),
    )


# ---------------------------------------------------------------------------
# Action codec
# ---------------------------------------------------------------------------


def _to_of(f, die, player):
    """Destination of a sub-move from digit ``f`` (0..23 board, 24 bar) with
    ``die`` for ``player``; -1 = bear-off.  Broadcasts."""
    f_conv = torch.where((f == 24) & (player == 1), -1, f)
    t = f_conv + die * player
    return torch.where((t >= 24) | (t <= -1), -1, t)


def decode_action(action, roll, player):
    """action [B] -> (f1, t1, f2, t2, single, noop, die1, die2), each [B].

    f values use -1 for the bar; f2 is meaningless when ``single``."""
    action = action.to(torch.int64)
    roll = roll.to(torch.int64)
    player = player.to(torch.int64)
    high = torch.maximum(roll[:, 0], roll[:, 1])
    low = torch.minimum(roll[:, 0], roll[:, 1])
    hrf = action < 676
    base = torch.where(hrf, action, action - 676)
    f1d = base % 26
    f2d = base // 26
    single = f2d == 25
    noop = action == NOOP_ACTION
    die1 = torch.where(hrf, high, low)
    die2 = torch.where(hrf, low, high)
    t1 = _to_of(f1d, die1, player)
    t2 = _to_of(f2d, die2, player)
    f1 = torch.where(f1d == 24, -1, f1d)
    f2 = torch.where(f2d == 24, -1, f2d)
    return f1, t1, f2, t2, single, noop, die1, die2


def _min_roll(f, t):
    """Minimum die value able to play sub-move (f, t)."""
    mr_bar = torch.where(t < 6, t + 1, 24 - t)
    mr_coll = torch.where(f < 6, f + 1, 24 - f)
    mr_norm = (f - t).abs()
    return torch.where(f < 0, mr_bar, torch.where(t < 0, mr_coll, mr_norm))


def encode_move(f1, t1, f2, t2, single, roll):
    """Move sequence -> canonical action index (broadcasting against
    ``low`` = the smaller die, shaped like ``roll[..., 0]``).  ``single``
    selects a 1-move sequence; the empty sequence is NOOP_ACTION and
    handled by callers."""
    low = torch.minimum(roll[..., 0], roll[..., 1])
    min1 = _min_roll(f1, t1)
    min2 = torch.where(single, 0, _min_roll(f2, t2))
    is_coll1 = (t1 < 0) & (f1 >= 0)
    is_coll2 = (t2 < 0) & (f2 >= 0)
    flag1 = (~is_coll1) & (min1 == low) & (~single)
    flag2 = (~single) & (~is_coll2) & (min2 == low)
    hrf = torch.where(
        flag1,
        False,
        torch.where(flag2, True,
                    torch.where(min2 != 0, min1 >= min2, min1 > low)),
    )
    digit1 = torch.where(f1 < 0, 24, f1)
    digit2 = torch.where(single, 25, torch.where(f2 < 0, 24, f2))
    enc = digit1 + 26 * digit2
    return torch.where(hrf, enc, enc + 676)


# ---------------------------------------------------------------------------
# Board transition
# ---------------------------------------------------------------------------


def _cell(board, idx):
    """board[..., idx] for idx in [0, 24); 0 outside, as the JAX package's
    one-hot reduction gives."""
    ok = (idx >= 0) & (idx < 24)
    v = board.gather(-1, idx.clamp(0, 23).unsqueeze(-1)).squeeze(-1)
    return torch.where(ok, v, 0)


def apply_submove(board, bar, off, player, frm, to, valid):
    """Apply one sub-move (frm -> to) where ``valid``; int64 [M, 24] board,
    [M, 2] bar/off, [M] player/frm/to/valid.

    frm == -1 means entry from the bar, to == -1 means bear-off; hitting a
    lone opposing checker sends it to the opponent's bar."""
    own = (player + 1) // 2
    opp = 1 - own
    is_collect = (to < 0) & (frm >= 0)
    is_entry = frm < 0
    toc = to.clamp(0, 23)
    frmc = frm.clamp(0, 23)
    cells = torch.arange(24, device=board.device)
    oh_to = cells == toc[:, None]
    oh_frm = cells == frmc[:, None]
    b_to = board.gather(1, toc[:, None])[:, 0]
    hit = valid & (~is_collect) & (b_to == -player)
    write_to = valid & (~is_collect)
    new_to = torch.where(hit, player, b_to + player)
    board = torch.where(oh_to & write_to[:, None], new_to[:, None], board)
    board = board - torch.where(
        oh_frm & (valid & ~is_entry)[:, None], player[:, None], 0)
    sides = torch.arange(2, device=board.device)
    bar = bar - ((sides == own[:, None]) & (valid & is_entry)[:, None]).long()
    bar = bar + ((sides == opp[:, None]) & hit[:, None]).long()
    off = off + ((sides == own[:, None]) & (valid & is_collect)[:, None]).long()
    return board, bar, off


# ---------------------------------------------------------------------------
# Single-move legality
# ---------------------------------------------------------------------------


def _is_collectible(board, bar, player):
    """All checkers in the home board and none on the bar; [M]."""
    own = (player + 1) // 2
    idx = torch.arange(24, device=board.device)
    neg_outside = (torch.where(idx >= 6, board, 0) < 0).any(-1)
    pos_outside = (torch.where(idx < 18, board, 0) > 0).any(-1)
    blocked = torch.where(player < 0, neg_outside, pos_outside)
    bar_own = bar.gather(1, own[:, None])[:, 0]
    return (bar_own == 0) & (~blocked)


def legal_single(board, bar, player, die, f):
    """Is the sub-move from digit ``f`` (0..23 board, 24 bar, 25 absent ->
    False) with ``die`` legal?  The port of the JAX ``legal_single``, the
    scalar oracle that :func:`legal_digits` is held against: the push
    conditions of the reference's entry, normal and bear-off move
    generators, one digit at a time.  int64 board ``[..., 24]`` and bar
    ``[..., 2]``; ``player``, ``die`` and ``f`` broadcast against their
    batch shape ``[...]``, which the result has.  Nothing on the main path
    calls it."""
    shape = torch.broadcast_shapes(board.shape[:-1], bar.shape[:-1], player.shape,
                                   die.shape, f.shape)
    board, bar = board.expand(*shape, 24).reshape(-1, 24), bar.expand(*shape, 2).reshape(-1, 2)
    player, die, f = (t.expand(shape).reshape(-1) for t in (player, die, f))
    dev = board.device
    own = (player + 1) // 2
    has_bar = bar.gather(1, own[:, None])[:, 0] > 0

    # --- entry from the bar
    e = torch.where(player < 0, 24 - die, die - 1)
    b_e = _cell(board, e)
    entry_open = torch.where(player < 0, b_e < 2, b_e > -2)
    legal_entry = has_bar & (f == 24) & entry_open

    on_board = (f >= 0) & (f <= 23)
    fc = f.clamp(0, 23)
    t_raw = fc + die * player
    in_range = (t_raw >= 0) & (t_raw <= 23)
    b_fc = _cell(board, fc)
    b_tc = _cell(board, t_raw.clamp(0, 23))
    own_piece = torch.where(player < 0, b_fc <= -1, b_fc >= 1)
    dest_open = torch.where(player < 0, b_tc <= 1, b_tc >= -1)

    # --- normal move
    legal_normal = (~has_bar) & on_board & in_range & own_piece & dest_open

    # --- bear-off
    collectible = _is_collectible(board, bar, player)
    exact = torch.where(player < 0, t_raw == -1, t_raw == 24) & own_piece
    idx = torch.arange(24, device=dev)
    # player -1: highest j < die-1 with board[j] < 0 and sum(board[j+1..6]) >= 0
    suff = torch.where(idx < 6, board, 0).flip(-1).cumsum(-1).flip(-1)  # sum board[j:6]
    suff_next = torch.cat([suff[:, 1:6], torch.zeros_like(suff[:, :1])], -1)
    cond_neg = (board[:, :6] < 0) & (suff_next >= 0)
    j6 = torch.arange(6, device=dev)
    hc = torch.where(cond_neg & (j6 < (die - 1)[:, None]), j6, -1).amax(-1)
    # player +1: lowest j >= 24-die with board[j] > 0 and sum(board[18..j-1]) <= 0
    pre = torch.where(idx >= 18, board, 0).cumsum(-1)  # sum board[18:j+1]
    pre_before = torch.cat([torch.zeros_like(pre[:, :1]), pre[:, :23]], -1)
    j18 = torch.arange(18, 24, device=dev)
    cond_pos = (board[:, 18:] > 0) & (pre_before[:, 18:] <= 0)
    lc = torch.where(cond_pos & (j18 >= (24 - die)[:, None]), j18, 99).amin(-1)
    higher = torch.where(player < 0, fc == hc, fc == lc)

    legal_collect = (~has_bar) & on_board & (~in_range) & collectible & (exact | higher)
    return (legal_entry | legal_normal | legal_collect).reshape(shape)


def legal_digits(board, bar, player, die):
    """[M, 26] bool: is the sub-move from each digit (0..23 board, 24 bar,
    25 absent -> False) with ``die`` legal?  int64 [M, 24] board, [M, 2]
    bar, [M] player and die.  The JAX ``legal_digits``, batched."""
    dev = board.device
    m = board.shape[0]
    own = (player + 1) // 2
    has_bar = bar.gather(1, own[:, None])[:, 0] > 0
    neg = (player < 0)[:, None]

    # --- entry digit (24)
    e = torch.where(player < 0, 24 - die, die - 1)
    b_e = _cell(board, e)
    legal_entry = has_bar & torch.where(player < 0, b_e < 2, b_e > -2)

    f = torch.arange(24, device=dev)
    own_piece = torch.where(neg, board <= -1, board >= 1)
    open_tab = torch.where(neg, board <= 1, board >= -1)
    t_raw = f + (die * player)[:, None]
    in_range = (t_raw >= 0) & (t_raw <= 23)
    dest_open = in_range & open_tab.gather(1, t_raw.clamp(0, 23))
    legal_normal = (~has_bar)[:, None] & in_range & own_piece & dest_open

    # --- bear-off (per-state boundary checkers hc/lc)
    collectible = _is_collectible(board, bar, player)
    exact = torch.where(neg, t_raw == -1, t_raw == 24) & own_piece
    home = board[:, :6]
    suff = home.flip(-1).cumsum(-1).flip(-1)  # suff[j] = sum board[j:6]
    suff_next = torch.cat([suff[:, 1:], torch.zeros_like(suff[:, :1])], -1)
    cond_neg = (home < 0) & (suff_next >= 0)
    j6 = torch.arange(6, device=dev)
    hc = torch.where(cond_neg & (j6 < (die - 1)[:, None]), j6, -1).amax(-1)
    top = board[:, 18:]
    pre_before = top.cumsum(-1) - top  # sum board[18:j]
    cond_pos = (top > 0) & (pre_before <= 0)
    j18 = torch.arange(18, 24, device=dev)
    lc = torch.where(cond_pos & (j18 >= (24 - die)[:, None]), j18, 99).amin(-1)
    higher = torch.where(neg, f == hc[:, None], f == lc[:, None])
    legal_collect = (
        (~has_bar)[:, None] & (~in_range) & collectible[:, None]
        & (exact | higher)
    )
    return torch.cat([
        legal_normal | legal_collect,
        legal_entry[:, None],
        torch.zeros((m, 1), dtype=torch.bool, device=dev),
    ], dim=-1)


# ---------------------------------------------------------------------------
# Legal-action mask
# ---------------------------------------------------------------------------

def _pack_signature(board, bar, off):
    """[..., 5] exact packed state signature (each key < 2**30)."""
    shifts = _consts(board.device)["pow32"]
    cells = (board + 15).reshape(board.shape[:-1] + (4, 6))
    k = (cells * shifts).sum(-1)  # [..., 4]
    k4 = bar[..., 0] + 16 * bar[..., 1] + 256 * off[..., 0] + 4096 * off[..., 1]
    return torch.cat([k, k4[..., None]], -1)


def _as_i64(state: BgState):
    return (state.board.long(), state.bar.long(), state.off.long(),
            state.roll.long(), state.player.long())


def _mask_tables(state: BgState) -> dict:
    """Stage 1: the [B, 2(die order), 26(digit)] first-move tables, the 52
    intermediate states after each candidate first move, and the
    [B, 2, 26, 26] second-move table."""
    board, bar, off, roll, player = _as_i64(state)
    b = board.shape[0]
    dev = board.device
    high = torch.maximum(roll[:, 0], roll[:, 1])
    low = torch.minimum(roll[:, 0], roll[:, 1])
    # attribution axis: 0 = high die first (action < 676), 1 = low first
    d_first = torch.stack([high, low], -1)   # [B, 2]
    d_second = torch.stack([low, high], -1)
    f_axis = torch.arange(26, device=dev)
    p3 = player[:, None, None]

    def rep(x, k):
        return x.repeat_interleave(k, dim=0)

    legal1 = legal_digits(rep(board, 2), rep(bar, 2), rep(player, 2),
                          d_first.reshape(-1)).reshape(b, 2, 26)
    t1_tab = _to_of(f_axis, d_first[:, :, None], p3)  # [B, 2, 26]

    # intermediate states after the first move [B, 2, 26, ...]
    fm = torch.where(f_axis == 24, -1, f_axis).expand(b, 2, 26)
    ok = legal1 & (f_axis <= 24)
    s1_board, s1_bar, s1_off = apply_submove(
        rep(board, 52), rep(bar, 52), rep(off, 52), rep(player, 52),
        fm.reshape(-1), t1_tab.reshape(-1), ok.reshape(-1),
    )
    s1_board = s1_board.reshape(b, 2, 26, 24)
    s1_bar = s1_bar.reshape(b, 2, 26, 2)
    s1_off = s1_off.reshape(b, 2, 26, 2)

    legal2 = legal_digits(
        s1_board.reshape(-1, 24), s1_bar.reshape(-1, 2), rep(player, 52),
        d_second[:, :, None].expand(b, 2, 26).reshape(-1),
    ).reshape(b, 2, 26, 26)
    t2_tab = _to_of(f_axis, d_second[:, :, None], p3)
    any2 = legal2.any(-1)  # [B, 2, 26]
    return dict(
        legal1=legal1, t1_tab=t1_tab, s1_board=s1_board, s1_bar=s1_bar,
        s1_off=s1_off, legal2=legal2, t2_tab=t2_tab, any2=any2,
        d_first=d_first, d_second=d_second, high=high, low=low,
    )


def _mask_raw(state: BgState, tb: dict):
    """Stage 2: per-action raw legality + exact resulting-state signature.
    Returns (raw [B, 1352] bool, keys [B, 1352, 5], prio [B, 1352])."""
    _, _, _, roll, player = _as_i64(state)
    k = _consts(roll.device)
    legal1, legal2 = tb["legal1"], tb["legal2"]
    t1_tab, t2_tab, any2 = tb["t1_tab"], tb["t2_tab"], tb["any2"]
    s1_board = tb["s1_board"]
    high, low = tb["high"], tb["low"]
    f1d, f2d, dsel, single = k["f1d"], k["f2d"], k["dsel"], k["single"]
    f1m, f2m, actions = k["f1m"], k["f2m"], k["act"]
    pl = player[:, None]

    t1 = t1_tab[:, dsel, f1d]  # [B, 1352]
    t2 = t2_tab[:, dsel, f2d]

    # canonical-encoding filter: action must be encode(decode(action))
    enc = encode_move(f1m, t1, f2m, t2, single, roll[:, None, :])
    canonical = enc == actions

    # tree legality under either die attribution
    def ok_att(d):
        first = legal1[:, d, f1d] & (t1_tab[:, d, f1d] == t1)
        two = legal2[:, d, f1d, f2d] & (t2_tab[:, d, f2d] == t2)
        return first & torch.where(single, ~any2[:, d, f1d], two)

    ok_high_first = ok_att(0)
    ok_low_first = ok_att(1)
    raw = (canonical & (ok_high_first | ok_low_first) & (f1d != 25)
           & (actions != NOOP_ACTION))

    # earliest tree position: the low-die attribution comes first
    die_eff = torch.where(ok_low_first, low[:, None], high[:, None])
    prio = (
        (die_eff << 20)
        | ((f1m + 1) << 15)
        | ((t1 + 1) << 10)
        | torch.where(single, 0, ((f2m + 1) << 5) | (t2 + 1))
    )

    # resulting-state signature per action: pack the 52 one-move states
    # and add the second sub-move's contribution (the packing is linear)
    sig1 = _pack_signature(s1_board, tb["s1_bar"], tb["s1_off"])  # [B,2,26,5]
    sig_lo = ok_low_first
    base_keys = torch.where(sig_lo[..., None], sig1[:, 1, f1d], sig1[:, 0, f1d])
    own = (pl + 1) // 2
    opp = 1 - own
    is_collect2 = (t2 < 0) & (f2m >= 0)
    is_entry2 = f2m < 0
    toc = t2.clamp(0, 23)
    frmc = f2m.clamp(0, 23)
    # V[b, d, f1, f2] = s1_board[b, d, f1, clip(t2_tab[b, d, f2])]
    b = s1_board.shape[0]
    t2_clip = t2_tab.clamp(0, 23)[:, :, None, :].expand(b, 2, 26, 26)
    V = s1_board.gather(3, t2_clip)
    v_to = torch.where(sig_lo, V[:, 1, f1d, f2d], V[:, 0, f1d, f2d])
    hit2 = (~is_collect2) & (v_to == -pl)
    change_to = torch.where(
        ~is_collect2, torch.where(hit2, pl - v_to, pl), 0)
    change_frm = torch.where(~is_entry2, -pl, 0)
    pow32 = k["pow32"]
    rows = torch.arange(4, device=roll.device)[:, None, None]
    dk_rows = (
        (toc // 6 == rows) * (change_to * pow32[toc % 6])
        + (frmc // 6 == rows) * (change_frm * pow32[frmc % 6])
    ).permute(1, 2, 0)  # [B, 1352, 4]
    bar_own_coef = torch.where(own == 0, 1, 16)
    bar_opp_coef = torch.where(opp == 0, 1, 16)
    off_own_coef = torch.where(own == 0, 256, 4096)
    dk4 = (
        -is_entry2.long() * bar_own_coef
        + hit2.long() * bar_opp_coef
        + is_collect2.long() * off_own_coef
    )
    delta = torch.cat([dk_rows, dk4[..., None]], -1)  # [B, 1352, 5]
    keys = base_keys + torch.where(single[:, None], 0, delta)
    return raw, keys, prio


def _mask_dedup(state: BgState, tb: dict, raw, keys, prio):
    """Stage 3: exact duplicate-resulting-state removal over the raw mask.
    Returns the final [B, 1352] mask WITHOUT the no-op bit.

    Two raw actions reach the same state only if they are transpositions of
    one sub-move pair, or members of one chain class (f -> m -> t under the
    two die orders, and the overshooting single bear-off); signature
    equality is the final arbiter.  Works on the [B, 2(block), 26(f2
    digit), 26(f1 digit)] grid the action axis reshapes to."""
    player = state.player.long()
    b = player.shape[0]
    d_first, d_second = tb["d_first"], tb["d_second"]
    props = torch.cat([keys, prio[..., None], raw[..., None].long()], -1)
    pm = props.reshape(b, 2, 26, 26, 7)  # [B, block, f2 digit, f1 digit, prop]
    keys_g = pm[..., :5]
    prio_g = pm[..., 5]
    raw_g = pm[..., 6] > 0

    digit_axis = torch.arange(26, device=player.device)
    p3 = player[:, None, None]
    # intermediate cell digit reached from digit f with a given die
    m1 = _to_of(digit_axis, d_first[:, :, None], p3)   # [B, 2, 26]
    m2 = _to_of(digit_axis, d_second[:, :, None], p3)

    def diag_f2(mtab):
        # D[b, k, f, :] = pm[b, k, mtab[b, k, f], f, :]; 0 where mtab < 0
        idx = mtab.clamp(min=0)[:, :, None, :, None].expand(b, 2, 1, 26, 7)
        d = pm.gather(2, idx)[:, :, 0]
        return torch.where((mtab >= 0)[..., None], d, 0)

    def diag_f1(mtab):
        # D[b, k, f, :] = pm[b, k, f, mtab[b, k, f], :]; 0 where mtab < 0
        idx = mtab.clamp(min=0)[:, :, :, None, None].expand(b, 2, 26, 1, 7)
        d = pm.gather(3, idx)[:, :, :, 0]
        return torch.where((mtab >= 0)[..., None], d, 0)

    e_fm = diag_f2(m1)             # partner (f1=f, f2=m1[f])
    e_mf = diag_f1(m2)             # partner (f1=m2[f], f2=f)
    e_single = pm[:, :, 25]        # partner (f1=f, no second move)

    def beats(pp):
        """partner is raw-legal, reaches the same state, and precedes in
        tree order; pp broadcasts against [B, 2, 26, 26, 7]."""
        same = (pp[..., :5] == keys_g).all(-1)
        return (pp[..., 6] > 0) & same & (pp[..., 5] < prio_g)

    pt = pm.transpose(2, 3)  # digit swap
    dup = torch.zeros_like(raw_g)
    for k in range(2):
        dup |= beats(pt[:, k, None])
        for e in (e_fm, e_mf, e_single):
            dup |= beats(e[:, k, None, None, :, :])
            dup |= beats(e[:, k, None, :, None, :])
    return (raw_g & ~dup).reshape(b, NUM_ACTIONS)


def legal_mask(state: BgState) -> torch.Tensor:
    """[B, 1352] bool legal-action mask, equal to the JAX package's:
    {encode(m) for m in get_valid_moves()} plus the no-op action when (and
    only when) no move is legal."""
    tb = _mask_tables(state)
    raw, keys, prio = _mask_raw(state, tb)
    mask = _mask_dedup(state, tb, raw, keys, prio)
    mask[:, NOOP_ACTION] = ~mask.any(-1)
    return mask


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def step(state: BgState, action) -> BgState:
    """Apply encoded actions [B] (NOOP_ACTION = skip turn) and advance the
    turn/dice state.  Doubles are played as two consecutive plies via the
    ``second`` flag."""
    board, bar, off, roll, player = _as_i64(state)
    action = action.to(torch.int64)
    f1, t1, f2, t2, single, noop, _, _ = decode_action(action, roll, player)
    board, bar, off = apply_submove(board, bar, off, player, f1, t1, ~noop)
    board, bar, off = apply_submove(
        board, bar, off, player, f2, t2, (~noop) & (~single))

    doubles = roll[:, 0] == roll[:, 1]
    goes_second = doubles & (~state.second) & (~noop)
    turn_passes = ~goes_second
    fresh = dice_from_stream(state.seed, state.cnt, action)
    return BgState(
        board=board.to(torch.int32),
        bar=bar.to(torch.int32),
        off=off.to(torch.int32),
        roll=torch.where(turn_passes[:, None], fresh, state.roll),
        player=torch.where(turn_passes, -state.player, state.player),
        second=goes_second,
        seed=state.seed,
        cnt=state.cnt + turn_passes.to(torch.int32),
    )


def winner(state: BgState) -> torch.Tensor:
    """[B] int32: 0 = none, else the winning player."""
    return torch.where(
        state.off[:, 0] == 15, -1, torch.where(state.off[:, 1] == 15, 1, 0)
    ).to(torch.int32)


def observe(state: BgState) -> torch.Tensor:
    """[B, 4, 6, 6] float32, NHWC: board points, player, hit counts
    (12/12), collected (12/12), roll (12/12), second-play flag."""
    b = state.board.shape[0]
    half = (torch.arange(24, device=state.board.device) < 12)

    def plane(v):
        return v.to(torch.float32).expand(b, 24).reshape(b, 4, 6)

    def split(pair):
        return torch.where(half, pair[:, :1], pair[:, 1:])

    return torch.stack([
        plane(state.board),
        plane(state.player[:, None]),
        plane(split(state.bar)),
        plane(split(state.off)),
        plane(split(state.roll)),
        plane(state.second[:, None]),
    ], dim=-1)


def player_of(state: BgState) -> torch.Tensor:
    return state.player


ENV = Env(
    spec=SPEC,
    init=init,
    step=step,
    legal_mask=legal_mask,
    observe=observe,
    winner=winner,
    player=player_of,
)


def validate_state(state: BgState) -> torch.Tensor:
    """[B] bool board invariant check: each side accounts for exactly 15
    checkers across board, bar and off, counts are non-negative, the dice
    are in range and the player is -1 or +1."""
    board = state.board
    neg = torch.where(board < 0, -board, 0).sum(-1)
    pos = torch.where(board > 0, board, 0).sum(-1)
    ok_m1 = neg + state.bar[:, 0] + state.off[:, 0] == 15
    ok_p1 = pos + state.bar[:, 1] + state.off[:, 1] == 15
    ok_counts = ((state.bar >= 0).all(-1) & (state.off >= 0).all(-1)
                 & (board.abs() <= 15).all(-1))
    ok_roll = ((state.roll >= 1) & (state.roll <= 6)).all(-1)
    return ok_m1 & ok_p1 & ok_counts & ok_roll & (state.player.abs() == 1)


def pretty_str(state: BgState, game: int = 0) -> str:
    """Game ``game`` of a batched state as a terminal board, the same
    string as the JAX package's ``pretty_str`` gives for that game."""
    b, bar, off, roll = (t[game].cpu().numpy() for t in
                         (state.board, state.bar, state.off, state.roll))
    top = " ".join(f"{i:>3}" for i in range(12, 24))
    bot = " ".join(f"{i:>3}" for i in range(11, -1, -1))
    rows = [
        top,
        " ".join(f"{b[i]:>3}" for i in range(12, 24)),
        "-" * len(top),
        " ".join(f"{b[i]:>3}" for i in range(11, -1, -1)),
        bot,
    ]
    player = "Player 1 (x, -1)" if int(state.player[game]) == -1 else "Player 2 (o, +1)"
    info = (
        f"Current turn: {player}  Roll: {tuple(roll)}"
        f"  second_play={bool(state.second[game])}\n"
        f"P1 bar={bar[0]} off={off[0]} | P2 bar={bar[1]} off={off[1]}"
    )
    return info + "\n" + "\n".join(rows)
