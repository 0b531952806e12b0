"""The port's environments against the JAX package's, bit for bit.

Backgammon: the dice stream, the action codec, ``legal_digits``, the
scalar oracle ``legal_single`` (against JAX's and against
``legal_digits``), the legal
mask on the cases of ``tests/test_mask_parity.py`` (JAX and the C++ oracle
``parity/oracle.py``) and on fuzzed positions, and ``step`` over seeded
random games with every ``BgState`` field equal at every ply.  Tic-tac-toe:
every reachable position.  Integer work, so every comparison is exact.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.envs.base import compact_take, freeze_where
from parity import oracle as cpp
from tests.test_mask_parity import FIXED_CASES, random_position

FIELDS = ("board", "bar", "off", "roll", "player", "second", "seed", "cnt")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_states(cases):
    """Batched JAX BgState from (board, bar, off, roll, player) cases."""
    cols = list(zip(*cases))
    n = len(cases)
    return jbg.BgState(
        board=jnp.asarray(np.array(cols[0]), jnp.int32),
        bar=jnp.asarray(np.array(cols[1]), jnp.int32),
        off=jnp.asarray(np.array(cols[2]), jnp.int32),
        roll=jnp.asarray(np.array(cols[3]), jnp.int32),
        player=jnp.asarray(np.array(cols[4]), jnp.int32),
        second=jnp.zeros(n, bool),
        seed=jnp.zeros(n, jnp.uint32),
        cnt=jnp.ones(n, jnp.int32),
    )


def torch_states(cases):
    cols = list(zip(*cases))
    return tbg.make_state(*cols[:5], device="cpu")


_JAX_MASK = jax.jit(jax.vmap(jbg.legal_mask))
_JAX_STEP = jax.jit(jax.vmap(jbg.step))


def assert_same_state(js, ts, msg=""):
    for f in FIELDS:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        if f == "seed":
            got = got.astype(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"{f} {msg}")


def assert_masks_match(cases, with_oracle=True):
    got = tbg.legal_mask(torch_states(cases)).numpy()
    want = np.asarray(_JAX_MASK(jax_states(cases)))
    np.testing.assert_array_equal(got, want)
    if with_oracle:
        for i, (board, bar, off, roll, player) in enumerate(cases):
            ref = cpp.legal_mask(board, bar, off, roll, player)
            if not ref.any():
                ref[tbg.NOOP_ACTION] = True  # the port marks the skip turn
            np.testing.assert_array_equal(got[i], ref, err_msg=f"case {i}")


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, 0xFFFFFFFF])
def test_dice_stream_matches_jax_and_oracle(seed):
    cnt = np.array([0, 1, 2, 77, 2 ** 31 - 1], np.int64)
    salt = np.array([0, 5, 1351, -1, 676], np.int64)
    seeds = np.full(cnt.shape, seed, np.int64)
    got = tbg.dice_from_stream(torch.tensor(seeds), torch.tensor(cnt),
                               torch.tensor(salt)).numpy()
    want = np.asarray(jax.vmap(jbg.dice_from_stream)(
        jnp.asarray(seeds.astype(np.uint32)), jnp.asarray(cnt, jnp.int32),
        jnp.asarray(salt, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    for i in range(len(cnt)):
        assert tuple(got[i]) == cpp.dice(seed, int(cnt[i]), int(salt[i]))


def test_init_matches_jax():
    seeds = np.array([0, 1, 7, 2 ** 31 - 2, 4000000000], np.uint32)
    ts = tbg.init(torch.tensor(seeds.astype(np.int64)), device="cpu")
    js = jax.vmap(jbg.init)(jnp.asarray(seeds))
    assert_same_state(js, ts)


def test_decode_encode_match_jax():
    rng = np.random.default_rng(0)
    n = 4096
    action = rng.integers(0, tbg.NUM_ACTIONS, n)
    roll = rng.integers(1, 7, (n, 2))
    player = rng.choice([-1, 1], n)
    got = tbg.decode_action(torch.tensor(action), torch.tensor(roll),
                            torch.tensor(player))
    want = jax.vmap(jbg.decode_action)(
        jnp.asarray(action, jnp.int32), jnp.asarray(roll, jnp.int32),
        jnp.asarray(player, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    f1, t1, f2, t2, single = got[:5]
    enc = tbg.encode_move(f1, t1, f2, t2, single, torch.tensor(roll)).numpy()
    jenc = jax.vmap(lambda *a: jbg.encode_move(*a, None))(
        *(jnp.asarray(x.numpy()) for x in (f1, t1, f2, t2, single)),
        jnp.asarray(roll, jnp.int32))
    np.testing.assert_array_equal(enc, np.asarray(jenc))


def test_legal_digits_matches_jax():
    rng = random.Random(31337)
    cases = [random_position(rng) for _ in range(60)]
    board = np.array([c[0] for c in cases] * 6)
    bar = np.array([c[1] for c in cases] * 6)
    player = np.array([c[4] for c in cases] * 6)
    die = np.repeat(np.arange(1, 7), len(cases))
    got = tbg.legal_digits(torch.tensor(board), torch.tensor(bar),
                           torch.tensor(player), torch.tensor(die)).numpy()
    want = np.asarray(jax.vmap(
        lambda b, br, p, d: jbg.legal_digits(b, br, jnp.zeros(2, jnp.int32), p, d)
    )(jnp.asarray(board, jnp.int32), jnp.asarray(bar, jnp.int32),
      jnp.asarray(player, jnp.int32), jnp.asarray(die, jnp.int32)))
    np.testing.assert_array_equal(got, want)


def _single_cases(seed):
    """60 seeded positions x 6 dice x both players, one row each: (board
    [M, 24], bar [M, 2], player [M], die [M]) as numpy arrays; bar
    checkers and bear-off shapes included (``random_position``)."""
    rng = random.Random(seed)
    cases = [random_position(rng) for _ in range(60)]
    board = np.repeat(np.array([c[0] for c in cases]), 12, 0)
    bar = np.repeat(np.array([c[1] for c in cases]), 12, 0)
    player = np.tile(np.repeat([-1, 1], 6), len(cases))
    die = np.tile(np.arange(1, 7), 2 * len(cases))
    assert (bar > 0).any()  # entry from the bar
    assert ((board[:, 6:] >= 0).all(-1) & (bar[:, 0] == 0)).any()  # a collectible side
    return board, bar, player, die


def _legal_single_all(board, bar, player, die):
    """The port's legal_single over the 26 digits: [M, 26]."""
    t = [torch.tensor(x) for x in (board, bar, player, die)]
    return tbg.legal_single(t[0][:, None], t[1][:, None], t[2][:, None], t[3][:, None],
                            torch.arange(26)[None]).numpy()


@pytest.mark.parametrize("seed", [31337, 2024])
def test_legal_single_matches_jax(seed):
    board, bar, player, die = _single_cases(seed)
    got = _legal_single_all(board, bar, player, die)

    def one(b, br, p, d, f):
        return jbg.legal_single(b, br, jnp.zeros(2, jnp.int32), p, d, f)

    want = np.asarray(jax.jit(jax.vmap(jax.vmap(one, in_axes=(None,) * 4 + (0,)),
                                       in_axes=(0,) * 4 + (None,)))(
        *(jnp.asarray(x, jnp.int32) for x in (board, bar, player, die)), jnp.arange(26)))
    assert got.shape == (len(board), 26) and got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [31337, 2024])
def test_legal_single_matches_legal_digits(seed):
    """Counterpart of ``tests/test_mask_parity.py::
    test_legal_digits_matches_legal_single`` on the port."""
    board, bar, player, die = _single_cases(seed)
    got = tbg.legal_digits(*(torch.tensor(x) for x in (board, bar, player, die))).numpy()
    np.testing.assert_array_equal(got, _legal_single_all(board, bar, player, die))


def test_legal_single_broadcasts():
    """One position against many digits, and one digit: the result has the
    broadcast batch shape."""
    board, bar, player, die = (torch.tensor(x) for x in _single_cases(31337))
    f = torch.arange(26)
    one = tbg.legal_single(board[0], bar[0], player[0], die[0], f)
    assert one.shape == (26,)
    assert torch.equal(one, tbg.legal_digits(board[:1], bar[:1], player[:1], die[:1])[0])
    col = tbg.legal_single(board, bar, player, die, torch.tensor(24))
    assert torch.equal(col, tbg.legal_digits(board, bar, player, die)[:, 24])


@pytest.mark.parametrize("i", range(len(FIXED_CASES)))
def test_legal_mask_fixed_positions(i):
    assert_masks_match([FIXED_CASES[i]])


def test_legal_mask_fixed_positions_batched():
    """All fixed cases in one batch: rows do not leak into each other."""
    assert_masks_match(FIXED_CASES, with_oracle=False)


@pytest.mark.parametrize("seed", range(8))
def test_legal_mask_fuzz(seed):
    rng = random.Random(1234 + seed)
    assert_masks_match([random_position(rng) for _ in range(80)])


@pytest.mark.parametrize("seed", range(4))
def test_legal_mask_fuzz_doubles(seed):
    rng = random.Random(777 + seed)
    cases = []
    for _ in range(40):
        board, bar, off, _, player = random_position(rng)
        d = rng.randint(1, 6)
        cases.append((board, bar, off, (d, d), player))
    assert_masks_match(cases)


def _random_games(seed, b, plies):
    """Play ``b`` seeded games for ``plies`` plies with uniformly random
    legal actions in both packages, checking every field at every ply."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 32, b, dtype=np.uint64).astype(np.uint32)
    js = jax.vmap(jbg.init)(jnp.asarray(seeds))
    ts = tbg.init(torch.tensor(seeds.astype(np.int64)), device="cpu")
    for ply in range(plies):
        assert_same_state(js, ts, f"ply {ply}")
        mask = tbg.legal_mask(ts).numpy()
        np.testing.assert_array_equal(mask, np.asarray(_JAX_MASK(js)), f"ply {ply}")
        np.testing.assert_array_equal(tbg.winner(ts).numpy(),
                                      np.asarray(jax.vmap(jbg.winner)(js)))
        np.testing.assert_array_equal(tbg.observe(ts).numpy(),
                                      np.asarray(jax.vmap(jbg.observe)(js)))
        action = np.array([rng.choice(np.nonzero(m)[0]) for m in mask])
        js = _JAX_STEP(js, jnp.asarray(action, jnp.int32))
        ts = tbg.step(ts, torch.tensor(action))
    return ts


@pytest.mark.parametrize("seed", range(3))
def test_step_random_games_match_jax(seed):
    _random_games(seed, b=24, plies=120)


@pytest.mark.parametrize("seed", [7, 2024])
def test_step_matches_oracle_trajectory(seed):
    """Feed the C++ oracle's whole seeded game through the port's step."""
    traj = cpp.run_trajectory(seed, max_steps=600)
    ts = tbg.init(torch.tensor([seed]), device="cpu")
    for t in range(traj["n"]):
        assert ts.board[0].tolist() == traj["boards"][t].tolist(), t
        assert ts.bar[0].tolist() == traj["bars"][t].tolist(), t
        assert ts.off[0].tolist() == traj["offs"][t].tolist(), t
        assert ts.roll[0].tolist() == traj["rolls"][t].tolist(), t
        assert int(ts.player[0]) == traj["players"][t], t
        assert int(ts.second[0]) == traj["seconds"][t], t
        a = int(traj["actions"][t])
        if a < 0:
            break
        assert bool(tbg.legal_mask(ts)[0, a]), t
        ts = tbg.step(ts, torch.tensor([a]))


def test_freeze_where_and_compact_take():
    a = tbg.init(torch.tensor([1, 2, 3]), device="cpu")
    b = tbg.step(a, torch.full((3,), tbg.NOOP_ACTION))
    done = torch.tensor([True, False, True])
    f = freeze_where(done, a, b)
    for name in FIELDS:
        got = getattr(f, name)
        assert torch.equal(got[0], getattr(a, name)[0])
        assert torch.equal(got[1], getattr(b, name)[1])
    s, d = compact_take(f, done, torch.tensor([2, 0]))
    assert torch.equal(s.seed, torch.tensor([3, 1]))
    assert d.tolist() == [True, True]


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbg.init([1, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        tttt.init([1, 2])


# ---------------------------------------------------------------------------
# tic-tac-toe: every reachable position
# ---------------------------------------------------------------------------


def _ttt_reachable():
    """All (board, player) reachable from the empty board, stopping at
    finished games, by breadth-first search in plain Python."""
    lines = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
             (2, 5, 8), (0, 4, 8), (2, 4, 6)]

    def over(b):
        return any(b[i] != 0 and b[i] == b[j] == b[k] for i, j, k in lines) or all(b)

    start = ((0,) * 9, -1)
    seen, frontier = {start}, [start]
    while frontier:
        nxt = []
        for board, player in frontier:
            if over(board):
                continue
            for a in range(9):
                if board[a] == 0:
                    s = (board[:a] + (player,) + board[a + 1:], -player)
                    if s not in seen:
                        seen.add(s)
                        nxt.append(s)
        frontier = nxt
    return sorted(seen)


def test_tictactoe_every_reachable_position():
    pos = _ttt_reachable()
    assert len(pos) == 5478
    boards = np.array([p[0] for p in pos], np.int32)
    players = np.array([p[1] for p in pos], np.int32)
    js = jttt.TttState(board=jnp.asarray(boards), player=jnp.asarray(players))
    ts = tttt.TttState(board=torch.tensor(boards), player=torch.tensor(players))
    for fn_t, fn_j in ((tttt.legal_mask, jttt.legal_mask), (tttt.winner, jttt.winner),
                       (tttt.done, jttt.done), (tttt.observe, jttt.observe),
                       (tttt.player_of, jttt.player_of)):
        np.testing.assert_array_equal(fn_t(ts).numpy(),
                                      np.asarray(jax.vmap(fn_j)(js)))
    step_j = jax.jit(jax.vmap(jttt.step))
    for a in range(10):  # every cell and the noop slot
        act = np.full(len(pos), a, np.int32)
        got = tttt.step(ts, torch.tensor(act))
        want = step_j(js, jnp.asarray(act))
        np.testing.assert_array_equal(got.board.numpy(), np.asarray(want.board))
        np.testing.assert_array_equal(got.player.numpy(), np.asarray(want.player))
