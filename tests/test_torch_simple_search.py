"""The port's pure-rollout search against the JAX package's.

With ``rollout_limit=0`` the playout takes no step: it returns the winner
of an already finished state, else 0, and draws nothing at random.  The
search is then exact, so the action, the visit probabilities and every
tree field must equal the JAX package's bit for bit, in both selection
modes.  Every value backed up is 0 or +-1, so UCB1's ties are exact ties
in both frameworks.  Playouts draw from generators the two frameworks do
not share, so searches with playouts are checked for what they must find
(the cases of ``tests/test_search.py::TestSimpleSearch``) and for
reproducibility under a fixed seed.

Backgammon runs at one shape (8 games, 16 iterations) so that the JAX
search compiles once in this file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu.search import simple as jsimple
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.ops import rows as R
from die_e_tpu_torch.search import simple as tsimple
from tests.test_torch_search import bg_roots, ttt_roots
from tests.test_torch_tree import assert_trees_equal, random_tree

BG_GAMES, BG_ITERS = 8, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run_both(jenv, tenv, js, ts, iterations, c=2.0):
    """Both packages' trees after ``iterations`` iterations without
    playouts, and the port's descent levels."""
    jt, player = jsimple.simple_search_init(jenv, js, capacity=iterations + 1)
    jt, _ = jsimple.simple_search_chunk(jenv, jt, js, jax.random.PRNGKey(0), player,
                                        n_iters=iterations, c=c, rollout_limit=0)
    tt, levels = tsimple.simple_search_tree(tenv, ts, torch.Generator().manual_seed(0),
                                            iterations, c, 0)
    return jt, tt, levels


def _assert_select_equal(jenv, tenv, jt, tt):
    for selection in tsimple.SELECTIONS:
        ja, jp = jsimple.simple_search_select(jenv, jt, selection)
        ta, tp = tsimple.simple_search_select(tenv, tt, selection)
        assert ta.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=selection)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=selection)


@pytest.mark.parametrize("iterations,c", [(9, 2.0), (40, 2.0), (40, 0.5), (120, 2.0)])
def test_simple_search_tictactoe_matches_jax(iterations, c):
    js, ts = ttt_roots()
    jt, tt, levels = _run_both(jttt.ENV, tttt.ENV, js, ts, iterations, c)
    assert_trees_equal(jt, tt)
    _assert_select_equal(jttt.ENV, tttt.ENV, jt, tt)
    assert (tt.node_count <= iterations + 1).all()
    assert tt.node_count[0] == iterations + 1  # the empty board: one node an iteration
    assert levels > 0  # the roots with few moves are full within 9 iterations


def _bg_case(seed, plies, finished):
    js, ts = bg_roots(seed, BG_GAMES, plies)
    if finished:  # two finished games: terminal roots
        off = np.zeros((BG_GAMES, 2), np.int32)
        off[0, 0] = off[3, 1] = 15
        js = js.replace(off=jnp.asarray(off))
        ts.off = torch.tensor(off)
    return js, ts


@pytest.mark.parametrize("seed,plies,finished", [(0, 0, False), (1, 9, False),
                                                 (2, 30, True)])
def test_simple_search_backgammon_matches_jax(seed, plies, finished):
    js, ts = _bg_case(seed, plies, finished)
    jt, tt, _ = _run_both(jbg.ENV, tbg.ENV, js, ts, BG_ITERS)
    assert_trees_equal(jt, tt)
    _assert_select_equal(jbg.ENV, tbg.ENV, jt, tt)
    # one allocation per iteration of a game whose root is not terminal
    live = ~tt.node_done[:, 0]
    assert (tt.node_count[live] == BG_ITERS + 1).all()
    assert (tt.node_count[~live] == 1).all()
    if finished:
        action, probs = tsimple.simple_search_select(tbg.ENV, tt)
        assert action[0] == action[3] == tbg.NOOP_ACTION
        assert not probs[0].any() and not probs[3].any()


@pytest.mark.parametrize("selection", tsimple.SELECTIONS)
def test_terminal_root_gives_the_noop(selection):
    _, ts = ttt_roots()
    action, probs = tsimple.simple_search(tttt.ENV, ts, torch.Generator().manual_seed(0),
                                          iterations=20, simulate_round_limit=9,
                                          selection=selection)
    assert action[4] == tttt.NOOP_ACTION and not probs[4].any()  # root 4 is won
    # visit shares of the live roots sum to 1, to float32 rounding
    torch.testing.assert_close(probs[:4].sum(-1), torch.ones(4), rtol=0, atol=1e-6)


def test_unknown_selection_raises():
    _, ts = ttt_roots()
    with pytest.raises(ValueError, match="unknown selection mode 'best'"):
        tsimple.simple_search(tttt.ENV, ts, torch.Generator(), iterations=2,
                              selection="best")


@pytest.mark.parametrize("seed", range(4))
def test_next_expand_action_matches_jax(seed):
    jt, tt, rng = random_tree(seed)
    cur = rng.integers(0, tt.capacity, tt.batch_size).astype(np.int32)
    ne = rng.integers(0, 400, tt.num_expanded.shape).astype(np.int32)
    jt = jt.replace(num_expanded=jnp.asarray(ne))
    tt = tt.replace(num_expanded=torch.tensor(ne))
    ja, jany = jsimple._next_expand_action(jt, jnp.asarray(cur))
    ta, tany = tsimple._next_expand_action(tt, torch.tensor(cur))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tany.numpy(), np.asarray(jany))


def batch_ttt(boards, players):
    return tttt.TttState(board=torch.tensor(boards, dtype=torch.int32),
                         player=torch.tensor(players, dtype=torch.int32))


def test_finds_immediate_win():
    s = batch_ttt([[-1, -1, 0, 1, 1, 0, 0, 0, 0]] * 4, [-1] * 4)
    action, _ = tsimple.simple_search(tttt.ENV, s, torch.Generator().manual_seed(1),
                                      iterations=200, c=2.0, simulate_round_limit=9)
    assert action.tolist() == [2, 2, 2, 2]


def test_blocks_immediate_loss():
    # o (+1) to move; x threatens 0-1-2: block at 2
    s = batch_ttt([[-1, -1, 0, 1, 0, 0, 0, 0, 0]] * 4, [1] * 4)
    action, _ = tsimple.simple_search(tttt.ENV, s, torch.Generator().manual_seed(2),
                                      iterations=200, c=2.0, simulate_round_limit=9)
    assert action.tolist() == [2, 2, 2, 2]


def test_deterministic_under_a_fixed_generator_seed():
    s = tttt.init(range(4), device="cpu")

    def probs(seed):
        return tsimple.simple_search(tttt.ENV, s, torch.Generator().manual_seed(seed),
                                     iterations=60, simulate_round_limit=9)[1]

    assert torch.equal(probs(7), probs(7))
    assert not torch.equal(probs(7), probs(8))  # the playouts do draw


def test_rollout_values_and_limit():
    gen = torch.Generator().manual_seed(0)
    # won by x, won by o, drawn (full board), live
    s = batch_ttt([[-1, -1, -1, 1, 1, 0, 0, 0, 0], [1, 1, 1, -1, -1, 0, -1, 0, 0],
                   [-1, 1, -1, -1, 1, 1, 1, -1, -1], [0] * 9], [1, -1, 1, -1])
    player = torch.tensor([-1, -1, 1, -1], dtype=torch.int32)
    assert tsimple._rollout(tttt.ENV, s, gen, player, 0).tolist() == [1.0, -1.0, 0.0, 0.0]
    for _ in range(20):  # a 9-step playout always ends a tic-tac-toe game
        v = tsimple._rollout(tttt.ENV, s, gen, player, 9)
        assert v[:3].tolist() == [1.0, -1.0, 0.0] and v[3].item() in (-1.0, 0.0, 1.0)


@pytest.mark.parametrize("selection", tsimple.SELECTIONS)
def test_rollout_limit_zero_matches_jax_simple_search(monkeypatch, selection):
    """``simple_search`` with ``rollout_limit=0`` under a round limit of
    300: no playout step, so the port equals the JAX package's
    ``simple_search`` bit for bit (action and visit probabilities), and
    its tree equals the tree JAX builds with the playout cap that JAX's
    own argument rule gives."""
    js, ts = ttt_roots()
    iterations = 40
    trees = []
    real = tsimple.simple_search_tree

    def spy(env, states, gen, iterations, c, sim_limit):
        trees.append(sim_limit)
        trees.append(real(env, states, gen, iterations, c, sim_limit)[0])
        return trees[-1], 0

    monkeypatch.setattr(tsimple, "simple_search_tree", spy)
    ta, tp = tsimple.simple_search(tttt.ENV, ts, torch.Generator().manual_seed(0),
                                   iterations=iterations, c=2.0, simulate_round_limit=300,
                                   selection=selection, rollout_limit=0)
    ja, jp = jsimple.simple_search(jttt.ENV, js, jax.random.PRNGKey(0), iterations=iterations,
                                   c=2.0, simulate_round_limit=300, selection=selection,
                                   rollout_limit=0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    limit = jsimple._check_args(selection, 0, 300)
    assert trees[0] == limit == 0
    jt, player = jsimple.simple_search_init(jttt.ENV, js, capacity=iterations + 1)
    jt, _ = jsimple.simple_search_chunk(jttt.ENV, jt, js, jax.random.PRNGKey(0), player,
                                        n_iters=iterations, c=2.0, rollout_limit=limit)
    assert_trees_equal(jt, trees[1])


@pytest.mark.parametrize("limit", [1, 3])
def test_rollout_limit_caps_every_playout(monkeypatch, limit):
    """With ``rollout_limit=k`` (below ``simulate_round_limit``) no
    playout takes more than k env steps, and from tic-tac-toe's opening
    some take exactly k."""
    steps = []
    real = tsimple._rollout

    def spy(env, states, gen, player, sim_limit):
        n = []

        def step(s, action):
            n.append(1)
            return env.step(s, action)

        out = real(dataclasses.replace(env, step=step), states, gen, player, sim_limit)
        steps.append(len(n))
        return out

    monkeypatch.setattr(tsimple, "_rollout", spy)
    tsimple.simple_search(tttt.ENV, tttt.init(range(4), device="cpu"),
                          torch.Generator().manual_seed(3), iterations=20,
                          simulate_round_limit=9, rollout_limit=limit)
    assert len(steps) == 20 and max(steps) == limit


def test_search_on_cpu_launches_no_kernel():
    _, ts = ttt_roots()
    R.reset_launches()
    tsimple.simple_search(tttt.ENV, ts, torch.Generator(), iterations=4)
    assert R.launches == {"gather_rows": 0, "scatter_rows": 0}
