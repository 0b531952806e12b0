"""The port's PUCT search against the JAX package's, bit for bit.

With ``dirichlet_epsilon = 0`` and a deterministic ``eval_fn`` the search
draws nothing at random, so visit_probs, root_value and every tree field
must be equal, with negamax on and off, on both games.  The ``eval_fn``
gives policies that are multiples of 1/1024: their sums are exact in any
order, so the masked renormalisation rounds the same in XLA and PyTorch,
and the test compares the search, not two summation orders.  The random
draws (Dirichlet noise, move sampling) cannot be reproduced across
frameworks and are checked for their distribution instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu.search import alpha as jalpha
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.ops import rows as R
from die_e_tpu_torch.search import alpha as talpha
from tests.test_torch_tree import assert_trees_equal


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_evals(num_actions):
    """The same deterministic eval_fn for both packages."""

    def j_eval(params, obs):
        b = obs.shape[0]
        w = jnp.arange(obs[0].size) % 7 + 1
        s = jnp.sum(obs.reshape(b, -1) * w, axis=-1).astype(jnp.int32)
        k = (s[:, None] + jnp.arange(num_actions)[None, :]) % 8 + 1
        return k.astype(jnp.float32) / 1024.0, (((s % 17) - 8) / 16.0)[:, None].astype(jnp.float32)

    def t_eval(obs):
        b = obs.shape[0]
        w = torch.arange(obs[0].numel()) % 7 + 1
        s = (obs.reshape(b, -1) * w).sum(-1).to(torch.int32)
        k = (s[:, None] + torch.arange(num_actions)) % 8 + 1
        return k.float() / 1024.0, (((s % 17) - 8).float() / 16.0)[:, None]

    return j_eval, t_eval


def bg_roots(seed, b, plies):
    """Backgammon roots ``plies`` random legal moves into seeded games."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 31, b)
    js = jax.vmap(jbg.init)(jnp.asarray(seeds, jnp.uint32))
    ts = tbg.init(torch.tensor(seeds), device="cpu")
    step = jax.jit(jax.vmap(jbg.step))
    for _ in range(plies):
        mask = tbg.legal_mask(ts).numpy()
        a = np.array([rng.choice(np.nonzero(m)[0]) for m in mask])
        js = step(js, jnp.asarray(a, jnp.int32))
        ts = tbg.step(ts, torch.tensor(a))
    return js, ts


def ttt_roots():
    """Tic-tac-toe roots: empty, mid-game, one move from a win, and won."""
    boards = np.array([
        [0, 0, 0, 0, 0, 0, 0, 0, 0],
        [-1, 0, 0, 0, 1, 0, 0, 0, 0],
        [-1, -1, 0, 1, 1, 0, 0, 0, 0],
        [1, -1, 1, -1, 0, 0, 0, 0, 0],
        [-1, -1, -1, 1, 1, 0, 0, 0, 0],
    ], np.int32)
    players = np.array([-1, -1, -1, -1, 1], np.int32)
    return (jttt.TttState(board=jnp.asarray(boards), player=jnp.asarray(players)),
            tttt.TttState(board=torch.tensor(boards), player=torch.tensor(players)))


def assert_search_equal(jres, tres):
    np.testing.assert_array_equal(tres.visit_probs.numpy(), np.asarray(jres.visit_probs))
    np.testing.assert_array_equal(tres.root_value.numpy(), np.asarray(jres.root_value))
    assert_trees_equal(jres.tree, tres.tree)


def _run_both(jenv, tenv, js, ts, iterations, negamax, c=2.0):
    j_eval, t_eval = make_evals(jenv.spec.num_actions)
    kw = dict(iterations=iterations, c=c, dirichlet_epsilon=0.0, negamax=negamax)
    jres = jalpha.alpha_search(jenv, j_eval, None, js, jax.random.PRNGKey(0), **kw)
    tres = talpha.alpha_search(tenv, t_eval, ts, torch.Generator().manual_seed(0), **kw)
    return jres, tres


@pytest.mark.parametrize("negamax", [False, True])
def test_search_tictactoe_matches_jax(negamax):
    js, ts = ttt_roots()
    assert_search_equal(*_run_both(jttt.ENV, tttt.ENV, js, ts, 40, negamax))


@pytest.mark.parametrize("negamax", [False, True])
@pytest.mark.parametrize("seed,plies", [(0, 0), (1, 9), (2, 30)])
def test_search_backgammon_matches_jax(seed, plies, negamax):
    js, ts = bg_roots(seed, 6, plies)
    jres, tres = _run_both(jbg.ENV, tbg.ENV, js, ts, 24, negamax)
    assert_search_equal(jres, tres)
    assert tres.levels >= 24  # every iteration descends at least one level


def test_search_terminal_root_matches_jax():
    js, ts = bg_roots(3, 4, 0)
    off = np.array([[15, 0], [0, 0], [0, 15], [0, 0]], np.int32)
    js = js.replace(off=jnp.asarray(off))
    ts.off = torch.tensor(off)
    jres, tres = _run_both(jbg.ENV, tbg.ENV, js, ts, 8, True)
    assert_search_equal(jres, tres)
    assert not tres.visit_probs[0].any() and not tres.visit_probs[2].any()


def test_search_on_cpu_launches_no_kernel():
    js, ts = ttt_roots()
    R.reset_launches()
    _run_both(jttt.ENV, tttt.ENV, js, ts, 4, False)
    assert R.launches == {"gather_rows": 0, "scatter_rows": 0}


def test_masked_renorm_matches_jax():
    rng = np.random.default_rng(0)
    policy = rng.random((32, 1352)).astype(np.float32)
    legal = rng.random((32, 1352)) < 0.1
    legal[0] = False  # no legal action: the 1e-30 floor, all -1.0
    got = talpha._masked_renorm(torch.tensor(policy), torch.tensor(legal)).numpy()
    want = np.asarray(jalpha._masked_renorm(jnp.asarray(policy), jnp.asarray(legal)))
    # f32 sums over 1352 entries in two orders: equal to rounding
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[~legal] == -1.0).all()


def test_temperature_probs_match_jax():
    rng = np.random.default_rng(1)
    vp = rng.random((16, 50)).astype(np.float32)
    vp[0] = 0.0
    got = talpha.temperature_probs(torch.tensor(vp), 1.25).numpy()
    want = np.asarray(jalpha.temperature_probs(jnp.asarray(vp), 1.25))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sample_action_follows_the_temperature_distribution():
    gen = torch.Generator().manual_seed(0)
    vp = torch.tensor([[0.5, 0.25, 0.25, 0.0], [0.0, 0.0, 0.0, 0.0]])
    n = 20000
    draws = torch.cat([talpha.sample_action(gen, vp.repeat(100, 1), 1.25).reshape(100, 2)
                       for _ in range(n // 100)])
    assert draws.dtype == torch.int32
    assert (draws[:, 1] == 3).all()  # an all-zero row gives the last index
    freq = torch.bincount(draws[:, 0].long(), minlength=4).float() / len(draws)
    want = talpha.temperature_probs(vp[:1], 1.25)[0]
    assert torch.allclose(freq, want, atol=0.015)  # ~5 sigma at n = 20000
    assert freq[3] == 0.0


def test_dirichlet_is_normalized_over_legal_actions():
    gen = torch.Generator().manual_seed(0)
    legal = torch.rand(64, 1352, generator=gen) < 0.05
    legal[:, 0] = True
    d = talpha._dirichlet_legal(gen, 0.3, legal)
    assert (d[~legal] == 0).all() and (d >= 0).all()
    torch.testing.assert_close(d.sum(-1), torch.ones(64), rtol=0, atol=1e-5)
    # Dir(0.3): the mean of each coordinate is 1/k over k legal actions
    k = legal.sum(-1, keepdim=True).float()
    mean = torch.where(legal, d * k, 0.0).sum() / legal.sum()
    assert abs(mean.item() - 1.0) < 0.1
