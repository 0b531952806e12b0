"""The port's self-play against the JAX package's.

The first round's records (obs, quantized visit probs, player, valid, the
sparse root-child pairs and their dense rebuild) are bit-exact with JAX
``_self_play_rounds`` from the same states, with ``dirichlet_epsilon = 0``
and the deterministic ``eval_fn`` of ``test_torch_search``.  Later rounds
depend on the sampled moves, which the two frameworks draw differently, so
they are checked for their invariants.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.train import self_play as tsp
from tests.test_torch_search import bg_roots, make_evals, ttt_roots

# the package's __init__ re-exports a function of the same name
jsp = importlib.import_module("die_e_tpu.train.self_play")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _first_round(jenv, tenv, js, ts, sparse, negamax=True, iterations=12):
    j_eval, t_eval = make_evals(jenv.spec.num_actions)
    jdone = jax.vmap(jenv.done)(js)
    jout = jsp._self_play_rounds(
        jenv, j_eval, None, js, jdone, jax.random.PRNGKey(0),
        iterations, 2.0, 0.3, 0.0, 1.25, 1, negamax, sparse=sparse)
    tout = tsp._self_play_rounds(
        tenv, t_eval, ts, tenv.done(ts), torch.Generator().manual_seed(0),
        iterations, 2.0, 0.3, 0.0, 1.25, 1, negamax, sparse=sparse)
    return jout, tout


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("seed,plies", [(0, 0), (5, 20)])
def test_first_round_records_match_jax_backgammon(seed, plies, sparse):
    js, ts = bg_roots(seed, 6, plies)
    jout, tout = _first_round(jbg.ENV, tbg.ENV, js, ts, sparse)
    j_obs, j_probs, j_player, j_valid = jout[:4]
    assert tout.rounds_played == 1
    np.testing.assert_array_equal(tout.obs.numpy(), np.asarray(j_obs))
    np.testing.assert_array_equal(tout.player.numpy(), np.asarray(j_player))
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(j_valid))
    if sparse:
        for got, want in zip(tout.probs, j_probs):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        act, vis = (p.numpy()[0] for p in tout.probs)
        dense = tsp._dense_q_from_sparse(act, vis, tbg.NUM_ACTIONS)
        np.testing.assert_array_equal(
            dense, jsp._dense_q_from_sparse(act, vis, jbg.NUM_ACTIONS))
        # the rebuild equals the dense record of the same search
        _, dense_out = _first_round(jbg.ENV, tbg.ENV, js, ts, False)
        np.testing.assert_array_equal(dense, dense_out.probs.numpy()[0])
    else:
        assert tout.probs.dtype == torch.uint16
        np.testing.assert_array_equal(tout.probs.numpy(), np.asarray(j_probs))


@pytest.mark.parametrize("negamax", [False, True])
def test_first_round_records_match_jax_tictactoe(negamax):
    js, ts = ttt_roots()
    jout, tout = _first_round(jttt.ENV, tttt.ENV, js, ts, False,
                              negamax=negamax, iterations=30)
    for got, want in zip((tout.obs, tout.probs, tout.player, tout.valid), jout[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not tout.valid[0, 4]  # the won root records no fragment


def test_dense_q_from_sparse_matches_jax_on_random_records():
    rng = np.random.default_rng(0)
    act = rng.integers(-1, 40, (50, 17)).astype(np.int16)
    vis = rng.integers(0, 300, (50, 17)).astype(np.uint16)
    act[3] = -1  # a row without root children
    got = tsp._dense_q_from_sparse(act, vis, 40)
    np.testing.assert_array_equal(got, jsp._dense_q_from_sparse(act, vis, 40))
    assert got.dtype == np.uint16 and not got[3].any()
    assert tsp._dense_q_from_sparse(act[:0], vis[:0], 40).shape == (0, 40)


def test_trajectory_to_memory_matches_jax():
    rng = np.random.default_rng(1)
    t, b, a = 5, 4, 9
    obs = rng.integers(-1, 2, (t, b, 3, 3, 3)).astype(np.float32)
    probs = rng.integers(0, 65536, (t, b, a)).astype(np.uint16)
    player = rng.choice([-1, 1], (t, b)).astype(np.int32)
    valid = rng.random((t, b)) < 0.6
    outcome = rng.choice([-1.0, 0.0, 1.0], (t, b)).astype(np.float32)
    winner = np.zeros(b, np.int32)
    jt = jsp.Trajectory(obs=obs, probs=probs, player=player, valid=valid,
                        outcome=outcome, winner=winner, num_moves=valid.sum(0))
    tt = tsp.Trajectory(obs=torch.tensor(obs), probs=torch.tensor(probs),
                        player=torch.tensor(player), valid=torch.tensor(valid),
                        outcome=torch.tensor(outcome), winner=torch.tensor(winner),
                        num_moves=torch.tensor(valid.sum(0)))
    for got, want in zip(tsp.trajectory_to_memory(tt, 1.25),
                         jsp.trajectory_to_memory(jt, 1.25)):
        np.testing.assert_array_equal(got, want)


def test_self_play_tictactoe_to_the_end():
    """Whole games on the CPU: every game ends, outcomes are relabeled per
    fragment, and the records hold only live, non-skip moves."""
    _, t_eval = make_evals(9)
    traj = tsp.self_play(tttt.ENV, t_eval, torch.Generator().manual_seed(3),
                         batch_size=8, iterations=16, round_limit=20,
                         negamax=True, device="cpu")
    t = traj.obs.shape[0]
    assert 5 <= t <= 9
    assert traj.probs.shape == (t, 8, 9) and traj.probs.dtype == torch.uint16
    assert torch.equal(traj.num_moves, traj.valid.sum(0).to(torch.int32))
    assert torch.equal(traj.outcome, (traj.winner[None] * traj.player).float())
    sums = traj.probs.to(torch.int64).sum(-1)[traj.valid]
    assert ((sums - 65535).abs() <= 9).all()
    obs, ps, outcome = tsp.trajectory_to_memory(traj, 1.25)
    assert len(obs) == len(ps) == len(outcome) == int(traj.valid.sum())
    assert traj.levels > 0


def test_self_play_backgammon_round_limit():
    _, t_eval = make_evals(tbg.NUM_ACTIONS)
    traj = tsp.self_play(tbg.ENV, t_eval, torch.Generator().manual_seed(0),
                         batch_size=3, iterations=6, round_limit=3,
                         negamax=True, device="cpu")
    assert traj.obs.shape == (3, 3, 4, 6, 6)
    assert (traj.winner == 0).all() and (traj.outcome == 0).all()  # cut games draw
    assert traj.valid.all()


def test_self_play_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    _, t_eval = make_evals(9)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsp.self_play(tttt.ENV, t_eval, torch.Generator(), batch_size=2,
                      iterations=2, round_limit=1)
