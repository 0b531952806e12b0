"""Live-game compaction in the port against the JAX package, on the CPU.

``compaction_plan`` and ``CompactionTracker`` are host numpy code and equal
the JAX package's exactly on the same inputs.  A compacted run draws its
random numbers per (smaller) batch, so its trajectory differs from an
uncompacted one, in the port as in the JAX package (DIVERGENCES.md row
12): compacted self-play and arena are held to their semantics (the
scenarios of ``tests/test_train.py::test_hosted_compaction_semantics`` and
``tests/test_arena.py::test_compacted_match_counts``, and more: on
tic-tac-toe each game's fragments are its moves in order, at its original
index, and its winner is the player of its last move), and a compaction
that never fires (``min_batch >= B``) gives the uncompacted run bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from die_e_tpu.envs import base as jbase
from die_e_tpu_torch.arena.versus import Agent, Player, play
from die_e_tpu_torch.core.config import MctsConfig
from die_e_tpu_torch.envs import base as tbase
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.nets.resnet import make_net
from die_e_tpu_torch.train.learner import net_eval_fn
from die_e_tpu_torch.train.self_play import self_play

ENV = dataclasses.replace(tttt.ENV, spec=dataclasses.replace(tttt.SPEC, n_filters=8,
                                                              n_res_blocks=1))
MCTS_CFG = MctsConfig(iterations=16, c=2.0, simulate_round_limit=9)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _done_masks():
    """Seeded done masks: many batch sizes, live fractions from none to all."""
    rng = np.random.default_rng(0)
    for b in (1, 2, 3, 7, 16, 64, 100, 128, 400, 1024):
        for p_live in (0.0, 0.01, 0.1, 0.3, 0.5, 0.74, 0.76, 0.9, 1.0):
            yield rng.random(b) >= p_live


@pytest.mark.parametrize("min_batch", [1, 2, 64, 96, 128, 200])
def test_compaction_plan_equals_jax(min_batch):
    for done in _done_masks():
        got, want = tbase.compaction_plan(done, min_batch), jbase.compaction_plan(done, min_batch)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_compaction_plan_ladder():
    """new_B is the smallest of {2^k} U {3 * 2^k} at least max(live,
    min_batch), live games first."""
    done = np.ones(1024, bool)
    done[[5, 700, 1000]] = False
    idx = tbase.compaction_plan(done, 2)
    assert len(idx) == 3 and list(idx) == [5, 700, 1000]
    done[:200] = False
    assert len(tbase.compaction_plan(done, 128)) == 256
    done[:300] = False
    assert len(tbase.compaction_plan(done, 128)) == 384
    assert tbase.compaction_plan(np.zeros(1024, bool), 128) is None


def test_compaction_tracker_equals_jax():
    rng = np.random.default_rng(1)
    for b in (8, 37, 128):
        t, j = tbase.CompactionTracker(b), jbase.CompactionTracker(b)
        done = np.zeros(b, bool)
        for _ in range(12):
            done = done | (rng.random(b) < 0.2)
            winner = np.where(done, rng.choice([-1, 0, 1], b), 0).astype(np.int32)
            cur_done, cur_winner = done[t.orig], winner[t.orig]
            stale = rng.random() < 0.3  # a merge in an older mapping
            gmap = t.orig if stale else None
            t.merge(cur_done, cur_winner, gmap)
            j.merge(cur_done, cur_winner, gmap)
            np.testing.assert_array_equal(t.current_done(), j.current_done())
            idx = tbase.compaction_plan(t.current_done(), 2)
            if idx is not None:
                t.take(idx)
                j.take(idx)
            np.testing.assert_array_equal(t.orig, j.orig)
            np.testing.assert_array_equal(t.final_winner(), j.final_winner())
        assert t.final_winner().dtype == j.final_winner().dtype == np.int32


def _self_play(compact, min_batch=2, games=16, seed=5):
    net = make_net(ENV.spec, 0, "cpu")
    return self_play(ENV, net_eval_fn(net), torch.Generator().manual_seed(seed),
                     batch_size=games, iterations=16, c=2.0, temperature=1.25,
                     round_limit=9, device="cpu", compact=compact, min_batch=min_batch)


def test_self_play_compaction_semantics():
    """Every game finishes; each game's fragments are its moves, one a
    round from round 0 on, at its original index; the winner is the player
    of the game's last move (a draw fills the board); every fragment's
    outcome is the winner from its player's side."""
    traj = _self_play(compact=True)
    assert traj.row_rounds < traj.obs.shape[0] * 16  # the batch did shrink
    valid = traj.valid.numpy()
    player = traj.player.numpy()
    winner = traj.winner.numpy()
    empty = traj.obs[..., 1].sum((-1, -2)).numpy()  # empty squares per fragment
    assert winner.shape == (16,) and set(np.unique(winner)) <= {-1, 0, 1}
    for g in range(16):
        n = int(valid[:, g].sum())
        assert valid[:n, g].all() and not valid[n:, g].any()
        np.testing.assert_array_equal(empty[:n, g], 9 - np.arange(n))
        if winner[g] == 0:
            assert n == 9
        else:
            assert n >= 5 and player[n - 1, g] == winner[g]
        np.testing.assert_array_equal(traj.outcome[:n, g].numpy(), winner[g] * player[:n, g])
    assert int(traj.num_moves.sum()) == int(valid.sum())


@pytest.mark.parametrize("games", [16, 24])
def test_self_play_compaction_that_never_fires_is_bit_identical(games):
    off = _self_play(compact=False, games=games)
    on = _self_play(compact=True, min_batch=games, games=games)
    for f in ("obs", "probs", "player", "valid", "outcome", "winner", "num_moves"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert (on.levels, on.row_rounds) == (off.levels, off.row_rounds)


def _replay_winner(rec) -> int:
    """Re-apply a record's moves from its initial board; the winner."""
    st = tttt.TttState(board=torch.tensor([rec.initial_state["board"]], dtype=torch.int32),
                       player=torch.tensor([rec.initial_state["player"]], dtype=torch.int32))
    for turn in rec.turns:
        st = tttt.step(st, torch.tensor([turn.action]))
    return int(tttt.winner(st)[0])


def test_arena_compaction_counts_and_records():
    """mcts against random with compaction: the tally adds up, mcts still
    wins more, and each recorded game replays to its recorded winner (the
    winners stay on the original game ids)."""
    res = play(ENV, Player(Agent.MCTS), Player(Agent.RANDOM), torch.Generator().manual_seed(2),
               MCTS_CFG, num_games=16, round_limit=9, record=True, compact=True, min_batch=2)
    assert res.wins_p1 + res.wins_p2 + res.draws == 16
    assert res.wins_p1 > res.wins_p2
    kinds = {-1: "mcts", 1: "random", 0: "none"}
    assert [r.winner for r in res.games].count("mcts") == res.wins_p1
    for rec in res.games:
        assert kinds[_replay_winner(rec)] == rec.winner


def test_arena_compaction_that_never_fires_is_bit_identical():
    def run(**kw):
        return play(ENV, Player(Agent.MCTS), Player(Agent.RANDOM),
                    torch.Generator().manual_seed(4), MCTS_CFG, num_games=12, round_limit=9,
                    record=True, **kw)

    off, on = run(), run(compact=True, min_batch=12)
    assert (on.wins_p1, on.wins_p2, on.draws, on.rounds, on.mcts_searches) == (
        off.wins_p1, off.wins_p2, off.draws, off.rounds, off.mcts_searches)
    strip = lambda rs: [{**r.to_json(), "id": None} for r in rs]  # noqa: E731
    assert strip(on.games) == strip(off.games)

