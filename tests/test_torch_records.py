"""The port's game records, board printing, invariant check and Elo fit
against the JAX package's.

Records cross between the packages both ways: the same game gives the same
JSON field for field, and a record written by either package replays in
the other with the same printed lines.  Games are played in lockstep in
both packages from the same seeds with the JAX package's random actions,
so every state and string is compared exactly.  ``elo.py`` is the same
numpy code in both packages and is compared exactly on the inputs of
``tests/test_elo.py`` (with 40 bootstrap resamples, to keep the file
short).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.arena import elo as jelo
from die_e_tpu.arena import records as jrec
from die_e_tpu.arena import versus as jv
from die_e_tpu.core.config import MctsConfig as JMctsConfig
from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu_torch.arena import elo as telo
from die_e_tpu_torch.arena import records as trec
from die_e_tpu_torch.arena import versus as tv
from die_e_tpu_torch.core.config import MctsConfig
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt

GAMES = {"backgammon": (jbg, tbg), "tictactoe": (jttt, tttt)}
_J_RANDOM_ACTIONS = jax.jit(jv._random_actions, static_argnums=0)
_J_VALIDATE = jax.jit(jax.vmap(jbg.validate_state))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def lockstep(game, n, rounds, seed=0):
    """A match of JAX random moves played in both packages: (JAX initial
    states, the port's, the round log, winners, and the (JAX, port) states
    after every round)."""
    jm, tm = GAMES[game]
    r_seed = jax.random.PRNGKey(seed)
    js = jv._init_match(jm.ENV, r_seed, n)
    seeds = np.asarray(jax.random.randint(
        r_seed, (n,), 0, jnp.iinfo(jnp.int32).max).astype(jnp.uint32))
    ts = tv._init_match(tm.ENV, torch.tensor(seeds.astype(np.int64)))
    j0, t0 = js, ts
    jdone, tdone = jax.vmap(jm.ENV.done)(js), tm.ENV.done(ts)
    log, seen = [], [(js, ts)]
    rng = jax.random.PRNGKey(100 + seed)
    for _ in range(rounds):
        rng, r = jax.random.split(rng)
        action = np.asarray(_J_RANDOM_ACTIONS(jm.ENV, js, r))
        roll = ts.roll.numpy() if game == "backgammon" else None
        log.append((tm.ENV.player(ts).numpy(), np.where(tdone.numpy(), -1, action), roll))
        js, jdone = jv._apply_round(jm.ENV, js, jdone, jnp.asarray(action))
        ts, tdone = tv._apply_round(tm.ENV, ts, tdone, torch.tensor(action))
        seen.append((js, ts))
    winner = torch.where(tdone, tm.ENV.winner(ts), 0).numpy()
    return j0, t0, log, winner, seen


@pytest.mark.parametrize("game,n,rounds", [("backgammon", 6, 40), ("tictactoe", 8, 9)])
def test_record_json_matches_jax(game, n, rounds):
    j0, t0, log, winner, _ = lockstep(game, n, rounds)
    jrecs = jrec.GameRecord.from_arrays(GAMES[game][0].ENV, jv.Agent.RANDOM, jv.Agent.MCTS,
                                        jax.device_get(j0), log, winner)
    trecs = trec.GameRecord.from_arrays(GAMES[game][1].ENV, tv.Agent.RANDOM, tv.Agent.MCTS,
                                        t0, log, winner)
    assert len(trecs) == n
    for jr, tr in zip(jrecs, trecs):
        tr.id = jr.id
        assert tr.to_json() == jr.to_json()
        assert json.dumps(tr.to_json(), indent=2) == json.dumps(jr.to_json(), indent=2)
    if game == "backgammon":
        state = trecs[0].to_json()["initial_state"]
        assert type(state["second"]) is bool
        assert all(0 <= r.initial_state["seed"] < 2 ** 32 for r in trecs)


def _replayed_lines(replay, env, path, pretty_str):
    lines = []
    state = replay(env, path, pretty_str, out=lines.append)
    return lines, state


@pytest.mark.parametrize("game", ["backgammon", "tictactoe"])
def test_port_record_replays_in_jax(game, tmp_path):
    """A match recorded by the port's arena, saved, and replayed by both
    packages: the same lines, and the port's last board is valid."""
    jm, tm = GAMES[game]
    res = tv.play(tm.ENV, tv.Player(tv.Agent.RANDOM), tv.Player(tv.Agent.RANDOM),
                  torch.Generator().manual_seed(3), MctsConfig(), num_games=4,
                  round_limit=30, record=True)
    for rec in res.games[::3]:  # one game of each opening side
        path = trec.save_game(rec, tmp_path)
        want, _ = _replayed_lines(jrec.replay_game, jm.ENV, path, jm.pretty_str)
        got, state = _replayed_lines(trec.replay_game, tm.ENV, path, tm.pretty_str)
        assert got == want
        assert got.count("State after action has been played:") == len(rec.turns) > 0
        if game == "backgammon":
            assert bool(tbg.validate_state(state).all())


@pytest.mark.parametrize("game", ["backgammon", "tictactoe"])
def test_jax_record_replays_in_port(game, tmp_path):
    """A match recorded by the JAX package's arena replays in the port with
    the JAX package's lines."""
    jm, tm = GAMES[game]
    res = jv.play(jm.ENV, None, jv.Player(jv.Agent.RANDOM), jv.Player(jv.Agent.RANDOM),
                  jax.random.PRNGKey(5), JMctsConfig(), num_games=2, round_limit=30,
                  record=True)
    for rec in res.games:
        path = jrec.save_game(rec, tmp_path)
        want, _ = _replayed_lines(jrec.replay_game, jm.ENV, path, jm.pretty_str)
        got, _ = _replayed_lines(trec.replay_game, tm.ENV, path, tm.pretty_str)
        assert got == want
        assert dataclasses.asdict(trec.load_game(path)) == dataclasses.asdict(jrec.load_game(path))


def test_load_all_games_reads_json_files_in_order(tmp_path):
    _, t0, log, winner, _ = lockstep("tictactoe", 3, 9)
    recs = trec.GameRecord.from_arrays(tttt.ENV, tv.Agent.MCTS, tv.Agent.RANDOM, t0, log, winner)
    for r in recs:
        trec.save_game(r, tmp_path)
    (tmp_path / "notes.txt").write_text("not a record")
    (tmp_path / "sub.json").mkdir()
    loaded = trec.load_all_games(tmp_path)
    assert [r.id for r in loaded] == sorted(r.id for r in recs)
    assert [dataclasses.asdict(r) for r in loaded] == \
        [dataclasses.asdict(r) for r in sorted(recs, key=lambda r: r.id)]


@pytest.mark.parametrize("game,n,rounds", [("backgammon", 6, 60), ("tictactoe", 8, 9)])
def test_pretty_str_matches_jax(game, n, rounds):
    jm, tm = GAMES[game]
    *_, seen = lockstep(game, n, rounds, seed=1)
    for js, ts in seen:
        for g in range(n):
            jstate = jax.tree_util.tree_map(lambda x: x[g], js)
            assert tm.pretty_str(ts, g) == jm.pretty_str(jstate)


def test_validate_state_matches_jax_on_the_invariant_cases():
    """``tests/test_invariants.py``'s cases in one batch: the initial
    state, the three broken ones, and random legal play."""
    js = jax.vmap(jbg.init)(jnp.arange(4, dtype=jnp.uint32))
    js = js.replace(board=js.board.at[1, 0].add(1),
                    off=js.off.at[2].set(jnp.array([16, 0], jnp.int32)),
                    roll=js.roll.at[3].set(jnp.array([0, 3], jnp.int32)))
    ts = tbg.make_state(*(np.array(getattr(js, f)) for f in
                          ("board", "bar", "off", "roll", "player")),
                        second=np.array(js.second), seed=np.array(js.seed).astype(np.int64),
                        cnt=np.array(js.cnt), device="cpu")
    got = tbg.validate_state(ts)
    assert got.tolist() == [True, False, False, False]
    np.testing.assert_array_equal(got.numpy(), np.asarray(_J_VALIDATE(js)))
    *_, seen = lockstep("backgammon", 6, 60, seed=2)
    for js, ts in seen:
        want = np.asarray(_J_VALIDATE(js))
        np.testing.assert_array_equal(tbg.validate_state(ts).numpy(), want)
        assert want.all()


def test_is_draw_matches_jax():
    *_, seen = lockstep("tictactoe", 16, 9, seed=3)
    for js, ts in seen:
        np.testing.assert_array_equal(tttt.is_draw(ts).numpy(),
                                      np.asarray(jax.vmap(jttt.is_draw)(js)))
    assert tttt.is_draw(seen[-1][1]).any()


def _simulate(m, true_elo, names, games=4000, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            p = m.expected_score(true_elo[a], true_elo[b])
            wins_a = int(rng.binomial(games, p))
            out.append(m.MatchResult(a, b, wins_a, games - wins_a))
    return out


def _rung(m, max_games, min_games, updates):
    seq = m.SequentialRung(max_games, min_games=min_games)
    steps = [seq.update(w, n) for w, n in updates]
    return steps, seq.verdict, seq.games, seq.ci, seq.winrate, seq.done


_LADDER = [
    {"metric": "strength_ladder", "model": "runs/bg_full/models/backgammon/model_34",
     "rung": "mcts400", "games": 128, "wins": 70, "losses": 55, "draws": 3,
     "model_sims": 100, "round_limit": 300},
    {"metric": "strength_ladder", "model": "runs/bg_full/models/backgammon/model_34",
     "rung": "random", "games": 128, "wins": 128, "losses": 0, "draws": 0,
     "model_sims": 100, "round_limit": 300},
    {"metric": "something_else"},
    {"metric": "strength_ladder", "model": "runs/bg_full/models/backgammon/best",
     "name": "model_11", "rung": "mcts100", "games": 32, "wins": 26, "losses": 6,
     "draws": 0, "model_sims": 100},
]
_EXISTING = [
    {"metric": "elo_match", "player_a": "model_34", "player_b": "random", "wins_a": 127,
     "wins_b": 1, "draws": 0, "games": 128, "model_sims": 100},
    {"metric": "elo_summary", "note": "no player keys at all"},
]


def _ladder(m):
    skipped = []
    return m.ladder_rows_to_match_records(_LADDER + _LADDER[:1], _EXISTING,
                                          skipped=skipped), skipped


ELO_CASES = {
    "recovers_known_ratings": lambda m: m.compute_elo(
        _simulate(m, {"random": 0.0, "mid": 200.0, "strong": 450.0},
                  ["random", "mid", "strong"]), anchor="random"),
    "ordering_and_anchor": lambda m: m.compute_elo(
        [m.MatchResult("a", "b", 75, 25), m.MatchResult("b", "c", 75, 25),
         m.MatchResult("a", "c", 90, 10)], anchor="a", anchor_rating=1000.0),
    "draws_count_half": lambda m: m.compute_elo([m.MatchResult("a", "b", 0, 0, draws=100)],
                                                anchor="a"),
    "empty": lambda m: m.compute_elo([]),
    "expected_score": lambda m: [m.expected_score(a, b) for a in (0.0, 120.0, -35.5)
                                 for b in (0.0, 120.0, 800.0)],
    "matches_from_records": lambda m: [
        (dataclasses.asdict(x), x.games, x.score_a) for x in m.matches_from_records(
            [{"player_a": "m1", "player_b": "random", "wins_a": 60, "wins_b": 30,
              "draws": 10, "extra": "ignored"}])],
    "bootstrap_decisive": lambda m: m.bootstrap_elo(
        _simulate(m, {"random": 0.0, "weak": 200.0, "strong": 500.0},
                  ["random", "weak", "strong"], games=800, seed=3),
        anchor="random", n_boot=40, seed=1),
    "bootstrap_even": lambda m: m.bootstrap_elo(
        [m.MatchResult("m6", "random", 63, 1), m.MatchResult("m12", "random", 62, 2),
         m.MatchResult("m6", "m12", 35, 29)], anchor="random", n_boot=40, seed=2),
    "wilson95": lambda m: [m.wilson95(s, n) for s, n in ((0, 0), (40, 64), (3, 32), (32, 32))],
    "sequential_rung": lambda m: [
        _rung(m, 128, 32, [(30, 32)]), _rung(m, 128, 32, [(3, 32)]),
        _rung(m, 128, 32, [(16, 32)] * 4), _rung(m, 128, 32, [(16, 16), (16, 16)]),
        _rung(m, 64, 32, [(40, 64)])],
    "ladder_rows_to_match_records": _ladder,
}


@pytest.mark.parametrize("case", sorted(ELO_CASES))
def test_elo_matches_jax(case):
    assert ELO_CASES[case](telo) == ELO_CASES[case](jelo)
