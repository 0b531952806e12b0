"""The port's arena and gate against the JAX package's.

Match set-up and the round step are integer work on states that both
packages derive from the same seeds and actions, so they are compared
bit for bit, field by field.  The gate's statistics and decisions are
pure Python and are compared exactly; its match is replaced by a
deterministic stand-in, as in ``tests/test_gate_sequential.py``.  The
dual evaluation selects whole rows, so it is compared bit for bit against
the single evaluations it selects from, and against JAX's within 1e-4
(float32 convolutions summed in different orders, as in
``tests/test_torch_resnet.py``).  Random agents, pure-rollout playouts and
move sampling draw from generators the two frameworks do not share, so
whole matches are checked for their invariants and for what the mcts
agent must do (beat random on tic-tac-toe).  ``get_next_move``'s search
takes no random draw without Dirichlet noise, so its visit probabilities
are compared with the JAX search's exactly, on a small flax net carried
across with ``nets/convert.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.arena import versus as jv
from die_e_tpu.core.config import ArenaConfig as JArenaConfig
from die_e_tpu.core.config import MctsConfig as JMctsConfig
from die_e_tpu.envs import backgammon as jbg
from die_e_tpu.envs import tictactoe as jttt
from die_e_tpu.nets import resnet as jnet
from die_e_tpu.search import alpha as jalpha
from die_e_tpu.train import gating as jg
from die_e_tpu.train.learner import net_eval_fn as j_net_eval_fn
from die_e_tpu_torch.arena import versus as tv
from die_e_tpu_torch.core.config import ArenaConfig, MctsConfig
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.nets import resnet as tnet
from die_e_tpu_torch.nets.convert import flax_to_state_dict
from die_e_tpu_torch.search import alpha as talpha
from die_e_tpu_torch.search import simple as tsimple
from die_e_tpu_torch.train import checkpoint as tckpt
from die_e_tpu_torch.train import gating as tg
from die_e_tpu_torch.train.learner import net_eval_fn

SMALL = dataclasses.replace(tttt.SPEC, n_filters=8, n_res_blocks=1)
J_SMALL = dataclasses.replace(jttt.SPEC, n_filters=8, n_res_blocks=1)
GAMES = {"backgammon": (jbg.ENV, tbg.ENV), "tictactoe": (jttt.ENV, tttt.ENV)}
_J_RANDOM_ACTIONS = jax.jit(jv._random_actions, static_argnums=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def assert_same_states(js, ts):
    for f in dataclasses.fields(ts):
        got = getattr(ts, f.name).numpy()
        want = np.asarray(getattr(js, f.name))
        if f.name == "seed":  # the port holds the uint32 seed in int64
            got = got.astype(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f.name)


class TestBinomAndSequentialGate:
    @pytest.mark.parametrize("n", [1, 7, 40, 100, 300])
    def test_binom_sf_ge_matches_jax(self, n):
        for k in range(-1, n + 2):
            for p in (0.0, 0.2, 0.45, 0.55, 0.9, 1.0):
                assert tg._binom_sf_ge(k, n, p) == jg._binom_sf_ge(k, n, p), (k, n, p)

    @pytest.mark.parametrize("num_games,block", [(400, 100), (100, 100), (40, 7)])
    def test_sequential_gate_matches_jax_on_a_grid(self, num_games, block):
        """Every block outcome (wins in the block) from every reachable
        running total, fed to both rules."""
        rng = np.random.default_rng(num_games + block)
        for _ in range(60):
            p = rng.random()
            a, b = tg.SequentialGate(num_games, 0.55), jg.SequentialGate(num_games, 0.55)
            games = 0
            while a.decision is None or b.decision is None:
                n = min(block, num_games - games)
                wins = int(rng.binomial(n, p))
                assert a.update(wins, n) == b.update(wins, n)
                games += n
            assert (a.decision, a.wins, a.games, a.winrate) == \
                (b.decision, b.wins, b.games, b.winrate)

    def test_exhaustion_is_the_fixed_rule(self):
        for w in range(41):
            assert tg.SequentialGate(40, 0.55).update(w, 40) == \
                ("promote" if w / 40 >= 0.55 - 1e-12 else "keep")


@pytest.mark.parametrize("game", ["backgammon", "tictactoe"])
@pytest.mark.parametrize("num_games", [8, 7])
def test_init_match_and_apply_round_match_jax(game, num_games):
    """The same seeds and then JAX's random actions, round by round: every
    state field and the done flags equal."""
    jenv, tenv = GAMES[game]
    r_seed = jax.random.PRNGKey(num_games)
    js = jv._init_match(jenv, r_seed, num_games)
    seeds = np.asarray(jax.random.randint(
        r_seed, (num_games,), 0, jnp.iinfo(jnp.int32).max).astype(jnp.uint32))
    ts = tv._init_match(tenv, torch.tensor(seeds.astype(np.int64)))
    assert_same_states(js, ts)
    jdone = jax.vmap(jenv.done)(js)
    tdone = tenv.done(ts)
    rng = jax.random.PRNGKey(100 + num_games)
    for _ in range(12):
        rng, r = jax.random.split(rng)
        action = _J_RANDOM_ACTIONS(jenv, js, r)
        js, jdone = jv._apply_round(jenv, js, jdone, action)
        ts, tdone = tv._apply_round(tenv, ts, tdone, torch.tensor(np.asarray(action)))
        assert_same_states(js, ts)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def test_half_the_games_open_on_a_skipped_turn():
    ts = tv._init_match(tttt.ENV, torch.arange(6))
    assert tttt.ENV.player(ts).tolist() == [-1, -1, -1, 1, 1, 1]


def _nets(seeds=(10, 11)):
    """JAX variables and the port's nets holding them."""
    jn = jnet.make_net(J_SMALL)
    out = []
    for s in seeds:
        v = jnet.init_params(jn, jax.random.PRNGKey(s))
        net = tnet.PolicyValueNet(SMALL)
        net.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v)))
        out.append((v, net))
    return jn, out


def test_dual_eval_selects_rows():
    jn, [(v1, n1), (v2, n2)] = _nets()
    obs = np.random.default_rng(0).normal(size=(6, *SMALL.obs_shape)).astype(np.float32)
    use1 = np.array([True, False, True, False, False, True])
    e1, e2 = net_eval_fn(n1), net_eval_fn(n2)
    p, v = tv.dual_eval_fn(e1, e2, torch.tensor(use1))(torch.tensor(obs))
    p1, v1_ = e1(torch.tensor(obs))
    p2, v2_ = e2(torch.tensor(obs))
    for b in range(6):
        want_p, want_v = (p1, v1_) if use1[b] else (p2, v2_)
        assert torch.equal(p[b], want_p[b]) and torch.equal(v[b], want_v[b])
    jp, jv_ = jv.dual_eval_fn(j_net_eval_fn(jn))((v1, v2, jnp.asarray(use1)), jnp.asarray(obs))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-4, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv_), atol=1e-4, rtol=0)


def test_model_vs_model_runs_one_search_per_round(monkeypatch):
    """One dual search a round, whose evaluations are [B] rows aligned with
    the match batch, and whose descent levels the result reports."""
    _, [(_, n1), (_, n2)] = _nets()
    seen, searches, levels = [], [], []
    real = tv.alpha_search

    def counting(env, eval_fn, states, gen, **kw):
        def fn(obs):
            seen.append(obs.shape[0])
            return eval_fn(obs)
        res = real(env, fn, states, gen, **kw)
        searches.append(1)
        levels.append(res.levels)
        return res

    monkeypatch.setattr(tv, "alpha_search", counting)
    res = tv.play(tttt.ENV, tv.Player(tv.Agent.MODEL, net_eval_fn(n1)),
                  tv.Player(tv.Agent.MODEL, net_eval_fn(n2)),
                  torch.Generator().manual_seed(0), MctsConfig(iterations=4),
                  num_games=6, round_limit=9)
    assert len(searches) == res.rounds > 0
    assert set(seen) == {6}
    assert res.levels == sum(levels) > 0
    assert res.wins_p1 + res.wins_p2 + res.draws == 6


def test_random_match_counts_and_round_limit_draws():
    res = tv.play(tttt.ENV, tv.Player(tv.Agent.RANDOM), tv.Player(tv.Agent.RANDOM),
                  torch.Generator().manual_seed(1), MctsConfig(), num_games=16,
                  round_limit=9)
    assert res.wins_p1 + res.wins_p2 + res.draws == 16 and res.winrate == res.wins_p1 / 16
    # two rounds cannot finish a game: all draws
    res = tv.play(tbg.ENV, tv.Player(tv.Agent.RANDOM), tv.Player(tv.Agent.RANDOM),
                  torch.Generator().manual_seed(1), MctsConfig(), num_games=4,
                  round_limit=2)
    assert (res.draws, res.rounds, res.winrate) == (4, 2, 0.0)


MCTS_CFG = MctsConfig(iterations=8, simulate_round_limit=9)


def test_mcts_beats_random():
    res = tv.play(tttt.ENV, tv.Player(tv.Agent.MCTS), tv.Player(tv.Agent.RANDOM),
                  torch.Generator().manual_seed(2), MCTS_CFG, num_games=16, round_limit=9)
    assert res.wins_p1 + res.wins_p2 + res.draws == 16
    assert res.wins_p1 > res.wins_p2
    assert res.mcts_searches == res.rounds and res.levels == 0


def test_half_the_games_open_on_a_skipped_turn_when_recorded():
    """Player 1 (mcts, side -1) opens the first half, player 2 (random)
    the second; each record's turns replay to its game's end."""
    res = tv.play(tttt.ENV, tv.Player(tv.Agent.MCTS), tv.Player(tv.Agent.RANDOM),
                  torch.Generator().manual_seed(1), MCTS_CFG, num_games=8, round_limit=9,
                  record=True)
    assert len(res.games) == 8
    assert [g.turns[0].player for g in res.games] == ["mcts"] * 4 + ["random"] * 4
    for g in res.games:
        assert (g.game, g.player1, g.player2) == ("tictactoe", "mcts", "random")
        assert all(t.roll is None for t in g.turns)
        assert [t.player for t in g.turns[:2]] != [g.turns[0].player] * 2  # sides alternate
    tally = [g.winner for g in res.games]
    assert (tally.count("mcts"), tally.count("random"), tally.count("none")) == \
        (res.wins_p1, res.wins_p2, res.draws)


def test_mcts_settings_reach_the_search(monkeypatch):
    """The config's iterations, c and playout cap reach the search; two
    mcts agents share one search a round."""
    seen = []
    real = tv.simple_search

    def spy(env, states, gen, **kw):
        seen.append(kw)
        return real(env, states, gen, **kw)

    monkeypatch.setattr(tv, "simple_search", spy)
    res = tv.play(tttt.ENV, tv.Player(tv.Agent.MCTS), tv.Player(tv.Agent.MCTS),
                  torch.Generator().manual_seed(0), MCTS_CFG, num_games=4, round_limit=3)
    assert len(seen) == res.mcts_searches == res.rounds == 3
    # without the overrides (None) the config's settings reach the search
    assert seen[0] == dict(iterations=MCTS_CFG.iterations, c=MCTS_CFG.c,
                           simulate_round_limit=MCTS_CFG.simulate_round_limit,
                           rollout_limit=None)


@pytest.mark.parametrize("path", ["plain", "recorded", "compacted"])
def test_mcts_overrides_reach_the_pure_rollout_agent_only(monkeypatch, path):
    """Model against mcts with ``mcts_iterations=5`` and
    ``mcts_rollout_limit=2``: the mcts agent's tree has capacity 6 and its
    playouts stop after 2 steps (playouts from tic-tac-toe's opening
    cannot end sooner), while the model searches with the config's
    iterations; on the recorded and the compacted path as on the plain
    one."""
    _, [(_, n1)] = _nets((3,))
    trees, playouts, model_iters = [], [], []
    real_tree, real_rollout, real_alpha = (tsimple.simple_search_tree, tsimple._rollout,
                                           tv.alpha_search)

    def tree_spy(*a, **k):
        out = real_tree(*a, **k)
        trees.append((out[0].capacity, out[0].batch_size))
        return out

    def rollout_spy(env, states, gen, player, sim_limit):
        steps = []

        def step(s, action):
            steps.append(1)
            return env.step(s, action)

        out = real_rollout(dataclasses.replace(env, step=step), states, gen, player, sim_limit)
        playouts.append(len(steps))
        return out

    def alpha_spy(env, eval_fn, states, gen, **kw):
        model_iters.append(kw["iterations"])
        return real_alpha(env, eval_fn, states, gen, **kw)

    monkeypatch.setattr(tsimple, "simple_search_tree", tree_spy)
    monkeypatch.setattr(tsimple, "_rollout", rollout_spy)
    monkeypatch.setattr(tv, "alpha_search", alpha_spy)
    res = tv.play(tttt.ENV, tv.Player(tv.Agent.MODEL, net_eval_fn(n1)),
                  tv.Player(tv.Agent.MCTS), torch.Generator().manual_seed(0), MCTS_CFG,
                  num_games=8, round_limit=9, record=path == "recorded",
                  compact=path == "compacted", min_batch=2,
                  mcts_iterations=5, mcts_rollout_limit=2)
    assert res.wins_p1 + res.wins_p2 + res.draws == 8
    assert len(trees) == res.mcts_searches == res.rounds == len(model_iters) > 0
    assert {cap for cap, _ in trees} == {6}
    assert min(b for _, b in trees) < 8 if path == "compacted" else {b for _, b in trees} == {8}
    assert len(playouts) == 5 * res.mcts_searches
    assert max(playouts) == 2
    assert set(model_iters) == {MCTS_CFG.iterations}
    if path == "recorded":
        assert len(res.games) == 8


@pytest.mark.parametrize("negamax", [False, True])
def test_get_next_move_matches_jax_visit_probs(monkeypatch, negamax):
    """A small flax net carried across: with no Dirichlet noise the one-game
    search gives JAX's visit probabilities, and the move is in their
    support; a finished game gives the noop."""
    jn, [(v1, n1)] = _nets((7,))
    js, ts = ttt_roots_one()
    kw = dict(iterations=24, c=2.0, dirichlet_epsilon=0.0, negamax=negamax)
    found = []
    real = talpha.alpha_search

    def spy(*a, **k):
        found.append(real(*a, **k))
        return found[-1]

    monkeypatch.setattr(talpha, "alpha_search", spy)
    for g in range(js.board.shape[0]):
        jstate = jax.tree_util.tree_map(lambda x: x[g:g + 1], js)
        jres = jalpha.alpha_search(jttt.ENV, j_net_eval_fn(jn), v1, jstate,
                                   jax.random.PRNGKey(g), **kw)
        move = talpha.get_next_move(tttt.ENV, net_eval_fn(n1), ts, torch.Generator().manual_seed(g),
                                    game=g, temperature=1.25, **kw)
        probs = found[-1].visit_probs[0]
        np.testing.assert_array_equal(probs.numpy(), np.asarray(jres.visit_probs[0]))
        if probs.sum() > 0:
            assert probs[move] > 0
        else:
            assert move == tttt.NOOP_ACTION
    assert move == tttt.NOOP_ACTION  # the last root is won


def ttt_roots_one():
    """Tic-tac-toe roots for one-game searches: empty, mid-game, a won game
    last."""
    boards = np.array([[0] * 9, [-1, 0, 0, 0, 1, 0, 0, 0, 0],
                       [-1, -1, 0, 1, 1, 0, 0, 0, 0], [-1, -1, -1, 1, 1, 0, 0, 0, 0]], np.int32)
    players = np.array([-1, -1, -1, 1], np.int32)
    return (jttt.TttState(board=jnp.asarray(boards), player=jnp.asarray(players)),
            tttt.TttState(board=torch.tensor(boards), player=torch.tensor(players)))


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("winrate", [0.7, 0.55, 0.5, 0.45, 0.2])
def test_gate_decisions_match_jax(tmp_path, monkeypatch, sequential, winrate):
    """A stand-in match that wins ``winrate`` of its games: both gates make
    the same calls, log the same verdict and promote alike."""
    jn, [(v1, n1), (v2, n2)] = _nets()
    from die_e_tpu.train import checkpoint as jckpt

    jbase, tbase = tmp_path / "j", tmp_path / "t"
    jckpt.save_variables(v2, jckpt.best_model_path("tictactoe", str(jbase)))
    tckpt.save_variables(n2.state_dict(), tckpt.best_model_path("tictactoe", str(tbase)))

    def stand_in(result_cls, agent, calls):
        def fake(*args, num_games, **kw):
            calls.append(num_games)
            wins = int(round(winrate * num_games))
            return result_cls(player1=agent, player2=agent, wins_p1=wins,
                              wins_p2=num_games - wins, draws=0, n_games=num_games,
                              winrate=wins / num_games, **({"games": []} if result_cls
                                                            is jv.PlayResult else {}))
        return fake

    class Log(list):
        def log(self, event, **kw):
            self.append((event, kw))

    jcalls, tcalls, jlog, tlog = [], [], Log(), Log()
    monkeypatch.setattr(jg, "play", stand_in(jv.PlayResult, jv.Agent.MODEL, jcalls))
    monkeypatch.setattr(tg, "play", stand_in(tv.PlayResult, tv.Agent.MODEL, tcalls))
    kw = dict(num_games=400, round_limit=9, gate_sequential=sequential, gate_block=100)
    jp = jg.gate(jttt.ENV, j_net_eval_fn(jn), v1, jax.random.PRNGKey(0),
                 JMctsConfig(iterations=2), JArenaConfig(**kw), temperature=1.25,
                 models_base=str(jbase), metrics=jlog)
    tp = tg.gate(tttt.ENV, n1, torch.Generator().manual_seed(0), MctsConfig(iterations=2),
                 ArenaConfig(**kw), temperature=1.25, models_base=str(tbase), metrics=tlog)
    assert tp == jp and tcalls == jcalls
    assert tlog == jlog
    best = tckpt.restore_variables(tckpt.best_model_path("tictactoe", str(tbase)),
                                   tnet.PolicyValueNet(SMALL))
    assert torch.equal(best.stem_conv.weight, (n1 if tp else n2).stem_conv.weight)


def test_gate_without_best_promotes_at_once(tmp_path):
    _, [(_, n1)] = _nets((3,))
    events = []

    class Log:
        def log(self, event, **kw):
            events.append((event, kw))

    assert tg.gate(tttt.ENV, n1, torch.Generator().manual_seed(0), MctsConfig(),
                   ArenaConfig(), 1.25, str(tmp_path), Log())
    assert events == [("gate", {"result": "no_best_promoted"})]
    best = tckpt.restore_variables(tckpt.best_model_path("tictactoe", str(tmp_path)),
                                   tnet.PolicyValueNet(SMALL))
    assert torch.equal(best.stem_conv.weight, n1.stem_conv.weight)


def test_gate_real_arena_between_identical_nets_keeps_best(tmp_path):
    """No stand-in: tiny identical nets through the real arena, sequential
    gate in blocks; every game of two rounds is a draw."""
    _, [(_, n1)] = _nets((5,))
    tckpt.save_variables(n1.state_dict(), tckpt.best_model_path("tictactoe", str(tmp_path)))
    promoted = tg.gate(tttt.ENV, n1, torch.Generator().manual_seed(0),
                       MctsConfig(iterations=4),
                       ArenaConfig(num_games=16, round_limit=2, gate_sequential=True,
                                   gate_block=8),
                       temperature=1.25, models_base=str(tmp_path))
    assert promoted is False
