"""The port's learning checks and parity sweep against the JAX package's
scripts.

``ttt_learning_check`` and ``bg_learning_demo`` build the same config and
play the same final match as the JAX scripts (checked with ``learn`` and
``play`` stubbed on both sides, exactly), and run to their end on the CPU
at tiny cuts (a 32x2 net swapped into the game's env, a few games and
simulations): the structure of what they print and write is checked, not
the rate.  ``parity_sweep`` on the CPU gives zero mismatches against the
C++ oracle, and its per-game action hashes, winners and move counts equal
the JAX sweep's ``jax_side`` bit for bit (integer work).
"""

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu_torch.arena.versus import Agent, PlayResult
from die_e_tpu_torch.envs import backgammon as tbg
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.scripts import bg_learning_demo as tbgdemo
from die_e_tpu_torch.scripts import parity_sweep as tsweep
from die_e_tpu_torch.scripts import ttt_learning_check as tttcheck
from parity import oracle

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_run(monkeypatch, mod, call, port: bool):
    """Run ``call`` with ``mod``'s learn and play stubbed; returns (the
    config learn got, play's settings)."""
    seen = {}

    def learn(env, config, seed, data_base, models_base, metrics, **kw):
        seen["learn"] = (env.spec.name, dataclasses.asdict(config), seed,
                         Path(data_base).name, Path(models_base).name)
        return SimpleNamespace(net=None, variables=None)

    def play(env, *a, **kw):
        p1, p2, cfg = (a[0], a[1], a[3]) if port else (a[1], a[2], a[4])
        seen["play"] = (env.spec.name, p1.kind.value, p2.kind.value,
                        dataclasses.asdict(cfg), kw["temperature"], kw["num_games"],
                        kw["round_limit"])
        return PlayResult(Agent.MODEL, Agent.RANDOM, 3, 1, 0, 4, 0.75)

    monkeypatch.setattr(mod, "learn", learn)
    monkeypatch.setattr(mod, "play", play)
    if port:
        monkeypatch.setattr(mod, "net_eval_fn", lambda net: None)
    call()
    return seen


@pytest.mark.parametrize("name,port_mod", [("ttt_learning_check", tttcheck),
                                           ("bg_learning_demo", tbgdemo)])
def test_config_and_final_match_match_jax(monkeypatch, capsys, tmp_path, name, port_mod):
    jmod = jax_script(name)
    want = _stub_run(monkeypatch, jmod, lambda: jmod.main(str(tmp_path)), port=False)
    got = _stub_run(monkeypatch, port_mod,
                    lambda: port_mod.main([str(tmp_path), "--device", "cpu"]), port=True)
    assert got == want and set(got) == {"learn", "play"}
    out = capsys.readouterr().out
    assert out.count("Wins Player 1: 3") == 2


def _small(monkeypatch, env_mod):
    """A 32x2 net for the game: the scripts read ``env_mod.ENV``."""
    spec = dataclasses.replace(env_mod.SPEC, n_filters=32, n_res_blocks=2)
    monkeypatch.setattr(env_mod, "ENV", dataclasses.replace(env_mod.ENV, spec=spec))


def _tally(out):
    return {k: int(re.search(rf"{k}: (\d+)", out).group(1))
            for k in ("Wins Player 1", "Wins Player 2", "Draws", "Number of Games")}


def test_ttt_learning_check_runs_to_its_end(monkeypatch, capsys, tmp_path):
    _small(monkeypatch, tttt)
    rc = tttcheck.main([str(tmp_path), "--device", "cpu"], iterations=4, games=8,
                       learn_iterations=2, self_play_iterations=1)
    out = capsys.readouterr().out
    tally = _tally(out)
    assert tally["Number of Games"] == 400
    assert tally["Wins Player 1"] + tally["Wins Player 2"] + tally["Draws"] == 400
    rate = float(re.search(r"NON-LOSS RATE vs random: ([0-9.]+) \(target > 0.95\)",
                           out).group(1))
    assert rate == pytest.approx((tally["Wins Player 1"] + tally["Draws"]) / 400, abs=5e-4)
    assert rc == (0 if rate > 0.95 else 1)
    models = tmp_path / "models" / "tictactoe"
    for m in ("model_0", "model_1", "best", "latest_state"):
        assert (models / m).is_dir(), m
    assert json.loads((models / "latest_meta.json").read_text())["next_learn_iter"] == 2
    (run,) = (tmp_path / "data" / "tictactoe").iterdir()
    assert sorted(p.name for p in run.iterdir()) == ["lrn-0", "lrn-1"]


def test_bg_learning_demo_runs_to_its_end(monkeypatch, capsys, tmp_path):
    _small(monkeypatch, tbg)
    assert tbgdemo.main([str(tmp_path), "--device", "cpu"], iterations=4, games=4,
                        learn_iterations=1, round_limit=2) == 0
    out = capsys.readouterr().out
    assert "--- model vs random ---" in out
    tally = _tally(out)
    # two rounds end no backgammon game: all draws
    assert tally == {"Wins Player 1": 0, "Wins Player 2": 0, "Draws": 128,
                     "Number of Games": 128}
    models = tmp_path / "models" / "backgammon"
    assert (models / "model_0").is_dir() and (models / "best").is_dir()
    (run,) = (tmp_path / "data" / "backgammon").iterdir()
    assert (run / "lrn-0" / "sp-0" / "memory.npz").exists()


def test_parity_sweep_matches_the_oracle_and_jax(capsys):
    n, max_steps = 16, 400
    seeds = tsweep.game_seeds(n)
    jsweep = jax_script("parity_sweep")
    np.testing.assert_array_equal(seeds, np.arange(1, n + 1, dtype=np.uint32)
                                  * np.uint32(2654435761))
    h_j, w_j, m_j = map(np.asarray, jsweep.jax_side(jnp.asarray(seeds), max_steps))
    h_d, w_d, m_d = tsweep.device_side(seeds, max_steps, torch.device("cpu"))
    np.testing.assert_array_equal(h_d, h_j)
    np.testing.assert_array_equal(w_d, w_j)
    np.testing.assert_array_equal(m_d, m_j)
    h_o, w_o, m_o = tsweep.oracle_side(seeds, max_steps)
    np.testing.assert_array_equal(h_o, h_j)
    np.testing.assert_array_equal(w_o, w_j)
    np.testing.assert_array_equal(m_o, m_j)
    # the oracle's hash, step by step as the JAX script computes it
    for i in (0, n - 1):
        h = np.uint32(0)
        for t, a in enumerate(oracle.run_trajectory(int(seeds[i]), max_steps)["actions"]):
            if a < 0:
                break
            h = jsweep._mix_np(np.uint32(int(h) ^ (t * 1353 + int(a))))
        assert h == h_o[i]
    assert (w_d != 0).all() and m_d.max() < max_steps  # every game ended
    assert tsweep.main([str(n), str(max_steps), "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"games={n} max_steps={max_steps} finished={n} longest=")
    assert "mismatches=0 " in line


def test_parity_sweep_reports_a_mismatch(monkeypatch, capsys):
    real = tsweep.device_side

    def off_by_one(seeds, max_steps, device):
        h, w, m = real(seeds, max_steps, device)
        m = m.copy()
        m[2] += 1
        return h, w, m

    monkeypatch.setattr(tsweep, "device_side", off_by_one)
    assert tsweep.main(["4", "400", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH game 2 seed" in out and "mismatches=1 " in out
