"""The port's learn loop and CLI on tic-tac-toe, on the CPU.

The scenarios of ``tests/test_learn_loop.py`` (artifacts, resume
numbering, fallback after a torn ``latest_state``, a pending gate re-run)
and of ``tests/test_cli.py`` (learn, train, play), on the port's single
device path with ``device="cpu"``.  The learn loop's randomness is the
port's own, so runs are checked for their artifacts, events and resume
behaviour; the CLI is held against the JAX package's on the artifact
layout and the JSONL events it writes.  The learn-loop scenarios use an
8x1 net to stay fast; the CLI runs the game's own 64x4 net.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from die_e_tpu_torch.cli.main import build_parser, main
from die_e_tpu_torch.core.config import (
    AlphaZeroConfig,
    ArenaConfig,
    Config,
    MctsConfig,
    OptimizerParams,
)
from die_e_tpu_torch.core.metrics import Metrics
from die_e_tpu_torch.envs import tictactoe as tttt
from die_e_tpu_torch.train import replay as treplay
from die_e_tpu_torch.train.learn import learn

ENV = dataclasses.replace(tttt.ENV, spec=dataclasses.replace(tttt.SPEC, n_filters=8,
                                                              n_res_blocks=1))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cfg(total_iters=1, batch=256):
    return Config(
        mcts=MctsConfig(iterations=4, simulate_round_limit=9),
        alphazero=AlphaZeroConfig(learn_iterations=total_iters, self_play_iterations=1,
                                  num_epochs=1, training_batch_size=batch,
                                  num_self_play_batches=8),
        optimizer=OptimizerParams(),
        arena=ArenaConfig(num_games=8, round_limit=9),
    )


def run(tmp_path, config, jsonl=None, **kw):
    metrics = Metrics(quiet=True, jsonl_path=str(jsonl) if jsonl else None)
    return learn(ENV, config, seed=0, data_base=str(tmp_path / "data"),
                 models_base=str(tmp_path / "models"), metrics=metrics,
                 device="cpu", **kw)


def events(jsonl):
    return [json.loads(line) for line in Path(jsonl).read_text().splitlines()]


def models(tmp_path):
    return tmp_path / "models" / "tictactoe"


def meta(tmp_path):
    return json.loads((models(tmp_path) / "latest_meta.json").read_text())


def tear(path):
    """A torn full-state checkpoint: its file cut short."""
    f = path / "state.pt"
    f.write_bytes(f.read_bytes()[:64])


def test_learn_produces_artifacts_and_events(tmp_path):
    jsonl = tmp_path / "e.jsonl"
    state = run(tmp_path, cfg(total_iters=2), jsonl)
    runs = list((tmp_path / "data" / "tictactoe").iterdir())
    assert len(runs) == 1
    for i in range(2):
        assert (runs[0] / f"lrn-{i}" / "sp-0" / "memory.npz").exists()
        assert (models(tmp_path) / f"model_{i}" / "variables.pt").exists()
    assert (models(tmp_path) / "best" / "variables.pt").exists()
    assert (models(tmp_path) / "latest_state" / "state.pt").exists()
    assert meta(tmp_path) == {"run_id": runs[0].name.removeprefix("run-"),
                              "next_learn_iter": 2}
    for p in state.net.parameters():
        assert torch.isfinite(p).all()
    assert not state.net.training
    ev = events(jsonl)
    names = [e["event"] for e in ev]
    assert names[:2] == ["run_start", "model_bootstrap"]
    gates = [e for e in ev if e["event"] == "gate"]
    assert gates[0]["result"] == "no_best_promoted"
    assert gates[1]["result"] in ("promoted", "best_kept", "inconclusive_kept")
    assert "arena_match" in names
    sp = [e for e in ev if e["event"] == "self_play"]
    assert sp[0]["wins_m1"] + sp[0]["wins_p1"] + sp[0]["draws"] == 8
    # 16384 bucket rows / 256 a batch: 64 steps an epoch, one epoch each
    assert state.step == 2 * 64
    epochs = [e for e in ev if e["event"] == "train_epoch"]
    assert len(epochs) == 2 and all(np.isfinite(e["loss"]) for e in epochs)


def test_resume_continues_iteration_numbering(tmp_path):
    run(tmp_path, cfg(1))
    assert meta(tmp_path)["next_learn_iter"] == 1
    jsonl = tmp_path / "e.jsonl"
    state = run(tmp_path, cfg(2), jsonl, resume=True)
    runs = list((tmp_path / "data" / "tictactoe").iterdir())
    assert len(runs) == 1
    assert (runs[0] / "lrn-1" / "sp-0" / "memory.npz").exists()
    assert (models(tmp_path) / "model_1").exists()
    m = meta(tmp_path)
    assert m == {"run_id": runs[0].name.removeprefix("run-"), "next_learn_iter": 2}
    ev = events(jsonl)
    assert ev[0]["start_iter"] == 1
    boot = next(e for e in ev if e["event"] == "model_bootstrap")
    assert boot["source"].endswith("latest_state (full train state)")
    assert state.step == 2 * 64  # the optimizer went on from the restored state


def test_resume_falls_back_to_newest_model_when_latest_state_torn(tmp_path):
    run(tmp_path, cfg(1))
    tear(models(tmp_path) / "latest_state")
    jsonl = tmp_path / "e.jsonl"
    state = run(tmp_path, cfg(2), jsonl, resume=True)
    ev = events(jsonl)
    boot = next(e for e in ev if e["event"] == "model_bootstrap")
    assert boot["source"].endswith("model_0 (variables only, fresh optimizer)")
    assert any(e["event"] == "checkpoint_unreadable" for e in ev)
    assert (models(tmp_path) / "model_1").exists()
    assert meta(tmp_path)["next_learn_iter"] == 2
    assert state.step == 64  # fresh optimizer: one epoch's steps


def _pending_gate(tmp_path, torn):
    run(tmp_path, cfg(1))
    # crash site: model_0 and latest_state committed (pending_gate=0), then
    # the gate arena died (and, with ``torn``, latest_state was torn too)
    m = meta(tmp_path)
    m["pending_gate"] = 0
    (models(tmp_path) / "latest_meta.json").write_text(json.dumps(m))
    if torn:
        tear(models(tmp_path) / "latest_state")
    jsonl = tmp_path / "e.jsonl"
    run(tmp_path, cfg(1), jsonl, resume=True)
    ev = events(jsonl)
    names = [e["event"] for e in ev]
    assert "gate_resume" in names
    assert names.index("gate_resume") < names.index("gate")
    assert meta(tmp_path) == {"run_id": m["run_id"], "next_learn_iter": 1}
    return ev


def test_resume_reruns_gate_interrupted_mid_arena(tmp_path):
    ev = _pending_gate(tmp_path, torn=False)
    boot = next(e for e in ev if e["event"] == "model_bootstrap")
    assert boot["source"].endswith("(full train state)")


def test_fallback_resume_still_runs_pending_gate(tmp_path):
    ev = _pending_gate(tmp_path, torn=True)
    boot = next(e for e in ev if e["event"] == "model_bootstrap")
    assert boot["source"].endswith("model_0 (variables only, fresh optimizer)")


def test_learn_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        learn(ENV, cfg(1), metrics=Metrics(quiet=True))


def test_memory_written_by_one_package_loads_in_the_other(tmp_path):
    from die_e_tpu.train import replay as jreplay

    rng = np.random.default_rng(0)
    mem = treplay.Memory(states=rng.integers(-1, 2, (5, 3, 3, 3)).astype(np.float32),
                         ps=rng.random((5, 9)).astype(np.float32),
                         outcomes=np.array([1, -1, 0, 1, -1], np.float32))
    treplay.save_training_data(mem, tmp_path / "a" / "lrn-0" / "sp-0")
    jreplay.save_training_data(jreplay.Memory(mem.states, mem.ps, mem.outcomes),
                               tmp_path / "a" / "lrn-1" / "sp-0")
    for loaded in (jreplay.load_all_training_data(tmp_path / "a"),
                   treplay.load_all_training_data(tmp_path / "a")):
        for f in ("states", "ps", "outcomes"):
            np.testing.assert_array_equal(getattr(loaded, f),
                                          np.concatenate([getattr(mem, f)] * 2))
    with pytest.raises(FileNotFoundError):
        treplay.load_all_training_data(tmp_path / "none")


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_subcommands_and_flags():
    p = build_parser()
    for argv in (["learn"], ["play", "-1", "random", "-2", "model"], ["train"],
                 ["replay", "g.json"]):
        assert p.parse_args(argv).command == argv[0]
    args = p.parse_args(["-c", "cfg.toml", "-g", "tictactoe", "--device", "cpu",
                         "--seed", "3", "--metrics-jsonl", "m.jsonl", "learn", "-m",
                         "model/path", "--resume"])
    assert (args.config, args.game, args.device, args.seed, args.metrics_jsonl,
            args.model_path, args.resume) == ("cfg.toml", "tictactoe", "cpu", 3,
                                              "m.jsonl", "model/path", True)
    assert p.parse_args(["learn"]).device == "cuda"
    args = p.parse_args(["train", "-m", "m", "-o", "o", "-r", "abc", "-l", "2", "-s", "1"])
    assert (args.model_path, args.out_path, args.run_id, args.learn_idx,
            args.sp_idx) == ("m", "o", "abc", "2", "1")
    args = p.parse_args(["play", "-1", "model", "-2", "random", "--model1-path", "m1",
                         "--model2-path", "m2", "--num-games", "10"])
    assert (args.agent_one, args.agent_two, args.model1_path, args.model2_path,
            args.num_games) == ("model", "random", "m1", "m2", 10)
    with pytest.raises(SystemExit):
        p.parse_args(["-g", "chess", "learn"])
    with pytest.raises(SystemExit):
        p.parse_args(["--device", "tpu", "learn"])


@pytest.mark.parametrize("argv,error", [
    (["--mesh-data", "4", "learn"], "must equal the number of processes"),
    (["--coordinator", "host:1234", "learn"], "needs its size: --num-processes"),
    (["--num-processes", "2", "--process-id", "0", "learn"],
     "needs a meeting point: --coordinator"),
])
def test_unported_commands_name_the_roadmap_item(argv, error, tmp_path, monkeypatch):
    """The mesh and cluster flags, once refused as unported, now run; a
    cluster or mesh they leave incomplete or inconsistent raises, naming
    what is missing, before any process joins or trains."""
    monkeypatch.chdir(tmp_path)
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "cfg.toml").write_text(TINY_TOML)
    with pytest.raises(ValueError, match=error):
        main(["--device", "cpu", "-c", "cfg.toml", "-g", "tictactoe", *argv])


@pytest.mark.parametrize("argv", [
    ["play", "-1", "mcts", "-2", "random", "--num-games", "4"],
    ["play", "-1", "random", "-2", "random", "-o", "out", "--num-games", "4"],
    ["replay", "GAME", "--no-wait"],
])
def test_play_mcts_records_and_replay_on_the_cpu(argv, tmp_path, monkeypatch, capsys):
    """The commands the port once refused, run on tic-tac-toe: an mcts
    match, a recorded match, and the replay of one recorded game."""
    from die_e_tpu_torch.arena.records import load_all_games, load_game

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfg.toml").write_text(TINY_TOML)
    base = ["--device", "cpu", "-c", "cfg.toml", "-g", "tictactoe"]
    if argv[0] == "replay":
        assert main(base + ["play", "-1", "mcts", "-2", "random", "-o", "games",
                            "--num-games", "2"]) == 0
        game = sorted((tmp_path / "games").iterdir())[0]
        argv = ["replay", str(game), "--no-wait"]
        capsys.readouterr()
    assert main(base + argv) == 0
    out = capsys.readouterr().out
    if argv[0] == "play":
        kinds = argv[2], argv[4]
        assert f"Player 1: {kinds[0]}\nPlayer 2: {kinds[1]}\n" in out
        assert "Number of Games: 4" in out
    if "-o" in argv:
        assert "saved 4 game records to out" in out
        records = load_all_games(tmp_path / "out")
        assert len(records) == 4 and all(len(r.turns) >= 5 for r in records)
        draws = sum(r.winner == "none" for r in records)
        assert f"Draws: {draws}\n" in out
    if argv[0] == "replay":
        rec = load_game(game)
        assert out.startswith(f"Game ID: {rec.id}\nPlayer 1: mcts, Player 2: random\n")
        assert out.count("State after action has been played:") == len(rec.turns)
        assert out.count("Action: ") == len(rec.turns) >= 5


TINY_TOML = """
temperature = 1.25
learn_iterations = 2
self_play_iterations = 1
num_epochs = 1
training_batch_size = 256
num_self_play_batches = 8
iterations = 4
exploration_const = 2
simulate_round_limit = 9
dirichlet_alpha = 0.3
dirichlet_epsilon = 0.25
wd = 0.0001
lr = 0.001
arena_num_games = 8
arena_round_limit = 9
"""


def _tree(root):
    """The artifact layout: directories and files, checkpoint contents left
    out (orbax and torch.save files differ by design), run id masked."""
    out = set()
    for p in Path(root).rglob("*"):
        rel = p.relative_to(root).parts
        if rel[0] == "models" and len(rel) > 3:
            continue
        out.add("/".join("run-*" if r.startswith("run-") else r for r in rel))
    return out


def _event_shapes(jsonl):
    return [(e["event"], sorted(k for k in e if k != "t")) for e in events(jsonl)]


def test_cli_learn_writes_the_jax_packages_layout_and_events(tmp_path, monkeypatch):
    """Two learn iterations through each package's CLI on the same config:
    the same files and directories, the same events with the same fields;
    then ``--resume`` with a third iteration continues the numbering."""
    from die_e_tpu.cli.main import main as jmain

    cfg_path = tmp_path / "cfg.toml"
    cfg_path.write_text(TINY_TOML)
    for name, fn, extra in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert fn(extra + ["-c", str(cfg_path), "-g", "tictactoe", "--metrics-jsonl",
                           "m.jsonl", "learn"]) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    jax_events = _event_shapes(tmp_path / "jax" / "m.jsonl")
    port_events = _event_shapes(tmp_path / "port" / "m.jsonl")
    # the tests' 8 virtual CPU devices send the JAX run down its mesh
    # branch, which logs a `mesh` event the single-device port has no
    # counterpart for; its self_play event may also carry its hosted loop's
    # timings
    jax_events = [s for s in jax_events if s[0] != "mesh"]
    strip = {"self_play"}
    assert [(e, k) for e, k in port_events if e not in strip] == \
        [(e, k) for e, k in jax_events if e not in strip]
    jsp = [k for e, k in jax_events if e == "self_play"]
    for e, k in port_events:
        if e == "self_play":
            assert set(k) <= set(jsp[0]), set(k) - set(jsp[0])

    (tmp_path / "cfg3.toml").write_text(TINY_TOML.replace("learn_iterations = 2",
                                                          "learn_iterations = 3"))
    assert main(["--device", "cpu", "-c", str(tmp_path / "cfg3.toml"), "-g", "tictactoe",
                 "--metrics-jsonl", "r.jsonl", "learn", "--resume"]) == 0
    ev = events(tmp_path / "port" / "r.jsonl")
    assert ev[0]["event"] == "run_start" and ev[0]["start_iter"] == 2
    runs = list((tmp_path / "port" / "data" / "tictactoe").iterdir())
    assert len(runs) == 1 and (runs[0] / "lrn-2" / "sp-0" / "memory.npz").exists()
    assert (tmp_path / "port" / "models" / "tictactoe" / "model_2").exists()


def test_cli_learn_train_play_end_to_end(tmp_path, monkeypatch, capsys):
    """learn (scratch) -> learn (best-model bootstrap and a real arena
    gate) -> train (offline from ./data) -> play model against random."""
    cfg_path = tmp_path / "cfg.toml"
    cfg_path.write_text(TINY_TOML.replace("learn_iterations = 2", "learn_iterations = 1"))
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "-c", str(cfg_path), "-g", "tictactoe",
            "--metrics-jsonl", str(tmp_path / "m.jsonl")]
    assert main(base + ["learn"]) == 0
    assert (tmp_path / "models" / "tictactoe" / "best").exists()
    assert main(base + ["learn"]) == 0
    ev = events(tmp_path / "m.jsonl")
    gates = [e for e in ev if e["event"] == "gate"]
    assert gates[0]["result"] == "no_best_promoted"
    assert gates[1]["result"] in ("promoted", "best_kept", "inconclusive_kept")
    boots = [e for e in ev if e["event"] == "model_bootstrap"]
    assert boots[0]["source"] == "scratch" and boots[1]["source"].endswith("best")

    assert main(base + ["train"]) == 0
    assert (tmp_path / "models" / "tictactoe" / "trained_model" / "variables.pt").exists()
    ev = events(tmp_path / "m.jsonl")
    assert ev[-1]["event"] == "model_saved"
    start = next(e for e in ev if e["event"] == "train_offline_start")
    assert start["fragments"] > 0

    capsys.readouterr()
    assert main(base + ["play", "-1", "model", "-2", "random", "--model1-path",
                        str(tmp_path / "models" / "tictactoe" / "trained_model"),
                        "--num-games", "4"]) == 0
    out = capsys.readouterr().out
    assert "Winrate" in out and "Number of Games: 4" in out
    assert main(base + ["play", "-1", "model", "-2", "model", "--num-games", "4"]) == 0


def test_cli_defaults_to_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-g", "tictactoe", "play", "-1", "random", "-2", "random"])
