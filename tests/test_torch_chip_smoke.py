"""``chip_smoke.py`` and the port as the card's machine sees them.

That machine has PyTorch but no JAX, flax, optax or orbax, and the JAX
package is not to be imported there.  The CPU rehearsal runs every phase
of ``chip_smoke.py`` at a tiny size in subprocesses where those are
unimportable (in three parts, each with its own time limit: the port's
phases 1-9 with the bf16, legal_single and bn-probe steps; the learn
phase with the ladder and the tournament; the
learning checks and the parity sweep); without a card the script's default run must fail without
its result line, and so must a copy of the script alone.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "die_e_tpu")

# run chip_smoke.py as __main__ with the forbidden packages unimportable
_BLOCKED_RUN = (
    "import runpy, sys\n"
    "for m in {mods!r}: sys.modules[m] = None\n"
    "sys.argv = {argv!r}\n"
    "runpy.run_path({script!r}, run_name='__main__')\n"
)


def _run(argv, cwd=ROOT, blocked=True, script=None):
    script = str(script or ROOT / "chip_smoke.py")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
    code = (_BLOCKED_RUN.format(mods=FORBIDDEN, argv=[script, *argv], script=script)
            if blocked else None)
    cmd = [sys.executable, "-c", code] if blocked else [sys.executable, script, *argv]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


REHEARSAL = ["--device", "cpu", "--games", "4", "--iterations", "4", "--filters", "8",
             "--blocks", "1"]


def test_cpu_rehearsal_runs_every_phase_without_jax():
    """Phases 1-9; 10-14 in the next two tests."""
    p = _run([*REHEARSAL, "--phases", "port"])
    assert p.returncode == 0, p.stdout + p.stderr
    for phase in ("device:", "build:", "kernels:", "reference:", "self-play:", "bf16:",
                  "learn:", "bn-probe:", "mcts:", "compaction:", "learn2:", "done:"):
        assert phase in p.stdout, phase
    for phase in ("ladder:", "elo:", "ttt-learn:", "bg-demo:", "parity:"):
        assert phase not in p.stdout, phase
    assert '"ok"' not in p.stdout  # no result line off the card
    # the learn phase: its checks passed, and it left its artifacts
    assert "one train step (32x2" in p.stdout
    assert "resume to iteration 2" in p.stdout
    assert "bit for bit" in p.stdout.split("learn:", 1)[1]
    run_dir = Path(p.stdout.split("; in ", 1)[1].split()[0])
    mdir = run_dir / "models" / "backgammon"
    for name in ("model_0", "model_1", "model_2", "best", "latest_state"):
        assert (mdir / name).is_dir(), name
    assert json.loads((mdir / "latest_meta.json").read_text())["next_learn_iter"] == 3
    (run,) = (run_dir / "data" / "backgammon").iterdir()
    for i in range(3):
        assert (run / f"lrn-{i}" / "sp-0" / "memory.npz").exists()
    # the bf16 phase: the forward within JAX's tolerance of f32, bf16 self-
    # play (forced: compute_dtype is f32 on the cpu), then the CLI under
    # DIE_E_BF16=1 at the f32 compute_dtype gives here
    bf16 = p.stdout.split("] bf16: ", 1)[1]
    assert "compute_dtype under DIE_E_BF16=1: torch.bfloat16 (forced" in bf16
    assert "<= 0.05 of f32" in bf16
    assert "self_play with net_eval_fn(net, torch.bfloat16): 2 rounds" in bf16
    assert "(f32 in the self-play phase: " in bf16
    cli = p.stdout.split("DIE_E_BF16=1 CLI play -1 model -2 random", 1)[1]
    assert "the model's net_eval_fn got torch.float32; tally " in cli and " of 4;" in cli
    assert not Path(cli.split("; in ", 1)[1].split()[0]).exists()  # the phase cleans up
    # the probe on the learn phase's best and memory: one finite JSON line
    probe = p.stdout.split("] bn-probe: ", 1)[1]
    row = next(json.loads(line) for line in probe.splitlines() if line.startswith("{"))
    assert row["metric"] == "bn_padding_probe" and row["rel_params_delta"] > 0
    assert row["model"] == str(mdir / "best") and "/lrn-2/sp-0/memory.npz" in row["memory"]
    assert "every number finite, the arms differ" in probe
    # legal_single on the device against legal_digits
    assert "legal_single over the 26 digits equals legal_digits for 60 seeded" in p.stdout
    shutil.rmtree(run_dir)
    # the kernels at the mcts arena's and get_next_move's shapes; the pure-
    # rollout and one-game searches against the cpu
    assert "B=1 N=5 L=2048 bf16 mask_false=0: gather and scatter equal" in p.stdout
    assert "pure-rollout search (8 games, no playout step" in p.stdout
    assert "takes the immediate win in" in p.stdout  # the search with playouts
    assert "get_next_move (one game" in p.stdout
    # the mcts phase: the CLI's tally, its 4 records, and the replay of one
    mcts = p.stdout.split("mcts: ", 1)[1]
    assert "Number of Games: 4\n" in mcts and "4 records whose winners agree" in mcts
    assert "re-applied 2 turns, last board valid" in mcts
    mcts_dir = Path(mcts.split("; in ", 1)[1].split()[0])
    records = sorted((mcts_dir / "games").glob("*.json"))
    assert len(records) == 4
    for path in records:
        rec = json.loads(path.read_text())
        assert (rec["game"], rec["player1"], rec["player2"]) == ("backgammon", "mcts", "random")
        assert len(rec["turns"]) == 2
    shutil.rmtree(mcts_dir)
    # the compaction phase: compacted tic-tac-toe self-play and arena, their
    # semantics checked, and the uncompacted self-play beside it
    comp = p.stdout.split("compaction: ", 1)[1]
    assert "with compaction on the cpu (rehearsal): 9 rounds" in comp
    assert "without compaction on the cpu (rehearsal): 9 rounds" in comp
    assert "its fragments and winner on its own game id" in comp
    assert ", 2 x" in comp.split("without compaction", 1)[0]  # the batch shrank to 2
    assert "all 4 records replay to their winners" in comp
    shutil.rmtree(Path(comp.split("; in ", 1)[1].split()[0]))
    # the 2-process learn phase: the data-parallel step against one
    # process, identical losses, process 0 alone writing
    learn2 = p.stdout.split("learn2: ", 1)[1]
    assert "2-process train step (32x2, batch 64 as 2 x 32" in learn2
    assert "identical on both; only process 0 gated (best_kept, 100 draws)" in learn2
    run2 = Path(learn2.split("; in ", 1)[1].split()[0])
    assert (run2 / "metrics.jsonl.p1").exists()
    assert json.loads((run2 / "models" / "backgammon" / "latest_meta.json").read_text()
                      )["next_learn_iter"] == 1
    shutil.rmtree(run2)


def _rehearse_part(part):
    p = _run([*REHEARSAL, "--phases", part])
    assert p.returncode == 0, p.stdout + p.stderr
    assert '"ok"' not in p.stdout
    phases = {"strength": ("learn", "ladder", "elo"),
              "learning": ("ttt-learn", "bg-demo", "parity")}[part]
    for phase in ("device", "build", *phases, "done"):
        assert f"] {phase}: " in p.stdout, phase
    for phase in ("kernels", "reference", "self-play", "bf16", "bn-probe", "mcts",
                  "compaction", "learn2", "ladder", "elo", "ttt-learn", "bg-demo", "parity",
                  "learn"):
        if phase not in phases:
            assert f"] {phase}: " not in p.stdout, phase
    return p


def test_cpu_rehearsal_runs_the_ladder_and_the_tournament():
    """The learn phase, whose checkpoints they play, then phases 10-11:
    the ladder's two rungs and its resume that plays nothing, the
    tournament and its cached re-run."""
    p = _rehearse_part("strength")
    ladder = p.stdout.split("ladder: ", 1)[1]
    assert "rung random: " in ladder and "rung mcts16: " in ladder
    assert "--resume-state played nothing: a ladder_skip line for random, mcts16" in ladder
    elo = p.stdout.split("elo: ", 1)[1]
    for pair in ("best against model_1", "best against random", "model_1 against random"):
        assert pair in elo
    assert "the cached re-run played nothing, loaded no model, and gave identical ratings" in elo
    for phase in (p.stdout.split("learn: ", 1)[1], ladder, elo):
        shutil.rmtree(Path(phase.split("; in ", 1)[1].split()[0]))


def test_cpu_rehearsal_runs_the_learning_checks_and_the_parity_sweep():
    """Phases 12-14: the cut learning checks (the backgammon demo's second
    iteration gating) and the parity sweep."""
    p = _rehearse_part("learning")
    ttt = p.stdout.split("ttt-learn: ", 1)[1]
    assert "non-loss rate against random" in ttt and "of 400;" in ttt
    assert "ttt_final_arena: launches" in ttt
    demo = p.stdout.split("bg-demo: ", 1)[1]
    assert "model against random 0/0/128 of 128" in demo  # 2 rounds end no game
    assert "bg_gate: launches" in demo
    parity = p.stdout.split("parity: ", 1)[1]
    assert "games=4 max_steps=1500 finished=4 " in parity and "mismatches=0 " in parity
    for phase in (ttt, demo):
        shutil.rmtree(Path(phase.split("; in ", 1)[1].split()[0]))


def test_default_run_without_a_card_fails_without_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run is valid here")
    p = _run([])
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_script_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(["--device", "cpu"], cwd=tmp_path, blocked=False,
             script=tmp_path / "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [ROOT / "chip_smoke.py", ROOT / "profile_port.py",
                                       *(ROOT / "die_e_tpu_torch").rglob("*.py")]))
def test_port_imports_nothing_of_jax(path):
    for mod in _imported_modules(ROOT / path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


def test_port_config_matches_jax():
    import dataclasses

    from die_e_tpu.core import config as jcfg
    from die_e_tpu_torch.core import config as tcfg

    path = ROOT / "configs" / "bg_full.toml"
    assert (dataclasses.asdict(tcfg.load_config(str(path)))
            == dataclasses.asdict(jcfg.load_config(str(path))))
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    assert tcfg._KEYMAP == jcfg._KEYMAP


def test_port_config_rejects_unknown_keys(tmp_path):
    from die_e_tpu_torch.core import config as tcfg

    bad = tmp_path / "bad.toml"
    bad.write_text("iterations = 3\nnot_a_key = 1\n")
    with pytest.raises(KeyError, match="not_a_key"):
        tcfg.load_config(str(bad))
