"""The port's CLI ``learn`` in 2 processes on the CPU, as
``tests/test_multiprocess_cli.py`` runs the JAX package's.

Two processes of ``python -m die_e_tpu_torch.cli.main ... learn`` join one
gloo group (``--coordinator file://...``, ``--num-processes 2``,
``--process-id``), with one thread each and a timeout, on tic-tac-toe's
own 64x4 net.  A first run of one learn iteration, then ``learn --resume``
to a second.  Checks:

* both processes log identical per-epoch losses and fragment counts (the
  memory is all-gathered, the step data-parallel);
* only process 0 writes: the run directory, the training data, the
  checkpoints, the resume cursor and the gate events (process 1's metrics
  go to ``metrics.jsonl.p1`` and hold no gate);
* the resume continues the same run id and numbering on both processes.

Equality with a 1-process run is not asserted: each process draws its own
games' moves, so host-sharding changes the trajectories (DIVERGENCES.md
row 28); the global game set and every process's math are the same.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CFG = """
temperature = 1.25
learn_iterations = {iters}
self_play_iterations = 1
num_epochs = 1
training_batch_size = 2048
num_self_play_batches = 8
iterations = 4
exploration_const = 2
simulate_round_limit = 9
dirichlet_alpha = 0.3
dirichlet_epsilon = 0.25
wd = 0.0001
lr = 0.001
arena_num_games = 4
arena_round_limit = 9
"""


def _events(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def _learn(tmp_path, iters, *extra):
    (tmp_path / "cfg.toml").write_text(CFG.format(iters=iters))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        env.pop(var, None)
    rdv = tmp_path / f"rendezvous-{iters}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "die_e_tpu_torch.cli.main", "--device", "cpu",
         "--coordinator", f"file://{rdv}", "--num-processes", "2", "--process-id", str(i),
         "-c", "cfg.toml", "-g", "tictactoe", "--metrics-jsonl", "metrics.jsonl",
         "--compact-self-play", "--compact-arena", "learn", *extra],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"


def test_cli_learn_two_processes_then_resume(tmp_path):
    _learn(tmp_path, 1)
    mdir = tmp_path / "models" / "tictactoe"
    assert json.loads((mdir / "latest_meta.json").read_text())["next_learn_iter"] == 1
    _learn(tmp_path, 2, "--resume")

    ev0, ev1 = _events(tmp_path / "metrics.jsonl"), _events(tmp_path / "metrics.jsonl.p1")

    def series(evs, event, key):
        return [e[key] for e in evs if e["event"] == event]

    dist0, dist1 = (series(ev, "dist", "backend") for ev in (ev0, ev1))
    assert dist0 == dist1 == ["gloo", "gloo"]
    assert series(ev0, "dist", "rank") == [0, 0] and series(ev1, "dist", "rank") == [1, 1]
    frags = series(ev0, "self_play", "fragments")
    assert frags == series(ev1, "self_play", "fragments") and len(frags) == 2
    assert all(f > 0 for f in frags)
    loss0 = series(ev0, "train_epoch", "loss")
    assert len(loss0) == 2 and loss0 == series(ev1, "train_epoch", "loss")  # bit for bit

    # one run, resumed on both processes: the same id, iterations 0 then 1
    for ev in (ev0, ev1):
        starts = [e for e in ev if e["event"] == "run_start"]
        assert [e["start_iter"] for e in starts] == [0, 1]
        assert {e["run_id"] for e in starts} == {series(ev0, "run_start", "run_id")[0]}

    # only process 0 writes: gate events, checkpoints, data, the cursor
    assert series(ev0, "gate", "result")[0] == "no_best_promoted"
    assert len(series(ev0, "gate", "result")) == 2
    assert not any(e["event"] in ("gate", "model_saved") for e in ev1)
    for name in ("best", "model_0", "model_1", "latest_state"):
        assert (mdir / name).is_dir(), name
    assert json.loads((mdir / "latest_meta.json").read_text())["next_learn_iter"] == 2
    (run,) = (tmp_path / "data" / "tictactoe").glob("run-*")
    for i in (0, 1):
        assert (run / f"lrn-{i}" / "sp-0" / "memory.npz").exists()
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("metrics")) == [
        "metrics.jsonl", "metrics.jsonl.p1"]
