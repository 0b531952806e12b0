"""The AlphaZero learn loop (self-play -> train -> gate): the port of
``die_e_tpu/train/learn.py``.

Per learn iteration: ``self_play_iterations`` batched self-play runs
append to the iteration's memory, each saved under
``data/{game}/run-{id}/lrn-{i}/sp-{j}/memory.npz``; ``num_epochs``
shuffled training epochs (the NaN/Inf check is inside them); the
``models/{game}/model_{i}`` checkpoint and the full ``latest_state``,
written by a background thread; then the gate against ``best``.

Resume: ``models/{game}/latest_meta.json`` holds the run id and the next
learn iteration.  It is written atomically and in two phases: the commit
of ``latest_state`` records ``pending_gate = i``, cleared once that gate
has finished, so a run killed during the gate re-runs it on ``--resume``.
A resume restores ``latest_state`` in full when it is intact, else falls
back to the newest intact ``model_i`` with a fresh optimizer.

Randomness: one ``torch.Generator`` on the device, seeded from ``seed``
(and from the resumed iteration, so that a resumed run does not replay a
fresh run's draws).  It draws, for each self-play run, the seed of the
global game set (``core/prng.py::per_game_seeds``) and the seed of the
run's own generator, then the epoch permutations and the seed of each
gate's generator.

Several processes (``cluster``, from
``parallel/multihost.py::initialize_multihost``): the same loop runs in
every process, and every process draws the same numbers from that
generator.  Each process self-plays its contiguous slice of the global
game set with a generator of its own (seeded from the shared draw and its
rank); the memory and the winners are all-gathered, so every process
trains on the identical global memory, data-parallel
(``train/learner.py``); only process 0 touches the filesystem (run
directories, training data, checkpoints, the gate and the resume cursor),
while the others wait at the next gather.
"""

from __future__ import annotations

import json
import os
import uuid
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from die_e_tpu_torch.core.config import Config
from die_e_tpu_torch.core.device import compute_dtype, resolve_device
from die_e_tpu_torch.core.mesh import make_mesh
from die_e_tpu_torch.core.metrics import Metrics, Timer
from die_e_tpu_torch.core.prng import seed_from
from die_e_tpu_torch.parallel.multihost import (
    allgather_memory,
    allgather_memory_sparse,
    broadcast_str,
    process_batch_slice,
)
from die_e_tpu_torch.train import checkpoint as ckpt
from die_e_tpu_torch.train.gating import gate
from die_e_tpu_torch.train.learner import (
    compact_memory,
    create_train_state,
    net_eval_fn,
    set_process_group,
    train_epoch,
    train_epoch_device,
    upload_epoch_data,
)
from die_e_tpu_torch.train.replay import Memory, load_all_training_data, save_training_data
from die_e_tpu_torch.train.self_play import self_play_from_states, trajectory_to_memory

GATE_RESUME_SALT = 0x6A7E
RUN_ID_CHARS = 21


def _write_meta_atomic(path: Path, meta: dict) -> None:
    """Write the resume cursor atomically (tmp + rename): a kill mid-write
    never leaves a truncated cursor."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, path)


def _generator(dev, *seeds: int) -> torch.Generator:
    """A generator on ``dev`` seeded from a tuple of integers."""
    return torch.Generator(device=dev).manual_seed(seed_from(*seeds))


def _draw(gen: torch.Generator, n: int) -> list:
    """``n`` integers in [0, 2^62) from ``gen``."""
    return torch.randint(0, 2 ** 62, (n,), generator=gen, device=gen.device).tolist()


def _fresh_state(env, config: Config, seed: int, dev, group=None):
    opt = config.optimizer
    state = create_train_state(env.spec, seed, lr=opt.lr, wd=opt.wd, device=dev)
    return set_process_group(state, group)


def learn(env, config: Config, seed: int = 0, model_path: Optional[str] = None,
          data_base: str = "./data", models_base: str = "./models",
          metrics: Optional[Metrics] = None, run_id: Optional[str] = None,
          resume: bool = False, device=None, cluster=None,
          compact_self_play: bool = False, compact_arena: bool = False):
    """Run the learn loop on ``device`` (cuda unless the caller asks for the
    CPU; with a ``cluster``, on its device); returns the final
    :class:`TrainState`.  ``compact_self_play`` and ``compact_arena``
    re-pack live games as games finish (``train/self_play.py``,
    ``arena/versus.py``)."""
    dev = cluster.device if cluster is not None else resolve_device(device)
    if metrics is None:
        metrics = Metrics()
    az, mcts_cfg = config.alphazero, config.mcts
    nproc, pid = (cluster.world_size, cluster.rank) if cluster is not None else (1, 0)
    host = cluster.host_group if cluster is not None else None
    group = dist.group.WORLD if cluster is not None else None
    is_main = pid == 0
    mesh = make_mesh(config.mesh.data, config.mesh.model, nproc)
    if nproc > 1:
        for key in ("num_self_play_batches", "training_batch_size"):
            if getattr(az, key) % nproc:
                raise ValueError(f"{key}={getattr(az, key)} not divisible by "
                                 f"{nproc} processes")
        metrics.log("dist", backend=cluster.backend, world_size=nproc, rank=pid,
                    device=str(dev), **mesh)

    mdir = ckpt.model_dir(env.spec.name, models_base)
    meta_path = mdir / "latest_meta.json"
    start_iter = 0
    pending_gate = None
    if resume and meta_path.exists():
        meta = json.loads(meta_path.read_text())
        run_id = run_id or meta.get("run_id")
        start_iter = int(meta.get("next_learn_iter", 0))
        pending_gate = meta.get("pending_gate")
    run_id = run_id or uuid.uuid4().hex[:RUN_ID_CHARS]
    if nproc > 1:
        # one run id for the group (process 0's); also the start barrier
        run_id = broadcast_str(run_id, RUN_ID_CHARS, host)
    run_base = Path(data_base) / env.spec.name / f"run-{run_id}"
    if is_main:
        run_base.mkdir(parents=True, exist_ok=True)
    metrics.log("run_start", run_id=run_id, game=env.spec.name, start_iter=start_iter)

    state = _fresh_state(env, config, seed, dev, group)
    source = ckpt.bootstrap_variables(state.net, env.spec.name, model_path, models_base)
    latest = mdir / "latest_state"
    full_resume = False
    fallback_restored = None  # the model_{i} the fallback restored
    if resume:
        # process 0 heals an interrupted swap of latest_state; the others
        # wait for it, then only read
        src = ckpt.resolve_state_dir(latest) if is_main else None
        if nproc > 1:
            dist.barrier(group=host)
        if not is_main:
            src = ckpt.resolve_state_dir(latest, heal=False)
        if src is not None:
            try:
                ckpt.restore_state(src, state)
                full_resume = True
                source = f"{src} (full train state)"
            except Exception as e:  # a torn or unreadable checkpoint: fall back
                metrics.log("checkpoint_unreadable", path=str(src), error=repr(e)[:200])
                state = _fresh_state(env, config, seed, dev, group)
                source = ckpt.bootstrap_variables(
                    state.net, env.spec.name, model_path, models_base)
        if not full_resume and start_iter:
            # newest intact model_{i} below the cursor: variables only, into
            # the fresh state (its optimizer has taken no step)
            for i in range(start_iter - 1, -1, -1):
                mp_i = mdir / f"model_{i}"
                if not mp_i.exists():
                    continue
                try:
                    ckpt.restore_variables(mp_i, state.net)
                except Exception as e:
                    metrics.log("checkpoint_unreadable", path=str(mp_i),
                                error=repr(e)[:200])
                    continue
                source = f"{mp_i} (variables only, fresh optimizer)"
                fallback_restored = i
                break
    metrics.log("model_bootstrap", source=source)
    # inference (self-play and the gate) in the compute dtype, bf16 under
    # DIE_E_BF16=1 on the card; training stays float32
    dtype = compute_dtype(dev)
    eval_fn = net_eval_fn(state.net, dtype)

    def run_gate(gen):
        gate(env, state.net, gen, mcts_cfg, config.arena, az.temperature,
             models_base, metrics, compact=compact_arena, dtype=dtype)

    def run_self_play(gen, stats):
        """This process's slice of the global game set, gathered over the
        processes: (obs, ps, outcome, winner [B], game rows searched)."""
        sp_seed, own_seed = _draw(gen, 2)
        seeds = process_batch_slice(az.num_self_play_batches, sp_seed, pid, nproc)
        states = env.init(torch.from_numpy(seeds.astype(np.int64)).to(dev), device=dev)
        traj = self_play_from_states(
            env, eval_fn, states, _generator(dev, own_seed, pid),
            iterations=mcts_cfg.iterations, c=mcts_cfg.c,
            dirichlet_alpha=mcts_cfg.dirichlet_alpha,
            dirichlet_epsilon=mcts_cfg.dirichlet_epsilon,
            temperature=az.temperature, round_limit=mcts_cfg.simulate_round_limit,
            negamax=mcts_cfg.negamax, compact=compact_self_play,
        )
        obs, ps, outcome = trajectory_to_memory(traj, az.temperature)
        winner = traj.winner.cpu().numpy()
        rows = np.asarray([traj.row_rounds], np.int64)
        if nproc > 1:
            obs, ps, outcome = allgather_memory_sparse(
                obs, ps, outcome, obs_int8=env.spec.obs_int8, stats=stats, group=host)
            # winners are one row per game, the memory one per fragment:
            # each gather trims by its own counts
            (winner,) = allgather_memory(winner, group=host)
            (rows,) = allgather_memory(rows, group=host)
        return obs, ps, outcome, winner, int(rows.sum())

    if is_main and pending_gate is not None and (
            full_resume or fallback_restored == int(pending_gate)):
        # the previous run died between committing model_{g} and finishing
        # its gate: run that gate now, so every checkpoint challenges best
        g = int(pending_gate)
        metrics.log("gate_resume", learn_iter=g)
        run_gate(_generator(dev, seed, GATE_RESUME_SALT + g))
        _write_meta_atomic(meta_path, {"run_id": run_id, "next_learn_iter": start_iter})

    gen = _generator(dev, seed, start_iter)
    saver = ckpt.AsyncSaver()
    for l_i in range(start_iter, az.learn_iterations):
        lrn_path = run_base / f"lrn-{l_i}"
        memory = Memory.empty(env.spec.obs_shape, env.spec.num_actions)
        for sp_i in range(az.self_play_iterations):
            sp_stats: dict = {}
            with Timer() as t:
                obs, ps, outcome, winner, rows = run_self_play(gen, sp_stats)
            frag = Memory(states=obs, ps=ps, outcomes=outcome)
            memory = Memory.concat([memory, frag])
            if is_main:
                save_training_data(frag, lrn_path / f"sp-{sp_i}")
            # the policy CE cannot fall below the mean entropy of its
            # targets (CE = H(target) + KL)
            p = frag.ps
            target_entropy = float(np.mean(-np.sum(
                np.where(p > 0, p * np.log(np.maximum(p, 1e-12)), 0.0), axis=-1,
            ))) if len(frag) else 0.0
            moves = len(frag)
            metrics.log(
                "self_play", learn_iter=l_i, sp_iter=sp_i, fragments=len(frag),
                moves_per_s=moves / max(t.elapsed, 1e-9),
                sims_per_s=moves * mcts_cfg.iterations / max(t.elapsed, 1e-9),
                # every game row searched, done games and noop plies too
                sims_per_s_device=rows * mcts_cfg.iterations / max(t.elapsed, 1e-9),
                wins_m1=int(np.sum(winner == -1)), wins_p1=int(np.sum(winner == 1)),
                draws=int(np.sum(winner == 0)), target_entropy=target_entropy,
                **sp_stats,
            )

        # the iteration's memory goes to the device once; the host loop only
        # for an empty memory
        epoch_data = upload_epoch_data(memory.states, memory.ps, memory.outcomes,
                                       az.training_batch_size, device=dev)
        compact = (compact_memory(memory.ps, memory.states)
                   if epoch_data is None else None)
        saver.wait()
        for epoch in range(az.num_epochs):
            ms: list = []
            with Timer() as t:
                if epoch_data is not None:
                    train_epoch_device(state, epoch_data, az.training_batch_size, gen, ms)
                else:
                    train_epoch(state, memory.states, memory.ps, memory.outcomes,
                                az.training_batch_size, gen, ms, compact=compact)
            metrics.log(
                "train_epoch", learn_iter=l_i, epoch=epoch,
                loss=float(np.mean([m["loss"] for m in ms])),
                policy_loss=float(np.mean([m["policy_loss"] for m in ms])),
                value_loss=float(np.mean([m["value_loss"] for m in ms])),
                samples_per_s=len(memory) / max(t.elapsed, 1e-9),
            )

        (gate_seed,) = _draw(gen, 1)
        if is_main:
            model_path_i = mdir / f"model_{l_i}"
            meta_committed = {"run_id": run_id, "next_learn_iter": l_i + 1,
                              "pending_gate": l_i}
            saver.save_state(
                state, latest,
                on_committed=lambda m=meta_committed: _write_meta_atomic(meta_path, m),
                extra_variables_path=model_path_i,
            )
            # marks the submission of the save; the cursor marks its commit
            metrics.log("model_saved", learn_iter=l_i, path=str(model_path_i))
            run_gate(_generator(dev, gate_seed))
            saver.wait()
            _write_meta_atomic(meta_path, {"run_id": run_id, "next_learn_iter": l_i + 1})
    saver.close()
    if nproc > 1:
        dist.barrier(group=host)  # the others wait for process 0's last gate
    return state


def train_offline(env, config: Config, data_path: str, seed: int = 0,
                  model_path: Optional[str] = None, out_path: Optional[str] = None,
                  models_base: str = "./models", metrics: Optional[Metrics] = None,
                  device=None):
    """Offline training from saved self-play data on ``device`` (cuda unless
    the caller asks for the CPU); writes ``models/{game}/trained_model``
    unless ``out_path`` is given."""
    dev = resolve_device(device)
    if metrics is None:
        metrics = Metrics()
    az = config.alphazero
    memory = load_all_training_data(data_path)
    metrics.log("train_offline_start", fragments=len(memory))

    state = _fresh_state(env, config, seed, dev)
    source = ckpt.bootstrap_variables(state.net, env.spec.name, model_path, models_base)
    metrics.log("model_bootstrap", source=source)
    gen = _generator(dev, seed)
    compact = compact_memory(memory.ps, memory.states)  # once for all epochs
    for epoch in range(az.num_epochs):
        ms: list = []
        train_epoch(state, memory.states, memory.ps, memory.outcomes,
                    az.training_batch_size, gen, ms, compact=compact)
        metrics.log("train_epoch", epoch=epoch, loss=float(np.mean([m["loss"] for m in ms])))

    out = Path(out_path) if out_path else ckpt.model_dir(env.spec.name, models_base) / "trained_model"
    ckpt.save_variables(state.net.state_dict(), out)
    metrics.log("model_saved", path=str(out))
    return state
