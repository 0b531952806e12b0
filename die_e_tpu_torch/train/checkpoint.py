"""Checkpoints of the net and the optimizer: the port of
``die_e_tpu/train/checkpoint.py``.

The same directory layout as the JAX package: ``models/{game}/model_{i}``
per learn iteration, ``models/{game}/best`` kept by the gate, and
``models/{game}/latest_state`` (the full train state, optimizer included)
for ``learn --resume``.  Each checkpoint is a directory holding one
``torch.save`` file: ``variables.pt`` (the net's ``state_dict``) or
``state.pt`` (net, optimizer ``state_dict`` and step count).  The port
cannot read the JAX package's orbax checkpoints on the card, where there
is no JAX: :func:`die_e_tpu_torch.nets.convert.save_flax_train_state`
writes a JAX run's state in this format.

A checkpoint is written into ``<path>.tmp`` and renamed into place.  The
full state goes through the swap of :meth:`AsyncSaver.save_state` and
:func:`resolve_state_dir`, so a kill at any point leaves a complete
``latest_state`` (or ``.new``/``.old``) behind.
"""

from __future__ import annotations

import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import torch

from die_e_tpu_torch.nets.resnet import PolicyValueNet
from die_e_tpu_torch.train.learner import TrainState

VARIABLES_FILE = "variables.pt"
STATE_FILE = "state.pt"


def _to_host(obj):
    """A copy of ``obj`` with every tensor on the CPU (nested dicts/lists)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path, name: str, obj) -> None:
    """``torch.save`` into ``<path>.tmp/<name>``, then rename over ``path``."""
    path = Path(path).absolute()
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(obj, tmp / name)
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)


def _read(path, name: str):
    """Load onto the CPU: ``load_state_dict`` copies onto the device, and
    keeps Adam's ``step`` counts on the host, where its update reads them
    without a device sync."""
    return torch.load(Path(path) / name, map_location="cpu", weights_only=True)


def host_state(state: TrainState) -> dict:
    """The full train state, copied to the CPU."""
    return _to_host({"net": state.net.state_dict(), "opt": state.opt.state_dict(),
                     "step": state.step})


def save_state(state: TrainState, path) -> None:
    _write(path, STATE_FILE, host_state(state))


def restore_state(path, state: TrainState) -> TrainState:
    """Load the full state at ``path`` into ``state`` in place."""
    saved = _read(path, STATE_FILE)
    state.net.load_state_dict(saved["net"])
    state.opt.load_state_dict(saved["opt"])
    state.step = int(saved["step"])
    return state


def save_variables(variables: dict, path) -> None:
    """Inference-only save: a net's ``state_dict``."""
    _write(path, VARIABLES_FILE, _to_host(variables))


def restore_variables(path, net):
    """Load the variables at ``path`` into ``net`` in place."""
    net.load_state_dict(_read(path, VARIABLES_FILE))
    return net


def load_net(path, spec, device) -> PolicyValueNet:
    """A net of ``spec``'s width on ``device`` with the variables at
    ``path``: a player's net in ``play``, the ladder and the tournament."""
    return restore_variables(path, PolicyValueNet(spec).to(device))


class AsyncSaver:
    """Background-thread checkpoint writer: one worker thread, saves in
    submission order.  The state is copied to the CPU on the caller's
    thread when a save is submitted, so training may go on while the
    worker writes.  :meth:`wait` re-raises any error of the background
    save; call it before exit and before reading a path being saved.

    ``on_committed`` runs in the worker strictly after the checkpoint is
    in place, which keeps the learn loop's resume cursor pointing at a
    committed state."""

    def __init__(self):
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-saver")
        self._pending = None

    def submit(self, fn: Callable[[], None]) -> None:
        """Queue ``fn`` on the saver thread (after any pending save)."""
        self.wait()
        self._pending = self._executor.submit(fn)

    def save_state(self, state: TrainState, path,
                   on_committed: Optional[Callable[[], None]] = None,
                   extra_variables_path=None) -> None:
        """Asynchronously save the full train state to ``path`` (and, if
        given, its net's variables to ``extra_variables_path`` from the
        same copy), then run ``on_committed``."""
        snapshot = host_state(state)

        def task():
            if extra_variables_path is not None:
                _write(extra_variables_path, VARIABLES_FILE, snapshot["net"])
            # never overwrite the resume target in place: a kill mid-save
            # leaves either the previous state at `path` or a complete new
            # one at `path.new` (resolve_state_dir is the reader's half)
            target = Path(path).absolute()
            new = target.with_name(target.name + ".new")
            old = target.with_name(target.name + ".old")
            _write(new, STATE_FILE, snapshot)
            shutil.rmtree(old, ignore_errors=True)
            if target.exists():
                target.rename(old)
            new.rename(target)
            shutil.rmtree(old, ignore_errors=True)
            if on_committed is not None:
                on_committed()

        self.submit(task)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._executor.shutdown(wait=True)


def resolve_state_dir(path, heal: bool = True) -> Optional[Path]:
    """The reader's half of :meth:`AsyncSaver.save_state`'s swap: the
    directory holding the newest complete full state for ``path``, or None.

    A kill can land mid-write to ``path.new`` (``path`` still holds the
    previous state), between the two renames (``path`` is gone and
    ``path.new`` is complete), or after the swap.  Prefers ``path``, then
    ``path.new``, then ``path.old``.  With ``heal`` (the one process that
    writes) it renames the chosen one into place and removes the others;
    without (every other process of a group, after the writer has healed)
    it only reads.  A restore from the result may still fail on a torn
    file; callers fall back then."""
    target = Path(path)
    new = target.with_name(target.name + ".new")
    old = target.with_name(target.name + ".old")
    if not heal:
        return next((p for p in (target, new, old) if p.exists()), None)
    if target.exists():
        # leftovers of a swap: both are older than `target`
        shutil.rmtree(new, ignore_errors=True)
        shutil.rmtree(old, ignore_errors=True)
        return target
    for cand in (new, old):  # .new is the more recent complete state
        if cand.exists():
            cand.rename(target)
            shutil.rmtree(new, ignore_errors=True)
            shutil.rmtree(old, ignore_errors=True)
            return target
    return None


def model_dir(game_name: str, base: str = "./models") -> Path:
    return Path(base) / game_name


def best_model_path(game_name: str, base: str = "./models") -> Path:
    return model_dir(game_name, base) / "best"


def bootstrap_variables(net, game_name: str, explicit_path: Optional[str] = None,
                        base: str = "./models") -> str:
    """Load the bootstrap weights into ``net``: an explicit path, else the
    best model, else the net's own scratch weights.  Returns the source."""
    if explicit_path is not None:
        restore_variables(explicit_path, net)
        return str(explicit_path)
    best = best_model_path(game_name, base)
    if best.exists():
        restore_variables(best, net)
        return str(best)
    return "scratch"
