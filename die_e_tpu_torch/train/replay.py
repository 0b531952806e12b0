"""Training-data store: save/load self-play memories.

The port's own copy of ``die_e_tpu/train/replay.py`` (framework-free): the
same ``memory.npz`` keys and directory walk, so that each package reads
the other's data directories.

Rebuilds the reference's save_training_data / load_training_data
(reference src/alphazero/alphazero.rs:149-200): stacked tensors written per
self-play directory ``data/{game}/run-{id}/lrn-{i}/sp-{j}``
(alpha_parallel.rs:18-21, 43-62).  The reference writes three libtorch files
(ps.ot / states.ot / outcomes.ot); here the same three arrays go into one
``memory.npz`` with keys ps/states/outcomes.

Documented divergence (quirk consciously fixed, SURVEY.md section 7): each
sp-j dir holds only that iteration's NEW fragments; the reference re-saves
the cumulative memory so sp-j duplicates sp-0..j-1
(alpha_parallel.rs:48-62) and its offline Train command re-reads the
duplicates.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class Memory:
    """Flat fragment store (Vec<MemoryFragment>, alphazero.rs:68-73)."""

    states: np.ndarray    # [M, H, W, C]
    ps: np.ndarray        # [M, A]
    outcomes: np.ndarray  # [M]

    def __len__(self):
        return self.states.shape[0]

    @staticmethod
    def empty(obs_shape, num_actions) -> "Memory":
        h, w, c = obs_shape
        return Memory(
            states=np.zeros((0, h, w, c), np.float32),
            ps=np.zeros((0, num_actions), np.float32),
            outcomes=np.zeros((0,), np.float32),
        )

    def append(self, states, ps, outcomes) -> "Memory":
        return Memory(
            states=np.concatenate([self.states, np.asarray(states, np.float32)]),
            ps=np.concatenate([self.ps, np.asarray(ps, np.float32)]),
            outcomes=np.concatenate(
                [self.outcomes, np.asarray(outcomes, np.float32)]
            ),
        )

    @staticmethod
    def concat(memories: List["Memory"]) -> "Memory":
        return Memory(
            states=np.concatenate([m.states for m in memories]),
            ps=np.concatenate([m.ps for m in memories]),
            outcomes=np.concatenate([m.outcomes for m in memories]),
        )


def save_training_data(memory: Memory, path) -> None:
    """alphazero.rs:149-176; errors if the parent is missing, like the
    reference's path-exists panic."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path / "memory.npz",
        ps=memory.ps,
        states=memory.states,
        outcomes=memory.outcomes,
    )


def load_training_data(path) -> Memory:
    """alphazero.rs:184-200."""
    path = Path(path)
    f = path / "memory.npz"
    if not f.exists():
        raise FileNotFoundError(f"no training data at {path}")
    z = np.load(f)
    return Memory(
        states=z["states"].astype(np.float32),
        ps=z["ps"].astype(np.float32),
        outcomes=z["outcomes"].astype(np.float32),
    )


def find_sp_dirs(root) -> Iterator[Path]:
    """Recursively collect sp-* leaf dirs under a data root — the offline
    Train command's directory walk (reference src/main.rs:176-206,
    get_all_paths_rec :218-231)."""
    root = Path(root)
    if root.name.startswith("sp-"):
        yield root
        return
    if not root.is_dir():
        return
    for child in sorted(root.iterdir()):
        if child.is_dir():
            yield from find_sp_dirs(child)


def load_all_training_data(root) -> Memory:
    mems = [load_training_data(p) for p in find_sp_dirs(root)]
    if not mems:
        raise FileNotFoundError(f"no sp-* training data under {root}")
    return Memory.concat(mems)
