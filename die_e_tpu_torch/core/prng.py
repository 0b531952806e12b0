"""Game seeds: the port's counterpart of ``die_e_tpu/core/prng.py``.

JAX's ``random.randint`` cannot be reproduced in torch, so the port keeps
its own contract: :func:`per_game_seeds` gives the same global game set for
a seed whatever the process count that plays it
(``parallel/multihost.py::process_batch_slice``).
"""

from __future__ import annotations

import numpy as np
import torch


def seed_from(*ints: int) -> int:
    """A 63-bit generator seed mixed from a tuple of integers."""
    return int(np.random.SeedSequence(list(ints)).generate_state(1, np.uint64)[0] >> 1)


def per_game_seeds(seed: int, n: int, salt: int = 0) -> np.ndarray:
    """Deterministic uint32 dice seeds [n] for n lockstep games, drawn on
    the CPU from (seed, salt), so every process and device draws the same
    set."""
    gen = torch.Generator().manual_seed(seed_from(seed, salt))
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=gen).numpy().astype(np.uint32)
