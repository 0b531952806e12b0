"""Multi-process scaffolding on ``torch.distributed``: the port of
``die_e_tpu/parallel/multihost.py``.

The same ``learn`` runs in every process of a group (``--coordinator``,
``--num-processes``, ``--process-id``, or torchrun's environment).  Each
process self-plays its contiguous slice of the global game set, the replay
memory is all-gathered so every process holds the identical global memory,
and each training batch is split by rows over the processes, with BatchNorm
statistics and gradients reduced over the group.

Backends, one rule (:func:`choose_backend`):

* NCCL when every process on a host has a card of its own (one process per
  card): gradients and BatchNorm sums go over NVLink;
* gloo when processes share a card or run on the CPU.  gloo reduces CUDA
  tensors here by way of the host (:func:`all_reduce_`).

Host data (counts, memory, winners, the run id) always goes over a gloo
group of CPU tensors (:attr:`Cluster.host_group`): NCCL cannot gather host
tensors, and gloo cannot all-gather CUDA tensors.  If NCCL fails to start,
the run raises; it never falls back to gloo.

Single-process runs are unaffected: :func:`initialize_multihost` returns
None without a cluster.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from die_e_tpu_torch.core.device import resolve_device
from die_e_tpu_torch.core.prng import per_game_seeds

# Every collective waits at most this long.  Process 0 plays the gate while
# the others wait at the next gather: a 400-game, 300-round gate at 2.9-6 s
# a move is 15-30 min a block of games, and the sequential gate plays up to
# four blocks, so the default 30 min would time out a healthy run.
GROUP_TIMEOUT = timedelta(hours=3)


@dataclasses.dataclass
class Cluster:
    """This process's place in the group."""

    rank: int
    world_size: int
    backend: str                 # of the default group: "nccl" or "gloo"
    device: torch.device         # where this process computes
    host_group: object           # a gloo group for host (CPU) tensors

    def close(self) -> None:
        dist.destroy_process_group()


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when the device is a card and this host has a card for each of
    its ``local_world_size`` processes; gloo otherwise (processes sharing a
    card, or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"  # torchrun's MASTER_ADDR / MASTER_PORT
    if "://" in coordinator_address:
        return coordinator_address  # tcp://host:port or file:///path
    return f"tcp://{coordinator_address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> Optional[Cluster]:
    """Join the process group; None (a single process) when neither the
    arguments nor torchrun's ``WORLD_SIZE`` name a cluster.

    ``coordinator_address`` is ``host:port`` (process 0 listens there), a
    ``tcp://`` or ``file://`` URL, or None for torchrun's environment.
    ``device`` is where this process computes (cuda unless the caller asks
    for the CPU); with NCCL each process takes the card of its local rank
    (``LOCAL_RANK``, else its rank modulo the processes on the host,
    ``LOCAL_WORLD_SIZE``, else all of them)."""
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None \
            and "WORLD_SIZE" not in env:
        return None
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    for value, what in ((world, "its size: --num-processes (or torchrun's WORLD_SIZE)"),
                        (rank, "this process's rank: --process-id (or torchrun's RANK)"),
                        (coordinator_address or env.get("MASTER_ADDR"),
                         "a meeting point: --coordinator host:port (or torchrun's "
                         "MASTER_ADDR)")):
        if value is None:
            raise ValueError(f"a multi-process run needs {what}")
    world, rank = int(world), int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a group of {world}")
    dev = resolve_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    backend = choose_backend(dev, local_world)
    if backend == "nccl":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank, timeout=GROUP_TIMEOUT)
    host = (dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
            if backend == "nccl" else dist.group.WORLD)
    # a first collective on each group: a backend that cannot start
    # raises here, not at the first gradient
    all_reduce_(torch.zeros(1, device=dev))
    dist.barrier(group=host)
    return Cluster(rank, world, backend, dev, host)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place and return it; under gloo a CUDA
    tensor goes by way of the host."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def _rank_world(group=None):
    if group is None and not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def batch_slice(rows: int, rank: int, world: int) -> slice:
    """This rank's contiguous ``1/world`` of a ``rows``-row batch (the JAX
    package's ``put_global_batch`` row ranges); raises unless ``world``
    divides ``rows``."""
    if rows % world:
        raise ValueError(f"batch rows {rows} not divisible by {world} processes")
    per = rows // world
    return slice(rank * per, (rank + 1) * per)


def process_batch_slice(global_batch: int, seed: int = 0, rank: Optional[int] = None,
                        world: Optional[int] = None) -> np.ndarray:
    """This process's dice seeds: games ``[i*B/H, (i+1)*B/H)`` of the global
    set :func:`per_game_seeds` draws from ``seed``, so the global game set
    is the same whatever the process count.  ``rank`` and ``world`` default
    to the default group's."""
    if rank is None or world is None:
        rank, world = _rank_world()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} hosts")
    return per_game_seeds(seed, global_batch)[batch_slice(global_batch, rank, world)]


def _allgather_np(x: np.ndarray, group) -> np.ndarray:
    """[world, *x.shape]: every rank's ``x`` (same shape and dtype on every
    rank), moved as raw bytes, so any dtype arrives bit for bit."""
    world = dist.get_world_size(group)
    x = np.ascontiguousarray(x)
    if x.nbytes == 0:
        return np.zeros((world, *x.shape), x.dtype)
    t = torch.from_numpy(x.reshape(-1).view(np.uint8))
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t, group=group)
    return np.stack([o.numpy().view(x.dtype).reshape(x.shape) for o in out])


def allgather_memory(*host_arrays, group=None):
    """All-gather variable-length host arrays over the processes of
    ``group`` (a gloo group: the cluster's ``host_group``); every process
    returns the identical concatenation in rank order.  Each array is
    padded to the largest row count before the collective and trimmed
    after.

    CONTRACT: every array in one call has the same local row count (all are
    trimmed by the first array's per-process counts).  Arrays of another
    cardinality (per-game winners beside per-fragment memory) go in their
    own call."""
    for x in host_arrays[1:]:
        if x.shape[0] != host_arrays[0].shape[0]:
            raise ValueError(
                "allgather_memory arrays must share the local row count "
                f"(got {x.shape[0]} vs {host_arrays[0].shape[0]}); gather "
                "different-cardinality arrays in separate calls"
            )
    counts = _allgather_np(np.asarray([host_arrays[0].shape[0]], np.int64), group)[:, 0]
    n_max = int(counts.max())
    out = []
    for x in host_arrays:
        x = np.asarray(x)
        pad = np.zeros((n_max - x.shape[0],) + x.shape[1:], x.dtype)
        stacked = _allgather_np(np.concatenate([x, pad]), group)  # [H, n_max, ...]
        out.append(np.concatenate([stacked[h, :counts[h]] for h in range(len(counts))]))
    return tuple(out)


def allgather_memory_sparse(obs, ps, outcome, obs_int8=False, stats=None, group=None):
    """:func:`allgather_memory` of the replay memory with a lean wire
    format: observations as int8 when they are integer-exact, probability
    rows CSR-packed (``train/learner.py::_sparsify_rows``: uint16 column,
    f32 value over the nonzero entries), outcomes as int8 (+-1/0).  Every
    process returns the identical dense (obs f32, ps f32, outcome f32)
    concatenation, bit for bit the dense gather's.

    ``stats`` (optional dict) receives ``{"bytes_wire", "bytes_dense"}``."""
    from die_e_tpu_torch.train.learner import _sparsify_rows

    obs, ps, outcome = np.asarray(obs), np.asarray(ps), np.asarray(outcome)
    a = ps.shape[1]
    idx, val = _sparsify_rows(ps)
    # pad the columns to the largest K over the processes (K is a multiple
    # of 64, so few distinct shapes)
    k = int(_allgather_np(np.asarray([idx.shape[1]], np.int64), group).max())
    if k > idx.shape[1]:
        padc = ((0, 0), (0, k - idx.shape[1]))
        idx, val = np.pad(idx, padc), np.pad(val, padc)
    obs_w = obs.astype(np.int8) if obs_int8 else obs
    out_w = outcome.astype(np.int8)  # outcomes are exactly -1/0/+1
    g_obs, g_idx, g_val, g_out = allgather_memory(obs_w, idx, val, out_w, group=group)
    ps_dense = np.zeros((g_idx.shape[0], a), np.float32)
    mask = g_val != 0.0  # padding slots are (col 0, val 0); real values are not 0
    rows = np.nonzero(mask)[0]
    ps_dense[rows, g_idx[mask].astype(np.int64)] = g_val[mask]
    if stats is not None:
        h = dist.get_world_size(group)
        stats["bytes_wire"] = int((obs_w.nbytes + idx.nbytes + val.nbytes + out_w.nbytes) * h)
        stats["bytes_dense"] = int((obs.nbytes + ps.nbytes + outcome.nbytes) * h)
    return (g_obs.astype(np.float32) if obs_int8 else g_obs, ps_dense,
            g_out.astype(np.float32))


def broadcast_str(s: str, width: int, group=None) -> str:
    """Process 0's ``s`` (at most ``width`` ASCII characters) on every
    process."""
    t = torch.from_numpy(np.frombuffer(s.encode().ljust(width)[:width], np.uint8).copy())
    dist.broadcast(t, src=0, group=group)
    return bytes(t.numpy()).decode().strip()
