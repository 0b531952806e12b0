"""Per-game row gather and masked row scatter on the search tree's prior
store: the port of ``die_e_tpu/ops/rows.py``.

The prior store is ``[B, N, L]`` bfloat16, with the action axis padded to
``L = pad_actions(A)`` (1352 -> 2048) so that tree fields compare directly
with the JAX package's ``Tree.prior`` (there ``[B, N, R, 128]``; here the
``[R, 128]`` split is merged).  The kernels take the row length as an
argument.

Each operation has two versions in this module:

* the CUDA kernel (``csrc/rows.cu``: ``rows_gather`` replaces
  ``_gather_rows_pallas``, ``rows_scatter`` replaces
  ``_scatter_rows_pallas``), launched for CUDA tensors; it raises when the
  launch fails, and there is no ``B % 8`` restriction;
* the plain PyTorch version (``_gather_rows_plain``,
  ``_scatter_rows_plain``), used for CPU tensors only, and on the card as
  the reference the kernels are held against.

Out-of-range ``idx`` gives a zero row on gather and writes nothing on
scatter, as the JAX package's fallbacks ``_gather_rows_reduce`` and
``_scatter_rows_where`` do.

``launches`` counts kernel launches by name, and ``launch_shapes`` by
name and store shape ``(B, N, L)``; callers reset both to read how often,
and at which shapes, a run went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from die_e_tpu_torch.ops import build

LANE = 128
SUBLANE = 8
_VEC = 16  # bytes per vector load/store in the kernels

launches = {"gather_rows": 0, "scatter_rows": 0}
launch_shapes: collections.Counter = collections.Counter()  # (name, B, N, L) -> launches

_SIGNATURES = (
    ("rows_gather", (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
     + (ctypes.c_void_p,)),
    ("rows_scatter", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3
     + (ctypes.c_void_p,)),
)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


def _count(name: str, store: torch.Tensor) -> None:
    launches[name] += 1
    launch_shapes[(name, *store.shape)] += 1


def pad_actions(a: int) -> int:
    """Smallest padded action-axis size R*128 with R a multiple of 8 (the
    JAX package's layout, kept so the stores compare directly)."""
    unit = LANE * SUBLANE
    return ((a + unit - 1) // unit) * unit


def _lib():
    return build.load("rows.cu", _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_cuda(device, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all tensors must be on {device}, got {t.device}")


def _row_vecs(store: torch.Tensor) -> int:
    row_bytes = store.shape[-1] * store.element_size()
    if row_bytes % _VEC or store.data_ptr() % _VEC:
        raise ValueError("rows must be 16-byte aligned multiples of 16 bytes")
    return row_bytes // _VEC


def _gather_rows_plain(src, idx):
    """out[b] = src[b, idx[b]]; a zero row where idx is outside [0, N)."""
    n = src.shape[1]
    ok = (idx >= 0) & (idx < n)
    ar = torch.arange(src.shape[0], device=src.device)
    out = src[ar, idx.long().clamp(0, n - 1)]
    return torch.where(ok[:, None], out, torch.zeros((), dtype=src.dtype,
                                                     device=src.device))


def _scatter_rows_plain(dst, idx, rows, mask):
    """dst with dst[b, idx[b]] = rows[b] where mask[b] (a new tensor)."""
    n = dst.shape[1]
    sel = (idx[:, None] == torch.arange(n, device=dst.device)) & mask[:, None]
    return torch.where(sel[:, :, None], rows[:, None, :], dst)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, L] rows ``src[b, idx[b]]`` of a [B, N, L] store; idx [B] int32.

    CUDA tensors launch the ``rows_gather`` kernel; CPU tensors take the
    plain version."""
    b, n, length = src.shape
    if src.device.type == "cpu":
        return _gather_rows_plain(src, idx)
    _check("src", src, None, (b, n, length))
    _check("idx", idx, torch.int32, (b,))
    _check_cuda(src.device, idx)
    out = torch.empty((b, length), dtype=src.dtype, device=src.device)
    if b == 0:
        return out
    err = _lib().rows_gather(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n,
        _row_vecs(src), torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"rows_gather launch failed: cudaError {err}")
    _count("gather_rows", src)
    return out


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """``dst[b, idx[b]] = rows[b]`` where ``mask[b]``, IN PLACE on the
    [B, N, L] store ``dst``, which is returned; idx [B] int32, rows [B, L]
    of dst's dtype, mask [B] bool.

    CUDA tensors launch the ``rows_scatter`` kernel; CPU tensors take the
    plain version (copied back into ``dst``)."""
    b, n, length = dst.shape
    if dst.device.type == "cpu":
        return dst.copy_(_scatter_rows_plain(dst, idx, rows, mask))
    _check("dst", dst, None, (b, n, length))
    _check("idx", idx, torch.int32, (b,))
    _check("rows", rows, dst.dtype, (b, length))
    _check("mask", mask, torch.bool, (b,))
    _check_cuda(dst.device, idx, rows, mask)
    if b == 0:
        return dst
    vecs = _row_vecs(dst)
    if rows.data_ptr() % _VEC:
        raise ValueError("rows must be 16-byte aligned")
    err = _lib().rows_scatter(
        dst.data_ptr(), idx.data_ptr(), rows.data_ptr(), mask.data_ptr(),
        b, n, vecs, torch.cuda.current_stream(dst.device).cuda_stream)
    if err:
        raise RuntimeError(f"rows_scatter launch failed: cudaError {err}")
    _count("scatter_rows", dst)
    return dst
