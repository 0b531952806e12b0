"""The row kernels' plain versions against the JAX package's fallbacks,
bit for bit, and the wrappers' CPU path.

``_gather_rows_plain`` / ``_scatter_rows_plain`` are what the CUDA kernels
are held against on the card (``chip_smoke.py``), and what the wrappers run
for CPU tensors; here they are held against ``_gather_rows_reduce`` /
``_scatter_rows_where``, including odd B and out-of-range idx.  The JAX
store is [B, N, R, 128]; the port's merges the last two axes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from die_e_tpu.ops.rows import _gather_rows_reduce, _scatter_rows_where
from die_e_tpu.ops.rows import pad_actions as jax_pad_actions
from die_e_tpu_torch.ops import rows as R


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(b, n, r, seed, dtype):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, n, r, 128)).astype(np.float32)
    rows = rng.standard_normal((b, r, 128)).astype(np.float32)
    idx = rng.integers(0, n, b).astype(np.int32)
    idx[0] = n - 1
    if b > 2:
        idx[1], idx[2] = -1, n  # out of range
    mask = rng.random(b) < 0.7
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = (jnp.asarray(src, jd), jnp.asarray(idx), jnp.asarray(rows, jd), jnp.asarray(mask))
    t = (torch.tensor(src).reshape(b, n, r * 128).to(td), torch.tensor(idx),
         torch.tensor(rows).reshape(b, r * 128).to(td), torch.tensor(mask))
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = [(16, 11, 8), (13, 5, 8), (1, 3, 16), (1000, 4, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,r", CASES)
def test_gather_plain_matches_jax_fallback(b, n, r, dtype):
    (jsrc, jidx, _, _), (tsrc, tidx, _, _) = _case(b, n, r, b + n, dtype)
    want = _np(_gather_rows_reduce(jsrc, jidx)).reshape(b, -1)
    got = R._gather_rows_plain(tsrc, tidx)
    assert got.dtype == tsrc.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(R.gather_rows(tsrc, tidx).float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,r", CASES)
def test_scatter_plain_matches_jax_fallback(b, n, r, dtype):
    (jsrc, jidx, jrows, jmask), (tsrc, tidx, trows, tmask) = _case(b, n, r, 7 * b + n, dtype)
    want = _np(_scatter_rows_where(jsrc, jidx, jrows, jmask)).reshape(b, n, -1)
    got = R._scatter_rows_plain(tsrc, tidx, trows, tmask)
    np.testing.assert_array_equal(got.float().numpy(), want)
    dst = tsrc.clone()
    out = R.scatter_rows(dst, tidx, trows, tmask)
    assert out is dst  # in place
    np.testing.assert_array_equal(dst.float().numpy(), want)


def test_pad_actions_matches_jax():
    for a in (9, 1024, 1352, 2048, 2049):
        assert R.pad_actions(a) == jax_pad_actions(a)


def test_cpu_path_launches_nothing():
    R.reset_launches()
    (_, _, _, _), (src, idx, rows, mask) = _case(4, 3, 8, 0, "bfloat16")
    R.gather_rows(src, idx)
    R.scatter_rows(src, idx, rows, mask)
    assert R.launches == {"gather_rows": 0, "scatter_rows": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """On the card: each kernel equals its plain version bit for bit at the
    main path's shape and at an odd B with false mask rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this check on the card")
    dev = torch.device("cuda")
    for b, n in ((1024, 101), (1000, 101), (7, 3)):
        (_, _, _, _), t = _case(b, n, 16, b, "bfloat16")
        src, idx, rows, mask = (x.to(dev) for x in t)
        assert torch.equal(R.gather_rows(src, idx), R._gather_rows_plain(src, idx))
        dst = R.scatter_rows(src.clone(), idx, rows, mask)
        assert torch.equal(dst, R._scatter_rows_plain(src, idx, rows, mask))
