// Per-game row gather and masked row scatter on the search tree's bf16
// prior store, for sm_90a.  Plain C interface, loaded with ctypes by
// die_e_tpu_torch/ops/build.py; every entry point returns
// cudaGetLastError() after its launch.
//
// rows_gather replaces die_e_tpu/ops/rows.py::_gather_rows_pallas
// (rows.py:50-88): out[b] = src[b, idx[b]].
// rows_scatter replaces die_e_tpu/ops/rows.py::_scatter_rows_pallas
// (rows.py:110-156): dst[b, idx[b]] = rows[b] where mask[b], in place.
//
// What bounds them: bytes.  At the main path's shape (B = 1024 games, a
// padded row of 2048 bf16 = 4096 B) a call moves B rows once in and once
// out, about 8.4 MB, or 2.5 us at 3.35 TB/s; the launch costs more than
// that.  Design: one block per game, and the row is copied in 16-byte
// vectors (uint4), so neighbouring threads touch neighbouring 16 B and a
// 4096 B row is 256 vectors, one per thread of a 256-thread block.  No
// shared memory and no atomics: each game reads and writes only its own
// [b] slab.  An idx outside [0, N) reads a zero row (the reference
// fallback _gather_rows_reduce does the same) and writes nothing (as
// _scatter_rows_where), where the TPU's DMA would go out of bounds.
// The row length is an argument, in 16-byte units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const uint4* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   uint4* __restrict__ out,
                                   int n, int row_vecs) {
  const int b = blockIdx.x;
  const int r = idx[b];
  uint4* o = out + (size_t)b * row_vecs;
  if (r < 0 || r >= n) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) o[i] = zero;
    return;
  }
  const uint4* s = src + ((size_t)b * n + r) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) o[i] = s[i];
}

__global__ void scatter_rows_kernel(uint4* __restrict__ dst,
                                    const int32_t* __restrict__ idx,
                                    const uint4* __restrict__ rows,
                                    const uint8_t* __restrict__ mask,
                                    int n, int row_vecs) {
  const int b = blockIdx.x;
  const int r = idx[b];
  if (!mask[b] || r < 0 || r >= n) return;
  uint4* d = dst + ((size_t)b * n + r) * row_vecs;
  const uint4* s = rows + (size_t)b * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) d[i] = s[i];
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int rows_gather(const void* src, const void* idx, void* out,
                           int b, int n, int row_vecs, void* stream) {
  gather_rows_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (const int32_t*)idx, (uint4*)out, n, row_vecs);
  return (int)cudaGetLastError();
}

extern "C" int rows_scatter(void* dst, const void* idx, const void* rows,
                            const void* mask, int b, int n, int row_vecs,
                            void* stream) {
  scatter_rows_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)dst, (const int32_t*)idx, (const uint4*)rows,
      (const uint8_t*)mask, n, row_vecs);
  return (int)cudaGetLastError();
}
