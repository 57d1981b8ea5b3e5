// Top-K kernel for Hopper (sm_90a): the K largest entries of each row of
// a (B, N) f32 matrix (flattened CFAR-masked power maps), in lax.top_k
// order.
//
// Replaces the TPU kernel radar_tpu/ops/pallas/topk_kernel.py _kernel
// (entry topk_pallas).  Order: value descending, ties to the lowest
// index.  -inf inputs (non-hits) are read as the f32 minimum, the
// selection's sentinel, so once the finite entries run out the remaining
// slots carry the untaken indices in ascending order, with value -inf,
// exactly as lax.top_k returns them.
//
// What bounds it on an H100: it reads each row once, 4 bytes a cell:
// 8.4 MB for 128 rows of 16,384 cells (about 2.5 us at 3.35 TB/s), 34 MB
// for 512 rows (about 10 us); the K output slots are negligible.  The
// design is the detect stage's selection (select_common.cuh), so the two
// paths select identically: one block of 256 threads per chunk of
// kChunk cells of a row (8 a thread), which compacts the row's finite
// cells, orders them and keeps the chunk's top min(K, kChunk) in a
// workspace; the row's last chunk block merges the chunks' lists into
// the row's K, reading them through L2.  A masked map has few finite
// cells, so a chunk costs one coalesced pass and a short sort, with no
// per-slot barrier; N has no limit but the int index.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "layout.h"
#include "select_common.cuh"

namespace {

using radar_cfar::kF32Min;
using radar_layout::kChunk;
using radar_select::Cand;

constexpr int kThreads = 256;

// Shared memory (layout.h topk_smem): the chunk (kChunk f32), its
// compacted list (kChunk candidates), its top m (m candidates).
__global__ void __launch_bounds__(kThreads) topk_kernel(
    const float* __restrict__ x, int n, int k, float* __restrict__ val,
    int32_t* __restrict__ idx, unsigned* __restrict__ tickets,
    int* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_int[2];
  const int n_chunks = radar_layout::topk_chunks(n);
  const long long row = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x % n_chunks;
  const int g0 = chunk * kChunk;
  const int len = min(kChunk, n - g0);
  const int m = min(k, kChunk);
  float* v = smem;
  Cand* list = reinterpret_cast<Cand*>(v + kChunk);
  Cand* out = list + kChunk;
  const float* xr = x + row * n + g0;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float t = xr[i];
    v[i] = t == -CUDART_INF_F ? kF32Min : t;
  }
  __syncthreads();
  radar_select::chunk_top_k(v, len, g0, k, list, out, &s_int[0]);
  // the row's top K, place by place; the sentinel leaves as -inf
  const auto emit = [&](int place, const Cand& c) {
    val[row * k + place] = c.v == kF32Min ? -CUDART_INF_F : c.v;
    idx[row * k + place] = c.i;
  };
  if (n_chunks == 1) {   // the chunk is the row (m = K <= N)
    for (int i = threadIdx.x; i < k; i += kThreads) emit(i, out[i]);
    return;
  }
  Cand* row_lists = reinterpret_cast<Cand*>(work) + row * n_chunks * m;
  for (int i = threadIdx.x; i < min(m, len); i += kThreads)
    row_lists[chunk * m + i] = out[i];
  if (!radar_select::last_to_arrive(&tickets[row], n_chunks, &s_int[1]))
    return;
  const int m_last = min(k, n - (n_chunks - 1) * kChunk);
  radar_select::merge_lists<true>(row_lists, n_chunks, m, m_last, k, emit);
}

}  // namespace

extern "C" {

// Top-K on ``stream``: x (B, N) f32 -> val (B, K) f32, idx (B, K) int32.
// Where N > 2048: ``tickets``, B int32 that are zero, one a row, which
// the launch leaves zero, and ``work``, an int32 workspace of
// ``work_words`` >= layout.h topk_work_words, 2 B ceil(N / 2048)
// min(K, 2048) words (the chunks' lists).
int radar_topk(const float* x, float* val, int32_t* idx, int* tickets,
               int* work, long long work_words, int n_rows, int n, int k,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0) return cudaSuccess;
  if (n <= 0 || k < 1 || k > n) return cudaErrorInvalidValue;
  const int n_chunks = radar_layout::topk_chunks(n);
  const long long n_blocks = (long long)n_rows * n_chunks;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n_chunks > 1 &&
      (tickets == nullptr || work == nullptr ||
       work_words < radar_layout::topk_work_words(n_rows, n, k)))
    return cudaErrorInvalidValue;
  const long long smem = radar_layout::topk_smem(k);
  const cudaError_t err = radar_cfar::allow_smem(topk_kernel, smem);
  if (err != cudaSuccess) return err;
  topk_kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      x, n, k, val, idx, reinterpret_cast<unsigned*>(tickets), work);
  return cudaGetLastError();
}

}  // extern "C"
