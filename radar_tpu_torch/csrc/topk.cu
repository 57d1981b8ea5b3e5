// Top-K kernel for Hopper (sm_90a): the K largest entries of each row of
// a (B, N) f32 matrix (flattened CFAR-masked power maps), in lax.top_k
// order.
//
// Replaces the TPU kernel radar_tpu/ops/pallas/topk_kernel.py _kernel
// (entry topk_pallas).  Order: value descending, ties to the lowest
// index.  -inf inputs (non-hits) are read as the f32 minimum and taken
// cells become -inf, so once the finite entries run out the remaining
// slots carry the untaken indices in ascending order, with value -inf,
// exactly as lax.top_k returns them.
//
// What bounds it on an H100: it reads each row once, 4 bytes a cell:
// 8.4 MB for 128 rows of 16,384 cells (about 2.5 us at 3.35 TB/s), 34 MB
// for 512 rows (about 10 us); the K output slots are negligible.  The
// design: one block of 512 threads per row, the row in registers (36
// cells a thread), K rounds of the block argmax of cfar_common.cuh (the
// one the detect kernel runs, so the two paths select identically),
// the winner's cell knocked out each round.  Each round costs two block
// barriers, so at K = 16 latency, not bytes, sets its pace.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cfar_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCellsPerThread = radar_cfar::kMaxCells / kThreads;

__global__ void __launch_bounds__(kThreads) topk_kernel(
    const float* __restrict__ x, int n, int k, float* __restrict__ val,
    int32_t* __restrict__ idx) {
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ float win_v;
  __shared__ int win_i;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* xr = x + row * n;
  float mv[kCellsPerThread];
#pragma unroll
  for (int j = 0; j < kCellsPerThread; ++j) {
    const int i = tid + j * kThreads;
    const float v = i < n ? xr[i] : -CUDART_INF_F;
    mv[j] = v == -CUDART_INF_F ? radar_cfar::kF32Min : v;
  }
  for (int kk = 0; kk < k; ++kk) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < n && radar_cfar::better(mv[j], i, bv, bi)) {
        bv = mv[j];
        bi = i;
      }
    }
    radar_cfar::block_argmax(bv, bi, red_v, red_i, &win_v, &win_i);
    const int win = win_i;
    if (tid == 0) {
      val[row * k + kk] = win_v == radar_cfar::kF32Min ? -CUDART_INF_F : win_v;
      idx[row * k + kk] = win;
    }
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j)
      if (tid + j * kThreads == win) mv[j] = -CUDART_INF_F;
  }
}

}  // namespace

extern "C" {

// Top-K on ``stream``: x (B, N) f32 -> val (B, K) f32, idx (B, K) int32.
int radar_topk(const float* x, float* val, int32_t* idx, int n_rows, int n,
               int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0) return cudaSuccess;
  if (n <= 0 || n > kThreads * kCellsPerThread || k < 1 || k > n)
    return cudaErrorInvalidValue;
  topk_kernel<<<n_rows, kThreads, 0, stream>>>(x, n, k, val, idx);
  return cudaGetLastError();
}

}  // extern "C"
