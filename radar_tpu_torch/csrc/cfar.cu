// CFAR threshold kernel for Hopper (sm_90a): power maps (B, D, R) ->
// threshold maps (B, D, R), cell-averaging (CA), greatest-of (GO) or
// smallest-of (SO).
//
// Replaces the TPU kernel radar_tpu/ops/pallas/cfar_kernel.py
// _cfar_kernel (entry ca_cfar_2d_pallas), and is the threshold stage of
// the maps entry of megakernel.cu (the TPU kernel _make_threshold inside
// _mega_kernel, which also takes GO and SO).  Doppler wraps; range
// reflects or wraps; threshold = coef * (CA ring sum, or GO/SO half sum).
//
// What bounds it on an H100: it reads each map once and writes its
// threshold once, 8 bytes a cell: 8.4 MB in and out for the 128 summed
// maps of a 512-frame NCI batch (about 5 us at 3.35 TB/s), 34 MB for 512
// maps (about 20 us).  The window sums are ~50 adds a cell, 0.8 GFLOP on
// 512 maps, far under the f32 rate, so bytes bound it, and launch
// latency shows at these sizes.  The design: one block per band of
// kBand Doppler rows of one map, so 128 maps give 1024 blocks, several
// to an SM.  The block gathers its rows plus the wrapped +-(gd + td)
// Doppler halo into shared memory (28 rows of 128 at the default
// window; the halo rows are read again from L2 by the next band), sums
// the two Doppler strip maps of its rows, then the range strips.  Where
// the halo would reach around the axis, the block holds the whole map
// instead.  Every cell sums its window offsets through the index maps of
// cfar_common.cuh in the same order as the detect kernel, so both paths'
// thresholds are bit-identical.  On the card this form stays far above
// the byte bound: the index arithmetic around each cell's ~55 shared-
// memory adds, not the bytes, sets its pace (PERF.md).  Branch-free
// interior loops or running sums along the axes (a new summation order)
// are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 16;   // Doppler rows a block

__global__ void __launch_bounds__(kThreads) threshold_kernel(
    const float* __restrict__ power, float* __restrict__ thresh, int d_size,
    int r_size, int halo, int kind, int range_wrap, int gd, int gr, int wd,
    int wr, float coef) {
  extern __shared__ float smem[];
  const int n_bands = (d_size + kBand - 1) / kBand;
  const long long b = blockIdx.x / n_bands;
  const int d0 = (blockIdx.x % n_bands) * kBand;
  const int nb = min(kBand, d_size - d0);
  // the band's rows with their Doppler halo, or the whole map
  const int p_rows = halo ? nb + 2 * wd : d_size;
  const int first = halo ? d0 - wd : 0;
  float* p = smem;
  float* y1 = p + p_rows * r_size;
  float* y2 = y1 + nb * r_size;
  const float* pf = power + b * d_size * r_size;
  for (int i = threadIdx.x; i < p_rows * r_size; i += kThreads) {
    const int h = i / r_size, r = i % r_size;
    p[i] = pf[radar_cfar::wrap_index(first + h, d_size) * r_size + r];
  }
  __syncthreads();
  radar_cfar::doppler_strips(p, y1, y2, p_rows, halo ? wd : d0, nb, r_size,
                             gd, wd, kThreads);
  __syncthreads();
  float* out = thresh + (b * d_size + d0) * r_size;
  for (int i = threadIdx.x; i < nb * r_size; i += kThreads)
    out[i] = radar_cfar::threshold(y1, y2, i / r_size, i % r_size, r_size,
                                   kind, range_wrap, gr, wr, coef);
}

}  // namespace

extern "C" {

// Threshold maps on ``stream``: power (B, D, R) f32 -> thresh (B, D, R)
// f32; kind 0 CA, 1 GO, 2 SO; coef = alpha / n_train (CA) or the
// Gandhi-Kassam multiplier of the half sum (GO/SO).
int radar_cfar_threshold(const float* power, float* thresh, int n_maps,
                         int d_size, int r_size, int kind, int range_wrap,
                         int guard_d, int guard_r, int win_d, int win_r,
                         float coef, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_cells = d_size * r_size;
  if (n_maps <= 0) return cudaSuccess;
  if (n_cells <= 0 || n_cells > radar_cfar::kMaxCells ||
      kind < radar_cfar::kCA || kind > radar_cfar::kSO)
    return cudaErrorInvalidValue;
  // a halo that reaches around the axis holds no fewer rows than the map
  const int halo = kBand + 2 * win_d < d_size;
  const int band = d_size < kBand ? d_size : kBand;
  const int p_rows = halo ? kBand + 2 * win_d : d_size;
  const size_t smem = (size_t)(p_rows + 2 * band) * r_size * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      threshold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_blocks =
      (long long)n_maps * ((d_size + kBand - 1) / kBand);
  threshold_kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      power, thresh, d_size, r_size, halo, kind, range_wrap, guard_d,
      guard_r, win_d, win_r, coef);
  return cudaGetLastError();
}

}  // extern "C"
