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
// to an SM.  The block gathers its rows plus the wrapped +-wd Doppler
// halo into shared memory (28 rows at the default window; the halo rows
// are read again from L2 by the next band), sums the two Doppler strip
// maps of its rows, then the range strips (cfar_common.cuh band_cfar,
// the detect stage's code).  Where the halo would reach around the axis,
// the block holds the whole map instead.  Every cell sums its window
// offsets in the same order as the detect stage, so both paths'
// thresholds are bit-identical; at the default window the adds come
// from register copies of a column and of a strip row, and the
// strip rows carry their range halo, so the edge cells take the same
// path.  Shared memory, tile rows x R plus 2 kBand x (R + 2 range_pad)
// floats (layout.h threshold_smem), is the only gate on the map's size.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "layout.h"

namespace {

constexpr int kThreads = 256;

template <int GD, int WD, int GR, int WR>
__global__ void __launch_bounds__(kThreads) threshold_kernel(
    const float* __restrict__ power, float* __restrict__ thresh, int d_size,
    int r_size, int kind, int range_wrap, int gd, int gr, int wd, int wr,
    float coef) {
  extern __shared__ __align__(16) float smem[];
  const int n_bands = radar_layout::n_bands(d_size);
  const long long b = blockIdx.x / n_bands;
  const radar_cfar::BandRows rows =
      radar_cfar::band_rows(blockIdx.x % n_bands, d_size, wd);
  float* p = smem;
  float* strips = p + radar_cfar::tile_rows(d_size, wd) * r_size;
  float* out = thresh + (b * d_size + rows.d0) * r_size;
  radar_cfar::band_cfar<GD, WD, GR, WR>(
      power + b * d_size * r_size, p, strips, rows, d_size, r_size, kind,
      range_wrap, gd, gr, wd, wr, coef,
      [&](int l, int r, float t) { out[l * r_size + r] = t; });
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
  if (n_maps <= 0) return cudaSuccess;
  if (d_size < 1 || r_size < 1 || guard_d < 0 || win_d < guard_d ||
      guard_r < 0 || win_r < guard_r || kind < radar_cfar::kCA ||
      kind > radar_cfar::kSO)
    return cudaErrorInvalidValue;
  const long long smem =
      radar_layout::threshold_smem(d_size, r_size, win_d, win_r);
  const long long n_blocks = (long long)n_maps * radar_layout::n_bands(d_size);
  if (smem > radar_layout::kSmemMax || n_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto kernel = radar_cfar::default_window(guard_d, guard_r, win_d, win_r)
                    ? threshold_kernel<2, 6, 2, 10>
                    : threshold_kernel<-1, -1, -1, -1>;
  const cudaError_t err = radar_cfar::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      power, thresh, d_size, r_size, kind, range_wrap, guard_d, guard_r,
      win_d, win_r, coef);
  return cudaGetLastError();
}

}  // extern "C"
