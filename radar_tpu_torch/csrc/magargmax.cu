// Masked argmax kernel for Hopper (sm_90a): per row of a complex64 range
// spectrum, the first index of the largest |X|^2 over bins [0, w) and the
// square root of that power.
//
// Replaces the TPU kernel radar_tpu/ops/pallas/magargmax.py _kernel (entry
// masked_argmax_pallas), the detect stage of the reference-parity range
// pipeline (RangeDetector(detect_impl='pallas')).  The TPU kernel reads
// split re / im planes because Pallas has no complex dtype; this one reads
// the complex64 spectrum in place as interleaved (re, im) float pairs and
// touches only the first w bins of each row.
//
// It is bit-identical to the plain version ops/detect.scan_window_argmax
// (torch.argmax over re*re + im*im, then sqrt) on finite spectra:
//   * the power is __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)): two
//     separately rounded products and a rounded sum, never an FMA, which
//     nvcc would otherwise contract a*a + b*b into;
//   * the reduction compares (value, index) pairs, larger value first and
//     the lower index on a tie (FindAbsMax's strict >);
//   * the magnitude is sqrtf, IEEE-rounded (no --use_fast_math).
// NaN follows torch.argmax: a NaN ranks above every number and the first
// NaN wins.  (The TPU kernel returns n there: masked == peak never holds.)
//
// What bounds it on an H100: the bytes.  It reads w * 8 bytes a row, 26.8
// MB for 512 rows of 6,553 bins (about 8 us at 3.35 TB/s), and writes 8
// bytes a row; the work is 3 flops a bin.  The design is the simple one:
// one block of 256 threads per row, each thread striding over the window
// with 8-byte loads (a warp reads 256 contiguous bytes), a warp shuffle
// reduction, then one over the block's warps.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// torch.argmax order: NaN above every number (the lower index among
// NaNs), then the larger value, ties to the lower index.
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb,
                                             int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (ranks_before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads) masked_argmax_kernel(
    const float2* __restrict__ x, long long row_len, int w,
    int32_t* __restrict__ idx, float* __restrict__ mag) {
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const long long row = blockIdx.x;
  const float2* xr = x + row * row_len;

  // A thread's bins ascend, so its first maximum is kept.  Every power
  // is >= 0 or NaN, so the first bin always replaces the start value;
  // threads without a bin keep (-inf, INT_MAX), which never wins.
  float bv = -CUDART_INF_F;
  int bi = 0x7fffffff;
#pragma unroll 4
  for (int i = tid; i < w; i += kThreads) {
    const float2 v = xr[i];
    const float p = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    if (ranks_before(p, i, bv, bi)) {
      bv = p;
      bi = i;
    }
  }
  warp_argmax(bv, bi);
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kThreads / 32 ? red_v[lane] : -CUDART_INF_F;
    bi = lane < kThreads / 32 ? red_i[lane] : 0x7fffffff;
    warp_argmax(bv, bi);
    if (lane == 0) {
      idx[row] = bi;
      mag[row] = sqrtf(bv);
    }
  }
}

}  // namespace

extern "C" {

// Masked argmax on ``stream``: x (B, row_len) complex64 as interleaved f32
// pairs, contiguous -> idx int32 (B), mag f32 (B), over bins [0, w).
int radar_masked_argmax(const float* x, int32_t* idx, float* mag,
                        int n_rows, int row_len, int w, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0) return cudaSuccess;
  if (w < 1 || w > row_len) return cudaErrorInvalidValue;
  masked_argmax_kernel<<<n_rows, kThreads, 0, stream>>>(
      reinterpret_cast<const float2*>(x), row_len, w, idx, mag);
  return cudaGetLastError();
}

}  // extern "C"
