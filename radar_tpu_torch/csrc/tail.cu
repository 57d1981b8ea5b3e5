// The detect op's tail for Hopper (sm_90a): from kernel 1's detection
// lists, every field of the RDResult that RDPipeline.detect returns (all
// but num_hits, which passes through) in one launch.  The maps path's tail
// (models/rd_pipeline.assemble_result: the top-K kernel's raw lists over
// a power map) is the same work but for where the five power samples of
// the sub-bin parabolas come from, so one kernel serves both, templated
// on that source: kernel 1 hands them over (kFromMap = false, entry
// radar_detect_tail), the maps path hands over the (..., D, R) power map,
// which the kernel reads at the indices of ops/cells.neighbour_samples
// (kFromMap = true, entry radar_maps_tail).
//
// Replaces no TPU kernel.  The JAX package leaves this O(B*K) work to XLA,
// which fuses it into a few ops; in eager PyTorch the same formulas
// (models/rd_pipeline.assemble_result_from_kernel_reference) are about a
// hundred small launches a batch, 15-20 us of host time each, so on the
// card the host, not the device, set the pace of detect.  Per detection:
//   * valid = isfinite(top_val), power = valid ? top_val : 0;
//   * the Doppler and range bins of the flat cell index (floor // and %);
//   * cell physics: range_m, velocity_mps (ops/physics.cell_physics);
//   * the sub-bin range and velocity: two log-parabolas through the
//     neighbour samples, the range one zeroed at the map's edge bins
//     (rd_pipeline.interp_from_samples, _parabolic_core);
//   * the RX calibration, then the TDM phase where num_tx > 1
//     (physics.apply_rx_cal, mimo_compensate);
//   * the angle spectrum over the first v = min(V, n) channels, summed in
//     channel order (ops/aoa.angle_fft_spectrum), its first-index argmax
//     over the n bins, the circular three-point log-parabola, asinf of the
//     clamped sin(theta) and the degrees (rd_pipeline.aoa_from_snapshots).
//
// It reproduces the plain version as that runs on the card, op by op.
// Where torch ran separate kernels, each rounding is its own:
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts no
// multiply-add that torch did not; a complex product, one torch kernel,
// takes the FMA that torch's build makes of it (cmul).  logf, cosf, sinf
// and asinf are the accurate library functions (no --use_fast_math).  The
// wrapper (ops/cuda/tail.py) rounds each Python-scalar factor to f32 once
// on the host, as torch does, and passes a division by a Python scalar as
// the multiply by the reciprocal that torch's CUDA div_true runs (taken
// in double, then rounded to f32).  selftest._det_fields is the gate:
// every field bit-exact but azimuth_deg, held to 1e-3 degrees, since the
// library functions of torch's CUDA and of this nvcc may differ in a last
// bit (on an H100 with torch 2.11 for CUDA 12.8 and nvcc 12.9, azimuth and
// angle bins came out bit-exact too).  NaN follows torch: clamp and
// clamp_min pass it, argmax ranks it above every number (the first NaN
// wins), ties go to the lower bin.
//
// What bounds it on an H100: neither bytes nor operations.  At B = 512,
// K = 16 it reads ~0.6 MB and writes ~0.4 MB (~0.3 us at 3.35 TB/s) and
// does a few million multiply-adds; it took 13-22 us a batch, the latency
// of each warp's short serial chain, against ~0.18-0.22 ms of device time
// and 1.7-2.5 ms of host time for the plain version's launches.  The design
// takes any V and n: one warp per detection, each lane one channel of the
// compensated snapshot (broadcast with shuffles, 32 channels a round) and
// bins lane, lane + 32, ... of the spectrum, the argmax reduced across
// the warp, then one more pass for the peak's two neighbours (recomputed
// with the same arithmetic, so the same bits).  Four detections a block.
// From a map, lanes 0-4 each issue one of the five scattered reads before
// the spectrum, so their latency hides under it; the top-K lists' slots
// past the hits carry untaken in-range cells (csrc/topk.cu), so every
// read lies inside its frame's map.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The f32 factors of the plain version's Python scalars, rounded on the
// host (ops/cuda/tail.tail_scalars, same order).
struct Scalars {
  float range_hz;      // sample_rate / range_fft_size
  float range_m;       // c / (2 slope)
  float range_interp;  // sample_rate / range_fft_size * c / (2 slope)
  float dopp_recip;    // 1 / (doppler_fft_size * slow_time_interval)
  float half_wl;       // wavelength / 2
  float tdm_coef;      // -2 pi chirp_interval
  float angle_recip;   // 1 / (num_angle_bins * rx_spacing)
  float rad2deg;       // 180 / pi
};

// torch.clamp_min / torch.clamp with scalar bounds: NaN passes through.
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// One complex64 product as torch's CUDA mul computes it: c10::complex's
// a*c - b*d and a*d + b*c, contracted by torch's build into an FMA on the
// first product (measured on the card), written out here so that this
// build cannot contract it otherwise.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// rd_pipeline._parabolic_core: the sub-bin offset in [-0.5, 0.5] of three
// power samples, each op rounded on its own as torch's kernels round it.
__device__ float parabolic(float pm, float pc, float pp) {
  const float eps = (float)1e-30, tiny = (float)1e-12;
  const float lm = logf(clamp_min_t(pm, eps));
  const float lc = logf(clamp_min_t(pc, eps));
  const float lp = logf(clamp_min_t(pp, eps));
  const float denom = __fadd_rn(__fsub_rn(lm, __fmul_rn(2.0f, lc)), lp);
  const float q = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(lm, lp)),
                            denom == 0.0f ? 1.0f : denom);
  return clamp_t(fabsf(denom) > tiny ? q : 0.0f, -0.5f, 0.5f);
}

// torch.argmax order: NaN above every number (the lower index among
// NaNs), then the larger value, ties to the lower index.
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb,
                                             int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

// |spectrum|^2 at this lane's bin j (j < 0: none; every lane takes part
// in the shuffles): the snapshot's first v channels, calibrated and
// TDM-rotated by the lane that owns each, times angle row ch, added in
// channel order onto 0 as Python's sum does.
__device__ float bin_power(int j, const float2* __restrict__ snap,
                           const float2* __restrict__ rows,
                           const float2* __restrict__ cal, int v, int n,
                           int num_rx, int num_tx, float phase_fd,
                           int lane) {
  float re = 0.0f, im = 0.0f;
  for (int c0 = 0; c0 < v; c0 += 32) {
    const int ch = c0 + lane;
    float2 x = make_float2(0.0f, 0.0f);
    if (ch < v) {
      x = snap[ch];
      if (cal != nullptr) x = cmul(x, cal[ch]);
      if (num_tx > 1) {
        const float ph = __fmul_rn(phase_fd, (float)(ch / num_rx));
        x = cmul(x, make_float2(cosf(ph), sinf(ph)));
      }
    }
    const int cn = min(32, v - c0);
    for (int c = 0; c < cn; ++c) {
      const float2 s = make_float2(__shfl_sync(kFull, x.x, c),
                                   __shfl_sync(kFull, x.y, c));
      if (j >= 0) {
        const float2 p = cmul(s, rows[(long long)(c0 + c) * n + j]);
        re = __fadd_rn(re, p.x);
        im = __fadd_rn(im, p.y);
      }
    }
  }
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// samples: kFromMap = false, kernel 1's (n_det, 5) samples (centre, range
// -1 / +1, Doppler -1 / +1); true, the power maps (n_det / k, D, R), k
// detections a map.
template <bool kFromMap>
__global__ void __launch_bounds__(kThreads) detect_tail_kernel(
    const int32_t* __restrict__ top_idx, const float* __restrict__ top_val,
    const float* __restrict__ samples, const float2* __restrict__ snaps,
    const float2* __restrict__ rows, const float2* __restrict__ cal,
    float* __restrict__ out_f, int32_t* __restrict__ out_i,
    bool* __restrict__ valid, int n_det, int n_ch, int v, int n, int r_size,
    int d_size, int num_rx, int num_tx, Scalars s, int k) {
  const int lane = threadIdx.x % 32;
  const long long det =
      (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (det >= n_det) return;   // whole warps leave together

  const int idx = top_idx[det];
  int d_bin = idx / r_size, r_bin = idx % r_size;
  if (r_bin < 0) {   // floor division, as torch's // and %
    r_bin += r_size;
    d_bin -= 1;
  }
  // from a map: lane i reads sample i (neighbour_samples' order; range
  // neighbours clamp at the map's edges, Doppler neighbours wrap)
  float mine = 0.0f;
  if constexpr (kFromMap) {
    if (lane < 5) {
      // det < n_det fits an int: a 32-bit division, no 64-bit call
      const float* map =
          samples + (long long)((int)det / k) * ((long long)d_size * r_size);
      long long at = idx;
      if (lane == 1) at = idx - (r_bin > 0);
      if (lane == 2) at = idx + (r_bin < r_size - 1);
      if (lane >= 3)
        at = (long long)((d_bin + (lane == 3 ? d_size - 1 : 1)) % d_size) *
                 r_size + r_bin;
      mine = map[at];
    }
  }
  const int d_rel = d_bin - d_size / 2;
  const float fd = __fmul_rn((float)d_rel, s.dopp_recip);   // doppler_hz

  // the angle spectrum's argmax: this lane's bins in ascending order, then
  // the warp's lanes
  const float2* snap = snaps + det * n_ch;
  const float phase_fd = __fmul_rn(s.tdm_coef, fd);
  float best = -CUDART_INF_F;
  int best_j = 0x7fffffff;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane < n ? j0 + lane : -1;
    const float p = bin_power(j, snap, rows, cal, v, n, num_rx, num_tx,
                              phase_fd, lane);
    if (j >= 0 && ranks_before(p, j, best, best_j)) {
      best = p;
      best_j = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(kFull, best, off);
    const int oj = __shfl_down_sync(kFull, best_j, off);
    if (ranks_before(ov, oj, best, best_j)) {
      best = ov;
      best_j = oj;
    }
  }
  const int ab = __shfl_sync(kFull, best_j, 0);
  // lanes 0, 1, 2: the bins (ab - 1) % n, ab, (ab + 1) % n
  const int j3 = lane < 3 ? ((ab + lane - 1) % n + n) % n : -1;
  const float g = bin_power(j3, snap, rows, cal, v, n, num_rx, num_tx,
                            phase_fd, lane);
  const float gm = __shfl_sync(kFull, g, 0);
  const float gc = __shfl_sync(kFull, g, 1);
  const float gp = __shfl_sync(kFull, g, 2);
  // the five samples, each in a register: centre, range -1 / +1,
  // Doppler -1 / +1
  float c, r_m, r_p, d_m, d_p;
  if constexpr (kFromMap) {
    c = __shfl_sync(kFull, mine, 0);
    r_m = __shfl_sync(kFull, mine, 1);
    r_p = __shfl_sync(kFull, mine, 2);
    d_m = __shfl_sync(kFull, mine, 3);
    d_p = __shfl_sync(kFull, mine, 4);
  }
  if (lane != 0) return;

  const float val = top_val[det];
  const bool ok = isfinite(val);
  if constexpr (!kFromMap) {
    const float* nb = samples + 5 * det;
    c = nb[0];
    r_m = nb[1];
    r_p = nb[2];
    d_m = nb[3];
    d_p = nb[4];
  }

  float r_off = parabolic(r_m, c, r_p);
  if (r_bin == 0 || r_bin == r_size - 1) r_off = 0.0f;
  const float d_off = parabolic(d_m, c, d_p);
  const float a_off = parabolic(gm, gc, gp);
  const float sin_theta = __fmul_rn(
      __fsub_rn(__fadd_rn((float)ab, a_off), (float)(n / 2)), s.angle_recip);

  const long long m = n_det;
  out_f[det] = ok ? val : 0.0f;
  out_f[m + det] =
      __fmul_rn(__fmul_rn((float)r_bin, s.range_hz), s.range_m);
  out_f[2 * m + det] = __fmul_rn(fd, s.half_wl);
  out_f[3 * m + det] =
      __fmul_rn(asinf(clamp_t(sin_theta, -1.0f, 1.0f)), s.rad2deg);
  out_f[4 * m + det] =
      __fmul_rn(__fadd_rn((float)r_bin, r_off), s.range_interp);
  out_f[5 * m + det] = __fmul_rn(
      __fmul_rn(__fadd_rn((float)d_rel, d_off), s.dopp_recip), s.half_wl);
  out_i[det] = d_bin;
  out_i[m + det] = r_bin;
  out_i[2 * m + det] = ab;
  valid[det] = ok;
}

// Checks the sizes and launches one variant over n_det detections.
template <bool kFromMap>
int launch_tail(const int32_t* top_idx, const float* top_val,
                const float* samples, const float* snaps, const float* rows,
                const float* cal, float* out_f, int32_t* out_i,
                uint8_t* valid, int n_det, int k, int n_ch, int v,
                int n_bins, int r_size, int d_size, int num_rx, int num_tx,
                const Scalars& s, cudaStream_t stream) {
  if (n_det <= 0) return cudaSuccess;
  if (v < 1 || v > n_ch || v > n_bins || r_size < 1 || d_size < 1 ||
      num_rx < 1 || num_tx < 1 || k < 1 || n_det % k != 0)
    return cudaErrorInvalidValue;
  const int blocks = (n_det + kWarps - 1) / kWarps;
  detect_tail_kernel<kFromMap><<<blocks, kThreads, 0, stream>>>(
      top_idx, top_val, samples, reinterpret_cast<const float2*>(snaps),
      reinterpret_cast<const float2*>(rows),
      reinterpret_cast<const float2*>(cal), out_f, out_i,
      reinterpret_cast<bool*>(valid), n_det, n_ch, v, n_bins, r_size, d_size,
      num_rx, num_tx, s, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The detect op's tail on ``stream`` over n_det = B * K detections, all
// contiguous: top_idx int32 (n_det), top_val f32 (n_det), nbr f32
// (n_det, 5), snaps complex64 (n_det, n_ch) as f32 pairs, rows complex64
// (v, n) angle rows, cal complex64 (n_ch) or null ->
// out_f f32 (6, n_det): power, range_m, velocity_mps, azimuth_deg,
// range_m_interp, velocity_mps_interp; out_i int32 (3, n_det):
// doppler_bin, range_bin, angle_bin; valid bool (n_det).
int radar_detect_tail(const int32_t* top_idx, const float* top_val,
                      const float* nbr, const float* snaps, const float* rows,
                      const float* cal, float* out_f, int32_t* out_i,
                      uint8_t* valid, int n_det, int n_ch, int v,
                      int n_bins, int r_size, int d_size, int num_rx,
                      int num_tx, float range_hz, float range_m,
                      float range_interp, float dopp_recip, float half_wl,
                      float tdm_coef, float angle_recip, float rad2deg,
                      void* stream_ptr) {
  const Scalars s{range_hz, range_m,  range_interp, dopp_recip,
                  half_wl,  tdm_coef, angle_recip,  rad2deg};
  return launch_tail<false>(top_idx, top_val, nbr, snaps, rows, cal, out_f,
                            out_i, valid, n_det, 1, n_ch, v, n_bins, r_size,
                            d_size, num_rx, num_tx, s,
                            static_cast<cudaStream_t>(stream_ptr));
}

// The maps path's tail: as radar_detect_tail, with the power maps f32
// (n_det / k, d_size, r_size) and k, the detections a map, in place of
// nbr; top_idx are the top-K kernel's flat cells of each map (slots past
// the hits carry untaken in-range cells, top_val -inf).
int radar_maps_tail(const int32_t* top_idx, const float* top_val,
                    const float* power, int k, const float* snaps,
                    const float* rows, const float* cal, float* out_f,
                    int32_t* out_i, uint8_t* valid, int n_det, int n_ch,
                    int v, int n_bins, int r_size, int d_size, int num_rx,
                    int num_tx, float range_hz, float range_m,
                    float range_interp, float dopp_recip, float half_wl,
                    float tdm_coef, float angle_recip, float rad2deg,
                    void* stream_ptr) {
  const Scalars s{range_hz, range_m,  range_interp, dopp_recip,
                  half_wl,  tdm_coef, angle_recip,  rad2deg};
  return launch_tail<true>(top_idx, top_val, power, snaps, rows, cal, out_f,
                           out_i, valid, n_det, k, n_ch, v, n_bins, r_size,
                           d_size, num_rx, num_tx, s,
                           static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
