// The planar (azimuth, elevation) angle scan for Hopper (sm_90a): per
// detection, the matched-filter power of its TDM-compensated snapshot on
// every point of the (n_az, n_el) grid and the grid point of the largest,
// as (azimuth_deg, elevation_deg).
//
// Replaces no TPU kernel.  The JAX package leaves the scan of
// RDPipeline.refine_2d to XLA; in eager PyTorch its plain version
// (ops/aoa.aoa_2d_from_snapshots_reference) is a Python sum of V broadcast
// complex products per chunk of 24 azimuth rows, so it writes the whole
// (N, n_az * n_el) spectrum, and its power, to device memory and reads
// them back, in a few hundred launches: ~10 ms a batch at B = 512, K = 16
// and V = 8, where one argmax per detection is all that is kept.
//
// It reproduces the plain version as that runs on the card, bit for bit:
//   * per grid point the channel sum in channel order, each complex product
//     as torch's build of c10::complex's a*c - b*d, a*d + b*c contracts it
//     (cmul: the FMA on the first product, as csrc/tail.cu found), each
//     add rounded on its own (__fadd_rn);
//   * the power __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)): three
//     torch kernels, never an FMA;
//   * the first maximum in grid order, as torch.argmax takes it over the
//     whole grid: NaN above every number, the first NaN wins, ties to the
//     lower index (the plain version's chunks of azimuth rows keep that
//     order; they only bound its memory).
// Python's sum starts from 0; adding the first product to +0 changes at
// most the sign of a zero, which the power squares away, so the sum here
// starts from the first product.  Each later product b is added as
// torch's add does, a + alpha * b with alpha = 1 + 0i, where 0 * inf and
// 0 * NaN make a component NaN: a power whose sum took a product past the
// first with a component not finite is NaN there, where the plain sum
// here can read inf.  Only a power that is not finite can differ, so the
// products are looked at again only there (nonfinite_power).  No TF32 and no fast math: the power is
// independent of torch.backends.cuda.matmul.allow_tf32, as the refiners'
// contract asks.
//
// What bounds it on an H100: the operations.  At N = B * K = 8,192
// detections, V = 12 channels and the 181 x 61 grid it does 8 flops a
// channel and 3 a point, 8.9 GFLOP (0.13 ms at the 67 TFLOP/s of f32
// outside the tensor cores), and reads 0.8 MB of snapshots and the 1.06
// MB steering table.  The design keeps every intermediate on chip: one
// thread a (detection, segment of the grid), the snapshot in registers
// (V a template argument at the deployments' 4, 8, 12 and 16 channels;
// any other count takes a general path that reads it from memory), the
// running (power, index) in registers, so the spectrum is never written.
// A block is 32 detections (the lanes) by 8 warps; each warp walks
// segments of ~230 consecutive points, staging their steering vectors in
// shared memory 16 points at a time with cp.async, one tile ahead of the
// arithmetic, and every lane reads the point in hand at one address (a
// broadcast).  The segments' partial peaks meet in shared memory, where
// warp 0 reduces them in grid order.  The first build read the table
// straight from L2, point by point, and took 1.19 ms a batch (11 % of
// the bound): each warp waited on L2 latency with nothing in flight.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;            // grid points a warp stages at a time
constexpr int kSegmentTarget = 256;  // grid points a segment aims at
constexpr int kMaxSegments = 64;     // partial peaks a block holds (a
                                     // multiple of kWarps)
constexpr int kSmemDefault = 48 * 1024;

// One complex64 product as torch's CUDA mul computes it (csrc/tail.cu).
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// Whether a later grid point of power p displaces the peak so far, in
// torch.argmax's order: a larger number, or a NaN over a number.
__device__ __forceinline__ bool later_wins(float p, float best) {
  return p > best || (isnan(p) && !isnan(best));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// A power p that is not finite, as the plain version reads it: NaN where
// a product past the first, snapshot snap against the conj-steering
// vector a, has a component that is not finite (torch's add turns the
// other component NaN); p elsewhere.  Not inlined: it runs only on
// infinite or NaN powers.
__device__ __noinline__ float nonfinite_power(float p,
                                              const float2* __restrict__ snap,
                                              const float2* a, int v) {
  for (int j = 1; j < v; ++j) {
    const float2 t = cmul(snap[j], a[j]);
    if (!(fabsf(t.x) < CUDART_INF_F && fabsf(t.y) < CUDART_INF_F)) {
      return CUDART_NAN_F;
    }
  }
  return p;
}

// Copy n_pts grid points' steering vectors (V channels each, V even:
// 16 bytes a channel pair) into this warp's buffer, as one group of
// asynchronous copies.
template <int V>
__device__ __forceinline__ void stage(float2* dst, const float2* src,
                                      int n_pts, int lane) {
  static_assert(V % 2 == 0, "the staged paths take an even channel count");
  const int n = n_pts * (V / 2);
  for (int i = lane; i < n; i += 32) cp_async16(dst + 2 * i, src + 2 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The power of one grid point: the channel sum of snapshot s (V a
// template argument; the snapshot in registers, snap its copy in device
// memory) against the conj-steering vector a, in channel order.
template <int V>
__device__ __forceinline__ float point_power(const float2 (&s)[V],
                                             const float2* snap,
                                             const float2* a) {
  float2 w[V];
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const float4 q = a4[j];
    w[2 * j] = make_float2(q.x, q.y);
    w[2 * j + 1] = make_float2(q.z, q.w);
  }
  float2 acc = cmul(s[0], w[0]);
#pragma unroll
  for (int j = 1; j < V; ++j) {
    const float2 t = cmul(s[j], w[j]);
    acc.x = __fadd_rn(acc.x, t.x);
    acc.y = __fadd_rn(acc.y, t.y);
  }
  const float p = __fadd_rn(__fmul_rn(acc.x, acc.x), __fmul_rn(acc.y, acc.y));
  return p < CUDART_INF_F ? p : nonfinite_power(p, snap, a, V);
}

// Any channel count: the snapshot and the table read from device memory.
__device__ float point_power_any(const float2* __restrict__ snap,
                                 const float2* __restrict__ a, int v) {
  float2 acc = cmul(snap[0], __ldg(a));
  for (int j = 1; j < v; ++j) {
    const float2 t = cmul(snap[j], __ldg(a + j));
    acc.x = __fadd_rn(acc.x, t.x);
    acc.y = __fadd_rn(acc.y, t.y);
  }
  const float p = __fadd_rn(__fmul_rn(acc.x, acc.x), __fmul_rn(acc.y, acc.y));
  return p < CUDART_INF_F ? p : nonfinite_power(p, snap, a, v);
}

// The peak of grid points [start, end) for this lane's snapshot: (power,
// index) of the first maximum in torch.argmax's order.  V > 0: the warp
// stages the points' steering vectors in shared memory a tile ahead of
// the one in hand (cp.async, so the table's L2 latency hides behind a
// tile of arithmetic) and every lane reads the same address (a
// broadcast).
template <int V>
__device__ __forceinline__ void segment_peak(
    const float2 (&s)[V > 0 ? V : 1], const float2* __restrict__ snap,
    const float2* __restrict__ steer, float2* buf, int start, int end, int v,
    int lane, float& best, int& best_i) {
  best = -CUDART_INF_F;
  best_i = -1;
  if constexpr (V == 0) {
    for (int g = start; g < end; ++g) {
      const float p = point_power_any(snap, steer + (long long)g * v, v);
      if (later_wins(p, best)) {
        best = p;
        best_i = g;
      }
    }
  } else {
    const int n = end - start;
    if (n <= 0) return;    // a segment past the end of a small grid
    stage<V>(buf, steer + (long long)start * V, min(kTile, n), lane);
    for (int t0 = 0, cur = 0; t0 < n; t0 += kTile, cur ^= 1) {
      const int next = t0 + kTile;
      if (next < n) {
        stage<V>(buf + (cur ^ 1) * kTile * V,
                 steer + (long long)(start + next) * V, min(kTile, n - next),
                 lane);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncwarp();
      const float2* tile = buf + cur * kTile * V;
      const int pts = min(kTile, n - t0);
#pragma unroll 2
      for (int q = 0; q < pts; ++q) {
        const float p = point_power<V>(s, snap, tile + q * V);
        if (later_wins(p, best)) {
          best = p;
          best_i = start + t0 + q;
        }
      }
      __syncwarp();    // the tile is read before it is staged over
    }
  }
}

// Segment seg holds grid points [seg * seg_len, ...) up to the grid's
// end; segments past the end of a small grid are empty.  Shared memory:
// each warp's two staging tiles (V > 0), then the partial peaks
// [n_seg][32].
template <int V>
__global__ void __launch_bounds__(kThreads) aoa2d_scan_kernel(
    const float2* __restrict__ snaps, const float2* __restrict__ steer,
    const float* __restrict__ az_axis, const float* __restrict__ el_axis,
    float* __restrict__ az_out, float* __restrict__ el_out, int n_det,
    int v, int n_el, int n_grid, int n_seg, int seg_len) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float2* buf = reinterpret_cast<float2*>(smem) + warp * 2 * kTile * V;
  float* part_v = reinterpret_cast<float*>(
      reinterpret_cast<float2*>(smem) + kWarps * 2 * kTile * V);
  int* part_i = reinterpret_cast<int*>(part_v + n_seg * 32);
  const long long det = (long long)blockIdx.x * 32 + lane;
  const bool live = det < n_det;
  // a lane past the last detection scans detection 0 and keeps nothing
  const float2* snap = snaps + (live ? det : 0) * v;
  float2 s[V > 0 ? V : 1];
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = snap[j];
  }

  for (int seg = warp; seg < n_seg; seg += kWarps) {
    const int start = seg * seg_len;
    const int end = min(start + seg_len, n_grid);
    float best;
    int best_i;
    segment_peak<V>(s, snap, steer, buf, start, end, v, lane, best, best_i);
    part_v[seg * 32 + lane] = best;
    part_i[seg * 32 + lane] = best_i;       // -1: an empty segment
  }
  __syncthreads();
  if (warp != 0 || !live) return;

  // segment 0 is never empty; the later ones in grid order
  float peak = part_v[lane];
  int peak_i = part_i[lane];
  for (int seg = 1; seg < n_seg; ++seg) {
    const int k = seg * 32 + lane;
    if (part_i[k] >= 0 && later_wins(part_v[k], peak)) {
      peak = part_v[k];
      peak_i = part_i[k];
    }
  }
  az_out[det] = az_axis[peak_i / n_el];
  el_out[det] = el_axis[peak_i % n_el];
}

template <int V>
cudaError_t launch_scan(const float2* snaps, const float2* steer,
                        const float* az_axis, const float* el_axis,
                        float* az_out, float* el_out, int n_det, int v,
                        int n_el, int n_grid, int n_seg, int seg_len,
                        cudaStream_t stream) {
  const int blocks = (n_det + 31) / 32;
  const size_t smem = (size_t)kWarps * 2 * kTile * V * sizeof(float2) +
                      (size_t)n_seg * 32 * 8;
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        aoa2d_scan_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  aoa2d_scan_kernel<V><<<blocks, kThreads, smem, stream>>>(
      snaps, steer, az_axis, el_axis, az_out, el_out, n_det, v, n_el,
      n_grid, n_seg, seg_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The scan on ``stream`` over n_det TDM-compensated snapshots, complex64
// (n_det, v) as f32 pairs, against the conj-steering table complex64
// (n_az, n_el, v) with its f32 axes az_axis (n_az) and el_axis (n_el)
// -> az_out, el_out f32 (n_det).  snaps and steer start on 16-byte
// boundaries.
int radar_aoa2d_scan(const float* snaps, const float* steer,
                     const float* az_axis, const float* el_axis,
                     float* az_out, float* el_out, int n_det, int v,
                     int n_az, int n_el, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_det <= 0) return cudaSuccess;
  if (v < 1 || n_az < 1 || n_el < 1 ||
      (long long)n_az * n_el > 0x7fffffffLL / 2) {
    return cudaErrorInvalidValue;
  }
  const int n_grid = n_az * n_el;
  // segments of ~kSegmentTarget points, a whole number of rounds of the
  // block's warps
  const int n_seg = min(kMaxSegments,
                        (n_grid + kSegmentTarget * kWarps - 1) /
                            (kSegmentTarget * kWarps) * kWarps);
  const int seg_len = (n_grid + n_seg - 1) / n_seg;
  const float2* s = reinterpret_cast<const float2*>(snaps);
  const float2* a = reinterpret_cast<const float2*>(steer);
#define RADAR_AOA2D_CASE(N)                                                \
  case N:                                                                  \
    return launch_scan<N>(s, a, az_axis, el_axis, az_out, el_out, n_det,  \
                          v, n_el, n_grid, n_seg, seg_len, stream);
  switch (v) {
    RADAR_AOA2D_CASE(4)
    RADAR_AOA2D_CASE(8)
    RADAR_AOA2D_CASE(12)
    RADAR_AOA2D_CASE(16)
    default:
      return launch_scan<0>(s, a, az_axis, el_axis, az_out, el_out, n_det,
                            v, n_el, n_grid, n_seg, seg_len, stream);
  }
#undef RADAR_AOA2D_CASE
}

}  // extern "C"
