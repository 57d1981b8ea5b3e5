// Mega kernels for Hopper (sm_90a): raw int16 radar frames -> per-frame
// CFAR detection lists (the detect entry), or -> power maps and CFAR
// threshold maps (the maps entry).
//
// The detect entry radar_mega_detect replaces the TPU kernel
// radar_tpu/ops/pallas/megakernel.py _mega_detect_kernel (entry
// detections_from_shorts_pallas).  It computes what that kernel
// computes, per frame:
//   1. raw frame minus the raw-space base (I/Q interleave kept),
//   2. the range DFT with decode and window folded into a (2S, 2R) constant,
//   3. 'base' or 'mean' clutter removal (mean over ALL chirps, pre-demux),
//   4. the TDM demux (chirp = kc * TX + tx),
//   5. the fftshifted, windowed Doppler DFT,
//   6. power summed over the TX*V virtual channels in a fixed order,
//   7. the CA, GO or SO CFAR threshold in the cancellation-free strip
//      form (the kind argument; OS runs on the maps entry's power),
//   8. the hit mask with the range-edge guard, and num_hits,
//   9. top-K in lax.top_k order,
//  10. five neighbour samples (range clamped, Doppler wrapped),
//  11. K x TV complex snapshots from the clutter-removed range planes.
//
// What bounds it on an H100: about 120 MFLOP of f32 DFT per frame at the
// default geometry (52 range + 67 Doppler), 61 GFLOP per 512-frame batch
// against 67 TFLOP/s of non-tensor f32 — about 0.9 ms at peak — while the
// bytes (105 MB of int16 in, 268 MB of range planes written and read
// back, 34 MB of power) need about 0.2 ms at 3.35 TB/s.  So it is bound
// by f32 arithmetic.  This first form keeps the arithmetic in plain f32
// FMAs (every dft_precision tier computes in f32) in three stages with
// the intermediates in device memory, because one frame's range planes
// (512 KB) do not fit a block's 227 KB of shared memory:
//   (a) range_gemm_kernel      tiled f32 GEMM over all frames' rows
//       chirp_mean_kernel      'mean' clutter only, in place on (a)'s planes
//   (b) doppler_power_kernel   per (frame, range tile), all Doppler bins
//   (c) detect_kernel          one block per frame, the power map and the
//                              two CFAR strip maps in dynamic shared memory
// In (a) and (b) the staging of operands, not the FMAs, set the pace
// until it used 16-byte loads prefetched a tile ahead (PERF.md).
// Tensor-core tiers and fusing the intermediates away are later work.
//
// The maps entry radar_mega_maps replaces the TPU kernel _mega_kernel
// (launcher _mega_call; entries power_from_shorts_pallas and
// power_cfar_from_shorts_pallas): stages (a) and (b) as they are, so its
// power maps are bit-identical to the detect entry's, then, for the
// with-CFAR form, the threshold kernel of cfar.cu (CA, GO or SO) on
// them.  Its bound is the detect entry's front end: 61 GFLOP of f32 DFT
// per 512-frame batch, about 0.9 ms at 67 TFLOP/s, against 105 MB in and
// 34 MB of power (plus 34 MB of threshold) out, about 0.05 ms.  The CFAR
// strip sums and the block argmax live in cfar_common.cuh, shared with
// the threshold and top-K kernels, so the two entries' detections agree
// bit for bit.
//
// The fused range entry radar_fused_range replaces the TPU kernel
// radar_tpu/ops/pallas/fused_dft_kernel.py (the inline kernel of
// fused_rd_planes_pallas): int16 frames minus the raw-space base, then
// the two range-DFT dots, written as the range planes.  Its work is
// stage (a) as it is, so it reuses range_gemm_kernel (and, for 'mean'
// clutter, chirp_mean_kernel) rather than a second GEMM; the Doppler
// stage stays outside, as in JAX.  Its bound is the bytes: 105 MB of
// int16 in and 268 MB of planes out per 512-frame batch, about 0.11 ms
// at 3.35 TB/s, against 1.3 GFLOP of FFT-equivalent range work.
//
// The kernels allocate nothing; the caller passes every buffer.  Each
// entry point returns the first CUDA error of its launches.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cfar_common.cuh"

namespace {

using radar_cfar::kF32Min;

// Vector loads from 16- (8-) byte aligned shared memory into registers.
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load2(float* dst, const float* src) {
  const float2 v = *reinterpret_cast<const float2*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
}

// ---------------------------------------------------------------------------
// (a) range DFT: Z[m, n] = sum_j (raw[m, j] - base[m % rows, j]) * A[j, n]
//     m over B*C*V raw rows (one chirp of one RX), j over the 2S
//     interleaved shorts, n over [zr | zi] (2R columns).

//     A 128 x 128 tile per block of 256 threads, 8 x 8 outputs per
//     thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
//     in tx), so each thread does 64 FMAs for 16 shared-memory reads.
//     Staging uses 16-byte loads: per 8-deep K tile, threads 0..127 read
//     one raw row's 8 shorts and its 8 base floats, threads 128..255 two
//     float4s of the constant.  Needs K and N multiples of 8 and 16-byte
//     aligned rows (checked by the entry point and the wrapper).

constexpr int kRaBM = 128, kRaBN = 128, kRaBK = 8;

__global__ void __launch_bounds__(256) range_gemm_kernel(
    const int16_t* __restrict__ raw, const float* __restrict__ base,
    const float* __restrict__ a, float* __restrict__ z,
    long long m_total, int k_total, int n_total, int rows_per_frame) {
  __shared__ __align__(16) float xs[kRaBK][kRaBM];
  __shared__ __align__(16) float as[kRaBK][kRaBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kRaBM;
  const int n0 = blockIdx.y * kRaBN;

  // What this thread stages never changes but the K offset: one raw row
  // and its base row (m mod rows_per_frame), or one 8-column slice of
  // the constant at row kk_a.
  const bool stages_x = tid < kRaBM;
  const int16_t* raw_row = nullptr;
  const float* base_row = nullptr;
  const float* a_col = nullptr;
  const int kk_a = (tid - kRaBM) / (kRaBN / 8);
  const int nn_a = (tid - kRaBM) % (kRaBN / 8) * 8;
  if (stages_x) {
    const long long m = m0 + tid;
    if (m < m_total) {
      raw_row = raw + m * k_total;
      if (base != nullptr) base_row = base + (m % rows_per_frame) * k_total;
    }
  } else if (n0 + nn_a < n_total) {
    a_col = a + (long long)kk_a * n_total + n0 + nn_a;
  }

  // The next K tile is loaded into registers while the current one is
  // multiplied, so device-memory latency hides behind the FMAs.
  float next[8];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) next[i] = 0.f;
    if (stages_x) {
      if (raw_row != nullptr) {
        const int4 r = *reinterpret_cast<const int4*>(raw_row + k0);
        const int w[4] = {r.x, r.y, r.z, r.w};   // two shorts each, low first
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          next[2 * i] = (float)(int16_t)(w[i] & 0xffff);
          next[2 * i + 1] = (float)(w[i] >> 16);
        }
        if (base_row != nullptr) {
          float b[8];
          load4(b, base_row + k0);
          load4(b + 4, base_row + k0 + 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) next[i] -= b[i];
        }
      }
    } else if (a_col != nullptr) {
      load4(next, a_col + (long long)k0 * n_total);
      load4(next + 4, a_col + (long long)k0 * n_total + 4);
    }
  };

  float acc[8][8] = {};
  load_tile(0);
  for (int k0 = 0; k0 < k_total; k0 += kRaBK) {
    if (stages_x) {
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[i][tid] = next[i];
    } else {
      *reinterpret_cast<float4*>(&as[kk_a][nn_a]) =
          make_float4(next[0], next[1], next[2], next[3]);
      *reinterpret_cast<float4*>(&as[kk_a][nn_a + 4]) =
          make_float4(next[4], next[5], next[6], next[7]);
    }
    __syncthreads();
    if (k0 + kRaBK < k_total) load_tile(k0 + kRaBK);
    // each K tile sums into fresh registers, then into the total: the
    // rounding error grows with K/8 + 8 terms instead of K
    float part[8][8] = {};
#pragma unroll
    for (int kk = 0; kk < kRaBK; ++kk) {
      // 16-byte shared loads: one wavefront serves 8 threads' float4s
      float xv[8], av[8];
      load4(xv, &xs[kk][ty * 4]);
      load4(xv + 4, &xs[kk][64 + ty * 4]);
      load4(av, &as[kk][tx * 4]);
      load4(av + 4, &as[kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = fmaf(xv[i], av[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
  const bool full_n = n0 + kRaBN <= n_total;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= m_total) continue;
    float* row = z + m * n_total + n0;
    if (full_n) {   // 16-byte stores
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      if (n0 + n < n_total) row[n] = acc[i][j];
    }
  }
}

// 'mean' clutter: subtract, per (frame, rx, column), the mean over ALL
// chirps (ascending-chirp sum, then / C) — before the TDM demux.
__global__ void chirp_mean_kernel(float* __restrict__ z, int n_chirps,
                                  int n_rx, int row_len,
                                  long long n_columns) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_columns) return;
  const int col = (int)(i % row_len);
  const long long bv = i / row_len;
  const int v = (int)(bv % n_rx);
  const long long b = bv / n_rx;
  const long long stride = (long long)n_rx * row_len;
  float* p = z + (b * n_chirps * n_rx + v) * row_len + col;
  float s = 0.f;
  for (int c = 0; c < n_chirps; ++c) s += p[c * stride];
  const float mean = s / (float)n_chirps;
  for (int c = 0; c < n_chirps; ++c) p[c * stride] -= mean;
}

// ---------------------------------------------------------------------------
// (b) Doppler DFT + power: for frame b, Doppler bin d, range bin r,
//     P[d, r] = sum_tv |sum_kc F[d, kc] * z[kc*TX + tx, v, r]|^2,
//     tv = tx*V + v summed in ascending order (no atomics).

constexpr int kDpBD = 128, kDpBR = 32, kDpBK = 16;

//     A block holds a 128 (Doppler) x 32 (range) tile of one frame, so
//     the range planes are read once; each thread owns 4 x 4 outputs.
//     The Doppler rows come transposed, ft (Kc, D), so both operands are
//     staged with 16-byte loads, the next tile while this one multiplies.
__global__ void __launch_bounds__(256) doppler_power_kernel(
    const float* __restrict__ z, const float* __restrict__ ft_re,
    const float* __restrict__ ft_im, float* __restrict__ power, int n_chirps,
    int n_rx, int n_tx, int r_size, int d_size, int kc_size) {
  __shared__ __align__(16) float zs[2][kDpBK][kDpBR];   // [re | im]
  __shared__ __align__(16) float fs[2][kDpBK][kDpBD];
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // range bins tx*4.., Doppler ty*4..
  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * kDpBR, d0 = blockIdx.z * kDpBD;
  const int row_len = 2 * r_size;
  const float* zf = z + b * n_chirps * n_rx * (long long)row_len;
  // staging: one float4 of z (part zh, chirp kk_z of the tile, range rz)
  // and four float4s of ft
  const int zh = tid / 128, kk_z = tid % 128 / 8, rz = tid % 8 * 4;
  const int n_ktiles = (kc_size + kDpBK - 1) / kDpBK;
  const int n_tiles = n_tx * n_rx * n_ktiles;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 z_next, f_next[4];
  auto load_tile = [&](int tile) {
    const int tv = tile / n_ktiles, k0 = tile % n_ktiles * kDpBK;
    const int t = tv / n_rx, v = tv % n_rx;
    const int kc = k0 + kk_z;
    z_next = zero4;
    if (kc < kc_size && r0 + rz < r_size)
      z_next = *reinterpret_cast<const float4*>(
          zf + ((long long)(kc * n_tx + t) * n_rx + v) * row_len +
          zh * r_size + r0 + rz);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + 256 * j;   // float4 index into fs
      const int kk = i % 512 / 32, d = d0 + i % 32 * 4;
      f_next[j] = zero4;
      if (k0 + kk < kc_size && d < d_size)
        f_next[j] = *reinterpret_cast<const float4*>(
            (i < 512 ? ft_re : ft_im) + (long long)(k0 + kk) * d_size + d);
    }
  };

  float pw[4][4] = {}, xr[4][4] = {}, xi[4][4] = {};
  load_tile(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kt = tile % n_ktiles;
    *reinterpret_cast<float4*>(&zs[zh][kk_z][rz]) = z_next;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + 256 * j;
      *reinterpret_cast<float4*>(&fs[i / 512][i % 512 / 32][i % 32 * 4]) =
          f_next[j];
    }
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1);
    float pr[4][4] = {}, pi[4][4] = {};   // per-tile partial sums
#pragma unroll
    for (int kk = 0; kk < kDpBK; ++kk) {
      float ar[4], ai[4], br[4], bi[4];   // vector shared loads
      load4(ar, &fs[0][kk][ty * 4]);
      load4(ai, &fs[1][kk][ty * 4]);
      load4(br, &zs[0][kk][tx * 4]);
      load4(bi, &zs[1][kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[i][j] = fmaf(ar[i], br[j], fmaf(-ai[i], bi[j], pr[i][j]));
          pi[i][j] = fmaf(ar[i], bi[j], fmaf(ai[i], br[j], pi[i][j]));
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xr[i][j] += pr[i][j];
        xi[i][j] += pi[i][j];
      }
    __syncthreads();
    if (kt == n_ktiles - 1) {   // channel tv done: add its power, reset
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pw[i][j] += xr[i][j] * xr[i][j] + xi[i][j] * xi[i][j];
          xr[i][j] = 0.f;
          xi[i][j] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty * 4 + i;
    if (d >= d_size) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r < r_size) power[(b * d_size + d) * r_size + r] = pw[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// (c) per-frame detection: CFAR, mask, top-K, neighbours, snapshots.

constexpr int kDetThreads = 512;
constexpr int kDetCellsPerThread = radar_cfar::kMaxCells / kDetThreads;
constexpr int kMaxK = 128;

__global__ void __launch_bounds__(kDetThreads) detect_kernel(
    const float* __restrict__ power, const float* __restrict__ z,
    const float* __restrict__ ft_re, const float* __restrict__ ft_im,
    int32_t* __restrict__ top_idx, float* __restrict__ top_val,
    float* __restrict__ nbr, int32_t* __restrict__ num_hits,
    float* __restrict__ snaps, int n_chirps, int n_rx, int n_tx, int r_size,
    int d_size, int kc_size, int k_det, int kind, int range_wrap, int gd,
    int gr, int wd, int wr, int r_valid, float coef) {
  extern __shared__ float smem[];
  __shared__ float red_v[kDetThreads / 32];
  __shared__ int red_i[kDetThreads / 32];
  __shared__ int s_idx[kMaxK];
  __shared__ float s_val[kMaxK];
  const int n_cells = d_size * r_size;
  float* p = smem;             // power map
  float* y1 = p + n_cells;     // (Td - Gd) @ p: Doppler training strips
  float* y2 = y1 + n_cells;    // Gd @ p:        Doppler guard strip
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int n_warps = kDetThreads / 32;
  const long long b = blockIdx.x;

  const float* pf = power + b * n_cells;
  for (int i = tid; i < n_cells; i += kDetThreads) p[i] = pf[i];
  __syncthreads();
  radar_cfar::doppler_strips(p, y1, y2, d_size, 0, d_size, r_size, gd, wd,
                             kDetThreads);
  __syncthreads();

  // Range strips (reflect or wrap), the CA / GO / SO threshold of
  // cfar_common.cuh (the maps entry's, so both agree bit for bit),
  // range-edge guard, mask.
  // Non-hits hold the f32-min sentinel, so taken cells (-inf) sort below
  // every untaken one and exhausted slots come out in lax.top_k order.
  float mv[kDetCellsPerThread];
  int hits = 0;
#pragma unroll
  for (int j = 0; j < kDetCellsPerThread; ++j) {
    const int i = tid + j * kDetThreads;
    mv[j] = -CUDART_INF_F;
    if (i < n_cells) {
      const int d = i / r_size, r = i % r_size;
      const float pv = p[i];
      const bool hit = pv > radar_cfar::threshold(y1, y2, d, r, r_size, kind,
                                                  range_wrap, gr, wr, coef) &&
                       r < r_valid;
      mv[j] = hit ? pv : kF32Min;
      hits += hit;
    }
  }

  // num_hits: block sum
#pragma unroll
  for (int off = 16; off > 0; off /= 2) hits += __shfl_down_sync(0xffffffffu, hits, off);
  if (lane == 0) red_i[warp] = hits;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < n_warps; ++w) total += red_i[w];
    num_hits[b] = total;
  }
  __syncthreads();

  // Top-K knockout: K rounds of a block argmax keyed on (value desc,
  // index asc); the winner's cell becomes -inf.
  for (int kk = 0; kk < k_det; ++kk) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kDetCellsPerThread; ++j) {
      const int i = tid + j * kDetThreads;
      if (i < n_cells && radar_cfar::better(mv[j], i, bv, bi)) {
        bv = mv[j];
        bi = i;
      }
    }
    radar_cfar::block_argmax(bv, bi, red_v, red_i, &s_val[kk], &s_idx[kk]);
    const int win = s_idx[kk];
#pragma unroll
    for (int j = 0; j < kDetCellsPerThread; ++j)
      if (tid + j * kDetThreads == win) mv[j] = -CUDART_INF_F;
  }

  // Outputs per slot: index, value (-inf where exhausted), neighbours.
  for (int kk = tid; kk < k_det; kk += kDetThreads) {
    const int idx = s_idx[kk];
    const float val = s_val[kk];
    const long long o = b * k_det + kk;
    top_idx[o] = idx;
    top_val[o] = val == kF32Min ? -CUDART_INF_F : val;
    const int d = idx / r_size, r = idx % r_size;
    const float* row = p + d * r_size;
    float* nb = nbr + o * 5;
    nb[0] = row[r];
    nb[1] = row[r > 0 ? r - 1 : r];
    nb[2] = row[r < r_size - 1 ? r + 1 : r];
    nb[3] = p[radar_cfar::wrap_index(d - 1, d_size) * r_size + r];
    nb[4] = p[radar_cfar::wrap_index(d + 1, d_size) * r_size + r];
  }

  // Snapshots: s[k, tv] = sum_kc F[d_k, kc] * z[kc*TX + tx, v, r_k], one
  // warp per (k, tv), lanes over kc, shuffle-reduced.
  const int tv_total = n_tx * n_rx;
  const long long row_len = 2LL * r_size;
  const float* zf = z + b * n_chirps * n_rx * row_len;
  for (int q = warp; q < k_det * tv_total; q += n_warps) {
    const int kk = q / tv_total, tv = q % tv_total;
    const int t = tv / n_rx, v = tv % n_rx;
    const int idx = s_idx[kk];
    const int d = idx / r_size, r = idx % r_size;
    float sr = 0.f, si = 0.f;
#pragma unroll 4   // the loads of four chirps in flight at once
    for (int kc = lane; kc < kc_size; kc += 32) {
      const float* row = zf + ((long long)(kc * n_tx + t) * n_rx + v) * row_len;
      const float zr = row[r], zi = row[r_size + r];
      const float fr = ft_re[(long long)kc * d_size + d];
      const float fi = ft_im[(long long)kc * d_size + d];
      sr = fmaf(fr, zr, fmaf(-fi, zi, sr));
      si = fmaf(fr, zi, fmaf(fi, zr, si));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      sr += __shfl_down_sync(0xffffffffu, sr, off);
      si += __shfl_down_sync(0xffffffffu, si, off);
    }
    if (lane == 0) {
      float* out = snaps + ((b * k_det + kk) * tv_total + tv) * 2;
      out[0] = sr;
      out[1] = si;
    }
  }
}

// Stage (a): raw frames -> the clutter-removed range planes z (B*C*V,
// 2R), with the chirp-mean pass for 'mean' clutter.  The front end of
// both mega entries, and the whole of the fused range entry.
cudaError_t range_stage(const int16_t* raw, const float* base_raw,
                        const float* a2, float* z, int n_frames,
                        int n_chirps, int n_rx, int s2, int r_size,
                        int clutter_mean, cudaStream_t stream) {
  const int rows_per_frame = n_chirps * n_rx;
  const long long m_total = (long long)n_frames * rows_per_frame;

  dim3 grid_a((unsigned)((m_total + kRaBM - 1) / kRaBM),
              (2 * r_size + kRaBN - 1) / kRaBN);
  range_gemm_kernel<<<grid_a, 256, 0, stream>>>(
      raw, clutter_mean ? nullptr : base_raw, a2, z, m_total, s2, 2 * r_size,
      rows_per_frame);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !clutter_mean) return err;

  const long long n_columns = (long long)n_frames * n_rx * 2 * r_size;
  chirp_mean_kernel<<<(unsigned)((n_columns + 255) / 256), 256, 0,
                      stream>>>(z, n_chirps, n_rx, 2 * r_size, n_columns);
  return cudaGetLastError();
}

// Stages (a) and (b) of the maps entry and of the detect entry: raw
// frames -> power maps (B, D, R) through the range planes z.
cudaError_t front_end(const int16_t* raw, const float* base_raw,
                      const float* a2, const float* ft_re,
                      const float* ft_im, float* z, float* power,
                      int n_frames, int n_chirps, int n_rx, int n_tx, int s2,
                      int r_size, int d_size, int clutter_mean,
                      cudaStream_t stream) {
  const int kc_size = n_chirps / n_tx;
  const cudaError_t err = range_stage(raw, base_raw, a2, z, n_frames,
                                      n_chirps, n_rx, s2, r_size,
                                      clutter_mean, stream);
  if (err != cudaSuccess) return err;

  dim3 grid_b(n_frames, (r_size + kDpBR - 1) / kDpBR,
              (d_size + kDpBD - 1) / kDpBD);
  doppler_power_kernel<<<grid_b, 256, 0, stream>>>(
      z, ft_re, ft_im, power, n_chirps, n_rx, n_tx, r_size, d_size, kc_size);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* radar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs stages (a) to (c) on ``stream``.  Shapes (row-major, f32 unless
// noted): raw int16 (B, C*V, 2S); base_raw (C*V, 2S) or NULL for 'mean'
// clutter and the MTI modes (their canceller comes folded into ft_re /
// ft_im, with clutter_mean 0); a2 (2S, 2R); ft_re/ft_im (Kc, D); scratch
// z (B*C*V, 2R) and
// power (B, D, R); outputs top_idx int32 (B, K), top_val (B, K),
// nbr (B, K, 5), num_hits int32 (B), snaps (B, K, TX*V, 2).  kind: 0 CA,
// 1 GO, 2 SO; coef = alpha / n_train (CA) or the GO/SO multiplier.
int radar_mega_detect(const int16_t* raw, const float* base_raw,
                      const float* a2, const float* ft_re, const float* ft_im,
                      float* z, float* power, int32_t* top_idx,
                      float* top_val, float* nbr, int32_t* num_hits,
                      float* snaps, int n_frames, int n_chirps, int n_rx,
                      int n_tx, int s2, int r_size, int d_size, int k_det,
                      int clutter_mean, int kind, int range_wrap, int guard_d,
                      int guard_r, int win_d, int win_r, int r_valid,
                      float coef, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_cells = d_size * r_size;
  if (n_frames <= 0) return cudaSuccess;
  if (k_det < 1 || k_det > kMaxK || k_det > n_cells ||
      n_cells > kDetThreads * kDetCellsPerThread || n_chirps % n_tx != 0 ||
      s2 % 8 != 0 || r_size % 4 != 0 || d_size % 4 != 0 ||
      kind < radar_cfar::kCA || kind > radar_cfar::kSO)
    return cudaErrorInvalidValue;
  const int kc_size = n_chirps / n_tx;
  cudaError_t err =
      front_end(raw, base_raw, a2, ft_re, ft_im, z, power, n_frames,
                n_chirps, n_rx, n_tx, s2, r_size, d_size, clutter_mean,
                stream);
  if (err != cudaSuccess) return err;

  const size_t smem = 3 * (size_t)n_cells * sizeof(float);
  err = cudaFuncSetAttribute(detect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  detect_kernel<<<n_frames, kDetThreads, smem, stream>>>(
      power, z, ft_re, ft_im, top_idx, top_val, nbr, num_hits, snaps, n_chirps,
      n_rx, n_tx, r_size, d_size, kc_size, k_det, kind, range_wrap, guard_d,
      guard_r, win_d, win_r, r_valid, coef);
  return cudaGetLastError();
}

// The maps entry: stages (a) and (b) on ``stream``, then, when
// ``thresh`` is not NULL, the CFAR threshold of ``kind`` (0 CA, 1 GO,
// 2 SO; cfar.cu) of every power map.  Shapes as radar_mega_detect, plus
// thresh (B, D, R) f32 or NULL.
int radar_mega_maps(const int16_t* raw, const float* base_raw,
                    const float* a2, const float* ft_re, const float* ft_im,
                    float* z, float* power, float* thresh, int n_frames,
                    int n_chirps, int n_rx, int n_tx, int s2, int r_size,
                    int d_size, int clutter_mean, int kind, int range_wrap,
                    int guard_d, int guard_r, int win_d, int win_r,
                    float coef, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0) return cudaSuccess;
  if (n_chirps % n_tx != 0 || s2 % 8 != 0 || r_size % 4 != 0 ||
      d_size % 4 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      front_end(raw, base_raw, a2, ft_re, ft_im, z, power, n_frames,
                n_chirps, n_rx, n_tx, s2, r_size, d_size, clutter_mean,
                stream);
  if (err != cudaSuccess || thresh == nullptr) return err;
  return radar_cfar_threshold(power, thresh, n_frames, d_size, r_size, kind,
                              range_wrap, guard_d, guard_r, win_d, win_r,
                              coef, stream);
}

// The fused range entry: stage (a) alone on ``stream``, raw int16 (B,
// C*V, 2S) -> z (B*C*V, 2R) f32, each row [zr | zi].  base_raw (C*V, 2S)
// for 'base' clutter, or NULL: 'mean' (clutter_mean = 1) subtracts the
// chirp mean in place; the MTI modes run with neither, and the caller
// filters the planes.
int radar_fused_range(const int16_t* raw, const float* base_raw,
                      const float* a2, float* z, int n_frames, int n_chirps,
                      int n_rx, int s2, int r_size, int clutter_mean,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0) return cudaSuccess;
  if (n_chirps < 1 || n_rx < 1 || s2 % 8 != 0 || r_size % 4 != 0)
    return cudaErrorInvalidValue;
  return range_stage(raw, base_raw, a2, z, n_frames, n_chirps, n_rx, s2,
                     r_size, clutter_mean, stream);
}

}  // extern "C"
