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
// What bounds it on an H100: about 120 MFLOP of dense DFT per frame at
// the default geometry (52 range + 67 Doppler), 61 GFLOP per 512-frame
// batch, while the bytes (105 MB of int16 in, 268 MB of range planes
// written and read back, 34 MB of power) need about 0.2 ms at 3.35 TB/s.
// It runs in three stages with the intermediates in device memory,
// because one frame's range planes (512 KB) do not fit a block's 227 KB
// of shared memory:
//   (a) the range DFT over all frames' rows, a GEMM
//       chirp_mean_kernel      'mean' clutter only, in place on (a)'s planes
//   (b) the Doppler DFT and power, per (frame, range tile)
//   (c) detect.cu              one block per (frame, band of Doppler rows):
//                              the band's CFAR and top K, merged per frame
//                              by its last band block (radar_detect_stage)
// Stages (a) and (b) run at the tier of cfg.dft_precision (the
// ``passes`` argument of every entry, ops/cuda/megakernel.dft_passes):
//   'highest' (0)  range_gemm_kernel, doppler_power_kernel: plain f32
//                  FMAs on the CUDA cores, 0.9 ms of work at 67 TFLOP/s;
//   'high' (3)     range_tc_kernel<3>, doppler_tc_kernel<3>: split TF32
//                  on the tensor cores (wgmma), hi*lo + lo*hi + hi*hi, each
//                  product to about 2^-21, 183 GFLOP at 495 TFLOP/s;
//   'default' (1)  the same kernels with hi*hi alone, about 2^-11.
// No tier gives way to another.  Stage (c) reads z and the Doppler
// constant in f32 at every tier.  Fusing (a) and (b), so that the range
// planes never reach device memory, is later work.
//
// The maps entry radar_mega_maps replaces the TPU kernel _mega_kernel
// (launcher _mega_call; entries power_from_shorts_pallas and
// power_cfar_from_shorts_pallas): stages (a) and (b) as they are, so its
// power maps are bit-identical to the detect entry's, then, for the
// with-CFAR form, the threshold kernel of cfar.cu (CA, GO or SO) on
// them.  Its bound is the detect entry's front end: 61 GFLOP of f32 DFT
// per 512-frame batch, about 0.9 ms at 67 TFLOP/s, against 105 MB in and
// 34 MB of power (plus 34 MB of threshold) out, about 0.05 ms.  The CFAR
// strip sums live in cfar_common.cuh and the top-K selection in
// select_common.cuh, shared with the threshold and top-K kernels, so the
// two entries' detections agree bit for bit.
//
// The fused range entry radar_fused_range replaces the TPU kernel
// radar_tpu/ops/pallas/fused_dft_kernel.py (the inline kernel of
// fused_rd_planes_pallas): int16 frames minus the raw-space base, then
// the two range-DFT dots, written as the range planes.  Its work is
// stage (a) as it is, so it reuses range_stage (range_gemm_kernel or
// range_tc_kernel by tier and, for 'mean' clutter, chirp_mean_kernel)
// rather than a second GEMM; the Doppler stage stays outside, as in JAX.
// Its bound is the bytes: 105 MB of int16 in and 268 MB of planes out
// per 512-frame batch, about 0.11 ms at 3.35 TB/s.
//
// The kernels allocate nothing; the caller passes every buffer.  Each
// entry point returns the first CUDA error of its launches.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "select_common.cuh"

namespace {

using radar_cfar::load4;


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
// Tensor-core tiers of stages (a) and (b): dft_precision 'high' (P = 3
// passes) and 'default' (P = 1), on Hopper's warpgroup MMA (wgmma) in
// TF32.
//
// TF32 keeps 10 explicit mantissa bits.  An f32 operand x is carried as
// hi = rna(x) and lo = rna(x - hi) (x - hi is exact), so |x - hi - lo|
// <= 2^-22 |x|; 'high' sums hi*lo + lo*hi + hi*hi and drops lo*lo (at
// most 2^-22 of the product), so each product is carried to about
// 2^-21.  int16 samples split exactly (11 + 11 bits cover 16).
// 'default' keeps hi*hi alone, about 2^-11 a product.
//
// Sum order, the same in both kernels: per 8-deep K step and output
// tile, hi*lo, then lo*hi, then hi*hi, into one f32 accumulator.
// ops/tf32.py emulates the products exactly in f32; only the order of
// the sums differs from the card.
//
// Both kernels: 128 x 128 output tiles, 256 threads as two warpgroups of
// 64 x 128 (one m64n128k8 wgmma a K step and pass), 16-deep K tiles,
// so that a block needs under half of an SM's shared memory and, at
// 128 registers a thread, two blocks share an SM: one block's barriers,
// copies and epilogue then overlap the other's tensor-core work.
// wgmma reads both operands from shared memory, K-major (the only
// layout it takes for TF32), in the interleaved form without swizzle:
// 8-row x 16-byte core matrices of 128 contiguous bytes, the 4 of a
// 16-deep K tile side by side (gmma_off).  One operand is a DFT
// constant, split into hi and lo and cut into such tiles on the host
// (megakernel.mega_constants: a2_split, dop_l); the other is data (the
// int16 rows, the range planes), split here.  Every tile comes by
// 16-byte cp.async copies: the constant's hi / lo tiles straight into
// one of two buffers of split tiles, the data's raw tiles (zero-filled
// past the ragged M, N and K edges; each thread's source rows are fixed
// when the block starts) into a ring a few tiles deep.  Once a raw tile
// has landed the block converts it once (int16 to f32, the base
// subtracted, the hi / lo split) into the same buffer.  The two buffers
// let one barrier phase run the wgmma of tile k, asynchronous, while the
// threads copy the constant's tile k + 1 and convert the data's tile
// k + 1.

// cvt.rna.tf32.f32 in two integer operations: half of the 13 dropped
// bits added to the sign-magnitude pattern rounds the magnitude half up
// (ties away from zero), then the dropped bits are cleared, as
// ops/tf32.tf32_round does.  The operands are finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// (hi, lo) of four floats: hi = rna(x); lo = rna(x - hi) when P = 3.
template <int P>
__device__ __forceinline__ void split4(const float4 x, float4& hi,
                                       float4& lo) {
  hi = make_float4(__uint_as_float(tf32_rna(x.x)),
                   __uint_as_float(tf32_rna(x.y)),
                   __uint_as_float(tf32_rna(x.z)),
                   __uint_as_float(tf32_rna(x.w)));
  if (P == 3)
    lo = make_float4(__uint_as_float(tf32_rna(x.x - hi.x)),
                     __uint_as_float(tf32_rna(x.y - hi.y)),
                     __uint_as_float(tf32_rna(x.z - hi.z)),
                     __uint_as_float(tf32_rna(x.w - hi.w)));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (``gmem``
// must still be a mapped address then; nothing is read from it).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 16;
constexpr int kTcThreads = 256;
constexpr int kTcMinBlocks = 2;          // blocks an SM holds at once
constexpr int kTcTile = kTcBM * kTcBK;   // floats of one operand tile
constexpr int kTcChunks = kTcTile / 4 / kTcThreads;   // 16 B a thread

// Float offset of element (r, k) in a 128 x kTcBK K-major tile: core
// matrix (r / 8, k / 4) at 32 floats each, kTcBK / 4 along K per 8-row
// group, row r % 8 of it at 4 floats.  The host's megakernel.gmma_tiles
// uses the same order.  K-adjacent core matrices lie 128 bytes apart
// (the descriptor's leading byte offset), 8-row groups kTcBK * 32 bytes
// (its stride byte offset).
__device__ __forceinline__ int gmma_off(int r, int k) {
  return ((r >> 3) * (kTcBK / 4) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// wgmma shared-memory descriptor of such a tile from ``p`` (the first
// core matrix that the instruction reads): no swizzle, LBO 128 bytes,
// SBO kTcBK * 32.
__device__ __forceinline__ uint64_t gmma_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(kTcBK * 32 >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void gmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (stores, cp.async) made visible
// to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_smem_to_gmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma that is in flight.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

// D (64 x 128 f32, 64 a thread) += A (64 x 8) . B (128 x 8)^T in TF32, A
// and B K-major in shared memory; ``accumulate`` 0 overwrites D.  Thread
// (warp w of the warpgroup, lane l) holds D rows 16 w + l / 4 (+ 8) and
// columns 8 j + 2 (l % 4) (+ 1): d[4 j] (row, col), d[4 j + 1] (row,
// col + 1), d[4 j + 2] (row + 8, col), d[4 j + 3] (row + 8, col + 1).
__device__ __forceinline__ void gmma_m64n128k8(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The hi / lo tiles of one K tile: A (M x K) and B (N x K), K-major.
struct TcSplitTiles {
  float a[2][kTcTile];   // [hi, lo]
  float b[2][kTcTile];
};

// The wgmma of one K tile for the warpgroup at A row ``wr`` (k_left:
// the tile's depth, ragged at the end; its zero steps are skipped), in
// the fixed pass order, issued and committed but not waited for.
template <int P>
__device__ __forceinline__ void gmma_tile(float (&d)[64],
                                          const TcSplitTiles& t, int wr,
                                          int k_left) {
  gmma_fence();
  pin(d);
#pragma unroll
  for (int kk = 0; kk < kTcBK; kk += 8) {
    if (kk >= k_left) break;
    const uint64_t ah = gmma_desc(&t.a[0][gmma_off(wr, kk)]);
    const uint64_t bh = gmma_desc(&t.b[0][gmma_off(0, kk)]);
    if (P == 3) {
      gmma_m64n128k8(d, ah, gmma_desc(&t.b[1][gmma_off(0, kk)]), 1);
      gmma_m64n128k8(d, gmma_desc(&t.a[1][gmma_off(wr, kk)]), bh, 1);
    }
    gmma_m64n128k8(d, ah, bh, 1);
  }
  gmma_commit();
  pin(d);
}

// Copies tile ``tile`` of a host-cut split constant (2, tiles, 128 x kTcBK)
// into split tiles ``dst`` ([hi, lo]), 4 chunks of 16 bytes a thread
// and half.
template <int P>
__device__ __forceinline__ void load_const_tile(float (*dst)[kTcTile],
                                                const float* src,
                                                long long tile,
                                                long long plane, int tid) {
  const float* s = src + tile * kTcTile;
#pragma unroll
  for (int h = 0; h < (P == 3 ? 2 : 1); ++h)
#pragma unroll
    for (int q = 0; q < kTcChunks; ++q) {
      const int i = (tid + kTcThreads * q) * 4;
      cp_async16(&dst[h][i], s + h * plane + i, true);
    }
}

// cp.async groups, per thread and in order, of both kernels: data tile
// 0, the constant's tile 0, then data tiles 1 .. S - 1; in the loop at
// tile k, the constant's tile k + 1, then data tile k + S.  Waiting
// until one group is left pending therefore leaves only data tile k + S
// - 1 in flight: data tile k + 1 and the constant's tile k have landed.

// (a) on the tensor cores: the product of range_gemm_kernel, Z (B*C*V,
// 2R) = (raw - base) (B*C*V, 2S) . a2 (2S, 2R).  Bound on an H100: 105
// MB of int16 in and 268 MB of planes out per 512-frame batch, 0.11 ms
// at 3.35 TB/s, against 27 GFLOP a pass (0.16 ms for 'high''s three at
// 495 TFLOP/s of TF32).  a2 comes split and cut, ``a2s`` (2, N tiles, K
// tiles, 128 x kTcBK) of a2^T.  The ring (3 stages) holds the raw tile
// (int16, unpadded) and the base rows (row m % rows_per_frame, so any
// frame length works; padded rows).  The epilogue goes through shared
// memory so that every [zr | zi] row leaves in 16-byte stores.
constexpr int kRtAs = kTcBK + 4;   // base row stride in floats
constexpr int kRtCs = kTcBN + 4;   // epilogue row stride in floats
constexpr int kRtStages = 3;

struct RangeTcShared {
  struct Stage {
    int16_t x[kTcBM * kTcBK];
    float b[kTcBM * kRtAs];
  } ring[kRtStages];
  TcSplitTiles split[2];
};
constexpr size_t kRangeTcSmem = sizeof(RangeTcShared);
static_assert(kTcBM * kRtCs * sizeof(float) <= kRangeTcSmem,
              "the epilogue reuses the shared memory");

template <int P>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks) range_tc_kernel(
    const int16_t* __restrict__ raw, const float* __restrict__ base,
    const float* __restrict__ a2s, float* __restrict__ z, long long m_total,
    int k_total, int n_total, int rows_per_frame) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  RangeTcShared& sh = *reinterpret_cast<RangeTcShared*>(tc_smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wr = warp / 4 * 64;   // the warpgroup's first row
  const long long m0 = (long long)blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * kTcBN;
  const int n_ktiles = (k_total + kTcBK - 1) / kTcBK;
  const int n_ntiles = (n_total + kTcBN - 1) / kTcBN;
  const long long plane = (long long)n_ntiles * n_ktiles * kTcTile;

  // The source rows of this thread's copies: raw chunks tid and tid +
  // 256 (8 shorts each), base chunks tid + 256 q (4 floats); null past
  // the edge.  Its conversion share: row cr, kTcBK / 2 columns from cc.
  constexpr int kRawChunks = kTcBM * kTcBK / 8 / kTcThreads;
  const int16_t* raw_src[kRawChunks];
  const float* base_src[kTcChunks];
#pragma unroll
  for (int q = 0; q < kRawChunks; ++q) {
    const int i = tid + kTcThreads * q;
    const long long m = m0 + i / (kTcBK / 8);
    raw_src[q] = m < m_total ? raw + m * k_total + i % (kTcBK / 8) * 8
                             : nullptr;
  }
#pragma unroll
  for (int q = 0; q < kTcChunks; ++q) {
    const int i = tid + kTcThreads * q;
    const long long m = m0 + i / (kTcBK / 4);
    base_src[q] = base != nullptr && m < m_total
                      ? base + (m % rows_per_frame) * k_total +
                            i % (kTcBK / 4) * 4
                      : nullptr;
  }
  const int cr = tid / 2, cc = tid % 2 * (kTcBK / 2);

  auto load_data = [&](int kt) {
    RangeTcShared::Stage& s = sh.ring[kt % kRtStages];
    const int k0 = kt * kTcBK;
#pragma unroll
    for (int q = 0; q < kRawChunks; ++q) {
      const int i = tid + kTcThreads * q;
      const bool ok =
          raw_src[q] != nullptr && k0 + i % (kTcBK / 8) * 8 < k_total;
      cp_async16(&s.x[i * 8], ok ? raw_src[q] + k0 : raw, ok);
    }
    if (base == nullptr) return;
#pragma unroll
    for (int q = 0; q < kTcChunks; ++q) {
      const int i = tid + kTcThreads * q;
      const bool ok =
          base_src[q] != nullptr && k0 + i % (kTcBK / 4) * 4 < k_total;
      cp_async16(&s.b[i / (kTcBK / 4) * kRtAs + i % (kTcBK / 4) * 4],
                 ok ? base_src[q] + k0 : base, ok);
    }
  };

  auto load_const = [&](int kt) {
    load_const_tile<P>(sh.split[kt % 2].b, a2s,
                       (long long)blockIdx.y * n_ktiles + kt, plane, tid);
  };

  // raw - base of tile kt (landed) -> A hi / lo of split buffer kt % 2
  auto convert = [&](int kt) {
    const RangeTcShared::Stage& s = sh.ring[kt % kRtStages];
    TcSplitTiles& t = sh.split[kt % 2];
#pragma unroll
    for (int h = 0; h < kTcBK / 16; ++h) {   // 8 shorts at a time
      const int4 w = *reinterpret_cast<const int4*>(
          &s.x[cr * kTcBK + cc + h * 8]);
      const int v[4] = {w.x, w.y, w.z, w.w};   // two shorts each, low first
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = cc + h * 8 + q * 4;
        float4 x = make_float4((float)(int16_t)(v[2 * q] & 0xffff),
                               (float)(v[2 * q] >> 16),
                               (float)(int16_t)(v[2 * q + 1] & 0xffff),
                               (float)(v[2 * q + 1] >> 16));
        if (base != nullptr) {
          const float4 b =
              *reinterpret_cast<const float4*>(&s.b[cr * kRtAs + k]);
          x = make_float4(x.x - b.x, x.y - b.y, x.z - b.z, x.w - b.w);
        }
        float4 hi, lo;
        split4<P>(x, hi, lo);
        *reinterpret_cast<float4*>(&t.a[0][gmma_off(cr, k)]) = hi;
        if (P == 3) *reinterpret_cast<float4*>(&t.a[1][gmma_off(cr, k)]) = lo;
      }
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  load_data(0);
  cp_async_commit();
  load_const(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kRtStages; ++s) {
    if (s < n_ktiles) load_data(s);
    cp_async_commit();
  }
  cp_async_wait<kRtStages - 1>();   // data tile 0 and a2 tile 0
  __syncthreads();
  convert(0);
  for (int kt = 0; kt < n_ktiles; ++kt) {
    // data tile kt + 1 and a2 tile kt landed, tile kt converted, every
    // warpgroup done with tile kt - 1 (its split buffer and ring slot)
    cp_async_wait<1>();
    fence_smem_to_gmma();
    gmma_wait_all();
    pin(d);
    __syncthreads();
    if (kt + 1 < n_ktiles) load_const(kt + 1);
    cp_async_commit();
    if (kt + kRtStages < n_ktiles) load_data(kt + kRtStages);
    cp_async_commit();
    gmma_tile<P>(d, sh.split[kt % 2], wr, k_total - kt * kTcBK);
    if (kt + 1 < n_ktiles) convert(kt + 1);
  }
  gmma_wait_all();
  pin(d);
  cp_async_wait<0>();
  __syncthreads();   // shared memory is free: stage the tile for stores
  float* cs = reinterpret_cast<float*>(tc_smem);
  const int r = wr + warp % 4 * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = j * 8 + 2 * (lane % 4);
    *reinterpret_cast<float2*>(&cs[r * kRtCs + c]) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(&cs[(r + 8) * kRtCs + c]) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
  __syncthreads();
  for (int i = tid; i < kTcBM * (kTcBN / 4); i += kTcThreads) {
    const int rr = i / (kTcBN / 4), c = i % (kTcBN / 4) * 4;
    const long long m = m0 + rr;
    if (m < m_total && n0 + c < n_total)
      *reinterpret_cast<float4*>(z + m * n_total + n0 + c) =
          *reinterpret_cast<const float4*>(&cs[rr * kRtCs + c]);
  }
}

// (b) on the tensor cores: per (frame, channel tv, range tile), the real
// form X (2D x R-tile) = L (2D x 2Kc) . [Zr; Zi] (2Kc x R-tile), then
// P[d, r] = sum_tv Re^2 + Im^2 with tv ascending, as doppler_power_kernel.
// L is the host-packed constant (megakernel.doppler_lhs): rows in groups
// of 16, the Re rows [Fr | -Fi] of Doppler bins d..d+7 and then their Im
// rows [Fi | Fr], the Fr / Fi halves each padded to Kc8 = Kc rounded up
// to 8 columns (zero), so D rows g and g + 8 of each warp are Re and Im
// of the same (d, r) cell and |X|^2 is summed in registers.  It comes
// split and cut, ``dop_l`` (2, M tiles, K tiles, 128 x kTcBK).  Bound on
// an H100: 268 MB of planes in and 34 MB of power out per 512-frame
// batch, 0.09 ms, against 34 GFLOP a pass.  A block owns 64 Doppler bins
// x 128 range bins of one frame and walks tv and K with the Z tiles
// ([k][r], unpadded) in a ring of 4 stages; their conversion also turns
// them K-major.
constexpr int kDtStages = 4;

struct DopplerTcShared {
  float z[kDtStages][kTcBK * kTcBN];
  TcSplitTiles split[2];
};
constexpr size_t kDopplerTcSmem = sizeof(DopplerTcShared);

template <int P>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks) doppler_tc_kernel(
    const float* __restrict__ z, const float* __restrict__ lhs,
    float* __restrict__ power, int n_chirps, int n_rx, int n_tx, int r_size,
    int d_size, int kc_size) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  DopplerTcShared& sh = *reinterpret_cast<DopplerTcShared*>(tc_smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wr = warp / 4 * 64;   // the warpgroup's first row
  const int kc8 = (kc_size + 7) / 8 * 8;
  const int k_total = 2 * kc8, m_total = (d_size + 7) / 8 * 16;
  const int n_mt = (m_total + kTcBM - 1) / kTcBM;
  const int n_rt = (r_size + kTcBN - 1) / kTcBN;
  const long long b = blockIdx.x / (n_mt * n_rt);
  const int tile = blockIdx.x % (n_mt * n_rt);
  const int mt = tile % n_mt, r0 = tile / n_mt * kTcBN;
  const int row_len = 2 * r_size;
  const float* zf = z + b * n_chirps * n_rx * (long long)row_len;
  const int n_ktiles = (k_total + kTcBK - 1) / kTcBK;
  const int n_tiles = n_tx * n_rx * n_ktiles;
  const long long plane = (long long)n_mt * n_ktiles * kTcTile;

  // This thread's copies: Z chunks (K row tid / 32 + 8 q, 4 floats at
  // range column zc).  Its conversion share: range column cn, K rows
  // ck .. ck + kTcBK / 2.
  const int zc = tid % (kTcBN / 4) * 4;
  const bool z_col_ok = r0 + zc < r_size;
  const int cn = tid % kTcBN, ck = tid / kTcBN * (kTcBK / 2);

  auto load_data = [&](int tile_k) {
    float* s = sh.z[tile_k % kDtStages];
    const int tv = tile_k / n_ktiles, k0 = tile_k % n_ktiles * kTcBK;
    const int t = tv / n_rx, v = tv % n_rx;
#pragma unroll
    for (int q = 0; q < kTcChunks; ++q) {
      const int kr = tid / (kTcBN / 4) + 8 * q;
      const int k = k0 + kr, half = k >= kc8, kc = k - half * kc8;
      const bool ok = z_col_ok && k < k_total && kc < kc_size;
      cp_async16(&s[kr * kTcBN + zc],
                 ok ? zf + ((long long)(kc * n_tx + t) * n_rx + v) * row_len +
                          half * r_size + r0 + zc
                    : z,
                 ok);
    }
  };

  auto load_const = [&](int tile_k) {
    load_const_tile<P>(sh.split[tile_k % 2].a, lhs,
                       (long long)mt * n_ktiles + tile_k % n_ktiles, plane,
                       tid);
  };

  // Z tile tile_k ([k][r], landed) -> B hi / lo (K-major) of split
  // buffer tile_k % 2
  auto convert = [&](int tile_k) {
    const float* s = sh.z[tile_k % kDtStages];
    TcSplitTiles& t = sh.split[tile_k % 2];
#pragma unroll
    for (int q = 0; q < kTcBK / 8; ++q) {
      const int k = ck + 4 * q;
      float4 hi, lo;
      split4<P>(make_float4(s[k * kTcBN + cn], s[(k + 1) * kTcBN + cn],
                            s[(k + 2) * kTcBN + cn], s[(k + 3) * kTcBN + cn]),
                hi, lo);
      *reinterpret_cast<float4*>(&t.b[0][gmma_off(cn, k)]) = hi;
      if (P == 3) *reinterpret_cast<float4*>(&t.b[1][gmma_off(cn, k)]) = lo;
    }
  };

  float d[64];
  float pw[16][2];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) pw[j][0] = pw[j][1] = 0.f;
  load_data(0);
  cp_async_commit();
  load_const(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kDtStages; ++s) {
    if (s < n_tiles) load_data(s);
    cp_async_commit();
  }
  cp_async_wait<kDtStages - 1>();   // Z tile 0 and L tile 0
  __syncthreads();
  convert(0);
  for (int tk = 0; tk < n_tiles; ++tk) {
    // Z tile tk + 1 and L tile tk landed, Z tile tk converted, every
    // warpgroup done with tile tk - 1 (its split buffer and ring slot)
    cp_async_wait<1>();
    fence_smem_to_gmma();
    gmma_wait_all();
    pin(d);
    __syncthreads();
    if (tk + 1 < n_tiles) load_const(tk + 1);
    cp_async_commit();
    if (tk + kDtStages < n_tiles) load_data(tk + kDtStages);
    cp_async_commit();
    const int kt = tk % n_ktiles;
    gmma_tile<P>(d, sh.split[tk % 2], wr, k_total - kt * kTcBK);
    if (tk + 1 < n_tiles) convert(tk + 1);
    if (kt == n_ktiles - 1) {   // channel tv done: add its power, reset
      gmma_wait_all();
      pin(d);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pw[j][0] += d[4 * j] * d[4 * j] + d[4 * j + 2] * d[4 * j + 2];
        pw[j][1] += d[4 * j + 1] * d[4 * j + 1] + d[4 * j + 3] * d[4 * j + 3];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
    }
  }
  cp_async_wait<0>();
  const int bin = (mt * kTcBM + wr + warp % 4 * 16) / 16 * 8 + lane / 4;
  if (bin < d_size) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = r0 + j * 8 + 2 * (lane % 4);   // r_size even: r + 1 too
      if (r < r_size)
        *reinterpret_cast<float2*>(power + (b * d_size + bin) * r_size + r) =
            make_float2(pw[j][0], pw[j][1]);
    }
  }
}

// The precision tier: 0 is 'highest' (the SIMT f32 kernels), 3 'high'
// and 1 'default' (the tensor-core kernels with that many passes).
bool valid_passes(int passes) {
  return passes == 0 || passes == 1 || passes == 3;
}

// Launches a tensor-core kernel of P passes with its dynamic shared ring.
template <typename Kernel, typename... Args>
cudaError_t launch_tc(Kernel kernel, size_t smem, dim3 grid,
                      cudaStream_t stream, Args... args) {
  const cudaError_t err = radar_cfar::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Stage (a): raw frames -> the clutter-removed range planes z (B*C*V,
// 2R), with the chirp-mean pass for 'mean' clutter.  The front end of
// both mega entries, and the whole of the fused range entry.  ``a2`` is
// the f32 constant of passes 0, ``a2s`` its split of the other tiers.
cudaError_t range_stage(const int16_t* raw, const float* base_raw,
                        const float* a2, const float* a2s, float* z,
                        int n_frames,
                        int n_chirps, int n_rx, int s2, int r_size,
                        int clutter_mean, int passes, cudaStream_t stream) {
  const int rows_per_frame = n_chirps * n_rx;
  const long long m_total = (long long)n_frames * rows_per_frame;
  const float* base = clutter_mean ? nullptr : base_raw;

  cudaError_t err;
  if (passes == 0) {
    dim3 grid_a((unsigned)((m_total + kRaBM - 1) / kRaBM),
                (2 * r_size + kRaBN - 1) / kRaBN);
    range_gemm_kernel<<<grid_a, 256, 0, stream>>>(
        raw, base, a2, z, m_total, s2, 2 * r_size, rows_per_frame);
    err = cudaGetLastError();
  } else {
    dim3 grid_a((unsigned)((m_total + kTcBM - 1) / kTcBM),
                (2 * r_size + kTcBN - 1) / kTcBN);
    err = passes == 3
              ? launch_tc(range_tc_kernel<3>, kRangeTcSmem, grid_a, stream,
                          raw, base, a2s, z, m_total, s2, 2 * r_size,
                          rows_per_frame)
              : launch_tc(range_tc_kernel<1>, kRangeTcSmem, grid_a, stream,
                          raw, base, a2s, z, m_total, s2, 2 * r_size,
                          rows_per_frame);
  }
  if (err != cudaSuccess || !clutter_mean) return err;

  const long long n_columns = (long long)n_frames * n_rx * 2 * r_size;
  chirp_mean_kernel<<<(unsigned)((n_columns + 255) / 256), 256, 0,
                      stream>>>(z, n_chirps, n_rx, 2 * r_size, n_columns);
  return cudaGetLastError();
}

// Stages (a) and (b) of the maps entry and of the detect entry: raw
// frames -> power maps (B, D, R) through the range planes z.
// ``a2s`` and ``dop_l`` are the split constants of the tensor-core
// tiers (unused at passes 0).
cudaError_t front_end(const int16_t* raw, const float* base_raw,
                      const float* a2, const float* a2s, const float* ft_re,
                      const float* ft_im, const float* dop_l, float* z,
                      float* power, int n_frames, int n_chirps, int n_rx,
                      int n_tx, int s2, int r_size, int d_size,
                      int clutter_mean, int passes, cudaStream_t stream) {
  const int kc_size = n_chirps / n_tx;
  const cudaError_t err = range_stage(raw, base_raw, a2, a2s, z, n_frames,
                                      n_chirps, n_rx, s2, r_size,
                                      clutter_mean, passes, stream);
  if (err != cudaSuccess) return err;

  if (passes == 0) {
    dim3 grid_b(n_frames, (r_size + kDpBR - 1) / kDpBR,
                (d_size + kDpBD - 1) / kDpBD);
    doppler_power_kernel<<<grid_b, 256, 0, stream>>>(
        z, ft_re, ft_im, power, n_chirps, n_rx, n_tx, r_size, d_size,
        kc_size);
    return cudaGetLastError();
  }
  const int m_total = (d_size + 7) / 8 * 16;
  const long long tiles = (long long)n_frames *
                          ((m_total + kTcBM - 1) / kTcBM) *
                          ((r_size + kTcBN - 1) / kTcBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid_b((unsigned)tiles);
  return passes == 3
             ? launch_tc(doppler_tc_kernel<3>, kDopplerTcSmem, grid_b, stream,
                         z, dop_l, power, n_chirps, n_rx, n_tx, r_size,
                         d_size, kc_size)
             : launch_tc(doppler_tc_kernel<1>, kDopplerTcSmem, grid_b, stream,
                         z, dop_l, power, n_chirps, n_rx, n_tx, r_size,
                         d_size, kc_size);
}

}  // namespace

extern "C" {

const char* radar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs stages (a) to (c) on ``stream``.  Shapes (row-major, f32 unless
// noted): raw int16 (B, C*V, 2S); base_raw (C*V, 2S) or NULL for 'mean'
// clutter and the MTI modes (their canceller comes folded into ft_re /
// ft_im, with clutter_mean 0); a2 (2S, 2R); a2s (2, ceil(2R / 128),
// ceil(2S / 16), 128 x 16), its TF32 split [hi; lo] cut into the K-major
// tiles of range_tc_kernel (megakernel.gmma_tiles of a2^T); ft_re/ft_im
// (Kc, D); dop_l (2, ceil(M / 128), ceil(2 Kc8 / 16), 128 x 16), M = 16
// ceil(D / 8), the split packed Doppler constant cut likewise for
// doppler_tc_kernel (a2s and dop_l NULL allowed at passes 0); scratch z
// (B*C*V, 2R) and power (B, D, R); passes 0 ('highest'), 3 ('high') or 1
// ('default'); tickets, B int32 that are zero (left zero), and work, an
// int32 workspace of work_words words: stage (c)'s (detect.cu); outputs
// top_idx int32 (B, K), top_val (B, K), nbr (B, K, 5), num_hits int32
// (B), snaps (B, K, TX*V, 2).  kind: 0 CA, 1 GO, 2 SO; coef = alpha /
// n_train (CA) or the GO/SO multiplier.
int radar_mega_detect(const int16_t* raw, const float* base_raw,
                      const float* a2, const float* a2s, const float* ft_re,
                      const float* ft_im, const float* dop_l, float* z,
                      float* power, int* tickets, int* work,
                      long long work_words,
                      int32_t* top_idx, float* top_val, float* nbr,
                      int32_t* num_hits, float* snaps, int n_frames,
                      int n_chirps, int n_rx, int n_tx, int s2, int r_size,
                      int d_size, int k_det, int clutter_mean, int passes,
                      int kind, int range_wrap, int guard_d, int guard_r,
                      int win_d, int win_r, int r_valid, float coef,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0) return cudaSuccess;
  if (n_chirps % n_tx != 0 || s2 % 8 != 0 || r_size % 4 != 0 ||
      d_size % 4 != 0 || kind < radar_cfar::kCA || kind > radar_cfar::kSO ||
      !valid_passes(passes) ||
      (passes != 0 && (a2s == nullptr || dop_l == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      front_end(raw, base_raw, a2, a2s, ft_re, ft_im, dop_l, z, power,
                n_frames, n_chirps, n_rx, n_tx, s2, r_size, d_size,
                clutter_mean, passes, stream);
  if (err != cudaSuccess) return err;
  return radar_detect_stage(power, z, ft_re, ft_im, tickets, work,
                            work_words,
                            top_idx, top_val, nbr, num_hits, snaps, n_frames,
                            n_chirps, n_rx, n_tx, r_size, d_size, k_det, kind,
                            range_wrap, guard_d, guard_r, win_d, win_r,
                            r_valid, coef, stream);
}

// The maps entry: stages (a) and (b) on ``stream``, then, when
// ``thresh`` is not NULL, the CFAR threshold of ``kind`` (0 CA, 1 GO,
// 2 SO; cfar.cu) of every power map.  Shapes as radar_mega_detect, plus
// thresh (B, D, R) f32 or NULL.
int radar_mega_maps(const int16_t* raw, const float* base_raw,
                    const float* a2, const float* a2s, const float* ft_re,
                    const float* ft_im, const float* dop_l, float* z,
                    float* power, float* thresh,
                    int n_frames, int n_chirps, int n_rx, int n_tx, int s2,
                    int r_size, int d_size, int clutter_mean, int passes,
                    int kind, int range_wrap, int guard_d, int guard_r,
                    int win_d, int win_r, float coef, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0) return cudaSuccess;
  if (n_chirps % n_tx != 0 || s2 % 8 != 0 || r_size % 4 != 0 ||
      d_size % 4 != 0 || !valid_passes(passes) ||
      (passes != 0 && (a2s == nullptr || dop_l == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      front_end(raw, base_raw, a2, a2s, ft_re, ft_im, dop_l, z, power,
                n_frames, n_chirps, n_rx, n_tx, s2, r_size, d_size,
                clutter_mean, passes, stream);
  if (err != cudaSuccess || thresh == nullptr) return err;
  return radar_cfar_threshold(power, thresh, n_frames, d_size, r_size, kind,
                              range_wrap, guard_d, guard_r, win_d, win_r,
                              coef, stream);
}

// The fused range entry: stage (a) alone on ``stream``, raw int16 (B,
// C*V, 2S) -> z (B*C*V, 2R) f32, each row [zr | zi].  base_raw (C*V, 2S)
// for 'base' clutter, or NULL: 'mean' (clutter_mean = 1) subtracts the
// chirp mean in place; the MTI modes run with neither, and the caller
// filters the planes.  passes as radar_mega_detect.
int radar_fused_range(const int16_t* raw, const float* base_raw,
                      const float* a2, const float* a2s, float* z,
                      int n_frames, int n_chirps, int n_rx, int s2,
                      int r_size, int clutter_mean, int passes,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0) return cudaSuccess;
  if (n_chirps < 1 || n_rx < 1 || s2 % 8 != 0 || r_size % 4 != 0 ||
      !valid_passes(passes) || (passes != 0 && a2s == nullptr))
    return cudaErrorInvalidValue;
  return range_stage(raw, base_raw, a2, a2s, z, n_frames, n_chirps, n_rx,
                     s2, r_size, clutter_mean, passes, stream);
}

}  // extern "C"
