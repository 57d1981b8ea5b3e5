// Stage (a) of the mega entries and of the fused range entry
// (megakernel.cu range_stage) at the tensor-core tiers, 'high' and
// 'default': raw int16 rows -> the range planes z (B*C*V, 2R), each row
// [zr | zi], as a float32 FFT.
//
// It serves the TPU kernels' range stage: stage (a) of
// radar_tpu/ops/pallas/megakernel.py _mega_detect_kernel (and of
// _mega_kernel, which shares it) and the inline kernel of
// fused_rd_planes_pallas (radar_tpu/ops/pallas/fused_dft_kernel.py).
// Those compute the range DFT as a product with the (2S, 2R) constant
// a2, which suits the TPU's matrix unit.  On an H100 the same product at
// the 'high' tier is three split-TF32 passes (range_tc_kernel<3>): 412
// GFLOP per 512-frame batch at the 2-TX, 256-sample geometry, 0.83 ms
// at the tensor cores' full 495 TFLOP/s even if perfectly fed.  An FFT
// computes the same DFT in about 5 R log2 R flops a row, ~3 GFLOP a
// batch there, under 0.1 ms on the CUDA cores; so this kernel is bound
// by its bytes: the int16 rows read once (268 MB there) and the f32
// planes written once (537 MB), 0.24 ms at 3.35 TB/s.
//
// What it computes, per raw row m (one chirp of one RX), in f32:
//   x_t = ((I_t - bI_t) + i (Q_t - bQ_t)) w_t, t < S, zero to R,
// I / Q decoded from the TI (I0, I1, Q0, Q1) interleave, the base row m
// % rows_per_frame subtracted in f32 (one rounding, as the GEMM kernels
// do; no base under 'mean' clutter or MTI), w the window (a2[i_col(t),
// 0], megakernel.mega_constants range_window), then Z = FFT_R(x).  The
// twiddles exp(-2 pi i n / R) come from a host table computed in float64
// and rounded once (range_twiddles).  Its error is of order 2^-24
// sqrt(log2 R) of the row's norm: inside both tiers' promises (2^-21 a
// product at 'high', 2^-11 at 'default').  'highest' keeps
// range_gemm_kernel, the f32 product, which reproduces the JAX package's
// HIGHEST product for product.
//
// Design.  R = 2^L, 4 <= R <= 512.  A row is a team of T = R / 16
// threads (one thread for R <= 16), each holding E = 16 points (R below
// 16: all R), so a warp runs 32 / T rows at once.  The FFT is Stockham's
// autosort form, radix 16 then 16, 8, 4 or 2 (R = 256: 16 x 16; 128:
// 16 x 8; 512: 16 x 16 x 2): each pass is E / radix in-register DFTs a
// thread, and in every pass thread i reads and keeps the points i + T e,
// e < E.  So the first pass takes its inputs straight from the decoded
// samples t = i + T e, and the last pass leaves output bin i + T e in
// the slot it stores from: every store of a warp covers whole 32-byte
// sectors of [zr | zi], with no bit-reversal pass.  Between passes the
// points go through shared memory, padded one float in 16, which keeps
// every exchange free of bank conflicts up to R = 256 (at 512 the reads
// are 2-way on one bank).
//
// What keeps it at the bytes' pace: a warp takes one row index of the
// frame for kFftFrames frames in turn, and copies the raw rows of step n
// + 2 into a ring in shared memory (cp.async) while it transforms step
// n, so two steps of loads stay in flight a warp.  Its base row is read
// once a task into shared memory as (bI_t, bQ_t) pairs; the window and
// each thread's twiddles sit in a table of the block's.  Held in
// registers or read through L1 a row at a time, those cost a third of
// the kernel's time in spills and L2 traffic (measured on an H100 at the
// 2-TX, 256-sample geometry: 0.55 and 0.37 ms a 512-frame batch against
// 0.29 with the rows in shared memory, which is the card's rate for a
// plain copy of the same bytes, 2.75 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

namespace {

constexpr int kFftWarps = 8;       // warps a block
constexpr int kFftFrames = 16;     // frames a warp takes of its row index
constexpr int kFftMinLog2 = 2;     // R from 4
constexpr int kFftMaxLog2 = 9;     // to 512: a row's team fits one warp
constexpr int kFftSlots = 32 * 17; // floats a warp exchanges, per part

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 times_minus_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-register DFTs, natural order in and out, X_k = sum_n x_n
// exp(-2 pi i n k / N).
__device__ __forceinline__ void dft(float2 (&a)[2]) {
  const float2 t = a[0];
  a[0] = cadd(t, a[1]);
  a[1] = csub(t, a[1]);
}

__device__ __forceinline__ void dft(float2 (&a)[4]) {
  const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
  const float2 t2 = cadd(a[1], a[3]), t3 = times_minus_i(csub(a[1], a[3]));
  a[0] = cadd(t0, t2);
  a[2] = csub(t0, t2);
  a[1] = cadd(t1, t3);
  a[3] = csub(t1, t3);
}

constexpr float kSqrtHalf = 0.707106781186547524f;
constexpr float kCos8 = 0.923879532511286756f;   // cos(pi / 8)
constexpr float kSin8 = 0.382683432365089772f;   // sin(pi / 8)

// even and odd halves as DFT4s, the odd ones times exp(-2 pi i k / 8)
__device__ __forceinline__ void dft(float2 (&a)[8]) {
  float2 e[4] = {a[0], a[2], a[4], a[6]}, o[4] = {a[1], a[3], a[5], a[7]};
  dft(e);
  dft(o);
  o[1] = make_float2(kSqrtHalf * (o[1].x + o[1].y),
                     kSqrtHalf * (o[1].y - o[1].x));
  o[2] = times_minus_i(o[2]);
  o[3] = make_float2(kSqrtHalf * (o[3].y - o[3].x),
                     -kSqrtHalf * (o[3].x + o[3].y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = cadd(e[k], o[k]);
    a[k + 4] = csub(e[k], o[k]);
  }
}

// 4 x 4: DFT4s down the columns n = 4 n1 + n2, the twiddles
// exp(-2 pi i n2 k1 / 16), DFT4s along the rows, X[k1 + 4 k2]
__device__ __forceinline__ void dft(float2 (&a)[16]) {
  float2 y[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    float2 c[4] = {a[n2], a[4 + n2], a[8 + n2], a[12 + n2]};
    dft(c);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) y[n2][k1] = c[k1];
  }
  y[1][1] = cmul(y[1][1], make_float2(kCos8, -kSin8));
  y[1][2] = cmul(y[1][2], make_float2(kSqrtHalf, -kSqrtHalf));
  y[1][3] = cmul(y[1][3], make_float2(kSin8, -kCos8));
  y[2][1] = cmul(y[2][1], make_float2(kSqrtHalf, -kSqrtHalf));
  y[2][2] = times_minus_i(y[2][2]);
  y[2][3] = cmul(y[2][3], make_float2(-kSqrtHalf, -kSqrtHalf));
  y[3][1] = cmul(y[3][1], make_float2(kSin8, -kCos8));
  y[3][2] = cmul(y[3][2], make_float2(-kSqrtHalf, -kSqrtHalf));
  y[3][3] = cmul(y[3][3], make_float2(-kCos8, kSin8));
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 c[4] = {y[0][k1], y[1][k1], y[2][k1], y[3][k1]};
    dft(c);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) a[k1 + 4 * k2] = c[k2];
  }
}

// The pass schedule of an R-point row: a thread holds fft_points(R)
// points; the pass after sub-transforms of length ns has radix
// fft_radix(R, ns), and a thread runs points / radix DFTs in it.
__host__ __device__ constexpr int fft_points(int r) { return r < 16 ? r : 16; }

__host__ __device__ constexpr int fft_radix(int r, int ns) {
  return ns == 1 ? fft_points(r) : (r / ns < 16 ? r / ns : 16);
}

// twiddles a thread holds for the passes from ``ns`` on
__host__ __device__ constexpr int fft_twiddles(int r, int ns) {
  return ns >= r ? 0
                 : (ns == 1 ? 0
                            : fft_points(r) / fft_radix(r, ns) *
                                  (fft_radix(r, ns) - 1)) +
                       fft_twiddles(r, ns * fft_radix(r, ns));
}

template <int R>
struct FftPlan {
  static constexpr int E = fft_points(R);   // points a thread holds
  static constexpr int T = R / E;           // threads a row
  static constexpr int kRows = 32 / T;      // rows a warp at once
  static constexpr int kTwiddles =
      fft_twiddles(R, 1) > 0 ? fft_twiddles(R, 1) : 1;
};

// The exchange's float of point p: one pad float in 16
__device__ __forceinline__ int slot(int p) { return p + (p >> 4); }

// Thread i's twiddles of the passes from ``NS`` on into the block's
// table ``tws`` (twiddle s at s T + i): exp(-2 pi i r k / (NS radix)) for
// job q (k = (i + q T) mod NS) and r = 1 .. radix - 1, entry r k R / (NS
// radix) of the host's table.
template <int R, int NS>
__device__ __forceinline__ void store_twiddles(
    float2* tws, const float2* __restrict__ table, int i) {
  using P = FftPlan<R>;
  if constexpr (NS < R) {
    constexpr int RP = fft_radix(R, NS), Q = P::E / RP;
    if constexpr (NS > 1) {
      constexpr int OFF = fft_twiddles(R, 1) - fft_twiddles(R, NS);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = (i + q * P::T) % NS;
#pragma unroll
        for (int r = 1; r < RP; ++r)
          tws[(OFF + q * (RP - 1) + r - 1) * P::T + i] =
              __ldg(table + r * k * (R / (NS * RP)));
      }
    }
    store_twiddles<R, NS * RP>(tws, table, i);
  }
}

// The passes from sub-transforms of length NS on, over the points x[e] =
// point i + T e of the thread's row; they leave bin i + T e in x[e].  In
// the pass, job j = i + q T takes points j + r R / RP (x[q + r Q]) and
// puts its outputs at j / NS * NS RP + j mod NS + r NS (Stockham).  The
// twiddles come from the block's table ``tws``, twiddle s of thread i at
// s T + i (store_twiddles' order).
template <int R, int NS>
__device__ __forceinline__ void fft_passes(float2 (&x)[FftPlan<R>::E],
                                           const float2* tws, float* sre,
                                           float* sim, int i) {
  using P = FftPlan<R>;
  constexpr int E = P::E, T = P::T, RP = fft_radix(R, NS), Q = E / RP;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float2 a[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) a[r] = x[q + r * Q];
    if constexpr (NS > 1) {
      constexpr int OFF = fft_twiddles(R, 1) - fft_twiddles(R, NS);
#pragma unroll
      for (int r = 1; r < RP; ++r)
        a[r] = cmul(a[r], tws[(OFF + q * (RP - 1) + r - 1) * T + i]);
    }
    dft(a);
#pragma unroll
    for (int r = 0; r < RP; ++r) x[q + r * Q] = a[r];
  }
  if constexpr (NS * RP < R) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = i + q * T;
      const int out = j / NS * NS * RP + j % NS;
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int s = slot(out + r * NS);
        sre[s] = x[q + r * Q].x;
        sim[s] = x[q + r * Q].y;
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int s = slot(i + e * T);
      x[e] = make_float2(sre[s], sim[s]);
    }
    __syncwarp();   // read before the next row's or pass's writes
    fft_passes<R, NS * RP>(x, tws, sre, sim, i);
  }
}

// 16 bytes global -> shared by cp.async, or 16 zero bytes where !valid
// (``gmem`` must still be a mapped address then; nothing is read).
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

// A warp's shared memory: a ring of kFftStages stages of its rows' raw
// shorts (the rows it runs at once, 2S shorts each, at most 2 KB: R / 16
// threads a row and S <= R), the exchange [re | im], and its base row as
// (bI_t, bQ_t) pairs.
constexpr int kFftStages = 3;
constexpr int kFftStageShorts = 1024;
template <int R>
struct FftWarpShared {
  int16_t ring[kFftStages][kFftStageShorts];
  float ex[2][kFftSlots];
  float2 base[R];
};

// The block's shared memory: the window (R floats, zero past S) and the
// twiddles of each thread of a row (kTwiddles x T), then its warps'.
// Tables and base rows in shared memory, not registers or L1: registers
// go to the loads in flight, and each base row is read from device
// memory once a warp task.
template <int R>
struct FftBlockShared {
  float window[R];
  float2 twiddles[FftPlan<R>::kTwiddles * FftPlan<R>::T];
  __align__(16) FftWarpShared<R> warps[kFftWarps];
};

// One block of kFftWarps warps; warp task w takes row index w mod
// rows_per_frame of frames (w / rows_per_frame) * F .. + F - 1, F =
// max(kFftFrames, rows a warp runs at once), kRows at a time (a step).
template <int LOG2R>
__global__ void __launch_bounds__(kFftWarps * 32, 2) range_fft_kernel(
    const int16_t* __restrict__ raw, const float* __restrict__ base,
    const float* __restrict__ window, const float2* __restrict__ twiddles,
    float* __restrict__ z, int n_frames, int rows_per_frame,
    int n_samples) {
  constexpr int R = 1 << LOG2R;
  using P = FftPlan<R>;
  constexpr int E = P::E, T = P::T, kRows = P::kRows;
  constexpr int F = kRows > kFftFrames ? kRows : kFftFrames;
  extern __shared__ __align__(16) unsigned char fft_smem[];
  FftBlockShared<R>& blk = *reinterpret_cast<FftBlockShared<R>*>(fft_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int team = lane / T, i = lane % T;

  // the tables: the window, and warp 0's first row's threads' twiddles
  for (int t = threadIdx.x; t < R; t += blockDim.x)
    blk.window[t] = t < n_samples ? __ldg(window + t) : 0.f;
  if (warp == 0 && team == 0)
    store_twiddles<R, 1>(blk.twiddles, twiddles, i);
  __syncthreads();

  FftWarpShared<R>& sh = blk.warps[warp];
  const long long task = (long long)blockIdx.x * kFftWarps + warp;
  const int row = (int)(task % rows_per_frame);
  const long long b0 = task / rows_per_frame * F;
  if (b0 >= n_frames) return;   // the whole warp
  const long long frames_left = n_frames - b0;
  const int steps =
      (int)(frames_left < F ? (frames_left + kRows - 1) / kRows : F / kRows);
  float* sre = sh.ex[0] + team * (R + R / 16);
  float* sim = sh.ex[1] + team * (R + R / 16);
  const int s2 = 2 * n_samples;

  // step n's rows b0 + n kRows + r (r < kRows) into ring slot n % stages,
  // row r at r * 2S shorts: S / 4 chunks of 16 bytes a row
  const int row_chunks = n_samples / 4;
  const int chunks = kRows * row_chunks;
  auto prefetch = [&](int n) {
    int16_t* dst = sh.ring[n % kFftStages];
    for (int c = lane; c < chunks; c += 32) {
      const int r = c / row_chunks, k = c - r * row_chunks;
      const long long b = b0 + (long long)n * kRows + r;
      const bool ok = n < steps && b < n_frames;
      cp_async16(dst + r * s2 + 8 * k,
                 ok ? raw + (b * rows_per_frame + row) * s2 + 8 * k : raw,
                 ok);
    }
    cp_async_commit();
  };
  // the base row as (bI_t, bQ_t), seen by every lane after the loop's
  // first __syncwarp
  if (base != nullptr) {
    const float4* src = reinterpret_cast<const float4*>(base) +
                        (long long)row * (n_samples / 2);
    for (int g = lane; g < n_samples / 2; g += 32) {
      const float4 v = __ldg(src + g);   // bI0 bI1 bQ0 bQ1
      sh.base[2 * g] = make_float2(v.x, v.z);
      sh.base[2 * g + 1] = make_float2(v.y, v.w);
    }
  }

  prefetch(0);
  prefetch(1);
  for (int n = 0; n < steps; ++n) {
    cp_async_wait<1>();   // step n's rows landed (this lane's copies)
    __syncwarp();         // ... and every lane's
    const int16_t* rows = sh.ring[n % kFftStages] + team * s2;
    float2 x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = i + T * e;
      x[e] = make_float2(0.f, 0.f);
      if (t < n_samples) {
        const int g = t >> 1, odd = t & 1;
        // two shorts a word, low first: I_t of the group in .x, Q_t in .y
        const int2 v = *reinterpret_cast<const int2*>(rows + 4 * g);
        float si = odd ? (float)(v.x >> 16) : (float)(int16_t)(v.x & 0xffff);
        float sq = odd ? (float)(v.y >> 16) : (float)(int16_t)(v.y & 0xffff);
        if (base != nullptr) {
          const float2 bt = sh.base[t];
          si -= bt.x;
          sq -= bt.y;
        }
        const float w = blk.window[t];
        x[e] = make_float2(si * w, sq * w);
      }
    }
    // the slot read at step n - 1 takes step n + 2: every lane is past
    // that read (the __syncwarp above)
    prefetch(n + 2);
    fft_passes<R, 1>(x, blk.twiddles, sre, sim, i);
    const long long b = b0 + (long long)n * kRows + team;
    if (b < n_frames) {
      float* zr = z + (b * rows_per_frame + row) * (2 * R);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        zr[i + T * e] = x[e].x;
        zr[R + i + T * e] = x[e].y;
      }
    }
  }
  cp_async_wait<0>();
}

template <int LOG2R>
cudaError_t launch_range_fft(const int16_t* raw, const float* base,
                             const float* window, const float2* twiddles,
                             float* z, int n_frames, int rows_per_frame,
                             int n_samples, cudaStream_t stream) {
  constexpr int rows = FftPlan<1 << LOG2R>::kRows;
  constexpr int frames = rows > kFftFrames ? rows : kFftFrames;
  const long long tasks =
      (long long)rows_per_frame * ((n_frames + frames - 1) / frames);
  const long long blocks = (tasks + kFftWarps - 1) / kFftWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(FftBlockShared<1 << LOG2R>);
  const cudaError_t err =
      radar_cfar::allow_smem(range_fft_kernel<LOG2R>, smem);
  if (err != cudaSuccess) return err;
  range_fft_kernel<LOG2R><<<(unsigned)blocks, kFftWarps * 32, smem,
                            stream>>>(raw, base, window, twiddles, z,
                                      n_frames, rows_per_frame, n_samples);
  return cudaGetLastError();
}

template <int LOG2R>
cudaError_t dispatch_range_fft(int log2r, const int16_t* raw,
                               const float* base, const float* window,
                               const float2* twiddles, float* z,
                               int n_frames, int rows_per_frame,
                               int n_samples, cudaStream_t stream) {
  if (log2r == LOG2R)
    return launch_range_fft<LOG2R>(raw, base, window, twiddles, z, n_frames,
                                   rows_per_frame, n_samples, stream);
  if constexpr (LOG2R < kFftMaxLog2)
    return dispatch_range_fft<LOG2R + 1>(log2r, raw, base, window, twiddles,
                                         z, n_frames, rows_per_frame,
                                         n_samples, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Stage (a) as the FFT: raw int16 (B, C*V, 2S) minus base (C*V, 2S) f32
// (or NULL), windowed by ``window`` (S f32), transformed with the table
// ``twiddles`` (R complex f32, exp(-2 pi i n / R)) into z (B*C*V, 2R).
// R a power of two in 4 .. 512 and S <= R, S a multiple of 4; else
// cudaErrorInvalidValue, launching nothing.
cudaError_t range_fft_stage(const int16_t* raw, const float* base,
                            const float* window, const float* twiddles,
                            float* z, int n_frames, int rows_per_frame,
                            int n_samples, int r_size, cudaStream_t stream) {
  int log2r = 0;
  while ((1 << log2r) < r_size) ++log2r;
  if ((1 << log2r) != r_size || log2r < kFftMinLog2 || log2r > kFftMaxLog2 ||
      n_samples > r_size || n_samples % 4 != 0 || window == nullptr ||
      twiddles == nullptr)
    return cudaErrorInvalidValue;
  return dispatch_range_fft<kFftMinLog2>(
      log2r, raw, base, window, reinterpret_cast<const float2*>(twiddles), z,
      n_frames, rows_per_frame, n_samples, stream);
}
