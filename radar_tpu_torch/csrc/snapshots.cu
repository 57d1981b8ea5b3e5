// The float64 range rows of the refiners' snapshots for Hopper (sm_90a):
// per frame and detection, the raw int16 frame, less its base, contracted
// with the detection's range row of the interleaved range-DFT table,
//
//   g_re[b, k, m] = sum_j a_re[r_k, j] * (raw[b, m, j] - base[m, j])
//   g_im[b, k, m] = sum_j a_im[r_k, j] * (raw[b, m, j] - base[m, j])
//
// each sum in float64, rounded once to float32 (r_k the range bin of
// detection k, m a (chirp, rx) row, j the 2S interleaved samples).
//
// Replaces no TPU kernel.  The JAX package gathers the refiners'
// snapshots from its fused RD planes; the port recomputes them from the
// raw frames (ops/cuda/megakernel.snapshots_from_shorts with exact=True),
// and its plain version (ops/cuda/snapshots.snapshot_rows_reference)
// converts the whole batch to float64, subtracts the base in place and
// runs two batched cuBLAS f64 products: at B = 512 frames of 768 rows x
// 512 samples it writes and reads a 1.61 GB copy four times (~3.2 ms).
//
// Exactness.  The base is subtracted before the products, as the plain
// version does: where it holds integers (a base frame, or any int16-valued
// base below 2^22) as an integer difference, exact, converted to float64
// with the 2^52 + 2^51 bias trick (no conversion instruction); anywhere
// else as float64(x) - float64(b), the plain version's own rounding.  The
// table's float32 values convert exactly, so every product of an int16
// difference and a table value is exact in float64; only the order of the
// float64 additions differs from cuBLAS's, and after the one rounding to
// float32 an element equals the plain version's or lies 1 ulp from it.
// No TF32: the products run on the float64 tensor cores.
//
// What bounds it on an H100: the operations.  At B = 512, K = 16, 768 rows
// and 2S = 512 it does 6.44e9 float64 FMAs (0.19 ms at 67 TFLOP/s of the
// FP64 tensor cores) and reads 403 MB of int16 frames once (0.12 ms at
// 3.35 TB/s).  The design: one block a frame and group of 16 detections.
// The block stages its 32 gathered table rows (16 re, 16 im) in shared
// memory as float64, laid out in the order of the mma fragments, so each
// fragment is two conflict-free 16-byte loads; then each warp takes 32
// rows at a time (two m16 tiles) and walks the samples 32 at a time,
// loading its rows' int16 samples and the base straight into registers
// with 16-byte loads one chunk ahead of the products, and runs
// mma.sync m16n8k16 f64 (A: the rows, B: the table, 4 n8 tiles) with the
// 32 x 32 sums in registers.  Within a chunk, thread t of a quad holds
// the samples 8t..8t+7 of its rows: the products' k index t + 4j maps to
// sample 8t + 4s + j of slab s, for the rows and the table alike, so the
// rows load as 16 contiguous bytes.  A table wider than 16 chunks (2S >
// 512) is staged 16 chunks at a time, once per pass of the block's rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDets = 16;                   // detections a block
constexpr int kNTiles = 2 * kDets / 8;      // n8 tiles: re 0-7, 8-15, im ...
constexpr int kMTiles = 2;                  // m16 tiles of rows a warp
constexpr int kRowsPerPass = kWarps * kMTiles * 16;
constexpr int kChunk = 32;                  // samples a chunk: 2 k16 slabs
constexpr int kSegChunks = 16;              // chunks of the table staged
constexpr int kChunkDoubles = 2 * kNTiles * 2 * 32 * 2;   // 8 KB a chunk
constexpr int kSmemDefault = 48 * 1024;

constexpr float kMagicF = 12582912.0f;             // 1.5 * 2^23
constexpr double kMagicD = 6755401588539392.0;     // 2^52 + 2^51 + 2^31

// Four consecutive samples of one row: the int16 pairs and the base.
struct Quad {
  uint2 x;
  float4 b;
};

// The double whose bits are 0x43380000:lo, less 2^52 + 2^51 + 2^31: the
// integer lo - 2^31, exactly.
__device__ __forceinline__ double biased(unsigned lo) {
  return __dsub_rn(__hiloint2double(0x43380000, static_cast<int>(lo)),
                   kMagicD);
}

// The quad's four samples less the base, as float64, in sample order.
template <int kBase>
__device__ __forceinline__ void to_f64(const Quad& q, double (&d)[4]) {
  const int w0 = static_cast<int>(q.x.x), w1 = static_cast<int>(q.x.y);
  const int x[4] = {static_cast<int16_t>(w0 & 0xffff), w0 >> 16,
                    static_cast<int16_t>(w1 & 0xffff), w1 >> 16};
  if constexpr (!kBase) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[i] = biased(static_cast<unsigned>(x[i]) ^ 0x80000000u);
    }
  } else {
    const float b[4] = {q.b.x, q.b.y, q.b.z, q.b.w};
    unsigned lo[4];
    bool whole = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bb = 1.5 * 2^23 + b rounded to an integer; its low bits are that
      // integer where |b| < 2^22, and b is one where bb - 1.5 * 2^23 == b
      const float bb = __fadd_rn(b[i], kMagicF);
      whole &= (__fsub_rn(bb, kMagicF) == b[i]) & (fabsf(b[i]) < 4194304.0f);
      // x - b + 2^31 = x - (bits(bb) - 0x4B400000) + 0x80000000
      lo[i] = static_cast<unsigned>(x[i]) - __float_as_uint(bb) + 0xCB400000u;
    }
    if (whole) {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = biased(lo[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i] = __dsub_rn(static_cast<double>(x[i]),
                         static_cast<double>(b[i]));
      }
    }
  }
}

// D = A B + D on the float64 tensor cores: A 16 x 16 (rows g, g + 8 of
// the quad's group; k index t + 4j), B 16 x 8 (k index t + 4j, column g).
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Offset (in doubles) of the table value that lane `lane` holds as b[2h +
// e] of n-tile nt, slab s, in the staged chunk i: per (i, s, nt) two
// 512-byte runs (h), 16 bytes a lane.
__device__ __forceinline__ int tab_index(int i, int s, int nt, int h,
                                         int lane, int e) {
  return ((((i * 2 + s) * kNTiles + nt) * 2 + h) * 32 + lane) * 2 + e;
}

// Stage the table rows of the block's detections for the chunks [c0, c0 +
// n_chunks) into shared memory as float64 (zeros past 2S and for
// detections past the last).  Column col: re of detection col for col <
// 16, im of detection col - 16 otherwise.
__device__ __forceinline__ void stage_table(
    double* tab, const float* __restrict__ a_re,
    const float* __restrict__ a_im, const int* r_bins, int n_dets, int c0,
    int n_chunks, int s2, int warp, int lane) {
  float v[4][kSegChunks];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = warp + kWarps * q;
    const int det = col % kDets;
    const float* src = det < n_dets
        ? (col < kDets ? a_re : a_im) + static_cast<size_t>(r_bins[det]) * s2
        : nullptr;
#pragma unroll
    for (int i = 0; i < kSegChunks; ++i) {
      const int sample = (c0 + i) * kChunk + lane;
      v[q][i] = (src != nullptr && i < n_chunks && sample < s2)
          ? __ldg(src + sample) : 0.0f;
    }
  }
  // within a chunk, sample 8t + 4s + 2h + e is b[2h + e] of lane 4g + t
  const int t = lane >> 3, s = (lane >> 2) & 1, h = (lane >> 1) & 1,
            e = lane & 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = warp + kWarps * q;
    const int nt = col / 8, dst_lane = (col % 8) * 4 + t;
#pragma unroll
    for (int i = 0; i < kSegChunks; ++i) {
      if (i < n_chunks) {
        tab[tab_index(i, s, nt, h, dst_lane, e)] =
            static_cast<double>(v[q][i]);
      }
    }
  }
}

// One quad pair of a chunk: row `row`, samples [sample, sample + 8).
template <int kBase>
__device__ __forceinline__ void load_rows(Quad (&q)[2],
                                          const int16_t* __restrict__ x,
                                          const float* __restrict__ base,
                                          int row, int sample, bool ok,
                                          int s2) {
  if (ok) {
    const size_t off = static_cast<size_t>(row) * s2 + sample;
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(x + off));
    q[0].x = make_uint2(w.x, w.y);
    q[1].x = make_uint2(w.z, w.w);
    if constexpr (kBase) {
      const float4* b = reinterpret_cast<const float4*>(base + off);
      q[0].b = __ldg(b);
      q[1].b = __ldg(b + 1);
    }
  } else {
    q[0].x = q[1].x = make_uint2(0u, 0u);
    q[0].b = q[1].b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Block (frame, group of kDets detections).  Shared memory: the staged
// table, kChunkDoubles doubles a chunk.
template <int kBase>
__global__ void __launch_bounds__(kThreads, 1) snapshot_rows_kernel(
    const int16_t* __restrict__ raw, const float* __restrict__ base,
    const long long* __restrict__ top_idx, const float* __restrict__ a_re,
    const float* __restrict__ a_im, float* __restrict__ g_re,
    float* __restrict__ g_im, int k, int n_rows, int s2, int r_size) {
  extern __shared__ double tab[];
  __shared__ int r_bins[kDets];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const long long frame = blockIdx.x;
  const int det0 = blockIdx.y * kDets;
  const int n_dets = min(kDets, k - det0);
  if (threadIdx.x < n_dets) {
    // torch's floor modulo: a negative index reads a row from the end
    const long long r = top_idx[frame * k + det0 + threadIdx.x] % r_size;
    r_bins[threadIdx.x] = static_cast<int>(r < 0 ? r + r_size : r);
  }
  __syncthreads();
  const int n_chunks = (s2 + kChunk - 1) / kChunk;
  const int n_seg = (n_chunks + kSegChunks - 1) / kSegChunks;
  const int16_t* x = raw + frame * n_rows * static_cast<long long>(s2);
  if (n_seg == 1) {
    stage_table(tab, a_re, a_im, r_bins, n_dets, 0, n_chunks, s2, warp,
                lane);
    __syncthreads();
  }

  for (int row0 = 0; row0 < n_rows; row0 += kRowsPerPass) {
    const int wrow = row0 + warp * kMTiles * 16;
    const bool live = wrow < n_rows;      // the same for the whole warp
    double acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;
      }
    }
    for (int seg = 0; seg < n_seg; ++seg) {
      const int c_begin = seg * kSegChunks;
      const int c_end = min(n_chunks, c_begin + kSegChunks);
      if (n_seg > 1) {
        __syncthreads();      // every warp is done with the last segment
        stage_table(tab, a_re, a_im, r_bins, n_dets, c_begin,
                    c_end - c_begin, s2, warp, lane);
        __syncthreads();
      }
      if (!live) continue;
      // [mt][half]: rows wrow + 16 mt + 8 half + g, this chunk's samples
      // 8t .. 8t + 7 as two quads
      Quad nxt[kMTiles][2][2];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wrow + 16 * mt + 8 * half + g;
          const int sample = c_begin * kChunk + 8 * t;
          load_rows<kBase>(nxt[mt][half], x, base, row, sample,
                           row < n_rows && sample < s2, s2);
        }
      }
      for (int c = c_begin; c < c_end; ++c) {
        Quad cur[kMTiles][2][2];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            cur[mt][half][0] = nxt[mt][half][0];
            cur[mt][half][1] = nxt[mt][half][1];
            if (c + 1 < c_end) {
              const int row = wrow + 16 * mt + 8 * half + g;
              const int sample = (c + 1) * kChunk + 8 * t;
              load_rows<kBase>(nxt[mt][half], x, base, row, sample,
                               row < n_rows && sample < s2, s2);
            }
          }
        }
        const int i = c - c_begin;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          double b[kNTiles][4];
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            const double2 lo = *reinterpret_cast<const double2*>(
                tab + tab_index(i, s, nt, 0, lane, 0));
            const double2 hi = *reinterpret_cast<const double2*>(
                tab + tab_index(i, s, nt, 1, lane, 0));
            b[nt][0] = lo.x;
            b[nt][1] = lo.y;
            b[nt][2] = hi.x;
            b[nt][3] = hi.y;
          }
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
            double d0[4], d1[4];
            to_f64<kBase>(cur[mt][0][s], d0);
            to_f64<kBase>(cur[mt][1][s], d1);
            const double a[8] = {d0[0], d1[0], d0[1], d1[1],
                                 d0[2], d1[2], d0[3], d1[3]};
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt) {
              mma_f64(acc[mt][nt], a, b[nt]);
            }
          }
        }
      }
    }
    if (!live) continue;
    // c[e]: row g + 8 (e / 2), column 2t + e % 2 of the tile
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wrow + 16 * mt + g + 8 * (e / 2);
          const int col = nt * 8 + 2 * t + e % 2;
          const int det = col % kDets;
          if (row < n_rows && det < n_dets) {
            float* out = col < kDets ? g_re : g_im;
            out[(frame * k + det0 + det) * static_cast<long long>(n_rows) +
                row] = __double2float_rn(acc[mt][nt][e]);
          }
        }
      }
    }
  }
}

template <int kBase>
cudaError_t launch_rows(const int16_t* raw, const float* base,
                        const long long* top_idx, const float* a_re,
                        const float* a_im, float* g_re, float* g_im,
                        int n_frames, int k, int n_rows, int s2, int r_size,
                        cudaStream_t stream) {
  const int n_chunks = (s2 + kChunk - 1) / kChunk;
  const size_t smem = static_cast<size_t>(min(n_chunks, kSegChunks)) *
                      kChunkDoubles * sizeof(double);
  if (smem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err = cudaFuncSetAttribute(
        snapshot_rows_kernel<kBase>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_frames, (k + kDets - 1) / kDets);
  snapshot_rows_kernel<kBase><<<grid, kThreads, smem, stream>>>(
      raw, base, top_idx, a_re, a_im, g_re, g_im, k, n_rows, s2, r_size);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The range rows on ``stream``: raw int16 (n_frames, n_rows, s2), base
// f32 (n_rows, s2) or null (no base clutter removal), top_idx int64
// (n_frames, k) flat D*R cell indices (the range bin is the index modulo
// r_size), the tables a_re, a_im f32 (r_size, s2) -> g_re, g_im f32
// (n_frames, k, n_rows).  s2 is a multiple of 8; raw, base, a_re and a_im
// start on 16-byte boundaries.
int radar_snapshot_rows(const int16_t* raw, const float* base,
                        const long long* top_idx, const float* a_re,
                        const float* a_im, float* g_re, float* g_im,
                        int n_frames, int k, int n_rows, int s2, int r_size,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0 || k <= 0) return cudaSuccess;
  if (n_rows < 1 || s2 < 8 || s2 % 8 || r_size < 1 ||
      (k + kDets - 1) / kDets > 65535) {
    return cudaErrorInvalidValue;
  }
  if (base != nullptr) {
    return launch_rows<1>(raw, base, top_idx, a_re, a_im, g_re, g_im,
                             n_frames, k, n_rows, s2, r_size, stream);
  }
  return launch_rows<0>(raw, base, top_idx, a_re, a_im, g_re, g_im,
                            n_frames, k, n_rows, s2, r_size, stream);
}

}  // extern "C"
