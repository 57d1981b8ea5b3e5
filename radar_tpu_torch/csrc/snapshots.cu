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

// ---------------------------------------------------------------------------
// The maps path's snapshots (ops/cuda/megakernel.snapshots_from_shorts with
// exact=False, the gatherer of every maps-path tail): per frame and
// detection the complex64 virtual-RX snapshot, straight from the int16
// frame,
//
//   snap[b, k, t*V + v] = sum_kc F'[d_k, kc] * (g_re + i g_im)[b, k, m]
//
// with m = c*V + v the (chirp, rx) row of chirp c = kc*TX + t, g the range
// rows above, d_k the detection's Doppler bin and F' its row of the
// windowed, fftshifted Doppler DFT with the clutter step folded in by
// linearity:
//
//   base    the base subtracted in raw space, as above: where it holds
//           whole numbers (a device flag, so no host sync) as an exact
//           integer difference from its int16 raw interleave, cached per
//           base tensor by the wrapper; elsewhere as snapshot_rows_kernel
//           does, read from the complex64 (V, C, S) base cube through the
//           interleave's index map (the 16 bytes of samples 2q, 2q + 1 are
//           I0, Q0, I1, Q1; the raw frame holds I0, I1, Q0, Q1); F' = F;
//   mean    F' = F, less the mean over all C chirps of the rows (per RX)
//           times sum_kc F[d_k, kc], a rank-one correction;
//   mti2/3  the circular canceller along each TX's chirps, folded into the
//           table: F'[kc] = F[kc] - F[kc+1], or F[kc] - 2 F[kc+1] +
//           F[kc+2], indices modulo Kc;
//   none    F' = F.
//
// Replaces no TPU kernel.  The plain version (snapshot_rows_reference in
// float32, the clutter step, the TDM demux and the Doppler-row products in
// torch) converts the whole batch to float32, subtracts the base in place
// and runs two cuBLAS SGEMMs and ~15 small ops around them: ~0.74 ms of
// device a batch at the OS deployment (B = 512, K = 16, 512 rows, 2S =
// 200), whose bound is 3.36 GFLOP at 67 TFLOP/s, 0.050 ms (the 105 MB of
// int16 frames read once take 0.031 ms).
//
// Exactness: the range rows as snapshot_rows_kernel forms them (exact
// products of int16 differences and table values, summed in float64 on
// the tensor cores), the Doppler sums in float64, rounded once to float32.
// So its error against float64 lies below the float32 path's, and no TF32
// switch reaches it.
//
// Design: snapshot_rows_kernel's blocks (a frame and 16 detections) and
// mma tiles, with each warp's 32 rows chosen so that the Doppler
// contraction is a sum in registers: tile (u, kcb) holds the rows m = kc*U
// + u for kc in [32 kcb, 32 kcb + 32) (U = TX*V, u = t*V + v, rows past Kc
// read as zeros), so all 32 feed the one output column u.  After the
// tile's products each thread weighs its four rows' sums by F' (the
// block's 16 Doppler rows staged in shared memory), the warp sums its
// eight row groups by a reduce-scatter of shuffles, and the block adds the
// tiles' sums into shared memory in a fixed order, so the result does not
// depend on the schedule.  A warp's loads run one chunk ahead through all
// its tiles, so the next tile's first chunk arrives during this tile's
// sums; the table is staged by destination, 16 bytes a lane.  The frames
// come through a frame stride (every n-th frame of a batch without a
// copy) and top_idx as int32 or int64.
//
// At the OS deployment it takes 0.122 ms a batch (41 % of the bound):
// 0.011 ms a chunk of 32 samples, 72 % of the FP64 tensor cores' rate, and
// ~0.04 ms that does not grow with 2S (the staging, each tile's sums while
// the tensor cores drain), one block an SM at 255 registers.

constexpr int kTileRows = kMTiles * 16;     // rows of a warp's tile
constexpr int kSlot = kDets * 4;            // a tile's sums: det x 4

// How a tile's rows read the base: none, the float32 cube (the integer
// test per sample, as snapshot_rows_kernel), or the int16 raw interleave
// of a base that holds whole numbers.
enum RowMode { kNoBase = 0, kCubeBase = 1, kIntBase = 2 };

// Four consecutive samples of one row: the int16 pairs and, for kIntBase,
// the base's.  The cube's float32 base is read where it is used (a base
// that is not whole numbers is rare, and holding it would take the
// registers the other modes use).
struct RowQuad {
  uint2 x;
  uint2 b16;
};

// Raw-interleave order (I0, I1, Q0, Q1) of a cube's two complex samples
// (re0, im0, re1, im1).
__device__ __forceinline__ float4 interleave(float4 c) {
  return make_float4(c.x, c.z, c.y, c.w);
}

// One quad pair of a chunk: the frame row at `row` (also the int16 base's
// row, in samples), samples [sample, sample + 8).
template <int kMode>
__device__ __forceinline__ void load_tile_rows(
    RowQuad (&q)[2], const int16_t* __restrict__ x,
    const void* __restrict__ base, int row, int sample, bool ok) {
  if (ok) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(x + row + sample));
    q[0].x = make_uint2(w.x, w.y);
    q[1].x = make_uint2(w.z, w.w);
    if constexpr (kMode == kIntBase) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const int16_t*>(base) + row + sample));
      q[0].b16 = make_uint2(b.x, b.y);
      q[1].b16 = make_uint2(b.z, b.w);
    }
  } else {
    q[0].x = q[1].x = q[0].b16 = q[1].b16 = make_uint2(0u, 0u);
  }
}

// The four samples of an int16 pair of words, sign-extended.
__device__ __forceinline__ void unpack(uint2 w, int (&v)[4]) {
  const int w0 = static_cast<int>(w.x), w1 = static_cast<int>(w.y);
  v[0] = static_cast<int16_t>(w0 & 0xffff);
  v[1] = w0 >> 16;
  v[2] = static_cast<int16_t>(w1 & 0xffff);
  v[3] = w1 >> 16;
}

// The quad's four samples less the base, as float64, in sample order: an
// exact integer difference for kNoBase and kIntBase, to_f64's for the
// cube, whose four values it reads at `cube` (cube order), a row past Kc
// (ok false) reading none.
template <int kMode>
__device__ __forceinline__ void row_f64(const RowQuad& q, double (&d)[4],
                                        const float* cube, bool ok) {
  if constexpr (kMode == kIntBase) {
    int x[4], b[4];
    unpack(q.x, x);
    unpack(q.b16, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[i] = biased(static_cast<unsigned>(x[i] - b[i]) ^ 0x80000000u);
    }
  } else {
    Quad p;
    p.x = q.x;
    if constexpr (kMode == kCubeBase) {
      p.b = ok ? interleave(__ldg(reinterpret_cast<const float4*>(cube)))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    to_f64<kMode == kCubeBase>(p, d);
  }
}

// F'[kc] of the clutter step (0 none or base, 1 mean, 2 mti2, 3 mti3) from
// the detection's Doppler row f (kc_size complex values, staged in shared
// memory), in float64.
__device__ __forceinline__ double2 folded_tap(const float2* f, int kc,
                                              int kc_size, int clutter) {
  const float2 a = f[kc];
  double re = a.x, im = a.y;
  if (clutter >= 2) {
    const int k1 = kc + 1 == kc_size ? 0 : kc + 1;
    const float2 b = f[k1];
    if (clutter == 2) {
      re -= b.x;
      im -= b.y;
    } else {
      const int k2 = k1 + 1 == kc_size ? 0 : k1 + 1;
      const float2 c = f[k2];
      re = re - 2.0 * b.x + c.x;
      im = im - 2.0 * b.y + c.y;
    }
  }
  return make_double2(re, im);
}

__device__ __forceinline__ double warp_sum(double v, int first_mask) {
#pragma unroll
  for (int m = first_mask; m < 32; m <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, m);
  }
  return v;
}

// stage_table's layout, staged by destination: each thread writes the
// pair b[2h], b[2h + 1] of a lane (16 contiguous bytes, so a warp's stores
// do not conflict) from two consecutive samples of the table (one 8-byte
// load); the chunks [c0, c0 + n_chunks).
__device__ __forceinline__ void stage_table_pairs(
    double* tab, const float* __restrict__ a_re,
    const float* __restrict__ a_im, const int* r_bins, int n_dets, int c0,
    int n_chunks, int s2) {
  // per chunk: 2 slabs x kNTiles x 2 halves x 32 lanes pairs
  const int per_chunk = 2 * kNTiles * 2 * 32;
  const int n_pairs = n_chunks * per_chunk;
  constexpr int kUnroll = 4;
  for (int p0 = threadIdx.x; p0 < n_pairs; p0 += kUnroll * kThreads) {
    float2 v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int pair = p0 + q * kThreads;
      // pair = ((i * 2 + s) * kNTiles + nt) * 2 + h) * 32 + dst_lane
      const int dst_lane = pair % 32, h = (pair / 32) % 2;
      const int nt = (pair / 64) % kNTiles, s = (pair / (64 * kNTiles)) % 2;
      const int i = pair / per_chunk;
      const int col = nt * 8 + dst_lane / 4, det = col % kDets;
      const int sample = (c0 + i) * kChunk + 8 * (dst_lane % 4) + 4 * s +
                         2 * h;
      v[q] = pair < n_pairs && det < n_dets && sample < s2
          ? __ldg(reinterpret_cast<const float2*>(
                (col < kDets ? a_re : a_im) +
                static_cast<size_t>(r_bins[det]) * s2 + sample))
          : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int pair = p0 + q * kThreads;
      if (pair < n_pairs) {
        reinterpret_cast<double2*>(tab)[pair] =
            make_double2(static_cast<double>(v[q].x),
                         static_cast<double>(v[q].y));
      }
    }
  }
}

// The block's shape and shared memory, as maps_tiles reads them.
struct TileArgs {
  const int16_t* x;            // the block's frame
  const void* base;            // the cube (floats) or the int16 interleave
  const void* top_idx;         // the block's first detection's index
  const float* a_re;
  const float* a_im;
  const float2* f_dop;
  int* r_bins;                 // (kDets) range and Doppler bins
  int* d_bins;
  double* tab;                 // staged table
  double* sums;                // (U, kDets, 2) snapshot sums
  double* rx_sums;             // (V, kDets, 2) the rows' sums per RX
  float2* dop;                 // (kDets, Kc) Doppler rows
  double* red;                 // (2, kWarps, kSlot) the passes' tile sums
  int* red_u;                  // (2, kWarps) their columns u, -1 for none
  int idx64, n_dets, n_chirps, n_rx, n_tx, s2, r_size, d_size, clutter;
};

// The detections' range and Doppler bins (torch's floor division and
// modulo: a negative index reads from the ends of the tables), then their
// Doppler rows and, where 2S fits one segment, the table, staged.
__device__ __forceinline__ void stage_block(const TileArgs& a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kc_size = a.n_chirps / a.n_tx;
  if (threadIdx.x < kDets) {
    int r = 0, d = 0;
    if (threadIdx.x < a.n_dets) {
      const long long idx =
          a.idx64 ? static_cast<const long long*>(a.top_idx)[threadIdx.x]
                  : static_cast<const int*>(a.top_idx)[threadIdx.x];
      if (idx == static_cast<int>(idx)) {     // 32-bit division
        const int i32 = static_cast<int>(idx);
        r = i32 % a.r_size;
        d = (i32 - r) / a.r_size;
        if (r < 0) {
          r += a.r_size;
          d -= 1;
        }
        d %= a.d_size;
      } else {
        long long rr = idx % a.r_size, dd = (idx - rr) / a.r_size;
        if (rr < 0) {
          rr += a.r_size;
          dd -= 1;
        }
        r = static_cast<int>(rr);
        d = static_cast<int>(dd % a.d_size);
      }
      if (d < 0) d += a.d_size;
    }
    a.r_bins[threadIdx.x] = r;
    a.d_bins[threadIdx.x] = d;
  }
  __syncthreads();
  for (int j = warp; j < kDets; j += kWarps) {
    // detection j's Doppler row, four loads in flight a lane
    const float2* f = a.f_dop + static_cast<size_t>(a.d_bins[j]) * kc_size;
    for (int kc0 = 0; kc0 < kc_size; kc0 += 4 * 32) {
      float2 vals[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kc = kc0 + 32 * q + lane;
        vals[q] = j < a.n_dets && kc < kc_size ? __ldg(f + kc)
                                               : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kc = kc0 + 32 * q + lane;
        if (kc < kc_size) a.dop[j * kc_size + kc] = vals[q];
      }
    }
  }
  // a table wider than one segment is staged a segment at a time in
  // maps_tiles
  const int n_chunks = (a.s2 + kChunk - 1) / kChunk;
  if (n_chunks <= kSegChunks) {
    stage_table_pairs(a.tab, a.a_re, a.a_im, a.r_bins, a.n_dets, 0,
                      n_chunks, a.s2);
  }
  __syncthreads();
}

// Where the thread's rows of tile `tile` lie: kc = kcg + 8 j (j = 2 mt +
// half), at row0 + j * row_step in the frame (and the int16 base) and at
// brow0 + j * brow_step in the base cube; kcg = Kc (rows read as zeros)
// for a tile past the last.
struct TileRows {
  int kcg, row0, brow0;
};

__device__ __forceinline__ TileRows tile_rows(const TileArgs& a, int tile,
                                              int n_tiles, int n_kcb,
                                              int g) {
  const int n_u = a.n_tx * a.n_rx, kc_size = a.n_chirps / a.n_tx;
  const int u = tile < n_tiles ? tile / n_kcb : 0;
  const int kcg = tile < n_tiles ? (tile % n_kcb) * kTileRows + g : kc_size;
  return {kcg, (kcg * n_u + u) * a.s2,
          ((u % a.n_rx) * a.n_chirps + kcg * a.n_tx + u / a.n_rx) * a.s2};
}

// Load chunk c of the thread's rows of a tile into q.
template <int kMode>
__device__ __forceinline__ void load_chunk(RowQuad (&q)[kMTiles][2][2],
                                           const TileArgs& a,
                                           const TileRows& r, int c, int t) {
  const int kc_size = a.n_chirps / a.n_tx;
  const int row_step = 8 * a.n_tx * a.n_rx * a.s2;
  const int sample = c * kChunk + 8 * t;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * mt + half;
      load_tile_rows<kMode>(q[mt][half], a.x, a.base, r.row0 + j * row_step,
                            sample, r.kcg + 8 * j < kc_size && sample < a.s2);
    }
  }
}

// The 16 values v summed over the 8 lanes that share t (lane bits 2-4) by
// halving: lane 4g + t ends with v[8 b4 + 4 b3 + 2 b2 + i] summed in
// out[i], i = 0, 1 (b4 b3 b2 the bits of g); 14 exchanges where a full
// sum of each value takes 48.
__device__ __forceinline__ void scatter_sum(double (&v)[16], int lane,
                                            double (&out)[2]) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  double h[8], q[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // keep v[8 b4 + i], send the other half
    const double send = b4 ? v[i] : v[i + 8];
    const double keep = b4 ? v[i + 8] : v[i];
    h[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // keep h[4 b3 + i]
    const double send = b3 ? h[i] : h[i + 4];
    const double keep = b3 ? h[i + 4] : h[i];
    q[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // keep q[2 b2 + i]
    const double send = b2 ? q[i] : q[i + 2];
    const double keep = b2 ? q[i + 2] : q[i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

// Every tile (u, kcb) of the block, kWarps at a time: the tile's range
// sums on the tensor cores, weighed by F', summed over the warp, then
// into a.sums and a.rx_sums in the order of the tiles.  A warp's loads
// run one chunk ahead through its tiles, from before the block's staging
// on, so the next tile's first chunk arrives during this tile's sums; a
// pass's tile sums alternate between two buffers, so one barrier a pass
// orders them.
template <int kMode>
__device__ __forceinline__ void maps_tiles(const TileArgs& a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_u = a.n_tx * a.n_rx, kc_size = a.n_chirps / a.n_tx;
  const int n_kcb = (kc_size + kTileRows - 1) / kTileRows;
  const int n_tiles = n_u * n_kcb;
  const int n_chunks = (a.s2 + kChunk - 1) / kChunk;
  const int n_seg = (n_chunks + kSegChunks - 1) / kSegChunks;
  const int brow_step = 8 * a.n_tx * a.s2;
  RowQuad nxt[kMTiles][2][2];
  TileRows rows = tile_rows(a, warp, n_tiles, n_kcb, g);
  if (warp < n_tiles) load_chunk<kMode>(nxt, a, rows, 0, t);
  stage_block(a);
  for (int tile0 = 0; tile0 < n_tiles; tile0 += kWarps) {
    double* red = a.red + ((tile0 / kWarps) & 1) * kWarps * kSlot;
    int* red_u = a.red_u + ((tile0 / kWarps) & 1) * kWarps;
    const int tile = tile0 + warp;
    const bool live = tile < n_tiles;     // the same for the whole warp
    const int u = live ? tile / n_kcb : 0;
    const int kc0 = (tile % n_kcb) * kTileRows;
    const TileRows next = tile_rows(a, tile + kWarps, n_tiles, n_kcb, g);
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
        stage_table_pairs(a.tab, a.a_re, a.a_im, a.r_bins, a.n_dets,
                          c_begin, c_end - c_begin, a.s2);
        __syncthreads();
      }
      if (!live) continue;
      for (int c = c_begin; c < c_end; ++c) {
        RowQuad cur[kMTiles][2][2];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            cur[mt][half][0] = nxt[mt][half][0];
            cur[mt][half][1] = nxt[mt][half][1];
          }
        }
        if (c + 1 < n_chunks) {
          load_chunk<kMode>(nxt, a, rows, c + 1, t);
        } else if (tile + kWarps < n_tiles) {
          load_chunk<kMode>(nxt, a, next, 0, t);
        }
        const int i = c - c_begin;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          double b[kNTiles][4];
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            const double2 lo = *reinterpret_cast<const double2*>(
                a.tab + tab_index(i, s, nt, 0, lane, 0));
            const double2 hi = *reinterpret_cast<const double2*>(
                a.tab + tab_index(i, s, nt, 1, lane, 0));
            b[nt][0] = lo.x;
            b[nt][1] = lo.y;
            b[nt][2] = hi.x;
            b[nt][3] = hi.y;
          }
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
            // kCubeBase: the base of samples 8t + 4s .. + 3 of the rows
            const int sample = c * kChunk + 8 * t + 4 * s;
            const float* cube = static_cast<const float*>(a.base) +
                                rows.brow0 + sample;
            const int j0 = 2 * mt, j1 = 2 * mt + 1;
            double d0[4], d1[4];
            row_f64<kMode>(cur[mt][0][s], d0, cube + j0 * brow_step,
                           rows.kcg + 8 * j0 < kc_size && sample < a.s2);
            row_f64<kMode>(cur[mt][1][s], d1, cube + j1 * brow_step,
                           rows.kcg + 8 * j1 < kc_size && sample < a.s2);
            const double av[8] = {d0[0], d1[0], d0[1], d1[1],
                                  d0[2], d1[2], d0[3], d1[3]};
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt) {
              mma_f64(acc[mt][nt], av, b[nt]);
            }
          }
        }
      }
    }
    rows = next;
    if (live) {
      // acc[mt][nt][e]: row kc0 + 16 mt + g + 8 (e / 2), column nt * 8 +
      // 2t + e % 2 (re of detection col for col < 16, im of col - 16).
      // v[4 (2 nt + e2) + q] for the thread's detection nt * 8 + 2t + e2:
      // q 0, 1 the Doppler-weighted sum (re, im) of its rows, 2, 3 the
      // plain sum (re, im)
      double v[16];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float2* f = a.dop + (nt * 8 + 2 * t + e2) * kc_size;
          double sr = 0.0, si = 0.0, gr_sum = 0.0, gi_sum = 0.0;
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int kc = kc0 + 16 * mt + 8 * hh + g;
              if (kc < kc_size) {
                const double gr = acc[mt][nt][2 * hh + e2];
                const double gi = acc[mt][nt + 2][2 * hh + e2];
                const double2 w = folded_tap(f, kc, kc_size, a.clutter);
                sr = fma(w.x, gr, fma(-w.y, gi, sr));
                si = fma(w.x, gi, fma(w.y, gr, si));
                gr_sum += gr;
                gi_sum += gi;
              }
            }
          }
          v[4 * (2 * nt + e2)] = sr;
          v[4 * (2 * nt + e2) + 1] = si;
          v[4 * (2 * nt + e2) + 2] = gr_sum;
          v[4 * (2 * nt + e2) + 3] = gi_sum;
        }
      }
      // lane 4g + t ends with v-index 8 b4 + 4 b3 + 2 b2 + i (the bits of
      // g), i = 0, 1: detection slot (2 nt + e2) = 2 b4 + b3, q = 2 b2 + i
      double out[2];
      scatter_sum(v, lane, out);
      const int slot = 2 * ((lane >> 4) & 1) + ((lane >> 3) & 1);
      const int det = (slot >> 1) * 8 + 2 * t + (slot & 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        red[warp * kSlot + det * 4 + 2 * ((lane >> 2) & 1) + i] = out[i];
      }
    }
    if (lane == 0) red_u[warp] = live ? u : -1;
    __syncthreads();
    // the tiles' sums into the block's, warp by warp in order: thread i
    // owns (detection i / 4, quantity i % 4); a pass's tiles run in order
    // of u, so a running sum is stored once a column
    if (threadIdx.x < kSlot) {
      const int det = threadIdx.x / 4, q = threadIdx.x % 4;
      double run = 0.0;
      int run_u = red_u[0];
      for (int w = 0; w <= kWarps; ++w) {
        const int uw = w < kWarps ? red_u[w] : -1;
        if (uw != run_u) {
          if (run_u >= 0) {
            double* dst = q < 2
                ? a.sums + (run_u * kDets + det) * 2 + q
                : a.rx_sums + ((run_u % a.n_rx) * kDets + det) * 2 + q - 2;
            *dst += run;
          }
          run = 0.0;
          run_u = uw;
        }
        if (uw >= 0) run += red[w * kSlot + threadIdx.x];
      }
    }
  }
  __syncthreads();
}

// Block (frame, group of kDets detections).  Dynamic shared memory: the
// staged table, the snapshot sums (U x kDets x 2) and, for 'mean', the
// rows' sums per RX (V x kDets x 2), in float64; then the detections'
// Doppler rows (kDets x Kc complex64).  With a base (kBase), *whole picks
// the int16 interleave base16 (1) or the float32 cube base (0).
template <int kBase>
__global__ void __launch_bounds__(kThreads, 1) maps_snapshots_kernel(
    const int16_t* __restrict__ raw, long long frame_stride,
    const float* __restrict__ base, const int16_t* __restrict__ base16,
    const int* __restrict__ whole, const void* __restrict__ top_idx,
    int idx64, const float* __restrict__ a_re,
    const float* __restrict__ a_im, const float2* __restrict__ f_dop,
    float2* __restrict__ out, int k, int n_chirps, int n_rx, int n_tx,
    int s2, int r_size, int d_size, int clutter) {
  extern __shared__ double dyn[];
  __shared__ double red[2 * kWarps * kSlot];
  __shared__ int red_u[2 * kWarps];
  __shared__ double sf[kDets * 2];
  __shared__ int r_bins[kDets], d_bins[kDets];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long frame = blockIdx.x;
  const int det0 = blockIdx.y * kDets;
  const int n_dets = min(kDets, k - det0);
  const int n_u = n_tx * n_rx, kc_size = n_chirps / n_tx;
  const int n_chunks = (s2 + kChunk - 1) / kChunk;
  double* tab = dyn;
  double* sums = dyn + static_cast<size_t>(min(n_chunks, kSegChunks)) *
                           kChunkDoubles;
  double* rx_sums = sums + n_u * kDets * 2;
  float2* dop = reinterpret_cast<float2*>(rx_sums + n_rx * kDets * 2);
  for (int i = threadIdx.x; i < (n_u + n_rx) * kDets * 2; i += kThreads) {
    sums[i] = 0.0;
  }
  TileArgs args{raw + frame * frame_stride,
                nullptr,
                idx64 ? static_cast<const void*>(
                            static_cast<const long long*>(top_idx) +
                            frame * k + det0)
                      : static_cast<const void*>(
                            static_cast<const int*>(top_idx) + frame * k +
                            det0),
                a_re, a_im, f_dop, r_bins, d_bins, tab, sums, rx_sums, dop,
                red, red_u, idx64, n_dets, n_chirps, n_rx, n_tx, s2, r_size, d_size,
                clutter};
  if constexpr (!kBase) {
    maps_tiles<kNoBase>(args);
  } else if (*whole) {
    args.base = base16;
    maps_tiles<kIntBase>(args);
  } else {
    args.base = base;
    maps_tiles<kCubeBase>(args);
  }

  if (clutter == 1) {
    // sum_kc F[d, kc] of each detection: warp w takes w, w + kWarps
    for (int j = warp; j < kDets; j += kWarps) {
      double re = 0.0, im = 0.0;
      if (j < n_dets) {
        for (int kc = lane; kc < kc_size; kc += 32) {
          const float2 f = dop[j * kc_size + kc];
          re += f.x;
          im += f.y;
        }
      }
      re = warp_sum(re, 1);
      im = warp_sum(im, 1);
      if (lane == 0) {
        sf[2 * j] = re;
        sf[2 * j + 1] = im;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n_dets * n_u; i += kThreads) {
    const int det = i / n_u, u = i % n_u;
    double re = sums[(u * kDets + det) * 2];
    double im = sums[(u * kDets + det) * 2 + 1];
    if (clutter == 1) {
      const double* rs = rx_sums + ((u % n_rx) * kDets + det) * 2;
      const double mr = rs[0] / n_chirps, mi = rs[1] / n_chirps;
      re -= mr * sf[2 * det] - mi * sf[2 * det + 1];
      im -= mr * sf[2 * det + 1] + mi * sf[2 * det];
    }
    out[(frame * k + det0 + det) * n_u + u] =
        make_float2(__double2float_rn(re), __double2float_rn(im));
  }
}

// Dynamic shared memory of maps_snapshots_kernel, in bytes.
size_t maps_smem(int n_chirps, int n_rx, int n_tx, int s2) {
  const int n_chunks = (s2 + kChunk - 1) / kChunk;
  return (static_cast<size_t>(min(n_chunks, kSegChunks)) * kChunkDoubles +
          static_cast<size_t>(n_tx * n_rx + n_rx) * kDets * 2) *
             sizeof(double) +
         static_cast<size_t>(kDets) * (n_chirps / n_tx) * sizeof(float2);
}

constexpr size_t kMapsStaticSmem =
    (2 * kWarps * kSlot + kDets * 2) * sizeof(double) +
    (2 * kDets + 2 * kWarps) * sizeof(int);

template <int kBase>
cudaError_t launch_maps(const int16_t* raw, long long frame_stride,
                        const float* base, const int16_t* base16,
                        const int* whole, const void* top_idx, int idx64,
                        const float* a_re, const float* a_im,
                        const float* f_dop, float* out, int n_frames, int k,
                        int n_chirps, int n_rx, int n_tx, int s2, int r_size,
                        int d_size, int clutter, cudaStream_t stream) {
  const size_t smem = maps_smem(n_chirps, n_rx, n_tx, s2);
  if (smem + kMapsStaticSmem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err = cudaFuncSetAttribute(
        maps_snapshots_kernel<kBase>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_frames, (k + kDets - 1) / kDets);
  maps_snapshots_kernel<kBase><<<grid, kThreads, smem, stream>>>(
      raw, frame_stride, base, base16, whole, top_idx, idx64, a_re, a_im,
      reinterpret_cast<const float2*>(f_dop), reinterpret_cast<float2*>(out),
      k, n_chirps, n_rx, n_tx, s2, r_size, d_size, clutter);
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

// The maps path's snapshots on ``stream``: frame b of raw int16 at raw + b
// * frame_stride (in samples, a multiple of 8), its n_chirps x n_rx rows
// of s2 interleaved samples contiguous; with a base, base the complex64
// base cube (n_rx, n_chirps, s2 / 2) as floats, base16 its raw interleave
// (n_chirps, n_rx, s2) rounded to int16 and whole a device int, 1 where
// base16 holds the base exactly (then it is read) and 0 where not (then
// the cube is); all three null without one; top_idx (n_frames, k) flat D*R
// cell indices, int64 where idx64 is 1 and int32 where it is 0; the range
// tables a_re, a_im f32 (r_size, s2); the Doppler table f_dop complex64
// (d_size, n_chirps / n_tx) as float pairs; clutter 0 (none, or base with
// a base), 1 (mean), 2 (mti2), 3 (mti3) -> out complex64 (n_frames, k,
// n_tx * n_rx) as float pairs.  s2 is a multiple of 8; raw, base, base16,
// a_re and a_im start on 16-byte boundaries.
int radar_maps_snapshots(const int16_t* raw, long long frame_stride,
                         const float* base, const int16_t* base16,
                         const int* whole, const void* top_idx, int idx64,
                         const float* a_re, const float* a_im,
                         const float* f_dop, float* out, int n_frames, int k,
                         int n_chirps, int n_rx, int n_tx, int s2,
                         int r_size, int d_size, int clutter,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0 || k <= 0) return cudaSuccess;
  if (n_rx < 1 || n_tx < 1 || n_chirps < n_tx || n_chirps % n_tx ||
      s2 < 8 || s2 % 8 || frame_stride % 8 || r_size < 1 || d_size < 1 ||
      clutter < 0 || clutter > 3 || (k + kDets - 1) / kDets > 65535 ||
      (base == nullptr) != (base16 == nullptr) ||
      (base == nullptr) != (whole == nullptr) ||
      maps_smem(n_chirps, n_rx, n_tx, s2) + kMapsStaticSmem > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
  if (base != nullptr) {
    return launch_maps<1>(raw, frame_stride, base, base16, whole, top_idx,
                          idx64, a_re, a_im, f_dop, out, n_frames, k,
                          n_chirps, n_rx, n_tx, s2, r_size, d_size, clutter,
                          stream);
  }
  return launch_maps<0>(raw, frame_stride, base, base16, whole, top_idx,
                        idx64, a_re, a_im, f_dop, out, n_frames, k, n_chirps,
                        n_rx, n_tx, s2, r_size, d_size, clutter, stream);
}

}  // extern "C"
