// OS-CFAR kernels for Hopper (sm_90a): power maps (B, D, R) -> the OS
// threshold map (radar_os_threshold) or the OS hit map without a
// threshold (radar_os_hits).
//
// radar_os_threshold replaces the TPU kernel
// radar_tpu/ops/pallas/oscfar_kernel.py _os_kernel (entry
// os_cfar_2d_pallas): threshold = f32(alpha) * (k-th smallest cell of
// the training ring), bit-identical to sorting the ring.
// radar_os_hits replaces both TPU hit bodies, _os_hits_box_kernel (the
// stride-1 box count) and _os_hits_kernel (the per-offset count; entry
// os_cfar_hits_pallas): a cell is a hit when
//   count over the ring of (RN(alpha * v) < p) >= k,
// which is exactly p > RN(alpha * T_k) (RN is monotone, so the k-th
// smallest scaled cell is RN(alpha * T_k); a power equal to it counts
// fewer than k strict inequalities).  alpha * v is one f32 multiply
// (__fmul_rn, never contracted into an FMA) and the compare is strict.
//
// The block: one per tile of Doppler rows of one map (layout.h
// os_tile_rows: 16, or fewer where the tile would not fit).  It gathers
// its rows with the +-wd Doppler halo (wrapped) and the +-wr range halo
// (reflected or wrapped) into shared memory through the index maps of
// cfar_common.cuh, so every window reads what JAX's pad-then-slice reads,
// windows wider than an axis included; the hits kernel stores the tile
// already multiplied by alpha.  Rows are padded (os_pitch) so that the
// 16-byte loads below stay inside them.
//
// The ring as row runs, each loaded value serving several cells: a
// thread owns kOsCells = 4 consecutive range cells of one Doppler row.
// At stride 1 the ring is, in each of the 2 wd + 1 rows of the window,
// one run of 2 wr + 1 columns, or two runs either side of the guard box.
// For the default window (guard (2, 2), train (4, 8)), fixed at compile
// time (BoxRing), a thread reads the 2 wr + 4 = 24 tile values of its
// four cells' windows in a ring row once, in six 16-byte loads, and
// compares each value with every one of its cells whose run covers it:
// no offset is loaded, and shared loads fall from 2 per (cell, ring
// cell) to 0.08.  Any other window or a decimated ring (ListRing) walks
// the host's list of ring offsets (ops.cfar.os_ring_params order) held in
// shared memory, each offset loaded once for the four cells; there a
// thread's four cells lie a quarter of the row apart, so that the lanes
// of a warp read consecutive columns (four consecutive cells a thread
// would meet 4-way bank conflicts).  A count is
// an integer, so the order of the ring cells does not matter.  A count
// is kept in f32 (exact to 2^24) and each (cell, ring cell) is one FSET
// (1.0 or 0.0) and one FADD.
//
// Kernel 6 (os_hits_kernel) counts once.  Kernel 5 (os_threshold_kernel)
// finds the k-th smallest ring value T of each cell by a search that
// ends on a ring value.  For non-negative f32 the order of values is the
// order of their bit patterns, and each cell keeps a bracket [lo, hi] of
// bit patterns that holds T, with n_lo ring values below lo and n_hi at
// or below hi (n_lo < k <= n_hi):
//   1. one pass takes the ring's min and max: lo = min, hi = max, n_lo =
//      0, n_hi = N;
//   2. while the cell is open (lo != hi, n_hi != k, n_lo != k - 1), one
//      counting pass against a pivot t in bit space, interpolated from
//      the counts toward rank k (t = lo + w (k - n_lo - 1/2) / (n_hi -
//      n_lo), w = hi - lo) and clamped to [lo + w/4, hi - 1 - w/4]:
//      count(v <= t) = c >= k gives hi = t, n_hi = c, else lo = t + 1,
//      n_lo = c.  A pass whose c equals the old count of the side it
//      moves passed no ring value; after kStall = 3 such passes of an
//      open cell, the thread's next pass also keeps, per cell, the
//      largest ring value <= t and the smallest > t, and snaps the bound
//      it moves onto that ring value (hi = that largest, or lo = that
//      smallest), so plateaus of ties and +inf close in a pass or two.
//      A snapping pass costs about three counting passes, so it is not
//      taken every time, and on the scene maps almost never.  Either
//      pass shrinks w to at most 3w/4 - 1, so a cell closes after
//      at most 72 passes (from w = 0x7F800000, +0.0 to +inf); on the
//      scene maps the slowest cell of a warp takes about 11;
//   3. one pass moves the bracket onto a ring value: T = lo where lo ==
//      hi, else the largest ring value <= hi where n_hi == k, else the
//      smallest >= lo (n_lo == k - 1).
// T is a ring value, so the threshold RN(alpha * T) is the sort's, bit
// for bit, +inf, +0.0 and subnormals included.  Power is a sum of
// squares, so the maps hold no -0.0 and no NaN; a -0.0 would come out
// as +0.0 or -0.0 (equal value), and a NaN cell could not hang the
// search (w falls every pass).
//
// What bounds them on an H100: one compare and one add per (cell, ring
// cell) is the least any exact selection does: 248 ring cells x 8.4 M
// cells at B = 512 = 4.2 G operations, 0.062 ms at 67 TFLOP/s, against
// 34 MB in and 34 MB (threshold) or 8 MB (hits) out, ~0.02 ms at
// 3.35 TB/s.  So operations bound them.  Kernel 6 issues about 2
// instructions per (cell, ring cell), FSET on the half-rate ALU pipe and
// FADD on the FMA pipe; kernel 5 runs that count once a pass, plus its
// min / max and snapping passes, so the passes of the slowest cell of a
// warp set its time.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "layout.h"

namespace {

using radar_layout::kOsCells;

constexpr int kThreads = 256;
constexpr int kC = kOsCells;
constexpr int kStall = 3;   // count passes in a row that move a cell's
                            // bound past no ring value before a snap

// 1.0f where a < b (lt1) or a <= b (le1), else 0.0f: one FSET, so that
// a count is one FSET and one FADD per (cell, ring cell).
__device__ __forceinline__ float lt1(float a, float b) {
  float r;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float le1(float a, float b) {
  float r;
  asm("set.le.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Gathers rows d0 - wd .. d0 + n_rows - 1 - wd (Doppler wrapped) and
// columns -wr .. R - 1 + wr (range reflected or wrapped) of the map pf
// into s, row pitch ``pitch`` (zeros past column R - 1 + wr), each value
// times alpha when ``scale``.
__device__ __forceinline__ void load_tile(const float* __restrict__ pf,
                                          float* s, int d0, int n_rows,
                                          int d_size, int r_size, int wd,
                                          int wr, int pitch, int range_wrap,
                                          bool scale, float alpha) {
  const int w = r_size + 2 * wr;
  for (int i = threadIdx.x; i < n_rows * pitch; i += kThreads) {
    const int h = i / pitch, c = i % pitch;
    float v = 0.f;
    if (c < w) {
      const int d = radar_cfar::wrap_index(d0 - wd + h, d_size);
      const int r = radar_cfar::range_index(c - wr, r_size, range_wrap);
      v = pf[d * r_size + r];
      if (scale) v = __fmul_rn(alpha, v);
    }
    s[i] = v;
  }
}

// The stride-1 ring of the window (GD, WD, GR, WR), fixed at compile
// time, of the kC cells whose windows' top-left corner is ``s`` (cells
// r0 .. r0 + kC - 1 of one tile row).  for_each(f) calls f(j, v) for
// every (cell j, ring value v): ring row dd reads the kLen values from
// column r0 once, and value q counts for cell j where |q - WR - j| <= WR,
// outside the guard columns |q - WR - j| <= GR on the guard rows.
template <int GD, int WD, int GR, int WR>
struct BoxRing {
  static constexpr int kLen = (2 * WR + kC + 3) / 4 * 4;
  const float* s;
  int pitch;

  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
#pragma unroll 1
    for (int dd = 0; dd <= 2 * WD; ++dd) {
      float v[kLen];
#pragma unroll
      for (int q = 0; q < kLen; q += 4)
        radar_cfar::load4(v + q, s + dd * pitch + q);
      if (dd >= WD - GD && dd <= WD + GD)
        row<true>(v, f);
      else
        row<false>(v, f);
    }
  }

  template <bool kGuard, typename F>
  __device__ __forceinline__ static void row(const float* v, F& f) {
#pragma unroll
    for (int o = -WR; o <= WR; ++o)
#pragma unroll
      for (int j = 0; j < kC; ++j)
        if (!kGuard || o < -GR || o > GR) f(j, v[WR + j + o]);
  }
};

// Any other ring: the n_off offsets ``offs`` (row * pitch + column from a
// window's top-left corner) in shared memory, each loaded once for the
// kC cells; cell j's window starts ``col[j]`` floats after ``s`` (cells
// past the map's last column repeat that column's cell).
struct ListRing {
  const float* s;
  const int* offs;
  int n_off;
  int col[kC];

  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
    for (int i = 0; i < n_off; ++i) {
      const float* w = s + offs[i];
#pragma unroll
      for (int j = 0; j < kC; ++j) f(j, w[col[j]]);
    }
  }
};

struct Tile {
  long long first;   // flat index of the block's first cell
  int rows;          // map rows of the block
  int pitch;         // floats a tile row
  const float* s;    // the gathered rows, in shared memory
  const int* offs;   // the ring offsets (list form), in shared memory
};

// The block's tile: map and rows from blockIdx.x; the rows with their
// halo gathered into shared memory, then the offset list, if any.
__device__ __forceinline__ Tile stage(const float* __restrict__ power,
                                      const int* __restrict__ offsets,
                                      int n_off, int d_size, int r_size,
                                      int tile_rows, int range_wrap, int wd,
                                      int wr, bool scale, float alpha) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (d_size + tile_rows - 1) / tile_rows;
  const long long b = blockIdx.x / n_tiles;
  const int d0 = (blockIdx.x % n_tiles) * tile_rows;
  const int nb = min(tile_rows, d_size - d0);
  const int pitch = radar_layout::os_pitch(r_size, wr);
  int* offs = reinterpret_cast<int*>(smem + (nb + 2 * wd) * pitch);
  if (offsets != nullptr)
    for (int j = threadIdx.x; j < n_off; j += kThreads) offs[j] = offsets[j];
  load_tile(power + b * d_size * r_size, smem, d0, nb + 2 * wd, d_size,
            r_size, wd, wr, pitch, range_wrap, scale, alpha);
  __syncthreads();
  return Tile{(b * d_size + d0) * r_size, nb, pitch, smem, offs};
}

// Calls body(l, r0, step, ring) for every group of kC cells of the
// block: tile row l, cells r0 + j step (j < kC; some past R where kC
// does not divide R), with their ring in the form (GD, WD, GR, WR)
// selects.  BoxRing groups are kC consecutive cells (step 1), whose
// windows share their loads.  ListRing groups are strided (step = the
// groups of a row), so that for each offset and cell j the lanes of a
// warp read consecutive columns: no bank conflict.
template <int GD, int WD, int GR, int WR, typename Body>
__device__ __forceinline__ void for_each_group(const Tile& t, int r_size,
                                               int n_off, Body body) {
  const int n_groups = (r_size + kC - 1) / kC;
  for (int g = threadIdx.x; g < t.rows * n_groups; g += kThreads) {
    const int l = g / n_groups, i = g % n_groups;
    const float* s = t.s + l * t.pitch;
    if constexpr (WD >= 0) {
      body(l, i * kC, 1, BoxRing<GD, WD, GR, WR>{s + i * kC, t.pitch});
    } else {
      ListRing ring{s, t.offs, n_off, {}};
#pragma unroll
      for (int j = 0; j < kC; ++j)
        ring.col[j] = min(i + j * n_groups, r_size - 1);
      body(l, i, n_groups, ring);
    }
  }
}

template <int GD, int WD, int GR, int WR>
__global__ void __launch_bounds__(kThreads) os_hits_kernel(
    const float* __restrict__ power, uint8_t* __restrict__ hits,
    const int* __restrict__ offsets, int n_off, int d_size, int r_size,
    int tile_rows, int range_wrap, int wd, int wr, int k, float alpha) {
  const Tile t = stage(power, offsets, n_off, d_size, r_size, tile_rows,
                       range_wrap, wd, wr, true, alpha);
  const float kf = (float)k;
  for_each_group<GD, WD, GR, WR>(t, r_size, n_off, [&](int l, int r0,
                                                       int step,
                                                       const auto& ring) {
    const long long row = t.first + (long long)l * r_size;
    float p[kC], cnt[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      p[j] = power[row + min(r0 + j * step, r_size - 1)];
      cnt[j] = 0.f;
    }
    ring.for_each([&](int j, float v) { cnt[j] += lt1(v, p[j]); });
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if (r0 + j * step < r_size) hits[row + r0 + j * step] = cnt[j] >= kf;
  });
}

// The next pivot of an open cell: bit space, interpolated from the counts
// toward rank k, clamped to [lo + w/4, hi - 1 - w/4].
__device__ __forceinline__ unsigned pivot(unsigned lo, unsigned hi, int n_lo,
                                          int n_hi, int k) {
  const unsigned w = hi - lo, q = w / 4;
  const float frac = ((float)(k - n_lo) - 0.5f) / (float)(n_hi - n_lo);
  const unsigned t = lo + (unsigned)__fmul_rn(frac, (float)w);
  return min(max(t, lo + q), hi - 1 - q);
}

template <int GD, int WD, int GR, int WR>
__global__ void __launch_bounds__(kThreads) os_threshold_kernel(
    const float* __restrict__ power, float* __restrict__ thresh,
    const int* __restrict__ offsets, int n_off, int d_size, int r_size,
    int tile_rows, int range_wrap, int wd, int wr, int k, float alpha) {
  const Tile t = stage(power, offsets, n_off, d_size, r_size, tile_rows,
                       range_wrap, wd, wr, false, alpha);
  for_each_group<GD, WD, GR, WR>(t, r_size, n_off, [&](int l, int r0,
                                                       int step,
                                                       const auto& ring) {
    // 1. the bracket: each cell's ring min and max
    float mn[kC], mx[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      mn[j] = CUDART_INF_F;
      mx[j] = -CUDART_INF_F;
    }
    ring.for_each([&](int j, float v) {
      mn[j] = fminf(mn[j], v);
      mx[j] = fmaxf(mx[j], v);
    });
    unsigned lo[kC], hi[kC];
    int n_lo[kC], n_hi[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      lo[j] = __float_as_uint(mn[j]);
      hi[j] = __float_as_uint(mx[j]);
      n_lo[j] = 0;
      n_hi[j] = n_off;
    }
    // 2. passes until every cell of the thread is closed: counting, or
    // snapping where a cell has stalled
    int stall[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) stall[j] = 0;
    while (true) {
      bool open[kC], any = false, snap = false;
      float piv[kC], cnt[kC], below[kC], above[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        open[j] = lo[j] != hi[j] && n_hi[j] != k && n_lo[j] != k - 1;
        piv[j] = __uint_as_float(
            open[j] ? pivot(lo[j], hi[j], n_lo[j], n_hi[j], k) : lo[j]);
        cnt[j] = 0.f;
        below[j] = -CUDART_INF_F;
        above[j] = CUDART_INF_F;
        any |= open[j];
        snap |= open[j] && stall[j] >= kStall;
      }
      if (!any) break;
      if (snap)
        ring.for_each([&](int j, float v) {
          if (v <= piv[j]) {
            cnt[j] += 1.f;
            below[j] = fmaxf(below[j], v);
          } else {
            above[j] = fminf(above[j], v);
          }
        });
      else
        ring.for_each([&](int j, float v) { cnt[j] += le1(v, piv[j]); });
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        if (!open[j]) continue;
        const int c = (int)cnt[j];
        const bool same = c == (c >= k ? n_hi[j] : n_lo[j]);
        stall[j] = same && !snap ? stall[j] + 1 : 0;
        if (c >= k) {
          hi[j] = __float_as_uint(snap ? below[j] : piv[j]);
          n_hi[j] = c;
        } else {
          lo[j] = snap ? __float_as_uint(above[j])
                       : __float_as_uint(piv[j]) + 1u;
          n_lo[j] = c;
        }
      }
    }
    // 3. onto a ring value: the largest <= hi (n_hi == k), or the
    // smallest >= lo, as the largest of -v <= -lo
    float sign[kC], bound[kC], x[kC];
    bool search = false;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const bool below = n_hi[j] == k;
      sign[j] = below ? 1.f : -1.f;
      bound[j] = below ? __uint_as_float(hi[j]) : -__uint_as_float(lo[j]);
      x[j] = -CUDART_INF_F;
      search |= lo[j] != hi[j];
    }
    if (search)
      ring.for_each([&](int j, float v) {
        const float u = sign[j] * v;
        if (u <= bound[j]) x[j] = fmaxf(x[j], u);
      });
    const long long row = t.first + (long long)l * r_size;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const float kth = lo[j] == hi[j] ? __uint_as_float(lo[j]) : sign[j] * x[j];
      const int r = r0 + j * step;
      if (r < r_size) thresh[row + r] = __fmul_rn(alpha, kth);
    }
  });
}

// Checks the arguments, then launches ``kernel`` (the BoxRing form where
// ``offsets`` is null, else the ListRing form) over n_maps maps in tiles
// of layout.h os_tile_rows Doppler rows.
template <typename Out>
using OsKernel = void (*)(const float*, Out*, const int*, int, int, int, int,
                          int, int, int, int, float);

template <typename Out>
cudaError_t launch_os(OsKernel<Out> box, OsKernel<Out> list,
                      const float* power, Out* out, const int* offsets,
                      int n_maps, int d_size, int r_size, int n_off,
                      int range_wrap, int gd, int gr, int wd, int wr, int k,
                      float alpha, cudaStream_t stream) {
  if (n_maps <= 0) return cudaSuccess;
  if (d_size < 1 || r_size < 1 || wd < 0 || wr < 0 || k < 1 || n_off < k)
    return cudaErrorInvalidValue;
  if (offsets == nullptr &&
      (!radar_layout::os_box_ring(gd, gr, wd, wr, 1) ||
       n_off != (2 * wd + 1) * (2 * wr + 1) - (2 * gd + 1) * (2 * gr + 1)))
    return cudaErrorInvalidValue;
  const int n_list = offsets == nullptr ? 0 : n_off;
  const int rows = radar_layout::os_tile_rows(d_size, r_size, wd, wr, n_list);
  if (rows < 1) return cudaErrorInvalidValue;
  const OsKernel<Out> kernel = offsets == nullptr ? box : list;
  const size_t smem = radar_layout::os_smem(rows, r_size, wd, wr, n_list);
  const cudaError_t err = radar_cfar::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long n_blocks =
      (long long)n_maps * ((d_size + rows - 1) / rows);
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      power, out, offsets, n_off, d_size, r_size, rows, range_wrap, wd, wr,
      k, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// OS hit maps on ``stream``: power (B, D, R) f32 -> hits (B, D, R) bytes
// 0 / 1.  offsets: null for the default window's undecimated ring
// (layout.h os_box_ring), else the n_off ring cells as row * os_pitch(R,
// win_r) + column from the window's top-left corner (ops.cfar.
// os_ring_params order); alpha the f32 Rohling alpha, k the rank.
int radar_os_hits(const float* power, uint8_t* hits, const int* offsets,
                  int n_maps, int d_size, int r_size, int n_off,
                  int range_wrap, int guard_d, int guard_r, int win_d,
                  int win_r, int k, float alpha, void* stream_ptr) {
  return launch_os<uint8_t>(
      os_hits_kernel<2, 6, 2, 10>, os_hits_kernel<-1, -1, -1, -1>, power,
      hits, offsets, n_maps, d_size, r_size, n_off, range_wrap, guard_d,
      guard_r, win_d, win_r, k, alpha, static_cast<cudaStream_t>(stream_ptr));
}

// OS threshold maps on ``stream``: power (B, D, R) f32 -> thresh
// (B, D, R) f32; arguments as radar_os_hits.
int radar_os_threshold(const float* power, float* thresh, const int* offsets,
                       int n_maps, int d_size, int r_size, int n_off,
                       int range_wrap, int guard_d, int guard_r, int win_d,
                       int win_r, int k, float alpha, void* stream_ptr) {
  return launch_os<float>(
      os_threshold_kernel<2, 6, 2, 10>, os_threshold_kernel<-1, -1, -1, -1>,
      power, thresh, offsets, n_maps, d_size, r_size, n_off, range_wrap,
      guard_d, guard_r, win_d, win_r, k, alpha,
      static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
