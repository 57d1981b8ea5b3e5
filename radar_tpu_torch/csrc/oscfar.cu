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
// Both kernels: one block per tile of Doppler rows of one map (16 rows,
// or fewer where the halo would not fit; the wrapper chooses).
// The block gathers its rows with the +-wd Doppler halo (wrapped) and
// the +-wr range halo (reflected or wrapped) into shared memory through
// the index maps of cfar_common.cuh, so every window reads what JAX's
// pad-then-slice reads, windows wider than an axis included; the hits
// kernel stores the tile already multiplied by alpha.  One thread counts
// for a cell over the ring, from the host's list of ring offsets
// (ops.cfar.os_ring_params order, decimated by cfg.cfar_os_stride) held
// in shared memory.  A count is an integer, so the order of the offsets
// does not matter; one list serves both TPU hit bodies (the box count is
// the stride-1 ring).  A stride-1 form that loops over the window and
// skips the guard box measured the same on the card (PERF.md), so it is
// not kept.
//
// The threshold kernel finds the k-th smallest value by the TPU kernel's
// own idea: for non-negative f32 the order of the values is the order of
// their bit patterns, so the answer is the smallest bit pattern t with
// count(v <= t) >= k, found by binary search over [0, +inf] (at most 31
// steps, each one count over the ring).  Power is a sum of squares, so
// the maps hold no -0.0 and no NaN; a -0.0 would come out as +0.0 (equal
// value, other bits), and an inf ring cell is found as inf, as a sort
// finds it.
//
// What bounds them on an H100: one compare and one add per (cell, ring
// cell) is the least any exact selection does: 248 ring cells x 8.4 M
// cells at B = 512 = 4.2 G operations, 0.062 ms at 67 TFLOP/s, against
// 34 MB in and 34 MB (threshold) or 8 MB (hits) out, ~0.02 ms at
// 3.35 TB/s.  So operations bound them.  This first form issues ~3
// instructions per (cell, ring cell) from shared memory (load, compare,
// add) and the threshold kernel repeats its count ~31 times; the
// shared-memory load rate, not the bound, sets the pace.  Reusing each
// loaded value across the cells of a thread (a column of cells per
// thread, sliding windows in registers) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"

namespace {

constexpr int kThreads = 256;

// Gathers rows d0 - wd .. d0 + n_rows - 1 - wd (Doppler wrapped) and
// columns -wr .. R - 1 + wr (range reflected or wrapped) of the map pf
// into s, row pitch R + 2 wr, each value times alpha when ``scale``.
__device__ __forceinline__ void load_tile(const float* __restrict__ pf,
                                          float* s, int d0, int n_rows,
                                          int d_size, int r_size, int wd,
                                          int wr, int range_wrap, bool scale,
                                          float alpha) {
  const int w = r_size + 2 * wr;
  for (int i = threadIdx.x; i < n_rows * w; i += kThreads) {
    const int h = i / w, c = i % w;
    const int d = radar_cfar::wrap_index(d0 - wd + h, d_size);
    const int r = radar_cfar::range_index(c - wr, r_size, range_wrap);
    const float v = pf[d * r_size + r];
    s[i] = scale ? __fmul_rn(alpha, v) : v;
  }
}

struct Below {    // hits: RN(alpha * v) < p
  float p;
  __device__ __forceinline__ int operator()(float v) const { return v < p; }
};

struct AtMost {   // threshold search: v <= t
  float t;
  __device__ __forceinline__ int operator()(float v) const { return v <= t; }
};

// Number of ring cells for which pred holds, of the cell whose window's
// top-left corner is ``win``: offs[0 .. n_off) are the ring cells as
// row * (R + 2 wr) + column from that corner.
template <typename Pred>
__device__ __forceinline__ int ring_count(const float* win, const int* offs,
                                          int n_off, Pred pred) {
  int count = 0;
  for (int j = 0; j < n_off; ++j) count += pred(win[offs[j]]);
  return count;
}

struct Tile {
  long long first;   // flat index of the tile's first cell
  int cells;         // cells in the tile (rows x R)
  int w;             // row pitch of the shared tile
  const int* offs;   // the ring offsets, in shared memory
  const float* s;    // the gathered rows, in shared memory
};

// The block's tile: map and rows from blockIdx.x; the offset list and
// the rows with their halo gathered into shared memory.
__device__ __forceinline__ Tile stage(const float* __restrict__ power,
                                      const int* __restrict__ offsets,
                                      int n_off, int d_size, int r_size,
                                      int tile_rows, int range_wrap, int wd,
                                      int wr, bool scale, float alpha) {
  extern __shared__ float smem[];
  const int n_tiles = (d_size + tile_rows - 1) / tile_rows;
  const long long b = blockIdx.x / n_tiles;
  const int d0 = (blockIdx.x % n_tiles) * tile_rows;
  const int nb = min(tile_rows, d_size - d0);
  int* offs = reinterpret_cast<int*>(smem);
  float* s = smem + n_off;
  for (int j = threadIdx.x; j < n_off; j += kThreads) offs[j] = offsets[j];
  load_tile(power + b * d_size * r_size, s, d0, nb + 2 * wd, d_size, r_size,
            wd, wr, range_wrap, scale, alpha);
  __syncthreads();
  return Tile{(b * d_size + d0) * r_size, nb * r_size, r_size + 2 * wr, offs,
              s};
}

__global__ void __launch_bounds__(kThreads) os_hits_kernel(
    const float* __restrict__ power, uint8_t* __restrict__ hits,
    const int* __restrict__ offsets, int n_off, int d_size, int r_size,
    int tile_rows, int range_wrap, int wd, int wr, int k, float alpha) {
  const Tile t = stage(power, offsets, n_off, d_size, r_size, tile_rows,
                       range_wrap, wd, wr, true, alpha);
  for (int i = threadIdx.x; i < t.cells; i += kThreads) {
    const float* win = t.s + (i / r_size) * t.w + i % r_size;
    const int count =
        ring_count(win, t.offs, n_off, Below{power[t.first + i]});
    hits[t.first + i] = count >= k;
  }
}

__global__ void __launch_bounds__(kThreads) os_threshold_kernel(
    const float* __restrict__ power, float* __restrict__ thresh,
    const int* __restrict__ offsets, int n_off, int d_size, int r_size,
    int tile_rows, int range_wrap, int wd, int wr, int k, float alpha) {
  const Tile t = stage(power, offsets, n_off, d_size, r_size, tile_rows,
                       range_wrap, wd, wr, false, alpha);
  for (int i = threadIdx.x; i < t.cells; i += kThreads) {
    const float* win = t.s + (i / r_size) * t.w + i % r_size;
    // smallest bit pattern t in [0, +inf] with count(v <= t) >= k
    unsigned lo = 0u, hi = 0x7F800000u;
    while (lo < hi) {
      const unsigned mid = lo + ((hi - lo) >> 1);
      if (ring_count(win, t.offs, n_off, AtMost{__uint_as_float(mid)}) >= k)
        hi = mid;
      else
        lo = mid + 1u;
    }
    thresh[t.first + i] = __fmul_rn(alpha, __uint_as_float(lo));
  }
}

// Checks the arguments, then launches ``kernel`` over n_maps maps in
// tiles of tile_rows Doppler rows.
template <typename Kernel, typename Out>
cudaError_t launch_os(Kernel kernel, const float* power, Out* out,
                      const int* offsets, int n_maps, int d_size, int r_size,
                      int tile_rows, int n_off, int range_wrap, int wd,
                      int wr, int k, float alpha, cudaStream_t stream) {
  if (n_maps <= 0) return cudaSuccess;
  if (d_size < 1 || r_size < 1 || tile_rows < 1 || wd < 0 || wr < 0 ||
      k < 1 || n_off < k || offsets == nullptr)
    return cudaErrorInvalidValue;
  const int rows = (tile_rows < d_size ? tile_rows : d_size) + 2 * wd;
  const size_t smem =
      ((size_t)rows * (r_size + 2 * wr) + n_off) * sizeof(float);
  const cudaError_t err = radar_cfar::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long n_blocks =
      (long long)n_maps * ((d_size + tile_rows - 1) / tile_rows);
  kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      power, out, offsets, n_off, d_size, r_size, tile_rows, range_wrap, wd,
      wr, k, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// OS hit maps on ``stream``: power (B, D, R) f32 -> hits (B, D, R) bytes
// 0 / 1.  offsets: the n_off ring cells as row * (R + 2 win_r) + column
// from the window's top-left corner (ops.cfar.os_ring_params order);
// alpha the f32 Rohling alpha, k the rank.
int radar_os_hits(const float* power, uint8_t* hits, const int* offsets,
                  int n_maps, int d_size, int r_size, int tile_rows,
                  int n_off, int range_wrap, int win_d, int win_r, int k,
                  float alpha, void* stream_ptr) {
  return launch_os(os_hits_kernel, power, hits, offsets, n_maps, d_size,
                   r_size, tile_rows, n_off, range_wrap, win_d, win_r, k,
                   alpha, static_cast<cudaStream_t>(stream_ptr));
}

// OS threshold maps on ``stream``: power (B, D, R) f32 -> thresh
// (B, D, R) f32; arguments as radar_os_hits.
int radar_os_threshold(const float* power, float* thresh, const int* offsets,
                       int n_maps, int d_size, int r_size, int tile_rows,
                       int n_off, int range_wrap, int win_d, int win_r, int k,
                       float alpha, void* stream_ptr) {
  return launch_os(os_threshold_kernel, power, thresh, offsets, n_maps,
                   d_size, r_size, tile_rows, n_off, range_wrap, win_d, win_r,
                   k, alpha, static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
