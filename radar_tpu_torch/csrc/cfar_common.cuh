// CFAR strip sums and the block argmax shared by the detect kernel
// (megakernel.cu), the threshold kernel (cfar.cu) and the top-K kernel
// (topk.cu); the OS-CFAR kernels (oscfar.cu) share the window index maps.
//
// Sharing them is what makes the two detection paths agree bit for bit:
// the detect kernel and the maps path (power map, threshold map, top-K)
// sum every CFAR window in the same order and select with the same
// (value desc, index asc) key, so bins, power, valid, num_hits and the
// sub-bin estimates come out identical.
//
// The CFAR window is summed in the cancellation-free strip form of the
// JAX band-matrix kernels:
//   y1 = (Td - Gd) @ p    Doppler training strips (offsets gd+1..wd)
//   y2 = Gd @ p           Doppler guard strip     (offsets -gd..gd)
//   CA ring   = y1 @ Sr^T + y2 @ (Sr - Gr)^T
//   GO/SO lead = sum_{o=1..wr} y1[r+o] + sum_{o=gr+1..wr} y2[r+o], lag
//   mirrored (r-o); the threshold is max (GO) or min (SO) of the two.
// The cell under test and its guard box never enter a partial sum.
// Offsets go through the wrap / reflect index maps one by one, so a
// window wider than the axis counts a cell as often as the band
// matrices do.

#pragma once

#include <math_constants.h>
#include <stdint.h>

namespace radar_cfar {

constexpr float kF32Min = -3.40282346638528859811704183484516925440e+38f;

// The largest map (D*R cells) any of the three kernels takes: the detect
// and threshold kernels hold the map and its two strip maps, three f32
// maps, in 227 KB of shared memory; the detect and top-K kernels hold a
// row in registers, kMaxCells / 512 cells a thread.  The wrappers' gate
// is ops/cuda/cfar.MAX_CELLS.
constexpr int kMaxCells = 18432;

enum Kind : int { kCA = 0, kGO = 1, kSO = 2 };

// Index maps of the CFAR windows.  Nearly every offset lands inside the
// axis or one period off it, so those cases skip the integer division.
__device__ __forceinline__ int wrap_index(int p, int n) {
  if (p >= 0 && p < n) return p;
  if (p < 0 && p >= -n) return p + n;
  if (p >= n && p < 2 * n) return p - n;
  const int q = p % n;
  return q < 0 ? q + n : q;
}

// numpy 'reflect' padding: the edge is not repeated, period 2n - 2.
__device__ __forceinline__ int reflect_index(int p, int n) {
  if (p >= 0 && p < n) return p;
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  if (p < 0 && p > -n) return -p;
  if (p >= n && p <= period) return period - p;
  int q = p % period;
  if (q < 0) q += period;
  return q >= n ? period - q : q;
}

__device__ __forceinline__ int range_index(int p, int n, int range_wrap) {
  return range_wrap ? wrap_index(p, n) : reflect_index(p, n);
}

// lax.top_k order: larger value first, ties to the lower flat index.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Doppler strips (wrap) into y1 and y2 of rows row0 .. row0 + n_rows - 1
// of ``p``, a block of ``p_rows`` rows of R cells that wraps: the whole
// (D, R) map (p_rows = D), or one band of it with its Doppler halo
// already gathered (row0 = wd, p_rows = n_rows + 2 wd).  Cells strided
// by ``stride`` threads; y1 / y2 row l belongs to row row0 + l.  Summing
// per offset through the index map reproduces the band matrices'
// multiplicities when a window is wider than the axis; cells whose
// window stays inside the block skip the map.  The caller synchronises
// before reading y1 / y2.
__device__ __forceinline__ void doppler_strips(const float* p, float* y1,
                                               float* y2, int p_rows,
                                               int row0, int n_rows,
                                               int r_size, int gd, int wd,
                                               int stride) {
  const int n_cells = n_rows * r_size;
  for (int i = threadIdx.x; i < n_cells; i += stride) {
    const int d = row0 + i / r_size, r = i % r_size;
    const bool inside = d >= wd && d + wd < p_rows;
    float s1 = 0.f, s2 = 0.f;
    for (int o = gd + 1; o <= wd; ++o) {
      s1 += p[(inside ? d - o : wrap_index(d - o, p_rows)) * r_size + r];
      s1 += p[(inside ? d + o : wrap_index(d + o, p_rows)) * r_size + r];
    }
    for (int o = -gd; o <= gd; ++o)
      s2 += p[(inside ? d + o : wrap_index(d + o, p_rows)) * r_size + r];
    y1[i] = s1;
    y2[i] = s2;
  }
}

// CA training-ring sum of cell (d, r) from the strip rows of its Doppler
// bin: ring = y1 @ Sr^T + y2 @ (Sr - Gr)^T, offsets -wr..wr in order.
__device__ __forceinline__ float ca_ring(const float* y1r, const float* y2r,
                                         int r, int r_size, int range_wrap,
                                         int gr, int wr) {
  const bool inside = r >= wr && r + wr < r_size;
  float ring = 0.f;
  for (int o = -wr; o <= wr; ++o) {
    const int q = inside ? r + o : range_index(r + o, r_size, range_wrap);
    ring += y1r[q];
    if (o < -gr || o > gr) ring += y2r[q];
  }
  return ring;
}

// GO/SO: the range-leading (offsets +1..+wr) and lagging (-1..-wr) half
// sums of cell (d, r); the dr == 0 column belongs to neither half.
__device__ __forceinline__ void half_sums(const float* y1r, const float* y2r,
                                          int r, int r_size, int range_wrap,
                                          int gr, int wr, float* lead,
                                          float* lag) {
  const bool inside = r >= wr && r + wr < r_size;
  float a = 0.f, b = 0.f;
  for (int o = 1; o <= wr; ++o) {
    const int qa = inside ? r + o : range_index(r + o, r_size, range_wrap);
    const int qb = inside ? r - o : range_index(r - o, r_size, range_wrap);
    a += y1r[qa];
    b += y1r[qb];
    if (o > gr) {
      a += y2r[qa];
      b += y2r[qb];
    }
  }
  *lead = a;
  *lag = b;
}

// The CFAR threshold of cell (d, r): ``coef`` times the CA ring, or
// times the larger (GO) or smaller (SO) half sum.
__device__ __forceinline__ float threshold(const float* y1, const float* y2,
                                           int d, int r, int r_size,
                                           int kind, int range_wrap, int gr,
                                           int wr, float coef) {
  const float* y1r = y1 + d * r_size;
  const float* y2r = y2 + d * r_size;
  if (kind == kCA)
    return ca_ring(y1r, y2r, r, r_size, range_wrap, gr, wr) * coef;
  float lead, lag;
  half_sums(y1r, y2r, r, r_size, range_wrap, gr, wr, &lead, &lag);
  return (kind == kGO ? fmaxf(lead, lag) : fminf(lead, lag)) * coef;
}

// Block argmax on (value desc, index asc) of each thread's candidate
// (bv, bi).  Warp shuffles, then warp 0 over the warps' winners
// (``red_v`` / ``red_i``: one slot per warp); lane 0 of warp 0 writes
// the winner to ``*win_v`` / ``*win_i``, which every thread may read
// after the call returns.  All threads of the block must call it.
__device__ __forceinline__ void block_argmax(float bv, int bi, float* red_v,
                                             int* red_i, float* win_v,
                                             int* win_i) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < n_warps ? red_v[lane] : -CUDART_INF_F;
    bi = lane < n_warps ? red_i[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      *win_v = bv;
      *win_i = bi;
    }
  }
  __syncthreads();
}

}  // namespace radar_cfar

extern "C" {
// Threshold maps of ``n_maps`` (D, R) f32 power maps (cfar.cu); the maps
// entry of megakernel.cu calls it for its with-CFAR form.
int radar_cfar_threshold(const float* power, float* thresh, int n_maps,
                         int d_size, int r_size, int kind, int range_wrap,
                         int guard_d, int guard_r, int win_d, int win_r,
                         float coef, void* stream_ptr);
}
