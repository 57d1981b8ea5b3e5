// CFAR strip sums of the band blocks shared by the detect stage
// (detect.cu) and the threshold kernel (cfar.cu); the OS-CFAR kernels
// (oscfar.cu) share the window index maps.
//
// Sharing them is what makes the two detection paths agree bit for bit:
// the detect stage and the maps path (power map, threshold map, top-K)
// sum every CFAR window in the same order and select with the same
// (value desc, index asc) key (select_common.cuh), so bins, power,
// valid, num_hits and the sub-bin estimates come out identical.
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
//
// A block owns one band of kBand Doppler rows of one map and holds its
// rows with the wrapped +-wd Doppler halo in shared memory (the whole
// map where the halo would reach around the axis), so no block holds a
// whole map of a size that matters.  Every cell's window offsets are
// added in the one order above; how the adds are issued differs only in
// speed: at the default window (gd, wd, gr, wr) = (2, 6, 2, 10), fixed
// at compile time, a thread sums a column of kStripRows cells from one
// register copy of the column's power and a row of 4 cells from one
// register copy of the strip row.  The strip rows carry their range halo
// (copied once through the index maps), so the cells at the range edge
// take the same path as the rest and no warp diverges on them.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

#include "layout.h"

namespace radar_cfar {

using radar_layout::band_halo;
using radar_layout::kBand;
using radar_layout::kSmemMax;
using radar_layout::range_pad;
using radar_layout::strip_floats;
using radar_layout::strip_stride;
using radar_layout::tile_rows;

constexpr float kF32Min = -3.40282346638528859811704183484516925440e+38f;

constexpr int kStripRows = 4;      // cells of a column a thread sums at once

enum Kind : int { kCA = 0, kGO = 1, kSO = 2 };

// Index maps of the CFAR windows.  Nearly every offset lands inside the
// axis or one period off it, so those cases skip the integer division.
__host__ __device__ __forceinline__ int wrap_index(int p, int n) {
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

// The strip rows y1 / y2 of a band block are padded (layout.h): each row
// carries range_pad(wr) cells of range halo on either side, copies of the
// cells that the reflect / wrap index map sends there (range_halo), so
// every cell's range window reads straight from the row, edge cells too.
// Row l's cell r is at y[l * ys + r] (ys = strip_stride; the pointer is
// at cell 0 of row 0, past the left halo).

// Doppler strips (wrap) into y1 and y2 of rows row0 .. row0 + n_rows - 1
// of ``p``, a block of ``p_rows`` rows of R cells that wraps: the whole
// (D, R) map (p_rows = D), or one band of it with its Doppler halo
// already gathered (row0 = wd, p_rows = n_rows + 2 wd).  y1 / y2 row l
// belongs to row row0 + l.  Summing per offset through the index map
// reproduces the band matrices' multiplicities when a window is wider
// than the axis; cells whose window stays inside the block skip the map.
// The caller synchronises before reading y1 / y2.
__device__ __forceinline__ void doppler_strips(const float* p, float* y1,
                                               float* y2, int p_rows,
                                               int row0, int n_rows,
                                               int r_size, int ys, int gd,
                                               int wd) {
  for (int i = threadIdx.x; i < n_rows * r_size; i += blockDim.x) {
    const int l = i / r_size, r = i % r_size, d = row0 + l;
    const bool inside = d >= wd && d + wd < p_rows;
    float s1 = 0.f, s2 = 0.f;
    for (int o = gd + 1; o <= wd; ++o) {
      s1 += p[(inside ? d - o : wrap_index(d - o, p_rows)) * r_size + r];
      s1 += p[(inside ? d + o : wrap_index(d + o, p_rows)) * r_size + r];
    }
    for (int o = -gd; o <= gd; ++o)
      s2 += p[(inside ? d + o : wrap_index(d + o, p_rows)) * r_size + r];
    y1[l * ys + r] = s1;
    y2[l * ys + r] = s2;
  }
}

// doppler_strips of the band form (row0 = WD) with the window fixed at
// compile time: a thread takes kStripRows cells of one range column,
// reads the column's kStripRows + 2 WD power values into registers once
// and sums each cell's two strips from them, offsets in the same order.
template <int GD, int WD>
__device__ __forceinline__ void doppler_strips_band(const float* p, float* y1,
                                                    float* y2, int n_rows,
                                                    int r_size, int ys) {
  constexpr int kS = kStripRows, kLen = kStripRows + 2 * WD;
  const int n_items = (n_rows + kS - 1) / kS * r_size;
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    const int l0 = it / r_size * kS, r = it % r_size;
    float v[kLen];
#pragma unroll
    for (int q = 0; q < kLen; ++q)
      v[q] = l0 + q < n_rows + 2 * WD ? p[(l0 + q) * r_size + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (l0 + j < n_rows) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int o = GD + 1; o <= WD; ++o) {
          s1 += v[WD + j - o];
          s1 += v[WD + j + o];
        }
#pragma unroll
        for (int o = -GD; o <= GD; ++o) s2 += v[WD + j + o];
        y1[(l0 + j) * ys + r] = s1;
        y2[(l0 + j) * ys + r] = s2;
      }
    }
  }
}

// Fills the range halo of the n_rows padded strip rows: column q outside
// 0 .. R - 1 takes the cell range_index(q) (reflect or wrap).  The caller
// synchronises before and after.
__device__ __forceinline__ void range_halo(float* y1, float* y2, int n_rows,
                                           int r_size, int ys, int pad,
                                           int range_wrap) {
  for (int i = threadIdx.x; i < n_rows * 2 * pad; i += blockDim.x) {
    const int l = i / (2 * pad), h = i % (2 * pad);
    const int q = h < pad ? h - pad : r_size + h - pad;
    const int src = range_index(q, r_size, range_wrap);
    y1[l * ys + q] = y1[l * ys + src];
    y2[l * ys + q] = y2[l * ys + src];
  }
}

// The CFAR threshold of a cell from its padded strip rows y1r / y2r at
// cell r: ``coef`` times the CA ring (y1 @ Sr^T + y2 @ (Sr - Gr)^T,
// offsets -wr..wr in order), or times the larger (GO) or smaller (SO) of
// the range-leading (offsets +1..+wr) and lagging (-1..-wr) half sums;
// the dr == 0 column belongs to neither half.
__device__ __forceinline__ float threshold(const float* y1r, const float* y2r,
                                           int r, int kind, int gr, int wr,
                                           float coef) {
  if (kind == kCA) {
    float ring = 0.f;
    for (int o = -wr; o <= wr; ++o) {
      ring += y1r[r + o];
      if (o < -gr || o > gr) ring += y2r[r + o];
    }
    return ring * coef;
  }
  float lead = 0.f, lag = 0.f;
  for (int o = 1; o <= wr; ++o) {
    lead += y1r[r + o];
    lag += y1r[r - o];
    if (o > gr) {
      lead += y2r[r + o];
      lag += y2r[r - o];
    }
  }
  return (kind == kGO ? fmaxf(lead, lag) : fminf(lead, lag)) * coef;
}

// Vector load from 16-byte aligned memory into registers.
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Calls emit(l, r, threshold) for every cell of the n_rows padded strip
// rows y1 / y2.  With the range window fixed at compile time (WR >= 0)
// and R a multiple of 4, a thread takes 4 adjacent cells of a row: it
// reads the strip cells of their windows (whole 16-byte chunks, halo
// included) into registers once and sums each cell's offsets from them
// in threshold's order, so the cells at the edge take the same path as
// the rest.
template <int GR, int WR, typename Emit>
__device__ __forceinline__ void band_thresholds(const float* y1,
                                                const float* y2, int n_rows,
                                                int r_size, int ys, int kind,
                                                int gr, int wr, float coef,
                                                Emit emit) {
  if constexpr (WR >= 0) {
    if (r_size % 4 == 0) {
      constexpr int kPad = (WR + 3) / 4 * 4, kLen = 4 + 2 * kPad;
      const int n_groups = r_size / 4;
      for (int it = threadIdx.x; it < n_rows * n_groups; it += blockDim.x) {
        const int l = it / n_groups, r0 = it % n_groups * 4;
        float a[kLen], c[kLen];
#pragma unroll
        for (int q = 0; q < kLen; q += 4) {
          load4(a + q, y1 + l * ys + r0 - kPad + q);
          load4(c + q, y2 + l * ys + r0 - kPad + q);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t;
          if (kind == kCA) {
            float ring = 0.f;
#pragma unroll
            for (int o = -WR; o <= WR; ++o) {
              ring += a[kPad + j + o];
              if (o < -GR || o > GR) ring += c[kPad + j + o];
            }
            t = ring * coef;
          } else {
            float lead = 0.f, lag = 0.f;
#pragma unroll
            for (int o = 1; o <= WR; ++o) {
              lead += a[kPad + j + o];
              lag += a[kPad + j - o];
              if (o > GR) {
                lead += c[kPad + j + o];
                lag += c[kPad + j - o];
              }
            }
            t = (kind == kGO ? fmaxf(lead, lag) : fminf(lead, lag)) * coef;
          }
          emit(l, r0 + j, t);
        }
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < n_rows * r_size; i += blockDim.x) {
    const int l = i / r_size, r = i % r_size;
    emit(l, r, threshold(y1 + l * ys, y2 + l * ys, r, kind, gr, wr, coef));
  }
}

// Rows of one band block's power tile: the band and its wrapped +-wd
// Doppler halo, or the whole map where the halo would reach around the
// axis (such maps are small: under kBand + 2 wd rows).
struct BandRows {
  int d0, nb;    // the band's first map row, its rows
  int first;     // map row of tile row 0, before the wrap
  int rows;      // tile rows gathered
  int row0;      // tile row of band row 0
};

__device__ __forceinline__ BandRows band_rows(int band, int d_size, int wd) {
  BandRows b;
  b.d0 = band * kBand;
  b.nb = min(kBand, d_size - b.d0);
  if (band_halo(d_size, wd)) {
    b.first = b.d0 - wd;
    b.rows = b.nb + 2 * wd;
    b.row0 = wd;
  } else {
    b.first = 0;
    b.rows = d_size;
    b.row0 = b.d0;
  }
  return b;
}

// The CFAR of one band block: gathers its tile of the map ``pf`` into
// ``p``, sums the Doppler strips of the band's rows into the padded strip
// rows at ``ys_base`` (strip_floats of them), fills their range halo and
// calls emit(l, r, threshold) for every cell of the band (band row l).
// Window (gd, wd, gr, wr) as the kernels' arguments; GD, WD, GR, WR the
// same at compile time, or -1 (generic).  All threads of the block call
// it.  It synchronises between its phases; the caller synchronises
// before reading what emit wrote.
template <int GD, int WD, int GR, int WR, typename Emit>
__device__ __forceinline__ void band_cfar(const float* __restrict__ pf,
                                          float* p, float* ys_base,
                                          const BandRows& b, int d_size,
                                          int r_size, int kind,
                                          int range_wrap, int gd, int gr,
                                          int wd, int wr, float coef,
                                          Emit emit) {
  if (r_size % 4 == 0) {   // 16-byte loads (rows stay 16-byte aligned)
    const int r4 = r_size / 4;
    for (int i = threadIdx.x; i < b.rows * r4; i += blockDim.x) {
      const int h = i / r4, c = i % r4 * 4;
      *reinterpret_cast<float4*>(p + h * r_size + c) =
          *reinterpret_cast<const float4*>(
              pf + wrap_index(b.first + h, d_size) * r_size + c);
    }
  } else {
    for (int i = threadIdx.x; i < b.rows * r_size; i += blockDim.x) {
      const int h = i / r_size, r = i % r_size;
      p[i] = pf[wrap_index(b.first + h, d_size) * r_size + r];
    }
  }
  const int pad = range_pad(wr), ys = strip_stride(r_size, wr);
  float* y1 = ys_base + pad;
  float* y2 = y1 + (d_size < kBand ? d_size : kBand) * ys;
  __syncthreads();
  bool fixed = false;
  if constexpr (WD >= 0) {
    if (band_halo(d_size, wd)) {   // row0 = wd = WD: every window inside
      doppler_strips_band<GD, WD>(p, y1, y2, b.nb, r_size, ys);
      fixed = true;
    }
  }
  if (!fixed)
    doppler_strips(p, y1, y2, b.rows, b.row0, b.nb, r_size, ys, gd, wd);
  __syncthreads();
  range_halo(y1, y2, b.nb, r_size, ys, pad, range_wrap);
  __syncthreads();
  band_thresholds<GR, WR>(y1, y2, b.nb, r_size, ys, kind, gr, wr, coef,
                          emit);
}

using radar_layout::default_window;

// Raises ``kernel``'s dynamic shared-memory limit to ``bytes`` on the
// current device once: the CUDA call would otherwise cost host time on
// every launch, and the host sets the main path's pace.  A later launch
// that needs no more than the kernel has been given skips it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  struct Grant {
    const void* fn;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static Grant grants[64];
  static int n_grants = 0;
  if (bytes <= 48 * 1024) return cudaSuccess;   // every kernel's default
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  Grant* g = nullptr;
  for (int i = 0; i < n_grants; ++i)
    if (grants[i].fn == fn && grants[i].device == device) g = &grants[i];
  if (g != nullptr && g->bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  if (g != nullptr)
    g->bytes = bytes;
  else if (n_grants < 64)
    grants[n_grants++] = Grant{fn, device, bytes};
  return cudaSuccess;
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
