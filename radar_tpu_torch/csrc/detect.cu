// Stage (c) of the detect entry (megakernel.cu radar_mega_detect) for
// Hopper (sm_90a): power maps and range planes -> per-frame detection
// lists.  Steps 7-11 of the TPU kernel radar_tpu/ops/pallas/megakernel.py
// _mega_detect_kernel, per frame:
//   7. the CA, GO or SO CFAR threshold in the cancellation-free strip
//      form (cfar_common.cuh, the threshold kernel's, so the two paths'
//      thresholds are bit-identical),
//   8. the hit mask with the range-edge guard, and num_hits,
//   9. top-K in lax.top_k order (select_common.cuh, kernel 3's),
//  10. five neighbour samples (range clamped, Doppler wrapped),
//  11. K x TV complex snapshots from the clutter-removed range planes.
//
// What bounds it on an H100: it reads each power map once (33.5 MB per
// 512-frame batch at the default 128 x 128 map) and, for the snapshots,
// the 32-byte sectors of the range planes that hold the K slots' cells,
// in each of a frame's C x V rows, plus the Doppler constants.  Slots
// that share a sector share its read, and CFAR hits cluster around
// targets, so that gather is far under its ceiling (268 MB per batch,
// every slot in sectors of its own); chip_smoke.py counts it from each
// run's slots.  The CFAR is ~50 adds a cell, 0.4 GFLOP.
// The design: one block of 256 threads per (frame, band of kBand Doppler
// rows), 4096 blocks at the default, each holding only its band's tile
// (the rows and their +-wd halo, 34 KB at the default), so several
// blocks share an SM.  The block runs the band's CFAR (cfar_common.cuh
// band_cfar), writes the masked power over its tile in place (non-hits
// the sentinel), selects the band's top K with its hit count
// (select_common.cuh chunk_top_k) into a workspace in device memory, and
// takes the frame's ticket; the last band block of the frame merges the
// bands' lists (merge_lists), sums the counts and writes the frame's
// outputs: the neighbours from the power map in device memory, the
// snapshots one warp per (slot, channel).  One launch, no block holds a
// whole map but where the Doppler halo would wrap around the axis (maps
// under kBand + 2 wd rows).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "layout.h"
#include "select_common.cuh"

namespace {

using radar_cfar::kF32Min;
using radar_layout::DetectLayout;
using radar_layout::kMaxK;
using radar_select::Cand;

constexpr int kThreads = 256;

template <int GD, int WD, int GR, int WR>
__global__ void __launch_bounds__(kThreads) detect_band_kernel(
    const float* __restrict__ power, const float* __restrict__ z,
    const float* __restrict__ ft_re, const float* __restrict__ ft_im,
    unsigned* __restrict__ tickets, int* __restrict__ work,
    int32_t* __restrict__ top_idx,
    float* __restrict__ top_val, float* __restrict__ nbr,
    int32_t* __restrict__ num_hits, float* __restrict__ snaps, int n_frames,
    int n_chirps, int n_rx, int n_tx, int r_size, int d_size, int kc_size,
    int k_det, int kind, int range_wrap, int gd, int gr, int wd, int wr,
    int r_valid, float coef, DetectLayout lay) {
  // shared memory as DetectLayout lays it out (layout.h), all of it
  // dynamic, so the entry's gate counts every byte
  extern __shared__ __align__(16) float smem[];
  Cand* s_band = reinterpret_cast<Cand*>(
      reinterpret_cast<char*>(smem) + lay.cand_offset);   // this band's top K
  Cand* s_top = s_band + k_det;                           // the frame's top K
  int* s_int = reinterpret_cast<int*>(s_top + k_det);
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / lay.n_bands;
  const int band = blockIdx.x % lay.n_bands;
  const radar_cfar::BandRows rows = radar_cfar::band_rows(band, d_size, wd);
  const float* pf = power + b * d_size * r_size;
  float* p = smem;
  float* strips = p + lay.tile_floats;   // then the band's candidate list
  float* pb = p + rows.row0 * r_size;    // the band's cells in the tile

  // CFAR, range-edge guard, mask: the band's cells become their power
  // where they hit, the sentinel elsewhere
  radar_cfar::band_cfar<GD, WD, GR, WR>(
      pf, p, strips, rows, d_size, r_size, kind, range_wrap, gd, gr, wd, wr,
      coef, [&](int l, int r, float t) {
        float* c = pb + l * r_size + r;
        const float pv = *c;
        *c = pv > t && r < r_valid ? pv : kF32Min;
      });
  __syncthreads();
  const int hits = radar_select::chunk_top_k(
      pb, rows.nb * r_size, rows.d0 * r_size, k_det,
      reinterpret_cast<Cand*>(strips), s_band, &s_int[0]);

  if (lay.n_bands == 1) {   // the band is the frame (m = K <= D R)
    for (int i = tid; i < k_det; i += kThreads) s_top[i] = s_band[i];
    if (tid == 0) num_hits[b] = hits;
  } else {
    int* counts = work;
    Cand* cands = reinterpret_cast<Cand*>(
        work + lay.count_words(n_frames));
    Cand* frame_lists = cands + b * lay.n_bands * lay.m_full;
    const int m = band == lay.n_bands - 1 ? lay.m_last : lay.m_full;
    for (int i = tid; i < m; i += kThreads)
      frame_lists[band * lay.m_full + i] = s_band[i];
    if (tid == 0) counts[b * lay.n_bands + band] = hits;
    if (!radar_select::last_to_arrive(&tickets[b], lay.n_bands, &s_int[1]))
      return;
    // the frame's last band block: stage the lists, merge, count
    Cand* lists = reinterpret_cast<Cand*>(smem);
    const int total = (lay.n_bands - 1) * lay.m_full + lay.m_last;
    for (int i = tid; i < total; i += kThreads)
      lists[i] = radar_select::load_cg(frame_lists + i);
    if (tid == 0) {
      int sum = 0;
      for (int j = 0; j < lay.n_bands; ++j)
        sum += __ldcg(counts + b * lay.n_bands + j);
      num_hits[b] = sum;
    }
    __syncthreads();
    radar_select::merge_lists<false>(
        lists, lay.n_bands, lay.m_full, lay.m_last, k_det,
        [&](int place, const Cand& c) { s_top[place] = c; });
  }
  __syncthreads();

  // Outputs per slot: index, value (-inf where exhausted), neighbours.
  for (int kk = tid; kk < k_det; kk += kThreads) {
    const Cand c = s_top[kk];
    const long long o = b * k_det + kk;
    top_idx[o] = c.i;
    top_val[o] = c.v == kF32Min ? -CUDART_INF_F : c.v;
    const int d = c.i / r_size, r = c.i % r_size;
    const float* row = pf + d * r_size;
    float* nb = nbr + o * 5;
    nb[0] = row[r];
    nb[1] = row[r > 0 ? r - 1 : r];
    nb[2] = row[r < r_size - 1 ? r + 1 : r];
    nb[3] = pf[radar_cfar::wrap_index(d - 1, d_size) * r_size + r];
    nb[4] = pf[radar_cfar::wrap_index(d + 1, d_size) * r_size + r];
  }

  // Snapshots: s[k, tv] = sum_kc F[d_k, kc] * z[kc*TX + tx, v, r_k], one
  // warp per (k, tv), lanes over kc, shuffle-reduced.
  const int lane = tid % 32, warp = tid / 32;
  const int tv_total = n_tx * n_rx;
  const long long row_len = 2LL * r_size;
  const float* zf = z + b * n_chirps * n_rx * row_len;
  for (int q = warp; q < k_det * tv_total; q += kThreads / 32) {
    const int kk = q / tv_total, tv = q % tv_total;
    const int t = tv / n_rx, v = tv % n_rx;
    const int idx = s_top[kk].i;
    const int d = idx / r_size, r = idx % r_size;
    float sr = 0.f, si = 0.f;
#pragma unroll 4   // the loads of four chirps in flight at once
    for (int kc = lane; kc < kc_size; kc += 32) {
      const float* zr_row =
          zf + ((long long)(kc * n_tx + t) * n_rx + v) * row_len;
      const float zr = zr_row[r], zi = zr_row[r_size + r];
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

}  // namespace

extern "C" {

// Stage (c) on ``stream``: power (B, D, R) and the clutter-removed range
// planes z (B*C*V, 2R) -> top_idx int32 (B, K), top_val (B, K), nbr
// (B, K, 5), num_hits int32 (B), snaps (B, K, TX*V, 2).  ``tickets``: B
// int32 that are zero, one a frame, which the launch leaves zero;
// ``work``: an int32 workspace of ``work_words`` words (at least what
// layout.h DetectLayout::work_words asks: the bands' counts and lists).
int radar_detect_stage(const float* power, const float* z,
                       const float* ft_re, const float* ft_im, int* tickets,
                       int* work, long long work_words, int32_t* top_idx,
                       float* top_val, float* nbr, int32_t* num_hits,
                       float* snaps, int n_frames, int n_chirps, int n_rx,
                       int n_tx, int r_size, int d_size, int k_det, int kind,
                       int range_wrap, int guard_d, int guard_r, int win_d,
                       int win_r, int r_valid, float coef, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_frames <= 0) return cudaSuccess;
  if (d_size < 1 || r_size < 1 || win_d < 0 || win_r < 0 || k_det < 1 ||
      k_det > kMaxK || (long long)k_det > (long long)d_size * r_size)
    return cudaErrorInvalidValue;
  const DetectLayout lay =
      radar_layout::detect_layout(d_size, r_size, win_d, win_r, k_det);
  if (lay.smem_bytes > radar_layout::kSmemMax || tickets == nullptr ||
      work == nullptr ||
      work_words < lay.work_words(n_frames) ||
      n_chirps % n_tx != 0 || kind < radar_cfar::kCA ||
      kind > radar_cfar::kSO)
    return cudaErrorInvalidValue;
  const long long n_blocks = (long long)n_frames * lay.n_bands;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = radar_cfar::default_window(guard_d, guard_r, win_d, win_r)
                    ? detect_band_kernel<2, 6, 2, 10>
                    : detect_band_kernel<-1, -1, -1, -1>;
  const cudaError_t err = radar_cfar::allow_smem(kernel, lay.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)n_blocks, kThreads, lay.smem_bytes, stream>>>(
      power, z, ft_re, ft_im, reinterpret_cast<unsigned*>(tickets), work,
      top_idx, top_val, nbr, num_hits, snaps,
      n_frames, n_chirps, n_rx, n_tx, r_size, d_size, n_chirps / n_tx, k_det,
      kind, range_wrap, guard_d, guard_r, win_d, win_r, r_valid, coef, lay);
  return cudaGetLastError();
}

}  // extern "C"
