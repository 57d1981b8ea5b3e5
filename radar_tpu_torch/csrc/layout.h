// Shared-memory and scratch layouts of the selection and CFAR kernels,
// and the limits their entries gate on: the band blocks of the detect
// stage (detect.cu, kernel 1) and of the threshold kernel (cfar.cu,
// kernel 4), the chunk blocks of the top-K kernel (topk.cu, kernel 3)
// and the tile blocks of the OS-CFAR kernels (oscfar.cu, kernels 5 and
// 6).  The one place these sizes are defined: the kernels include this
// header, and layout.cpp, built with the host's C++ compiler, exports it
// to the wrappers (ops/cuda/layout.py), so the gates they check before a
// launch are the kernels' own.  Plain C++; nvcc and the host compiler
// both take it.

#pragma once

#if defined(__CUDACC__)
#define RADAR_HD __host__ __device__ __forceinline__
#else
#define RADAR_HD inline
#endif

namespace radar_layout {

constexpr int kBand = 16;          // Doppler rows a band block owns
constexpr int kSmemMax = 232448;   // bytes of shared memory a block may use
constexpr int kMaxK = 128;         // kernel 1's selection width (_K_LANE)
constexpr int kChunk = 2048;       // cells of a row a top-K block orders
constexpr int kCandBytes = 8;      // a candidate: f32 value, int32 index

RADAR_HD int min_int(int a, int b) { return a < b ? a : b; }

RADAR_HD long long max_ll(long long a, long long b) { return a > b ? a : b; }

// n rounded up to a multiple of 4 (whole 16-byte chunks of 4-byte words).
RADAR_HD long long words16(long long n) { return (n + 3) / 4 * 4; }

// Smallest power of two >= n (n >= 1).
RADAR_HD int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The padded strip rows of a band block: each row carries range_pad(wr)
// cells of range halo a side (wr rounded up to whole 16-byte chunks).
RADAR_HD int range_pad(int wr) { return (wr + 3) / 4 * 4; }

RADAR_HD int strip_stride(int r_size, int wr) {
  return r_size + 2 * range_pad(wr);
}

// Whether a band's +-wd Doppler halo stays clear of the wrap: otherwise
// the block holds the whole map (such maps are under kBand + 2 wd rows).
RADAR_HD bool band_halo(int d_size, int wd) { return kBand + 2 * wd < d_size; }

// Rows of a band block's power tile.
RADAR_HD int tile_rows(int d_size, int wd) {
  return band_halo(d_size, wd) ? kBand + 2 * wd : d_size;
}

// Floats of a band block's padded strip rows, y1 and y2 together.
RADAR_HD long long strip_floats(int d_size, int r_size, int wr) {
  return 2LL * min_int(d_size, kBand) * strip_stride(r_size, wr);
}

RADAR_HD int n_bands(int d_size) { return (d_size + kBand - 1) / kBand; }

// Kernel 4's band block: the tile, then the strip rows.
RADAR_HD long long threshold_smem(int d_size, int r_size, int wd, int wr) {
  return ((long long)tile_rows(d_size, wd) * r_size +
          strip_floats(d_size, r_size, wr)) *
         4;
}

// Kernel 1's band block.  Dynamic shared memory, all of it: the tile
// (tile_floats), then the padded strip rows, whose space the band's
// compacted candidate list reuses (pow2_ceil(band cells) candidates); the
// frame's last band block stages the bands' lists (n_bands x m_full
// candidates) over both.  From cand_offset: the band's top K, the
// frame's top K, two ints.  Scratch in device memory, per frame: each
// band's hit count, then each band's top m candidates.
struct DetectLayout {
  int n_bands, m_full, m_last;
  long long tile_floats, cand_offset, smem_bytes;
  RADAR_HD long long count_words(long long n_frames) const {
    return words16(n_frames * n_bands);   // the lists start 16-byte aligned
  }
  RADAR_HD long long work_words(long long n_frames) const {
    return count_words(n_frames) + 2LL * n_frames * n_bands * m_full;
  }
};

RADAR_HD DetectLayout detect_layout(int d_size, int r_size, int wd, int wr,
                                    int k) {
  DetectLayout l;
  l.n_bands = n_bands(d_size);
  const int band_cells = min_int(d_size, kBand) * r_size;
  const int last_cells = (d_size - (l.n_bands - 1) * kBand) * r_size;
  l.m_full = min_int(k, band_cells);
  l.m_last = min_int(k, last_cells);
  l.tile_floats = (long long)tile_rows(d_size, wd) * r_size;
  const long long list = 2LL * pow2_ceil(band_cells);
  const long long band_floats =
      l.tile_floats + max_ll(strip_floats(d_size, r_size, wr), list);
  const long long stage_floats = 2LL * l.n_bands * l.m_full;
  l.cand_offset = (max_ll(band_floats, stage_floats) * 4 + 15) / 16 * 16;
  l.smem_bytes = l.cand_offset + 2LL * k * kCandBytes + 2 * 4;
  return l;
}

// Kernel 3's chunk block: the chunk (f32), its compacted list and its
// top min(K, kChunk), candidates.  Scratch in device memory where a row
// has more than one chunk: each chunk's list.
RADAR_HD int topk_chunks(int n) { return (n + kChunk - 1) / kChunk; }

RADAR_HD long long topk_smem(int k) {
  return (long long)kChunk * (4 + kCandBytes) +
         (long long)min_int(k, kChunk) * kCandBytes;
}

RADAR_HD long long topk_work_words(long long n_rows, int n, int k) {
  const int n_chunks = topk_chunks(n);
  return n_chunks > 1 ? 2LL * n_rows * n_chunks * min_int(k, kChunk) : 0;
}

// Whether (gd, wd, gr, wr) is the CFAR window that the kernels fix at
// compile time: RadarConfig's default guard (2, 2) and training (4, 8).
RADAR_HD bool default_window(int gd, int gr, int wd, int wr) {
  return gd == 2 && wd == 6 && gr == 2 && wr == 10;
}

// The OS-CFAR kernels' block: a tile of os_tile_rows Doppler rows with
// their +-wd Doppler halo, os_pitch floats a row (the R + 2 wr cells of
// the row and its range halo, then zeros, so that the 16-byte loads of a
// thread's kOsCells cells' windows stay inside the row), then, for a ring
// given as a list of offsets, the list (n_list int32).  The default
// window's undecimated ring is fixed at compile time and needs no list.
constexpr int kOsTileRows = 16;    // Doppler rows a block, where they fit
constexpr int kOsCells = 4;        // consecutive range cells a thread owns

RADAR_HD int round4(int n) { return (n + 3) / 4 * 4; }

RADAR_HD int os_pitch(int r_size, int wr) {
  return round4(r_size) + round4(2 * wr);
}

RADAR_HD bool os_box_ring(int gd, int gr, int wd, int wr, int stride) {
  return stride == 1 && default_window(gd, gr, wd, wr);
}

RADAR_HD long long os_smem(int tile_rows, int r_size, int wd, int wr,
                           int n_list) {
  return ((long long)(tile_rows + 2 * wd) * os_pitch(r_size, wr) + n_list) *
         4;
}

// Doppler rows of a block's tile: kOsTileRows, or fewer where the tile
// would pass kSmemMax; 0 where not even one row fits.
RADAR_HD int os_tile_rows(int d_size, int r_size, int wd, int wr,
                          int n_list) {
  const long long fit =
      ((long long)kSmemMax / 4 - n_list) / os_pitch(r_size, wr) - 2 * wd;
  const int rows = min_int(kOsTileRows, d_size);
  return fit < 0 ? 0 : (fit < rows ? (int)fit : rows);
}

}  // namespace radar_layout
