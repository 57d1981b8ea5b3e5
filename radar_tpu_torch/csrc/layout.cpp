// The layouts of layout.h for the wrappers' gates (ops/cuda/layout.py).
// Built with the host's C++ compiler into a library of its own, so the
// gates run, and are tested, where there is no CUDA toolkit.

#include "layout.h"

extern "C" {

int radar_smem_max() { return radar_layout::kSmemMax; }

int radar_max_k() { return radar_layout::kMaxK; }

// Kernel 1's band block at (d_size, r_size, wd, wr, k): its shared-memory
// bytes, and the scratch words of n_frames frames.
void radar_detect_layout(int d_size, int r_size, int wd, int wr, int k,
                         long long n_frames, long long* smem,
                         long long* words) {
  const radar_layout::DetectLayout l =
      radar_layout::detect_layout(d_size, r_size, wd, wr, k);
  *smem = l.smem_bytes;
  *words = l.work_words(n_frames);
}

// Kernel 4's band block: its shared-memory bytes.
long long radar_threshold_smem(int d_size, int r_size, int wd, int wr) {
  return radar_layout::threshold_smem(d_size, r_size, wd, wr);
}

// Kernel 3: the scratch words of n_rows rows of n cells at k.
long long radar_topk_work_words(long long n_rows, int n, int k) {
  return radar_layout::topk_work_words(n_rows, n, k);
}

// Kernels 5 and 6: whether the ring is the one fixed at compile time
// (then the entries take no offset list), a tile row's floats and a
// block's tile rows.
int radar_os_box_ring(int gd, int gr, int wd, int wr, int stride) {
  return radar_layout::os_box_ring(gd, gr, wd, wr, stride);
}

int radar_os_pitch(int r_size, int wr) {
  return radar_layout::os_pitch(r_size, wr);
}

int radar_os_tile_rows(int d_size, int r_size, int wd, int wr, int n_list) {
  return radar_layout::os_tile_rows(d_size, r_size, wd, wr, n_list);
}

}  // extern "C"
