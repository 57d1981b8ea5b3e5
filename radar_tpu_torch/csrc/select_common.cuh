// Two-level top-K in lax.top_k order, shared by the detect stage
// (detect.cu, kernel 1) and the top-K kernel (topk.cu, kernel 3), so the
// two paths select identically.
//
// Order: value descending, ties to the lower flat index.  Cells that are
// not candidates (CFAR non-hits, -inf inputs) hold the f32-minimum
// sentinel and sort below every other value, lowest index first, so
// once the other cells run out the remaining slots carry the untaken
// indices in ascending order, exactly as lax.top_k returns them.
//
// Level 1, per chunk of a row (a CFAR band of kernel 1, a span of
// kernel 3's row), in one block: the non-sentinel cells are compacted
// into a list (warp ballot, one shared-memory atomic a warp), the list
// is sorted by the key (counting ranks when short, a bitonic network
// otherwise), and when it holds fewer than K cells the chunk's lowest
// sentinel indices follow in ascending order.  The chunk's first
// min(K, len) keys in order are exactly its top min(K, len).
// Level 2, per row: the row's top K from its chunks' sorted lists.  A
// candidate's place in the row is its place in its own list plus, in
// each other list, the number of entries that beat it (a binary
// search); places under K are the row's top K.  A chunk's list holds its
// top min(K, len), and every entry that beats a candidate of the row's
// top K is itself one of them, so no place under K is missed or shifted.
// The merge runs in the block that arrives last at the row's ticket
// (last_to_arrive), so the two levels are one launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "layout.h"

namespace radar_select {

using radar_cfar::kF32Min;
using radar_layout::pow2_ceil;

// One candidate: its value and flat index.
struct __align__(8) Cand {
  float v;
  int i;
};
static_assert(sizeof(Cand) == radar_layout::kCandBytes, "layout.h kCandBytes");

// lax.top_k order: larger value first, ties to the lower flat index.
__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

// Lists up to this long are sorted by counting ranks (len^2 / threads
// compares each); longer ones by a bitonic network.
constexpr int kRankSortMax = 256;

// Candidates read from device memory that other blocks of the launch
// wrote: through L2, past this SM's L1.
__device__ __forceinline__ Cand load_cg(const Cand* p) {
  const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
  return Cand{t.x, __float_as_int(t.y)};
}

template <bool kGlobal>
__device__ __forceinline__ Cand load(const Cand* p) {
  if constexpr (kGlobal) return load_cg(p);
  return *p;
}

// Entries of the sorted ``list`` (n long) that beat ``c``.
template <bool kGlobal>
__device__ __forceinline__ int count_better(const Cand* list, int n,
                                            const Cand& c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(load<kGlobal>(list + mid), c))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Level 1: the top m = min(k, len) of the chunk v[0 .. len) (shared
// memory; sentinel = non-candidate), whose cell i has flat index g0 + i,
// into out[0 .. m) in order.  ``list`` is shared scratch of
// pow2_ceil(len) entries; ``s_count`` one shared int.  Returns the
// number of candidates (non-sentinel cells) in every thread.  All
// threads of the block call it (blockDim.x a multiple of 32); it
// synchronises before it returns.
__device__ __forceinline__ int chunk_top_k(const float* v, int len, int g0,
                                           int k, Cand* list, Cand* out,
                                           int* s_count) {
  const int lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();
  for (int i0 = 0; i0 < len; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool hit = i < len && v[i] != kF32Min;
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    int pos = 0;
    if (lane == 0 && bal != 0u) pos = atomicAdd(s_count, __popc(bal));
    pos = __shfl_sync(0xffffffffu, pos, 0);
    if (hit) list[pos + __popc(bal & lt)] = Cand{v[i], g0 + i};
  }
  __syncthreads();
  const int h = *s_count;
  const int m = min(k, len);
  if (h <= kRankSortMax) {
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      const Cand c = list[j];
      int rank = 0;
      for (int q = 0; q < h; ++q) rank += better(list[q], c);
      if (rank < m) out[rank] = c;
    }
  } else {
    // bitonic sort of list[0 .. n), best first; the padding sorts last
    const int n = pow2_ceil(h);
    for (int i = h + threadIdx.x; i < n; i += blockDim.x)
      list[i] = Cand{-CUDART_INF_F, 0x7fffffff};
    __syncthreads();
    for (int size = 2; size <= n; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
          const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
          const Cand a = list[lo], b = list[hi];
          if ((lo & size) == 0 ? better(b, a) : better(a, b)) {
            list[lo] = b;
            list[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int j = threadIdx.x; j < min(h, m); j += blockDim.x) out[j] = list[j];
  }
  if (h < m && threadIdx.x < 32) {
    // the lowest sentinel indices, ascending; len - h >= m - h exist
    const int need = m - h;
    int filled = 0;
    for (int base = 0; filled < need; base += 32) {
      const int i = base + lane;
      const bool miss = i < len && v[i] == kF32Min;
      const unsigned bal = __ballot_sync(0xffffffffu, miss);
      const int pos = filled + __popc(bal & lt);
      if (miss && pos < need) out[h + pos] = Cand{kF32Min, g0 + i};
      filled += __popc(bal);
    }
  }
  __syncthreads();
  return h;
}

// Level 2: the top k of n_lists sorted lists, list j at lists + j *
// stride, stride entries long but the last (last_len).  Calls emit(place,
// cand) for each place 0 .. k - 1 once, from whichever thread ranks it;
// the lists hold k entries or more in all.  kGlobal: the lists lie in
// device memory, written by other blocks of the launch.
template <bool kGlobal, typename Emit>
__device__ __forceinline__ void merge_lists(const Cand* lists, int n_lists,
                                            int stride, int last_len, int k,
                                            Emit emit) {
  const int total = (n_lists - 1) * stride + last_len;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / stride;
    const Cand c = load<kGlobal>(lists + i);
    int place = i - j * stride;
    for (int q = 0; q < n_lists && place < k; ++q)
      if (q != j)
        place += count_better<kGlobal>(lists + q * stride,
                                       q == n_lists - 1 ? last_len : stride,
                                       c);
    if (place < k) emit(place, c);
  }
}

// Whether this block is the last of the ``n`` blocks that share
// ``*ticket`` to get here, in every thread of the block; the last one
// resets the ticket to 0 for the next launch.  What each thread wrote
// before the call is visible to the last block (its reads through L2:
// load_cg).  All threads of the block call it.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, int n,
                                               int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1u) == (unsigned)(n - 1);
    if (last) atomicExch(ticket, 0u);
    *s_flag = last;
  }
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace radar_select

extern "C" {
// Stage (c) of the detect entry (detect.cu): power maps and range planes
// -> the detect entry's outputs.  Arguments as radar_mega_detect.
int radar_detect_stage(const float* power, const float* z,
                       const float* ft_re, const float* ft_im, int* tickets,
                       int* work, long long work_words, int32_t* top_idx,
                       float* top_val, float* nbr, int32_t* num_hits,
                       float* snaps, int n_frames, int n_chirps, int n_rx,
                       int n_tx, int r_size, int d_size, int k_det, int kind,
                       int range_wrap, int guard_d, int guard_r, int win_d,
                       int win_r, int r_valid, float coef, void* stream_ptr);
}
