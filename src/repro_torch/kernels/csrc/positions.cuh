// Explicit token positions for B5 and B5-bwd (flash_attention.cu,
// flash_attention_bwd.cu): the mask of the reference's _chunk_mask
// (src/repro/models/layers/attention.py) on the positions of a (B, S)
// int32 row a batch, where the index-masked kernels compare row and column
// indices.  Left-padded prompts carry positions = arange(S) - pad: the pad
// keys (negative positions) drop out, and a pad query under a causal mask
// attends no key (out 0, lse NEG_INF).
//
//   allowed(kp, qp) = kp >= 0 && (!causal || kp <= qp)
//                     && (window <= 0 || kp > qp - window)
//
// Positions need not be sorted, so a tile's reach is read from the
// positions it holds, not from its indices:
//   * reach(): the first and last row of the streamed side (the keys, or
//     in dK/dV the queries) whose position may pair with the block's own
//     rows, by every thread of the block over the whole sequence once;
//     the kernel's loop visits the tiles between them;
//   * warp_span() and classify(): per tile, the least and greatest
//     position of the tile's rows and of the own rows, one warp each (all
//     lanes get the result): a tile no pair of which is allowed is skipped
//     (kSkip) where the kernel's loop can skip, one every pair of which is
//     allowed takes the unmasked branch (kClean), any other the
//     per-element mask (kEdge).
// With arange positions these give the index-masked kernels' tile ranges
// and edge tests, so the two compute the same bits.
#pragma once

#include <climits>
#include <stdint.h>

namespace pos {

constexpr int kNone = INT_MIN;  // the position of a row past the end

// the position of row j, or kNone past the end of the sequence
__device__ __forceinline__ int at(const int* p, int j, int seq) {
  return j < seq ? __ldg(p + j) : kNone;
}

// may the query at position qp attend the key at kp (kNone: past the end)
__device__ __forceinline__ bool allowed(int kp, int qp, int causal,
                                        int window) {
  return kp >= 0 && qp != kNone && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

struct Span {
  int lo, hi;  // least and greatest position of the rows that take part
  bool bad;    // some row takes no part (past the end; a key below 0)
};

// The span of rows [r0, r0 + N) by one warp.  A key takes part where it
// is in the sequence at a position >= 0, a query where it is in the
// sequence.
template <int N, bool KEYS>
__device__ __forceinline__ Span warp_span(const int* p, int r0, int seq,
                                          int lane) {
  int lo = INT_MAX, hi = INT_MIN;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < (N + 31) / 32; ++i) {
    const int j = lane + 32 * i;
    if (N % 32 == 0 || j < N) {
      const int v = at(p, r0 + j, seq);
      if (v != kNone && (!KEYS || v >= 0)) {
        lo = min(lo, v);
        hi = max(hi, v);
      } else {
        bad = true;
      }
    }
  }
  return {__reduce_min_sync(0xffffffffu, lo),
          __reduce_max_sync(0xffffffffu, hi),
          __any_sync(0xffffffffu, bad) != 0};
}

enum : int { kSkip = 0, kEdge = 1, kClean = 2 };

// A tile of keys k against query rows q: kSkip where no pair is allowed,
// kClean where every pair of rows that take part is, else kEdge.  Query
// rows past the end that are never stored pass q.bad = false.
__device__ __forceinline__ int classify(Span q, Span k, int causal,
                                        int window) {
  if (k.lo > k.hi || q.lo > q.hi) return kSkip;
  if (causal && k.lo > q.hi) return kSkip;
  if (window > 0 && k.hi <= q.lo - window) return kSkip;
  if (k.bad || q.bad) return kEdge;
  if (causal && k.hi > q.lo) return kEdge;
  if (window > 0 && k.lo <= q.hi - window) return kEdge;
  return kClean;
}

// The first and last row, in [0, seq), of the streamed side (STREAM_KEYS:
// keys against the own queries' span `own`; else queries against the own
// keys') that may pair with a row of `own`, as tiles of T rows: x the
// first tile, y the last, x > y where none.  Every thread of the block
// calls it (two __syncthreads); `sh` is two ints of shared memory.
template <bool STREAM_KEYS, int T>
__device__ __forceinline__ int2 reach(const int* p, int seq, Span own,
                                      int causal, int window, int* sh) {
  int lo = INT_MAX, hi = INT_MIN;
  if (own.lo <= own.hi) {
    for (int j = threadIdx.x; j < seq; j += blockDim.x) {
      const int v = __ldg(p + j);
      const bool ok =
          STREAM_KEYS
              ? v >= 0 && (!causal || v <= own.hi) &&
                    (window <= 0 || v > own.lo - window)
              : (!causal || v >= own.lo) &&
                    (window <= 0 || v < own.hi + window);
      if (ok) {
        lo = min(lo, j);
        hi = max(hi, j);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (threadIdx.x == 0) {
    sh[0] = INT_MAX;
    sh[1] = INT_MIN;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicMin(sh, lo);
    atomicMax(sh + 1, hi);
  }
  __syncthreads();
  const int first = sh[0], last = sh[1];
  return first > last ? make_int2(0, -1) : make_int2(first / T, last / T);
}

}  // namespace pos
