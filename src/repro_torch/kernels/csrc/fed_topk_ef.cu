// Top-k sparsification with error feedback over a stacked (K, D) cohort,
// for Hopper.
//
// Replaces the TPU kernel fed_topk_ef_pallas
// (src/repro/kernels/fed_aggregate.py, body _topk_ef_kernel).  Per cohort
// row r and per parameter-leaf SEGMENT s of the flat row (offset, size,
// k_s = max(int(frac * size), 1), from the host's table):
//
//     corrected = msgs[r] + err[ids[r]]          (the gather happens here)
//     keep      = exactly k_s entries of the segment, ranked on the bf16
//                 round trip of |corrected|, ties toward the lower index
//     sent      = keep ? corrected : 0,   new_err = corrected - sent
//
// The selection runs per segment, never over the whole row: the reference
// ranks each leaf of the parameter tree on its own.
//
// Exact selection.  The key of an element is the bf16 bit pattern of
// |corrected| (__float2bfloat16_rn: round to nearest even, as torch and
// XLA cast).  Non-negative bf16 patterns order like their values, so a
// 16-bit radix select finds the threshold key T, the k-th largest key of
// the segment; every NaN key becomes 0xFFFF, above +inf (0x7F80), as the
// plain version's torch.topk ranks NaN above every number.  Then
//     keep = key is not NaN and (key > T or (key == T and tie rank < need)),
//     need = k - #(non-NaN keys > T),
// with the tie rank counted in index order.  If T itself is NaN nothing is
// kept, as in the plain version (nothing compares greater than or equal to
// NaN).  Six launches, all over a chunk table (chunk -> segment, start,
// length; chunks never straddle a segment), grid (chunks, K):
//   1. hist_hi:   256-bin histogram of the key's high byte per (row,
//                 segment), in shared memory, merged with global atomics;
//   2. select_hi: per (row, segment) the bucket B holding the k-th key;
//   3. hist_lo:   256-bin histogram of the low byte of the keys in B;
//   4. select_lo: T, and need;
//   5. tie_count: per chunk, the number of keys equal to T;
//   6. write:     per chunk, the ties of the segment's earlier chunks
//                 (summed from step 5) start the tie rank; inside the
//                 chunk the rank comes from a warp ballot and __popc, in
//                 sub-chunks of kThreads elements walked in order.
// corrected, sent and new_err use __fadd_rn / __fsub_rn, so both outputs
// are BITWISE the plain version (kernels/ref.py).  ids are clamped to
// [0, L) before the gather, so a padded row cannot read out of bounds;
// a row of NaN keeps nothing and never stalls a loop.
//
// Bound on this card: bytes.  The function reads msgs and the error rows
// and writes sent and new_err, four (K, D) fp32 arrays, against a few
// integer operations per element.  This simple version reads its inputs
// four times (steps 1, 3, 5, 6); the rows of one call fit the 50 MB L2
// at the federation's shape, so most re-reads come from there.
//
// Plain C interface (bound with ctypes): returns the first CUDA error of
// the memsets and launches; launches on the caller's stream and never
// synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr uint32_t kNaNKey = 0xFFFFu;

__device__ __forceinline__ uint32_t mag_key(float c) {
  const uint32_t u = __bfloat16_as_ushort(__float2bfloat16_rn(fabsf(c)));
  return u > 0x7F80u ? kNaNKey : u;
}

struct Table {
  const int* chunk_seg;       // (C,) segment of each chunk
  const int64_t* chunk_start; // (C,) first column of each chunk
  const int* chunk_len;       // (C,) columns in each chunk
  const int* seg_k;           // (S,) entries kept per segment
  const int* seg_chunk0;      // (S,) first chunk of each segment
  int nseg, nchunk;
};

struct Rows {
  const float* msgs;          // (K, D)
  const float* err;           // (L, D)
  const int* ids;             // (K,)
  int64_t d;
  int l;
};

__device__ __forceinline__ const float* err_row(const Rows& r, int row) {
  int id = r.ids[row];
  id = id < 0 ? 0 : (id >= r.l ? r.l - 1 : id);
  return r.err + (int64_t)id * r.d;
}

__global__ void hist_hi_kernel(Rows r, Table t, unsigned* hist_hi) {
  __shared__ unsigned h[kBins];
  const int c = blockIdx.x, row = blockIdx.y;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int64_t start = t.chunk_start[c];
  const int len = t.chunk_len[c];
  const float* m = r.msgs + (int64_t)row * r.d + start;
  const float* e = err_row(r, row) + start;
  for (int j = threadIdx.x; j < len; j += blockDim.x)
    atomicAdd(&h[mag_key(__fadd_rn(m[j], e[j])) >> 8], 1u);
  __syncthreads();
  unsigned* g = hist_hi + ((int64_t)row * t.nseg + t.chunk_seg[c]) * kBins;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (h[b]) atomicAdd(&g[b], h[b]);
}

// sel per (row, segment): [0] high byte B, [1] rank of the k-th key inside
// bucket B, [2] threshold key T, [3] need.
__global__ void select_hi_kernel(Table t, const unsigned* hist_hi, int* sel) {
  const int row = blockIdx.x;
  for (int s = threadIdx.x; s < t.nseg; s += blockDim.x) {
    const unsigned* h = hist_hi + ((int64_t)row * t.nseg + s) * kBins;
    const unsigned k = (unsigned)t.seg_k[s];
    unsigned above = 0;
    int b = kBins - 1;
    for (; b > 0; --b) {
      if (above + h[b] >= k) break;
      above += h[b];
    }
    int* out = sel + ((int64_t)row * t.nseg + s) * 4;
    out[0] = b;
    out[1] = (int)(k - above);
  }
}

__global__ void hist_lo_kernel(Rows r, Table t, const int* sel,
                               unsigned* hist_lo) {
  __shared__ unsigned h[kBins];
  const int c = blockIdx.x, row = blockIdx.y;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int64_t rs = (int64_t)row * t.nseg + t.chunk_seg[c];
  const uint32_t hi = (uint32_t)sel[rs * 4];
  const int64_t start = t.chunk_start[c];
  const int len = t.chunk_len[c];
  const float* m = r.msgs + (int64_t)row * r.d + start;
  const float* e = err_row(r, row) + start;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const uint32_t key = mag_key(__fadd_rn(m[j], e[j]));
    if ((key >> 8) == hi) atomicAdd(&h[key & 0xFFu], 1u);
  }
  __syncthreads();
  unsigned* g = hist_lo + rs * kBins;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (h[b]) atomicAdd(&g[b], h[b]);
}

__global__ void select_lo_kernel(Table t, const unsigned* hist_hi,
                                 const unsigned* hist_lo, int* sel) {
  const int row = blockIdx.x;
  for (int s = threadIdx.x; s < t.nseg; s += blockDim.x) {
    const int64_t rs = (int64_t)row * t.nseg + s;
    const unsigned* h = hist_lo + rs * kBins;
    int* out = sel + rs * 4;
    const unsigned k = (unsigned)t.seg_k[s];
    const unsigned kk = (unsigned)out[1];
    unsigned above = 0;
    int b = kBins - 1;
    for (; b > 0; --b) {
      if (above + h[b] >= kk) break;
      above += h[b];
    }
    const uint32_t thr = ((uint32_t)out[0] << 8) | (uint32_t)b;
    // keys > T: (k - kk) in higher buckets, `above` in this one; the NaN
    // keys (0xFFFF, the only keys of bucket 0xFF) are not "greater" for
    // the plain version's float comparison
    const unsigned nan_keys = hist_hi[rs * kBins + (kBins - 1)];
    const unsigned greater = (k - kk) + above - nan_keys;
    out[2] = (int)thr;
    out[3] = thr == kNaNKey ? 0 : (int)(k - greater);
  }
}

__global__ void tie_count_kernel(Rows r, Table t, const int* sel,
                                 int* tie_cnt) {
  const int c = blockIdx.x, row = blockIdx.y;
  const int64_t rs = (int64_t)row * t.nseg + t.chunk_seg[c];
  const uint32_t thr = (uint32_t)sel[rs * 4 + 2];
  const int64_t start = t.chunk_start[c];
  const int len = t.chunk_len[c];
  const float* m = r.msgs + (int64_t)row * r.d + start;
  const float* e = err_row(r, row) + start;
  int total = 0;
  for (int base = 0; base < len; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int tie = j < len && thr != kNaNKey
                    && mag_key(__fadd_rn(m[j], e[j])) == thr;
    total += __syncthreads_count(tie);
  }
  if (threadIdx.x == 0) tie_cnt[(int64_t)row * t.nchunk + c] = total;
}

__global__ void write_kernel(Rows r, Table t, const int* sel,
                             const int* tie_cnt, float* sent_out,
                             float* err_out) {
  __shared__ int warp_tot[kWarps];
  const int c = blockIdx.x, row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = t.chunk_seg[c];
  const int64_t rs = (int64_t)row * t.nseg + s;
  const uint32_t thr = (uint32_t)sel[rs * 4 + 2];
  const int need = sel[rs * 4 + 3];
  // ties in the segment's earlier chunks: a block-wide sum
  int prior = 0;
  for (int q = t.seg_chunk0[s] + threadIdx.x; q < c; q += blockDim.x)
    prior += tie_cnt[(int64_t)row * t.nchunk + q];
  for (int off = 16; off > 0; off >>= 1)
    prior += __shfl_down_sync(0xffffffffu, prior, off);
  if (lane == 0) warp_tot[warp] = prior;
  __syncthreads();
  int running = 0;
  for (int w = 0; w < kWarps; ++w) running += warp_tot[w];
  __syncthreads();
  const int64_t start = t.chunk_start[c];
  const int len = t.chunk_len[c];
  const int64_t ob = (int64_t)row * r.d + start;
  const float* m = r.msgs + ob;
  const float* e = err_row(r, row) + start;
  for (int base = 0; base < len; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool in = j < len;
    float cv = 0.0f;
    uint32_t key = 0;
    if (in) {
      cv = __fadd_rn(m[j], e[j]);
      key = mag_key(cv);
    }
    const bool tie = in && key == thr && key != kNaNKey;
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_tot[w];
      if (w < warp) before += n;
      total += n;
    }
    if (in) {
      const int rank = running + before + __popc(ballot & ((1u << lane) - 1u));
      const bool keep = key != kNaNKey && (key > thr || (tie && rank < need));
      const float sent = keep ? cv : 0.0f;
      sent_out[ob + j] = sent;
      err_out[ob + j] = __fsub_rn(cv, sent);
    }
    running += total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int fed_topk_ef(const float* msgs, const float* err,
                           const int* ids, int64_t k_rows, int64_t d,
                           int l_rows, const int* chunk_seg,
                           const int64_t* chunk_start, const int* chunk_len,
                           const int* seg_k, const int* seg_chunk0, int nseg,
                           int nchunk, unsigned* hist_hi, unsigned* hist_lo,
                           int* sel, int* tie_cnt, float* sent,
                           float* new_err, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows r{msgs, err, ids, d, l_rows};
  const Table t{chunk_seg, chunk_start, chunk_len, seg_k, seg_chunk0, nseg,
                nchunk};
  const size_t hist_bytes = (size_t)k_rows * nseg * kBins * sizeof(unsigned);
  cudaError_t e = cudaMemsetAsync(hist_hi, 0, hist_bytes, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(hist_lo, 0, hist_bytes, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nchunk, (unsigned)k_rows);
  hist_hi_kernel<<<grid, kThreads, 0, st>>>(r, t, hist_hi);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  select_hi_kernel<<<(unsigned)k_rows, 64, 0, st>>>(t, hist_hi, sel);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hist_lo_kernel<<<grid, kThreads, 0, st>>>(r, t, sel, hist_lo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  select_lo_kernel<<<(unsigned)k_rows, 64, 0, st>>>(t, hist_hi, hist_lo,
                                                     sel);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tie_count_kernel<<<grid, kThreads, 0, st>>>(r, t, sel, tie_cnt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  write_kernel<<<grid, kThreads, 0, st>>>(r, t, sel, tie_cnt, sent, new_err);
  return (int)cudaGetLastError();
}
