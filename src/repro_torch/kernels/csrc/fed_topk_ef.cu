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
// NaN).
//
// Work layout: one memset and three launches, each over a chunk table
// (chunk -> segment, start, length; at most 4096 columns, never straddling
// a segment), grid (chunks, K), 256 threads a block.  A chunk's columns
// are a scalar head, 16-byte vectors and a scalar tail (segment offsets
// need not be multiples of 4); each thread issues its loads (four vectors
// of each operand) before any barrier or arithmetic.
//   1. key pass: reads msgs and the gathered error row once, writes the
//      16-bit key of every element to a (K, D) scratch, and builds the
//      chunk's high-byte histogram in shared memory, merged into its
//      (row, segment)'s with global atomics.
//   2. low pass: every block first finds its segment's bucket B, the bin
//      that holds the k-th key, by a block-wide suffix scan over the 256
//      bins of the now complete high-byte histogram, while its keys load
//      (2 bytes an element, 16-byte loads).  It then counts the low bytes
//      of the keys in B: the chunk's histogram, kept in global scratch,
//      and merged into the (row, segment)'s.
//   3. write pass: while msgs and the error row load again, every block
//      finds T (B and the low byte at which the count reaches the k-th
//      key) and need by the same scan over the complete low-byte
//      histogram, then its tie prefix, the keys equal to T in the
//      segment's earlier chunks (their low-byte bin T & 0xFF: T's high
//      byte is B).  It ranks the ties in index order by one block-wide
//      prefix sum (four 16-bit counts packed in 64 bits, taken only when
//      the chunk holds a tie) and writes sent and new_err in 16-byte
//      streaming stores.  The key pass's loads ask L2 to keep msgs and
//      err (evict last) and the write pass's stream them (evict first).
// Each selection is thus recomputed by every block that needs it, from a
// histogram that the previous launch completed: no block waits on
// another, and none takes an arrival ticket.  (Selecting in the last
// block of a segment to arrive, after a __threadfence, measured slower on
// this card: the fence held every block of the key pass until its key
// stores landed.)  Both histograms count with plain shared-memory
// atomics: warp-aggregated increments (__match_any_sync) measured slower
// in both passes, markedly so in the low pass, whose bins are spread.
// The histograms are scratch of the call, zeroed by the one memset on the
// caller's stream, so calls on two streams never share them.
// corrected, sent and new_err use __fadd_rn / __fsub_rn, so both outputs
// are BITWISE the plain version (kernels/ref.py).  ids are clamped to
// [0, L) before the gather, so a padded row cannot read out of bounds.
//
// Bound on this card: bytes.  The function reads msgs and the error rows
// and writes sent and new_err, four (K, D) fp32 arrays, against a few
// integer operations per element.  Beyond them the kernel moves the keys
// (written once, read once: half a row's bytes) and reads msgs and the
// error rows a second time; at the federation's shape (K=5, D=775 500,
// 31 MB of inputs) the 50 MB L2 holds part of that second read.
//
// Plain C interface (bound with ctypes): returns the first CUDA error of
// the memset and launches; launches on the caller's stream and never
// synchronises.  msgs and keys must start on 16 bytes (the wrapper
// ensures it); err may start anywhere, and a row whose error row is off
// msgs' 16-byte phase is read with scalar loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;    // == kThreads: a thread per bin
constexpr int kUnroll = 4;    // items a thread per step
// the most columns a chunk holds (the host table's CHUNK): one step of
// 16-byte vectors, or two of 8 keys
constexpr int kChunk = kThreads * kUnroll * 4;
constexpr int kKeyVecs = kChunk / 8 / kThreads;
constexpr uint32_t kNaNKey = 0xFFFFu;

__device__ __forceinline__ uint32_t mag_key(float c) {
  const uint32_t u = __bfloat16_as_ushort(__float2bfloat16_rn(fabsf(c)));
  return u > 0x7F80u ? kNaNKey : u;
}

struct Table {
  const int* chunk_seg;       // (C,) segment of each chunk
  const int64_t* chunk_start; // (C,) first column of each chunk
  const int* chunk_len;       // (C,) columns in each chunk, <= kChunk
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

struct Scratch {
  unsigned* hist_hi;          // (K, S, 256) high-byte counts, zeroed
  unsigned* hist_lo;          // (K, S, 256) low-byte counts in B, zeroed
  int* sel;                   // (K, S, 2): B, rank of the k-th key in B
  unsigned* lo_chunk;         // (K, C, 256) low-byte counts in B per chunk
  uint16_t* keys;             // (K, D)
};

__device__ __forceinline__ const float* err_row(const Rows& r, int row) {
  int id = r.ids[row];
  id = id < 0 ? 0 : (id >= r.l ? r.l - 1 : id);
  return r.err + (int64_t)id * r.d;
}

// A chunk's columns as a scalar head, `nvec` 16-byte vectors and a scalar
// tail; all scalar when msgs and err differ in their 16-byte phase.
struct Span {
  int head, nvec, tail;
};

__device__ __forceinline__ Span span_of(const float* m, const float* e,
                                        int len) {
  const unsigned am = (unsigned)(reinterpret_cast<uintptr_t>(m) & 15u);
  if (am != (unsigned)(reinterpret_cast<uintptr_t>(e) & 15u))
    return {len, 0, 0};
  const int head = min(len, (int)(((16u - am) & 15u) >> 2));
  const int nvec = (len - head) >> 2;
  return {head, nvec, len - head - 4 * nvec};
}

// a 16-byte load that asks L2 to keep the line (evict last): the key
// pass's reads of msgs and err, which the write pass reads again
__device__ __forceinline__ float4 ld_keep(const float4* p) {
  float4 v;
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// corrected = m + e for this thread's items i = u * kThreads + tid
// (u < kUnroll), item i being columns [V i, V i + V); items i >= n give
// zeros.  Every load is issued before any addition; 16-byte loads keep
// their lines in L2 (kKeep) or stream them (their last read).
template <int V, bool kKeep = false>
__device__ __forceinline__ void load_corrected(const float* __restrict__ m,
                                               const float* __restrict__ e,
                                               int n,
                                               float (&c)[kUnroll][V]) {
  float a[kUnroll][V], b[kUnroll][V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + (int)threadIdx.x;
    if constexpr (V == 4) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* m4 = reinterpret_cast<const float4*>(m) + i;
      const float4* e4 = reinterpret_cast<const float4*>(e) + i;
      const float4 x = i >= n ? z : kKeep ? ld_keep(m4) : __ldcs(m4);
      const float4 y = i >= n ? z : kKeep ? ld_keep(e4) : __ldcs(e4);
      a[u][0] = x.x; a[u][1] = x.y; a[u][2] = x.z; a[u][3] = x.w;
      b[u][0] = y.x; b[u][1] = y.y; b[u][2] = y.z; b[u][3] = y.w;
    } else {
      a[u][0] = i < n ? m[i] : 0.f;
      b[u][0] = i < n ? e[i] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) c[u][v] = __fadd_rn(a[u][v], b[u][v]);
}

// exclusive prefix sum of v over the block in thread order; `total` gets
// the block's sum.  Every thread must call it.
template <typename T>
__device__ __forceinline__ T block_exclusive_sum(T v, T* warp_sums,
                                                 T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  T before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();  // warp_sums free for the next call
  return before + x - v;
}

// the bucket b of a 256-bin histogram (in L2) at which the count of keys
// in bins >= b first reaches `want` (1 <= want <= the histogram's total):
// a block-wide suffix scan, thread t holding bin 255 - t; exactly one
// thread returns true, with b and the count in the bins above b
__device__ __forceinline__ bool find_bucket(const unsigned* hist, int want,
                                            int* warp_sums, int& b,
                                            int& above) {
  b = kBins - 1 - (int)threadIdx.x;
  const int v = (int)__ldcg(hist + b);
  int total;
  above = block_exclusive_sum(v, warp_sums, total);
  return above < want && above + v >= want;
}

// 1. keys, high-byte histograms
__global__ void __launch_bounds__(kThreads)
key_pass_kernel(Rows r, Table t, Scratch sc) {
  __shared__ unsigned h[kBins];
  const int c = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int s = t.chunk_seg[c];
  const int len = t.chunk_len[c];
  const int64_t ob = (int64_t)row * r.d + t.chunk_start[c];
  const float* m = r.msgs + ob;
  const float* e = err_row(r, row) + t.chunk_start[c];
  uint16_t* kp = sc.keys + ob;
  const Span sp = span_of(m, e, len);
  float body[kUnroll][4];
  load_corrected<4, true>(m + sp.head, e + sp.head, sp.nvec, body);
  h[tid] = 0;
  __syncthreads();
  // the scalar head and tail (all of the chunk when msgs and err differ
  // in phase), item q at column q of the head or of the tail
  const int ns = sp.head + sp.tail;
  for (int base = 0; base < ns; base += kThreads * kUnroll) {
    float a[kUnroll], b[kUnroll];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = base + u * kThreads + tid;
      j[u] = q < sp.head ? q : len - sp.tail + (q - sp.head);
      a[u] = q < ns ? m[j[u]] : 0.f;
      b[u] = q < ns ? e[j[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads + tid < ns) {
        const uint32_t key = mag_key(__fadd_rn(a[u], b[u]));
        kp[j[u]] = (uint16_t)key;
        atomicAdd(&h[key >> 8], 1u);
      }
    }
  }
  // the body: one step of four 16-byte vectors a thread, 8-byte key stores
  uint2* k4 = reinterpret_cast<uint2*>(kp + sp.head);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + tid;
    if (i < sp.nvec) {
      const uint32_t k0 = mag_key(body[u][0]), k1 = mag_key(body[u][1]);
      const uint32_t k2 = mag_key(body[u][2]), k3 = mag_key(body[u][3]);
      k4[i] = make_uint2(k0 | (k1 << 16), k2 | (k3 << 16));
      atomicAdd(&h[k0 >> 8], 1u);
      atomicAdd(&h[k1 >> 8], 1u);
      atomicAdd(&h[k2 >> 8], 1u);
      atomicAdd(&h[k3 >> 8], 1u);
    }
  }
  __syncthreads();
  const int64_t rs = (int64_t)row * t.nseg + s;
  unsigned* g = sc.hist_hi + rs * kBins;
  if (h[tid]) atomicAdd(&g[tid], h[tid]);
}

// 2. bucket B; low-byte histograms of the keys in B, per chunk and per
// segment
__global__ void __launch_bounds__(kThreads)
low_pass_kernel(Table t, int64_t d, Scratch sc) {
  __shared__ unsigned h[kBins];
  __shared__ int warp_sums[kWarps];
  __shared__ int bucket;
  const int c = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int s = t.chunk_seg[c];
  const int len = t.chunk_len[c];
  const int64_t rs = (int64_t)row * t.nseg + s;
  const uint16_t* kp = sc.keys + (int64_t)row * d + t.chunk_start[c];
  // a scalar head and tail of at most 7 keys each around 16-byte vectors
  const int head = min(len, (int)(((16u - (unsigned)(
      reinterpret_cast<uintptr_t>(kp) & 15u)) & 15u) >> 1));
  const int nvec = (len - head) >> 3;
  const int tail = len - head - 8 * nvec;
  const uint4* k8 = reinterpret_cast<const uint4*>(kp + head);
  uint4 q[kKeyVecs];
#pragma unroll
  for (int u = 0; u < kKeyVecs; ++u) {
    const int i = u * kThreads + tid;
    q[u] = i < nvec ? __ldcs(k8 + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  // bucket B, from the segment's complete high-byte histogram
  const int k = t.seg_k[s];
  int b, above;
  if (find_bucket(sc.hist_hi + rs * kBins, k, warp_sums, b, above)) {
    bucket = b;
    if (c == t.seg_chunk0[s]) {     // for the write pass
      sc.sel[rs * 2] = b;
      sc.sel[rs * 2 + 1] = k - above;
    }
  }
  h[tid] = 0;
  __syncthreads();
  const uint32_t hi = (uint32_t)bucket;
  if (tid < head + tail) {
    const uint32_t key = kp[tid < head ? tid : len - tail + (tid - head)];
    if ((key >> 8) == hi) atomicAdd(&h[key & 0xFFu], 1u);
  }
#pragma unroll
  for (int u = 0; u < kKeyVecs; ++u) {
    if (u * kThreads + tid < nvec) {
      const uint32_t w[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint32_t k0 = w[x] & 0xFFFFu, k1 = w[x] >> 16;
        if ((k0 >> 8) == hi) atomicAdd(&h[k0 & 0xFFu], 1u);
        if ((k1 >> 8) == hi) atomicAdd(&h[k1 & 0xFFu], 1u);
      }
    }
  }
  __syncthreads();
  unsigned* lo_chunk = sc.lo_chunk + (int64_t)row * t.nchunk * kBins;
  lo_chunk[(int64_t)c * kBins + tid] = h[tid];
  unsigned* g = sc.hist_lo + rs * kBins;
  if (h[tid]) atomicAdd(&g[tid], h[tid]);
}

// sent and new_err of this thread's items (see load_corrected), the ties
// ranked in index order from `running`: item i's ties come after those of
// every item before it, and items run u-major, so one block-wide prefix
// sum of the kUnroll per-item tie counts, packed 16 bits each (at most
// kThreads * 4 a step), gives every rank
template <int V>
__device__ __forceinline__ void write_items(
    const float (&c)[kUnroll][V], int n, float* __restrict__ so,
    float* __restrict__ eo, uint32_t thr, int need, int& running,
    unsigned long long* warp_sums) {
  uint32_t key[kUnroll][V];
  unsigned long long cnt = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = u * kThreads + (int)threadIdx.x < n;
    unsigned ties = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      key[u][v] = mag_key(c[u][v]);
      ties += in && key[u][v] == thr && thr != kNaNKey;
    }
    cnt |= (unsigned long long)ties << (16 * u);
  }
  unsigned long long before = 0, total = 0;
  if (__syncthreads_or(cnt != 0))
    before = block_exclusive_sum(cnt, warp_sums, total);
  int rank[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    rank[u] = running + (int)((before >> (16 * u)) & 0xFFFFu);
    running += (int)((total >> (16 * u)) & 0xFFFFu);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + (int)threadIdx.x;
    if (i >= n) continue;
    float sv[V], ev[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool tie = key[u][v] == thr && thr != kNaNKey;
      const bool keep = key[u][v] != kNaNKey
                        && (key[u][v] > thr || (tie && rank[u] < need));
      rank[u] += tie;
      sv[v] = keep ? c[u][v] : 0.0f;
      ev[v] = __fsub_rn(c[u][v], sv[v]);
    }
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(so) + i,
             make_float4(sv[0], sv[1], sv[2], sv[3]));
      __stcs(reinterpret_cast<float4*>(eo) + i,
             make_float4(ev[0], ev[1], ev[2], ev[3]));
    } else {
      so[i] = sv[0];
      eo[i] = ev[0];
    }
  }
}

// 3. sent and new_err
__global__ void __launch_bounds__(kThreads)
write_pass_kernel(Rows r, Table t, Scratch sc, float* sent_out,
                  float* err_out) {
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ int warp_sums32[kWarps];
  __shared__ int sel_s[2];
  const int c = blockIdx.x, row = blockIdx.y;
  const int len = t.chunk_len[c];
  const int64_t ob = (int64_t)row * r.d + t.chunk_start[c];
  const float* m = r.msgs + ob;
  const float* e = err_row(r, row) + t.chunk_start[c];
  float* so = sent_out + ob;
  float* eo = err_out + ob;
  const Span sp = span_of(m, e, len);
  float body[kUnroll][4];
  load_corrected<4>(m + sp.head, e + sp.head, sp.nvec, body);
  // while the loads are in flight: T and need from the segment's complete
  // low-byte histogram, then the chunk's tie prefix, the keys equal to T
  // in the segment's earlier chunks (bin T & 0xFF of their low-byte
  // histograms; T's high byte is B)
  const int s = t.chunk_seg[c];
  const int64_t rs = (int64_t)row * t.nseg + s;
  {
    const uint32_t hi = (uint32_t)sc.sel[rs * 2];
    const int k = t.seg_k[s], kk = sc.sel[rs * 2 + 1];
    int b, above;
    if (find_bucket(sc.hist_lo + rs * kBins, kk, warp_sums32, b, above)) {
      const uint32_t thr = (hi << 8) | (uint32_t)b;
      // keys > T: (k - kk) in higher buckets, `above` in this one; the
      // NaN keys (0xFFFF, the only keys of bucket 0xFF) are not "greater"
      // for the plain version's float comparison
      const int nan_keys = (int)sc.hist_hi[rs * kBins + (kBins - 1)];
      const int greater = (k - kk) + above - nan_keys;
      sel_s[0] = (int)thr;
      sel_s[1] = thr == kNaNKey ? 0 : k - greater;
    }
    __syncthreads();
  }
  const uint32_t thr = (uint32_t)sel_s[0];
  const int need = sel_s[1];
  unsigned long long prior = 0;
  if (thr != kNaNKey)
    for (int q = t.seg_chunk0[s] + (int)threadIdx.x; q < c; q += kThreads)
      prior += sc.lo_chunk[((int64_t)row * t.nchunk + q) * kBins
                           + (thr & 0xFFu)];
  unsigned long long ties_before;
  block_exclusive_sum(prior, warp_sums, ties_before);
  int running = (int)ties_before;
  // the scalar head (all of the chunk when msgs and err differ in phase),
  // the body, the scalar tail: in index order
  for (int base = 0; base < sp.head; base += kThreads * kUnroll) {
    float hv[kUnroll][1];
    load_corrected<1>(m + base, e + base, sp.head - base, hv);
    write_items<1>(hv, sp.head - base, so + base, eo + base, thr, need,
                   running, warp_sums);
  }
  write_items<4>(body, sp.nvec, so + sp.head, eo + sp.head, thr, need,
                 running, warp_sums);
  if (sp.tail) {
    const int j = len - sp.tail;
    float tv[kUnroll][1];
    load_corrected<1>(m + j, e + j, sp.tail, tv);
    write_items<1>(tv, sp.tail, so + j, eo + j, thr, need, running,
                   warp_sums);
  }
}

}  // namespace

// zeroed: 2 K S 256 unsigned ints (the two histograms, zeroed here);
// scratch: K S 2 + K C 256 ints (B and the rank in B per segment, the
// per-chunk low-byte histograms); keys: K D uint16.  msgs and keys start
// on 16 bytes; every chunk holds at most kChunk = 4096 columns.
extern "C" int fed_topk_ef(const float* msgs, const float* err,
                           const int* ids, int64_t k_rows, int64_t d,
                           int l_rows, const int* chunk_seg,
                           const int64_t* chunk_start, const int* chunk_len,
                           const int* seg_k, const int* seg_chunk0, int nseg,
                           int nchunk, unsigned* zeroed, int* scratch,
                           uint16_t* keys, float* sent, float* new_err,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows r{msgs, err, ids, d, l_rows};
  const Table t{chunk_seg, chunk_start, chunk_len, seg_k, seg_chunk0, nseg,
                nchunk};
  const int64_t ks = k_rows * nseg;
  const Scratch sc{zeroed, zeroed + ks * kBins, scratch,
                   reinterpret_cast<unsigned*>(scratch + 2 * ks), keys};
  cudaError_t e = cudaMemsetAsync(
      zeroed, 0, (size_t)(2 * ks * kBins) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nchunk, (unsigned)k_rows);
  key_pass_kernel<<<grid, kThreads, 0, st>>>(r, t, sc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  low_pass_kernel<<<grid, kThreads, 0, st>>>(t, d, sc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  write_pass_kernel<<<grid, kThreads, 0, st>>>(r, t, sc, sent, new_err);
  return (int)cudaGetLastError();
}
