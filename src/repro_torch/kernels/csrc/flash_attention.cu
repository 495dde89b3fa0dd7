// Flash attention forward (causal / sliding-window / full, GQA), for Hopper.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py, body _flash_kernel), and on the
// port's model path the jnp core chunked_attention that the reference's
// gqa_full runs (src/repro/models/layers/attention.py):
//
//   out[b,q,h,:] = sum_k p[q,k] v[b,k,h/(H/Hkv),:] / sum_k p[q,k]
//   s = (q . k) * scale, masked to NEG_INF = -1e30 where the key is
//   outside the mask; p = mask ? exp(s - m) : 0 (online over key tiles);
//   a row with l == 0 (fully masked) gives 0.
//
// Mask: causal k <= q, sliding window k > q - window, both, or none; keys
// and queries past the sequence end are masked (the ragged tail).
//
// Bound on this card: operations.  At the hymba-1.5b prefill shape (B=4,
// H=25, Hkv=5, S=2048, D=64, window 1024, bf16) the window reaches ~157M
// (q, k) pairs, 4*D flops each: ~40 GFLOP against ~63 MB of q/k/v/out,
// far above the ~295 flop/byte at which bf16 tensor cores (989 TFLOP/s
// against 3.35 TB/s, H100 SXM data-sheet peaks at 700 W) stop waiting on
// memory.
//
// Two routes, chosen by dtype (a rule, not a fallback):
//
// bf16 -> flash_fwd_tc_kernel, on the tensor cores (wgmma, sm_90a).
//   * One block takes 128 query rows of one (batch, query head): two
//     warpgroups of 64 rows.  The Q tile is loaded once into shared
//     memory.  K and V tiles of 64 keys come through a 3-stage ring by
//     cp.async (16 bytes a thread, zero-fill past the sequence end): tile
//     t+1 loads while tile t multiplies, and the P V product of tile t-1
//     is left in flight until S of tile t has been issued.  Every tile is
//     stored as column atoms of 64 bf16 (one 128-byte row each) under the
//     128-byte swizzle, the layout wgmma's shared-memory descriptors read.
//     The grid starts the longest query tiles (the most key tiles under a
//     causal mask) first, so the short ones fill the last wave.
//   * S = Q K^T: wgmma.m64n64k16 per 16 columns of the head dim, A (Q)
//     and B (K) both K-major from shared memory, fp32 accumulators.
//   * Online softmax on the accumulator fragments: row max and row sum by
//     quad shuffles, exp2 (ex2.approx on the special-function unit) with
//     scale * log2(e) folded in.  The per-element mask runs only on tiles
//     that cross the diagonal, the window's edge or the sequence end;
//     interior tiles take an unmasked branch.
//   * P is cast to bf16 in registers: the m64n64 accumulator layout is the
//     A-register layout of the next four k16 slices, so P never goes to
//     shared memory.  O += P V is a wgmma with A from registers and V from
//     shared memory read as a transposed (N-major) B; O stays in fp32
//     registers.
//   * Each block visits only the key tiles in [q0 - window + 1, q0 + 127];
//     a warpgroup skips the tiles its own 64 rows cannot reach.
//   Arithmetic: q x k products of bf16 values are exact in fp32, so S
//   differs from the reference only in summation order; P is rounded to
//   bf16 before P V (2^-9 relative); l is summed from the fp32 p, as in
//   the reference; the output is cast to bf16 once.  Bound: 2e-2 abs +
//   rel against the plain version, the reference's own bf16 bound.
//   Operands: 16-byte aligned data pointers and (b, s, h) strides that
//   are multiples of 8 elements (the wrapper raises otherwise).
//
// fp32 -> flash_fwd_kernel, the port's first design, IEEE fp32 on the
//   CUDA cores: the card-vs-CPU agreement holds fp32 inputs to 2e-5 per
//   kernel case and 2e-4 end to end, which TF32 or bf16 products cannot.
//   One block per (query tile of 64 rows, head, batch); two threads per
//   query row split the head dim, so q, (m, l, acc) and the 64 scores of
//   a tile live in registers; K and V tiles staged in shared memory as
//   fp32, read back as broadcast float4 loads.
//
// Both: GQA by index (query head h reads kv head h / (H / Hkv); 5 at
// hymba width is no power of two; K/V are never repeated); strided
// operands (the wrapper passes the (b, s, h) strides of each of q, k, v
// and out, so (B,S,H,D) projections are read in place); head dims 32,
// 64, 96 and 128.  The wgmma building blocks are in wgmma.cuh (shared with
// ssd_scan.cu).
//
// Both also write, when given a non-null lse (B, H, S) fp32, each row's
// log-sum-exp of its masked scaled scores, lse = m + log(l), from the m
// and l the epilogue already holds; a fully masked row (l == 0) writes
// NEG_INF (the reference's l_safe convention: m + log(1) with m = NEG_INF).
// The backward (flash_attention_bwd.cu) recomputes p = exp(s - lse) from
// it.  A null lse (the serve path) skips the store.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the launch; launches on the caller's stream and never
// synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 64;                 // keys per shared-memory tile
constexpr int kTpr = 2;                     // threads per query row
constexpr int kThreads = kBlockQ * kTpr;    // 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is contiguous
};

__device__ __forceinline__ bool allowed(int kp, int qp, int seq, int causal,
                                        int window) {
  bool ok = kp < seq && qp < seq;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int seq, int heads, int kv_heads, int causal,
                 int window, float scale) {
  constexpr int kDpt = D / kTpr;  // head-dim entries per thread
  constexpr int kVec = kDpt / 4;  // float4 groups per thread
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBlockK][D]
  float* v_s = k_s + kBlockK * D;                 // [kBlockK][D]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int row = tid / kTpr, part = tid % kTpr;
  const int qpos = q0 + row;

  // this thread's head-dim entries: float4 group g = i * kTpr + part, so
  // the two threads of a row read neighbouring 16-byte words
  float qr[kDpt], acc[kDpt];
  const T* qrow = q + b * qs.b + (int64_t)qpos * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (i * kTpr + part) * 4 + e;
      qr[i * 4 + e] = qpos < seq ? to_f32(qrow[d]) : 0.0f;
      acc[i * 4 + e] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  // the key tiles the mask can reach from rows [q0, q0 + kBlockQ)
  int lo = 0, hi = seq - 1;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(hi, q0 + kBlockQ - 1);
  const T* kbase = k + b * ks.b + hk * ks.h;
  const T* vbase = v + b * vs.b + hk * vs.h;

  for (int k0 = (lo / kBlockK) * kBlockK; k0 <= hi; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const int kp = k0 + r;
      float kv = 0.0f, vv = 0.0f;  // rows past the end stay finite zeros
      if (kp < seq) {
        kv = to_f32(kbase[(int64_t)kp * ks.s + c]);
        vv = to_f32(vbase[(int64_t)kp * vs.s + c]);
      }
      k_s[idx] = kv;
      v_s[idx] = vv;
    }
    __syncthreads();

    float s[kBlockK];
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* krow = reinterpret_cast<const float4*>(k_s + j * D);
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 kk = krow[i * kTpr + part];
        dot = fmaf(qr[i * 4 + 0], kk.x, dot);
        dot = fmaf(qr[i * 4 + 1], kk.y, dot);
        dot = fmaf(qr[i * 4 + 2], kk.z, dot);
        dot = fmaf(qr[i * 4 + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      s[j] = dot;
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = allowed(k0 + j, qpos, seq, causal, window) ? s[j] * scale
                                                        : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = allowed(k0 + j, qpos, seq, causal, window)
                          ? expf(s[j] - m_new)
                          : 0.0f;
      s[j] = p;
      psum += p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < kDpt; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vrow = reinterpret_cast<const float4*>(v_s + j * D);
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 vv = vrow[i * kTpr + part];
        acc[i * 4 + 0] = fmaf(p, vv.x, acc[i * 4 + 0]);
        acc[i * 4 + 1] = fmaf(p, vv.y, acc[i * 4 + 1]);
        acc[i * 4 + 2] = fmaf(p, vv.z, acc[i * 4 + 2]);
        acc[i * 4 + 3] = fmaf(p, vv.w, acc[i * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (qpos < seq) {
    const float denom = l == 0.0f ? 1.0f : l;  // fully masked rows give 0
    if (lse != nullptr && part == 0)
      lse[((int64_t)b * heads + h) * seq + qpos] =
          l == 0.0f ? kNegInf : m + logf(l);
    T* orow = o + b * os.b + (int64_t)qpos * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (i * kTpr + part) * 4 + e;
        store_val(orow + d, acc[i * 4 + e] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides qs, Strides ks, Strides vs, Strides os, int batch,
           int seq, int heads, int kv_heads, int causal, int window,
           float scale, cudaStream_t stream) {
  const int smem = 2 * kBlockK * D * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qs, ks, vs, os,
      seq, heads, kv_heads, causal, window, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma)
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;     // query rows per block: two warpgroups of 64
constexpr int kTcKeys = 64;      // keys per K/V tile
constexpr int kTcThreads = 256;
constexpr int kStages = 3;       // K/V ring: tile t+1 loads while tile t
                                 // multiplies and P V of t-1 drains
constexpr float kLog2e = 1.4426950408889634f;

// one 64-key tile of K and of V into a ring stage; keys past the end read
// as zeros
template <int D>
__device__ __forceinline__ void load_kv(uint32_t sk, uint32_t sv,
                                        const bf16* kb, const bf16* vb,
                                        int64_t kss, int64_t vss, int k0,
                                        int seq, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTcKeys * kChunks / kTcThreads; ++i) {
    const int idx = tid + i * kTcThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = k0 + r < seq;
    const int64_t kp = ok ? k0 + r : 0;
    cp_async16(sk + swz(kTcKeys, r, c), kb + kp * kss + c * 8, ok);
    cp_async16(sv + swz(kTcKeys, r, c), vb + kp * vss + c * 8, ok);
  }
}

template <int D>
constexpr int tc_smem_bytes() {
  // Q, then the K and the V ring (kStages tiles each); 1024 bytes of slack
  // to align the base to the swizzle's 1024-byte period
  return ((D + 63) / 64) * (kTcRows + 2 * kStages * kTcKeys) * (int)kSwRow
         + 1024;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, int seq, int heads, int kv_heads,
                    int causal, int window, float scale_log2) {
  constexpr int kAtoms = (D + 63) / 64;
  constexpr int kChunks = D / 8;
  constexpr uint32_t kQBytes = kAtoms * kTcRows * kSwRow;
  constexpr uint32_t kTileBytes = kAtoms * kTcKeys * kSwRow;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kQBytes, sv = sk + kStages * kTileBytes;

  // the longest query tiles (most key tiles under a causal mask) first:
  // blocks start in index order, so the short ones fill the last wave
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int w0 = q0 + wg * 64;                   // the warpgroup's rows
  const int qa = w0 + warp * 16 + (lane >> 2);   // this thread's: qa, qa+8
  const int cq = 2 * (lane & 3);  // its first column of each 8-column block

  const bf16* qb = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int i = 0; i < kTcRows * kChunks / kTcThreads; ++i) {
    const int idx = tid + i * kTcThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = q0 + r < seq;
    cp_async16(sq + swz(kTcRows, r, c),
               qb + (ok ? (int64_t)(q0 + r) * qs.s : 0) + c * 8, ok);
  }

  // the key tiles the mask can reach from the block's rows, and from this
  // warpgroup's
  int lo = 0, hi = seq - 1, wlo = 0, whi = seq - 1;
  if (window > 0) {
    lo = max(0, q0 - window + 1);
    wlo = max(0, w0 - window + 1);
  }
  if (causal) {
    hi = min(hi, q0 + kTcRows - 1);
    whi = min(whi, w0 + 63);
  }
  const int first = lo / kTcKeys, last = hi / kTcKeys;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  load_kv<D>(sk, sv, kb, vb, ks.s, vs.s, first * kTcKeys, seq, tid);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  // running max (in units of scale * log2(e)) and this thread's part of
  // the row sum, for rows qa and qa + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  // Ring stage of tile t: (t - first) % 3.  At iteration t the block
  // loads tile t+1 into the stage tile t-2 used; each warpgroup waited for
  // its P V of t-2 at iteration t-1, before this iteration's barrier, so
  // P V of t-1 may still run while tile t+1 loads and S of t multiplies.
  for (int t = first; t <= last; ++t) {
    const uint32_t st = (uint32_t)((t - first) % kStages) * kTileBytes;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile t is in; every warpgroup has waited for the
                      // P V of tile t-2
    if (t < last) {
      const uint32_t nx = (uint32_t)((t + 1 - first) % kStages) * kTileBytes;
      load_kv<D>(sk + nx, sv + nx, kb, vb, ks.s, vs.s, (t + 1) * kTcKeys,
                 seq, tid);
      cp_async_commit();
    }
    const int k0 = t * kTcKeys;
    if (w0 >= seq || k0 > whi || k0 + kTcKeys - 1 < wlo) {
      wgmma_wait_all();  // a skipped tile still retires the last P V
      continue;
    }

    // S = Q K^T over the head dim, 16 columns a wgmma
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // 16 entries = 32 bytes
      const uint32_t a = sq + (kk >> 2) * kTcRows * kSwRow + wg * 64 * kSwRow
                         + col;
      const uint32_t bk = sk + st + (kk >> 2) * kTcKeys * kSwRow + col;
      wgmma_ss(s, kmajor_desc(a), kmajor_desc(bk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();  // S of t, and P V of t-1 before acc is touched
    pin(s);
    pin(acc);

    // online softmax on the fragments: s[4j + e] is row qa + 8 (e >> 1),
    // key k0 + 8j + cq + (e & 1)
    const bool edge = (causal && k0 + kTcKeys - 1 > w0) ||
                      (window > 0 && k0 <= w0 + 63 - window) ||
                      k0 + kTcKeys > seq;
    uint32_t keep = 0xffffffffu;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge && !allowed(k0 + 8 * (i >> 2) + cq + (i & 1),
                           qa + 8 * ((i >> 1) & 1), seq, causal, window)) {
        x = kNegInf;
        keep &= ~(1u << i);
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = (keep >> i) & 1u ? fast_exp2(s[i] - mx[r]) : 0.0f;
      const float p1 = (keep >> (i + 1)) & 1u ? fast_exp2(s[i + 1] - mx[r])
                                              : 0.0f;
      psum[r] += p0 + p1;
      pa[i >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V, 16 keys a wgmma: P's registers for keys 16j..16j+15 are
    // pa[4j..4j+3]; V's rows 16j.. start 16 * 128 bytes further
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
      const uint32_t a[4] = {pa[4 * j], pa[4 * j + 1], pa[4 * j + 2],
                             pa[4 * j + 3]};
      wgmma_rs(acc, a,
               sw128_desc(sv + st + j * 16 * kSwRow, kTcKeys * kSwRow,
                          8 * kSwRow));
    }
    wgmma_commit();  // left in flight: waited for with the next S
  }
  wgmma_wait_all();
  pin(acc);

  if (w0 >= seq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    if (row >= seq) continue;
    const float denom = l[r] == 0.0f ? 1.0f : l[r];  // fully masked -> 0
    // m is in units of scale * log2(e): lse = m ln 2 + log(l)
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * heads + h) * seq + row] =
          l[r] == 0.0f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    bf16* orow = o + b * os.b + (int64_t)row * os.s + h * os.h + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom,
                                acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, Strides qs, Strides ks, Strides vs, Strides os,
              int batch, int seq, int heads, int kv_heads, int causal,
              int window, float scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes<D>();
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(heads, batch, (seq + kTcRows - 1) / kTcRows);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, qs, ks, vs,
      os, seq, heads, kv_heads, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

// route by dtype, then head dim
int dispatch(int is_bf16, int head_dim, const void* q, const void* k,
             const void* v, void* o, float* lse, Strides qs, Strides ks,
             Strides vs, Strides os, int batch, int seq, int heads,
             int kv_heads, int causal, int window, float scale,
             cudaStream_t s) {
#define FLASH_ARGS q, k, v, o, lse, qs, ks, vs, os, batch, seq, heads, \
                   kv_heads, causal, window, scale, s
  if (is_bf16) {
    switch (head_dim) {
      case 32: return launch_tc<32>(FLASH_ARGS);
      case 64: return launch_tc<64>(FLASH_ARGS);
      case 96: return launch_tc<96>(FLASH_ARGS);
      case 128: return launch_tc<128>(FLASH_ARGS);
    }
  } else {
    switch (head_dim) {
      case 32: return launch<float, 32>(FLASH_ARGS);
      case 64: return launch<float, 64>(FLASH_ARGS);
      case 96: return launch<float, 96>(FLASH_ARGS);
      case 128: return launch<float, 128>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

// dynamic shared memory a block of the bf16 (tensor-core) kernel asks for
// at head_dim, or -1 for a head dim it does not take
extern "C" int flash_attention_tc_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 32: return tc_smem_bytes<32>();
    case 64: return tc_smem_bytes<64>();
    case 96: return tc_smem_bytes<96>();
    case 128: return tc_smem_bytes<128>();
    default: return -1;
  }
}

// q, o: (B, S, H, D); k, v: (B, S, Hkv, D); each with its (b, s, h)
// strides in elements and a contiguous head dim.  head_dim in
// {32, 64, 96, 128}; H a multiple of Hkv.  bf16 (is_bf16 = 1) runs on the
// tensor cores and needs 16-byte aligned q, k, v with (b, s, h) strides
// that are multiples of 8 (else cudaErrorMisalignedAddress); fp32 on the
// CUDA cores.  lse: null, or (B, H, S) fp32 for the backward.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int batch, int seq, int heads, int kv_heads, int head_dim,
    int causal, int window, float scale, int is_bf16, float* lse,
    void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  if (is_bf16 && !(aligned16(q, qs) && aligned16(k, ks) &&
                   aligned16(v, vs)))
    return (int)cudaErrorMisalignedAddress;
  return dispatch(is_bf16, head_dim, q, k, v, o, lse, qs, ks, vs, os, batch,
                  seq, heads, kv_heads, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}
