// Flash attention forward (causal / sliding-window / full, GQA), for Hopper.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py, body _flash_kernel), and on the
// port's model path the jnp core chunked_attention that the reference's
// gqa_full runs (src/repro/models/layers/attention.py):
//
//   out[b,q,h,:] = sum_k p[q,k] v[b,k,h/(H/Hkv),:] / sum_k p[q,k]
//   s = (q . k) * scale over the query/key head dim DQK, while v and the
//   output have a head dim DV of their own (MLA: q and k carry the
//   decoupled rope channels on top of v's, (96, 64) at minicpm3-4b
//   width); s masked to NEG_INF = -1e30 where the key is outside the
//   mask; p = mask ? exp(s - m) : 0 (online over key tiles); a row with
//   l == 0 (fully masked) gives 0.
//
// Mask: causal k <= q, sliding window k > q - window, both, or none; keys
// and queries past the sequence end are masked (the ragged tail).
//
// Positions: k and q above are the rows' indices, or, where the caller
// passes positions (q_pos, k_pos: (B, S) int32, a left-padded prompt's
// arange(S) - pad), their positions, and a key at a negative position is
// never attended (the reference's _chunk_mask).  Each kernel is built
// twice, the bool template POS telling the two apart, so that the
// index-masked instance is the code it was.  With positions a block finds
// the key tiles it visits from the keys' positions (pos::reach, one pass
// of the block over the sequence's positions), and each warp classifies
// every tile from the least and greatest position of its keys and of its
// own query rows (pos::classify): skipped (bf16, where a warpgroup may
// skip), unmasked, or masked per element from the loaded positions.  A
// row that may attend no key keeps p = 0 on every tile (the keep bits),
// so it ends with l == 0: out 0 and lse NEG_INF, never NaN.  Measured on
// an H100 at 700 W (tools/time_kernel.py): the index-masked instances
// compile to the SASS of kernels with no position code at all,
// instruction for instruction, and read their times; through the POS
// instances arange positions cost the bf16 route +5% (205.5-206.7
// against 195.4 us at hymba-1.5b's prefill) and the fp32 route +25%
// (5900.3-5982.0 against 4710.2-4751.7 us at the federated hymba round's
// shape), and a pad of 1000 at 1 x 4096 takes the bf16 route from 118.6
// to 95.7 us (pad queries visit no tile).  The index path writes its mask
// test as one condition: through a separate bool, ptxas kept the
// predicates in registers and the bf16 route read 276-284 us against
// 197-198.
//
// Bound on this card: operations.  At the hymba-1.5b prefill shape (B=4,
// H=25, Hkv=5, S=2048, D=64, window 1024, bf16) the window reaches ~157M
// (q, k) pairs, 4*D flops each: ~40 GFLOP against ~63 MB of q/k/v/out,
// far above the ~295 flop/byte at which bf16 tensor cores (989 TFLOP/s
// against 3.35 TB/s, H100 SXM data-sheet peaks at 700 W) stop waiting on
// memory.
//
// Two routes, chosen by dtype (a rule, not a fallback), both on the
// tensor cores:
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
// fp32 -> flash_fwd_f32_kernel, on the tensor cores in split TF32 (wgmma,
//   sm_90a): ~4.8 ms at the federated hymba-1.5b round's (16, 2048,
//   25/5, 64, window 1024), where IEEE fp32 on the CUDA cores took
//   13.3-15.0, and ~6.7 ms at the minicpm3-4b round's (8, 2048, 40/40,
//   (96, 64)), under the library's fp32 7.0 (PERF.md).
//   * Split TF32 (wgmma.cuh): each fp32 operand is carried as hi =
//     tf32(x) and lo = tf32(x - hi); a product is lo hi + hi lo + hi hi.
//     S takes lo_q hi_k as one product of N = T and hi_q [hi_k | lo_k]
//     as one of N = 2T (K staged as a pair tile, a k8 slice's hi rows
//     then its lo rows), so Q's hi tile is read once for two terms; the
//     three sums are added small terms first.  P V takes its three
//     products into one accumulator, the small ones of every k8 slice
//     first.  The split is made once per tile, as threads stage it into
//     shared memory; P is split in registers.  Softmax and exp stay on
//     the CUDA cores in fp32 (exp2f, scale * log2(e) folded in).
//     Measured against the plain version on an H100: max |kernel -
//     plain| 6.6e-7 to 5.0e-6 over the card checks' grid (at most 0.17 of
//     the 2e-5 abs + rel bound), 1.4e-6 to 2.2e-6 of max|plain| at the
//     two federated rounds' shapes; one TF32 product alone reads ~1e-3
//     (tests/test_torch_kernels.py emulates both).
//   * TF32 wgmma reads both operands K-major only, so V is staged
//     transposed (V^T, the B operand of P V) and P's accumulator is the
//     A-register operand without a shuffle: its 8 columns of a k8 slice
//     are taken in the order 0 2 4 6 1 3 5 7 and V^T's rows staged in the
//     same order (frag_tf32).
//   * One block takes 64 query rows of one (batch, query head): one
//     warpgroup, Q's hi and lo staged once.  K and V tiles of T keys come
//     by cp.async (16 bytes a thread, zero-fill past the end) into a raw
//     fp32 ring of two stages, two tiles ahead of their use; S = Q K^T
//     multiplies while V^T is split from the ring, P V while the next K
//     is split.  Every tile is fp32 under the 32-byte swizzle, one block
//     of 8 columns a k8 slice, so 80 and 96 need no padding.  Longest
//     query tiles first; only the key tiles the mask reaches; the mask
//     only on edge tiles.
//   * T and the budget: two blocks an SM (4 warps each) where a block's
//     shared memory allows (at most 113 KB), the widest T of 64, 32, 16
//     that fits; else one.  (Dqk, Dv): T, shared memory a block, blocks
//     an SM, registers (ptxas): (32, 32) 64, 85 248 B, 2, 221; (64, 64)
//     32, 100 096 B, 2, 182; (80, 80) 16, 82 944 B, 2, 168; (96, 96) 16,
//     99 328 B, 2, 167; (128, 128) 32, 198 400 B, 1, 255; (96, 64) 16,
//     91 136 B, 2, 159; (80, 64) 16, 78 848 B, 2, 159; no spills.
//     At (96, 64) two blocks of T = 16 took 7.54 ms against one block
//     of T = 64's 10.93 (the minicpm3-4b round's shape, H100), and the
//     N = 2T product 6.7 against three N = T ones' 7.4; the ring and
//     staging by threads from device memory measured within 5% of each
//     other at both rounds' shapes (the ring is kept as the backward's,
//     where it paid).
//   Operands: 16-byte aligned data pointers and (b, s, h) strides that
//   are multiples of 4 elements (the wrapper raises otherwise).
//
// Both: GQA by index (query head h reads kv head h / (H / Hkv); 5 at
// hymba width is no power of two; K/V are never repeated); strided
// operands (the wrapper passes the (b, s, h) strides of each of q, k, v
// and out, so (B,S,H,D) projections are read in place); the head-dim
// pairs (DQK, DV) (32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
// (96, 64) and (80, 64).  Head dim 80 (hubert-xlarge's 1280 / 16) needs no
// layout of its own on the tensor cores: a row is stored as column atoms of
// 64 entries, so 80 is one full atom and 16 columns of a second, as 96 is
// one and a half; the swizzle works within each 128-byte atom row and the
// descriptors step from atom to atom, never across a 160-byte row.  The
// wgmma building blocks are in wgmma.cuh (shared with ssd_scan.cu).
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

#include "positions.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// fp32 route: tensor cores, split TF32 (wgmma, sm_90a)
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 64;     // query rows per block: one warpgroup
constexpr int kF32Threads = 128;
constexpr int kSmemMax = 232448;   // a block's dynamic shared memory, sm_90
constexpr int kSmemHalf = 115712;  // each of two blocks on an SM (228 KB,
                                   // 1 KB reserved a block)

// Q, a K tile and a V^T tile of T keys, each as TF32 hi and lo, and two
// raw stages of T keys' K and V; 256 bytes of slack to align the base to
// the 32-byte swizzle's 256-byte period
template <int DQK, int DV, int T>
__host__ __device__ constexpr int f32_bytes() {
  return 2 * 4 * (kF32Rows * DQK + T * DQK + DV * T)
         + 2 * 4 * raw_floats<DQK, DV, T>() + 256;
}
// keys a tile: the most (64, 32, 16) with which two blocks share an SM,
// else the most a block's shared memory holds
template <int DQK, int DV>
__host__ __device__ constexpr int f32_keys() {
  if (f32_bytes<DQK, DV, 64>() <= kSmemHalf) return 64;
  if (f32_bytes<DQK, DV, 32>() <= kSmemHalf) return 32;
  if (f32_bytes<DQK, DV, 16>() <= kSmemHalf) return 16;
  if (f32_bytes<DQK, DV, 64>() <= kSmemMax) return 64;
  return f32_bytes<DQK, DV, 32>() <= kSmemMax ? 32 : 16;
}
template <int DQK, int DV>
constexpr int f32_smem_bytes() {
  return f32_bytes<DQK, DV, f32_keys<DQK, DV>()>();
}

template <int DQK, int DV, bool POS>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, int seq, int heads,
                     int kv_heads, int causal, int window,
                     float scale_log2, const int* __restrict__ qpos,
                     const int* __restrict__ kpos) {
  constexpr int T = f32_keys<DQK, DV>();
  constexpr uint32_t kQ = kF32Rows * DQK * 4, kK = T * DQK * 4,
                     kV = DV * T * 4;
  constexpr int kRaw = raw_floats<DQK, DV, T>(), kStride = DQK + DV + 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qh = align256(smem_raw);
  uint8_t* const ql = qh + kQ;
  uint8_t* const kp = ql + kQ;   // K's hi and lo rows a k8 slice
  uint8_t* const vh = kp + 2 * kK;
  uint8_t* const vl = vh + kV;
  float* const raw = reinterpret_cast<float*>(vl + kV);  // two stages
  const uint32_t sqh = smem_addr(qh), sql = sqh + kQ, skp = sql + kQ,
                 svh = skp + 2 * kK, svl = svh + kV, sraw = svl + kV;

  // the longest query tiles (most key tiles under a causal mask) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kF32Rows;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qa = q0 + warp * 16 + (lane >> 2);   // this thread's: qa, qa+8
  const int cq = 2 * (lane & 3);

  // the key tiles the mask can reach from the block's rows: from their
  // indices, or with positions from the keys' positions (positions.cuh)
  int lo = 0, hi = seq - 1;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(hi, q0 + kF32Rows - 1);
  int first = lo / T, last = hi / T;
  [[maybe_unused]] pos::Span own;
  [[maybe_unused]] int qv[2];
  if constexpr (POS) {
    __shared__ int reach_s[2];
    qpos += (int64_t)b * seq;
    kpos += (int64_t)b * seq;
    own = pos::warp_span<kF32Rows, false>(qpos, q0, seq, lane);
    own.bad = false;  // rows past the end are never stored
    const int2 r = pos::reach<true, T>(kpos, seq, own, causal, window,
                                       reach_s);
    first = r.x;
    last = r.y;
    qv[0] = pos::at(qpos, qa, seq);
    qv[1] = pos::at(qpos, qa + 8, seq);
  }
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  // K and V of tile t come by cp.async into raw stage (t - first) % 2,
  // two tiles ahead of their use; their hi and lo tiles are split from it
  auto fetch = [&](int t) {
    fetch_rows<DQK, DV, T>(sraw + (uint32_t)(((t - first) & 1) * kRaw) * 4u,
                           kb, ks.s, vb, vs.s, t * T, seq, tid);
  };
  fetch(first);
  cp_async_commit();
  if (first < last) fetch(first + 1);
  cp_async_commit();
  stage_tf32<DQK, kF32Rows>(qh, ql, q + b * qs.b + h * qs.h, qs.s, q0, seq,
                            tid);
  cp_async_wait_all();
  __syncthreads();
  split_raw<DQK, T, kStride, 0>(kp, raw, tid);
  fence_proxy_async();
  __syncthreads();

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
  // running max (in units of scale * log2(e)) and this thread's part of
  // the row sum, for rows qa and qa + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  // Per key tile: S's products run while V^T is split, P V's while the
  // next K is split and tile t+2 is fetched; each waits for its products
  // before the barrier that hands its tiles over.
  for (int t = first; t <= last; ++t) {
    const int k0 = t * T;
    const float* rst = raw + ((t - first) & 1) * kRaw;
    // S = Q K^T over DQK: lo_q hi_k into s, and hi_q [hi_k | lo_k] into
    // s2 as one N = 2T product (Q's hi tile read once for both), summed
    // small terms first once the products are in
    float s[T / 2], s2[T];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < T; ++i) s2[i] = 0.0f;
    pin(s);
    pin(s2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 8; ++kk) {
      const uint32_t qo = kk * kF32Rows * 32, ko = kk * 2 * T * 32;
      wgmma_tf32(s, kmajor32_desc(sql + qo), kmajor32_desc(skp + ko),
                 kk > 0);
      wgmma_tf32(s2, kmajor32_desc(sqh + qo), kmajor32_desc(skp + ko),
                 kk > 0);
    }
    wgmma_commit();
    split_raw_t<DV, T, kStride, DQK>(vh, vl, rst, tid);
    fence_proxy_async();
    wgmma_wait_all();
    pin(s);
    pin(s2);
    __syncthreads();  // V^T of t is in; K of t is read
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = (s[i] + s2[i + T / 2]) + s2[i];

    // online softmax on the fragments: s[4j + e] is row qa + 8 (e >> 1),
    // key k0 + 8j + cq + (e & 1); the mask only on tiles that cross the
    // diagonal, the window's edge or the sequence end (with positions:
    // that hold a pad key or a pair the mask refuses)
    [[maybe_unused]] int cls = pos::kEdge;
    if constexpr (POS)
      cls = pos::classify(own, pos::warp_span<T, true>(kpos, k0, seq, lane),
                          causal, window);
    const bool edge = POS ? cls != pos::kClean
                          : (causal && k0 + T - 1 > q0) ||
                                (window > 0 &&
                                 k0 <= q0 + kF32Rows - 1 - window) ||
                                k0 + T > seq;
    [[maybe_unused]] int kv[POS ? T / 4 : 1];
    if constexpr (POS) {
      if (edge) {
#pragma unroll
        for (int i = 0; i < T / 4; ++i)
          kv[i] = pos::at(kpos, k0 + 8 * (i >> 1) + cq + (i & 1), seq);
      }
    }
    uint32_t keep = 0xffffffffu;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      float x = s[i] * scale_log2;
      if (edge && !(POS ? pos::allowed(kv[POS ? 2 * (i >> 2) + (i & 1) : 0],
                                       qv[(i >> 1) & 1], causal, window)
                        : allowed(k0 + 8 * (i >> 2) + cq + (i & 1),
                                  qa + 8 * ((i >> 1) & 1), seq, causal,
                                  window))) {
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
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (keep >> i) & 1u ? exp2f(s[i] - mx[r]) : 0.0f;
      psum[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t ph[T / 8][4], pl[T / 8][4];
#pragma unroll
    for (int j = 0; j < T / 8; ++j) frag_tf32(s + 4 * j, ph[j], pl[j]);

    // O += P V over DV, 8 keys a product, V^T's block j the B operand
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      wgmma_tf32(acc, pl[j], kmajor32_desc(svh + j * DV * 32));
      wgmma_tf32(acc, ph[j], kmajor32_desc(svl + j * DV * 32));
    }
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
      wgmma_tf32(acc, ph[j], kmajor32_desc(svh + j * DV * 32));
    wgmma_commit();
    if (t < last) {
      cp_async_wait_all();
      __syncthreads();  // tile t+1 is in; tile t's stage and S are read
      if (t + 2 <= last) fetch(t + 2);
      cp_async_commit();
      split_raw<DQK, T, kStride, 0>(kp, raw + ((t + 1 - first) & 1) * kRaw,
                                    tid);
      fence_proxy_async();
    }
    wgmma_wait_all();
    pin(acc);
    __syncthreads();  // K of t+1 is in; V^T of t is read
  }

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
    float* orow = o + b * os.b + (int64_t)row * os.s + h * os.h + cq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[4 * j + 2 * r] / denom,
                      acc[4 * j + 2 * r + 1] / denom);
  }
}

template <int DQK, int DV, bool POS>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, Strides qs, Strides ks, Strides vs, Strides os,
               int batch, int seq, int heads, int kv_heads, int causal,
               int window, float scale, const int* qpos, const int* kpos,
               cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DQK, DV>();
  auto kern = flash_fwd_f32_kernel<DQK, DV, POS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(heads, batch, (seq + kF32Rows - 1) / kF32Rows);
  kern<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, qs, ks, vs,
      os, seq, heads, kv_heads, causal, window, scale * kLog2e, qpos, kpos);
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

// `rows` rows of D entries (16-byte chunks) into a swizzled tile, by
// cp.async from rows `stride` entries apart starting at row r0; rows past
// the end read as zeros.  D / 8 chunks a row need not divide evenly among
// the threads (D = 80: 10 chunks a row).
template <int D, int Rows>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int64_t stride, int r0, int seq,
                                          int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = Rows * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kTcThreads - 1) / kTcThreads; ++i) {
    const int idx = tid + i * kTcThreads;
    if (kTotal % kTcThreads != 0 && idx >= kTotal) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r0 + r < seq;
    const int64_t row = ok ? r0 + r : 0;
    cp_async16(dst + swz(Rows, r, c), src + row * stride + c * 8, ok);
  }
}

// one 64-key tile of K and of V into their ring stages.  With one head dim
// whose chunks divide evenly among the threads, one loop issues both
// copies of a chunk, its index arithmetic and bounds test once: two loops
// cost hymba-1.5b's prefill shape ~3% (201-205 against 196-198 us a
// call on an H100, tools/time_kernel.py); otherwise K and V load apart.
template <int DQK, int DV>
__device__ __forceinline__ void load_kv(uint32_t sk, uint32_t sv,
                                        const bf16* kb, const bf16* vb,
                                        int64_t kss, int64_t vss, int k0,
                                        int seq, int tid) {
  constexpr int kChunks = DQK / 8;
  if constexpr (DQK == DV && kTcKeys * kChunks % kTcThreads == 0) {
#pragma unroll
    for (int i = 0; i < kTcKeys * kChunks / kTcThreads; ++i) {
      const int idx = tid + i * kTcThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const bool ok = k0 + r < seq;
      const int64_t kp = ok ? k0 + r : 0;
      cp_async16(sk + swz(kTcKeys, r, c), kb + kp * kss + c * 8, ok);
      cp_async16(sv + swz(kTcKeys, r, c), vb + kp * vss + c * 8, ok);
    }
  } else {
    load_rows<DQK, kTcKeys>(sk, kb, kss, k0, seq, tid);
    load_rows<DV, kTcKeys>(sv, vb, vss, k0, seq, tid);
  }
}

template <int DQK, int DV>
constexpr int tc_smem_bytes() {
  // Q, then the K ring and the V ring (kStages tiles each), each in column
  // atoms of 64 entries; 1024 bytes of slack to align the base to the
  // swizzle's 1024-byte period
  return (((DQK + 63) / 64) * (kTcRows + kStages * kTcKeys) +
          ((DV + 63) / 64) * kStages * kTcKeys) * (int)kSwRow
         + 1024;
}

template <int DQK, int DV, bool POS>
__global__ void __launch_bounds__(kTcThreads, DQK <= 64 && DV <= 64 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, int seq, int heads, int kv_heads,
                    int causal, int window, float scale_log2,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos) {
  constexpr uint32_t kAtoms = (DQK + 63) / 64;
  constexpr uint32_t kQBytes = kAtoms * kTcRows * kSwRow;
  constexpr uint32_t kKTile = kAtoms * kTcKeys * kSwRow;
  constexpr uint32_t kVTile = ((DV + 63) / 64) * kTcKeys * kSwRow;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kQBytes, sv = sk + kStages * kKTile;

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

  load_rows<DQK, kTcRows>(sq, q + b * qs.b + h * qs.h, qs.s, q0, seq, tid);

  // the key tiles the mask can reach from the block's rows, and from this
  // warpgroup's: from their indices, or with positions from the keys'
  // positions (positions.cuh)
  int lo = 0, hi = seq - 1, wlo = 0, whi = seq - 1;
  if (window > 0) {
    lo = max(0, q0 - window + 1);
    wlo = max(0, w0 - window + 1);
  }
  if (causal) {
    hi = min(hi, q0 + kTcRows - 1);
    whi = min(whi, w0 + 63);
  }
  int first = lo / kTcKeys, last = hi / kTcKeys;
  [[maybe_unused]] pos::Span wown;
  [[maybe_unused]] int qv[2];
  if constexpr (POS) {
    __shared__ int reach_s[2];
    qpos += (int64_t)b * seq;
    kpos += (int64_t)b * seq;
    pos::Span own = pos::warp_span<kTcRows, false>(qpos, q0, seq, lane);
    own.bad = false;  // rows past the end are never stored
    wown = pos::warp_span<64, false>(qpos, w0, seq, lane);
    wown.bad = false;
    const int2 r = pos::reach<true, kTcKeys>(kpos, seq, own, causal, window,
                                             reach_s);
    first = r.x;
    last = r.y;
    qv[0] = pos::at(qpos, qa, seq);
    qv[1] = pos::at(qpos, qa + 8, seq);
  }
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  if (!POS || first <= last)
    load_kv<DQK, DV>(sk, sv, kb, vb, ks.s, vs.s, first * kTcKeys, seq, tid);
  cp_async_commit();

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
  // running max (in units of scale * log2(e)) and this thread's part of
  // the row sum, for rows qa and qa + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  // Ring stage of tile t: (t - first) % 3.  At iteration t the block
  // loads tile t+1 into the stage tile t-2 used; each warpgroup waited for
  // its P V of t-2 at iteration t-1, before this iteration's barrier, so
  // P V of t-1 may still run while tile t+1 loads and S of t multiplies.
  for (int t = first; t <= last; ++t) {
    const uint32_t stage = (uint32_t)((t - first) % kStages);
    const uint32_t stk = stage * kKTile, stv = stage * kVTile;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile t is in; every warpgroup has waited for the
                      // P V of tile t-2
    if (t < last) {
      const uint32_t nx = (uint32_t)((t + 1 - first) % kStages);
      load_kv<DQK, DV>(sk + nx * kKTile, sv + nx * kVTile, kb, vb, ks.s,
                       vs.s, (t + 1) * kTcKeys, seq, tid);
      cp_async_commit();
    }
    const int k0 = t * kTcKeys;
    [[maybe_unused]] int cls = pos::kEdge;
    if constexpr (POS)
      cls = pos::classify(wown, pos::warp_span<kTcKeys, true>(kpos, k0, seq,
                                                             lane),
                          causal, window);
    if (POS ? cls == pos::kSkip
            : w0 >= seq || k0 > whi || k0 + kTcKeys - 1 < wlo) {
      wgmma_wait_all();  // a skipped tile still retires the last P V
      continue;
    }

    // S = Q K^T over the query/key head dim, 16 columns a wgmma
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // 16 entries = 32 bytes
      const uint32_t a = sq + (kk >> 2) * kTcRows * kSwRow + wg * 64 * kSwRow
                         + col;
      const uint32_t bk = sk + stk + (kk >> 2) * kTcKeys * kSwRow + col;
      wgmma_ss(s, kmajor_desc(a), kmajor_desc(bk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();  // S of t, and P V of t-1 before acc is touched
    pin(s);
    pin(acc);

    // online softmax on the fragments: s[4j + e] is row qa + 8 (e >> 1),
    // key k0 + 8j + cq + (e & 1)
    const bool edge = POS ? cls == pos::kEdge
                          : (causal && k0 + kTcKeys - 1 > w0) ||
                                (window > 0 && k0 <= w0 + 63 - window) ||
                                k0 + kTcKeys > seq;
    [[maybe_unused]] int kv[POS ? kTcKeys / 4 : 1];
    if constexpr (POS) {
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTcKeys / 4; ++i)
          kv[i] = pos::at(kpos, k0 + 8 * (i >> 1) + cq + (i & 1), seq);
      }
    }
    uint32_t keep = 0xffffffffu;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge && !(POS ? pos::allowed(kv[POS ? 2 * (i >> 2) + (i & 1) : 0],
                                       qv[(i >> 1) & 1], causal, window)
                        : allowed(k0 + 8 * (i >> 2) + cq + (i & 1),
                                  qa + 8 * ((i >> 1) & 1), seq, causal,
                                  window))) {
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
    for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V over v's head dim (wgmma N = DV), 16 keys a wgmma: P's
    // registers for keys 16j..16j+15 are pa[4j..4j+3]; V's rows 16j..
    // start 16 * 128 bytes further
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
      const uint32_t a[4] = {pa[4 * j], pa[4 * j + 1], pa[4 * j + 2],
                             pa[4 * j + 3]};
      wgmma_rs(acc, a,
               sw128_desc(sv + stv + j * 16 * kSwRow, kTcKeys * kSwRow,
                          8 * kSwRow));
    }
    wgmma_commit();  // left in flight: waited for with the next S
  }
  wgmma_wait_all();
  pin(acc);
  if constexpr (POS) cp_async_wait_all();  // Q's copy, where no tile ran

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
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom,
                                acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int DQK, int DV, bool POS>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, Strides qs, Strides ks, Strides vs, Strides os,
              int batch, int seq, int heads, int kv_heads, int causal,
              int window, float scale, const int* qpos, const int* kpos,
              cudaStream_t stream) {
  const int smem = tc_smem_bytes<DQK, DV>();
  auto kern = flash_fwd_tc_kernel<DQK, DV, POS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(heads, batch, (seq + kTcRows - 1) / kTcRows);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, qs, ks, vs,
      os, seq, heads, kv_heads, causal, window, scale * kLog2e, qpos, kpos);
  return (int)cudaGetLastError();
}

// the instantiated (DQK, DV) pairs, as one key
constexpr int pair(int dqk, int dv) { return dqk * 1000 + dv; }

// route by dtype, then head-dim pair, then explicit or implicit positions
int dispatch(int is_bf16, int head_dim, int v_head_dim, const void* q,
             const void* k, const void* v, void* o, float* lse, Strides qs,
             Strides ks, Strides vs, Strides os, int batch, int seq,
             int heads, int kv_heads, int causal, int window, float scale,
             const int* qpos, const int* kpos, cudaStream_t s) {
#define FLASH_ARGS q, k, v, o, lse, qs, ks, vs, os, batch, seq, heads, \
                   kv_heads, causal, window, scale, qpos, kpos, s
#define FLASH_PAIR(DQK, DV)                                             \
  case pair(DQK, DV):                                                   \
    if (qpos != nullptr)                                                \
      return is_bf16 ? launch_tc<DQK, DV, true>(FLASH_ARGS)             \
                     : launch_f32<DQK, DV, true>(FLASH_ARGS);           \
    return is_bf16 ? launch_tc<DQK, DV, false>(FLASH_ARGS)              \
                   : launch_f32<DQK, DV, false>(FLASH_ARGS);
  switch (pair(head_dim, v_head_dim)) {
    FLASH_PAIR(32, 32)
    FLASH_PAIR(64, 64)
    FLASH_PAIR(80, 80)
    FLASH_PAIR(96, 96)
    FLASH_PAIR(128, 128)
    FLASH_PAIR(96, 64)
    FLASH_PAIR(80, 64)
  }
#undef FLASH_PAIR
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// a 16-byte aligned data pointer and (b, s, h) strides of whole 16-byte
// chunks (`per16` entries of the dtype)
bool aligned16(const void* p, const Strides& st, int per16) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st.b % per16 == 0 &&
         st.s % per16 == 0 && st.h % per16 == 0;
}

}  // namespace

// dynamic shared memory a block of the bf16 (is_bf16 = 1) or fp32 kernel
// asks for at the head-dim pair (DQK, DV), or -1 for a pair it does not
// take
extern "C" int flash_attention_tc_smem_bytes(int head_dim, int v_head_dim,
                                             int is_bf16) {
#define SMEM_PAIR(DQK, DV)                                        \
  case pair(DQK, DV):                                             \
    return is_bf16 ? tc_smem_bytes<DQK, DV>() : f32_smem_bytes<DQK, DV>();
  switch (pair(head_dim, v_head_dim)) {
    SMEM_PAIR(32, 32)
    SMEM_PAIR(64, 64)
    SMEM_PAIR(80, 80)
    SMEM_PAIR(96, 96)
    SMEM_PAIR(128, 128)
    SMEM_PAIR(96, 64)
    SMEM_PAIR(80, 64)
  }
#undef SMEM_PAIR
  return -1;
}

// q: (B, S, H, DQK); k: (B, S, Hkv, DQK); v: (B, S, Hkv, DV); o: (B, S, H,
// DV); each with its (b, s, h) strides in elements and a contiguous head
// dim.  (head_dim, v_head_dim) = (DQK, DV) one of the pairs of dispatch;
// H a multiple of Hkv.  Both dtypes run on the tensor cores
// and need 16-byte aligned q, k, v with (b, s, h) strides of whole 16-byte
// chunks, multiples of 8 (bf16) or 4 (fp32) entries (else
// cudaErrorMisalignedAddress).  lse: null, or (B, H, S) fp32 for the
// backward.  q_pos, k_pos: both null (the implicit arange(S), the
// index-masked instances), or both (B, S) int32 contiguous.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int batch, int seq, int heads, int kv_heads, int head_dim,
    int v_head_dim, int causal, int window, float scale, int is_bf16,
    float* lse, const int* q_pos, const int* k_pos, void* stream) {
  if ((q_pos == nullptr) != (k_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const int per16 = is_bf16 ? 8 : 4;
  if (!(aligned16(q, qs, per16) && aligned16(k, ks, per16) &&
        aligned16(v, vs, per16)))
    return (int)cudaErrorMisalignedAddress;
  return dispatch(is_bf16, head_dim, v_head_dim, q, k, v, o, lse, qs, ks, vs,
                  os, batch, seq, heads, kv_heads, causal, window, scale,
                  q_pos, k_pos, static_cast<cudaStream_t>(stream));
}
