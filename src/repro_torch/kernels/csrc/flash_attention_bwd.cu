// Flash attention backward (causal / sliding-window / full, GQA), for Hopper.
//
// The gradient of B5 (flash_attention.cu).  The reference has no Pallas
// backward: it differentiates its attention core by the hand-written jnp
// VJP _flash_vjp_bwd (src/repro/models/layers/attention.py), which
// recomputes the probabilities chunk by chunk from (q, k, v, out, lse):
//
//   p[q,k]   = mask ? exp(s[q,k] - lse[q]) : 0,   s = (q . k) * scale
//   delta[q] = sum_d dout[q,d] out[q,d]       (over v's head dim)
//   ds[q,k]  = p[q,k] (dout[q] . v[k] - delta[q]) * scale
//   dq[q]    = sum_k ds[q,k] k[k]
//   dk[k]    = sum_{h in group} sum_q ds[q,k] q[q]
//   dv[k]    = sum_{h in group} sum_q p[q,k] dout[q]
//
// GQA by index: kv head hk is read by the H/Hkv query heads
// [hk * H/Hkv, (hk + 1) * H/Hkv), and dk, dv sum over them.  q and k
// have a head dim DQK, v, out and dout one of their own, DV (MLA's q and
// k carry the decoupled rope channels on top of v's: (96, 64) at
// minicpm3-4b width), so dq and dk have DQK columns and dv has DV.
//
// Bound on this card: operations.  A (q, k) pair the mask allows costs
// 6 DQK + 4 DV flops (s, dq and dk over DQK; dp and dv over DV), 10 D
// when DQK = DV = D.  At the hymba-1.5b training shape (B=1, S=4096,
// H=25, Hkv=5, D=64, window 1024, bf16) the window reaches ~92M (q, k)
// pairs: ~59 GFLOP, 59.4 us at the bf16 tensor cores' 989 TFLOP/s,
// against ~58 MB of q/k/v/out/dout/lse and gradients read and written
// once, 17.3 us at 3.35 TB/s (H100 SXM data-sheet peaks at 700 W;
// chip_smoke.py works the same count out).  FA2's split into two
// kernels recomputes s and dp in both, 14 * D flops a pair: at least 1.4x
// the bound, the price of no atomics (every call gives the same bits).  Registers bound the tensor-core
// kernels (one block an SM): the dk/dv kernel keeps DQK/2 + DV/2 fp32
// accumulators a thread beside the 64 of S^T and dP^T, which spills at
// DQK = DV = 128 (chip_smoke.py prints ptxas' count for every instance).
//
// Two routes, chosen by dtype (a rule, not a fallback), as the forward,
// both on the tensor cores:
//
// bf16 -> three launches on the tensor cores (wgmma, sm_90a), oriented so
//   that the probabilities and their gradient never go through shared
//   memory: the m64n64 accumulator of S (or S^T) is, packed to bf16, the
//   A-register operand of the next product.
//   1. flash_bwd_dq_tc_kernel, one block per (128 query rows, head,
//      batch), built like the forward's flash_fwd_tc_kernel: two
//      warpgroups of 64 rows; Q and dO loaded once; K and V tiles of 64
//      keys through a 3-stage cp.async ring under the 128-byte swizzle
//      (zero-fill past the end); the longest query tiles first; only the
//      key tiles the mask reaches; an unmasked branch for interior tiles.
//      Per key tile: S = Q K^T and dP = dO V^T (wgmma_ss, both
//      K-major), P = exp2(S scale log2e - lse log2e), dS = P (dP - delta)
//      scale in the fp32 fragments, rounded to bf16 in registers, and
//      dQ += dS K (wgmma_rs, K read MN-major as the forward reads V).
//      The prologue computes each row's delta = rowsum(dO o O) in fp32
//      and stores it for launch 2.
//   2. flash_bwd_dkdv_tc_kernel, one block per (128 keys, query head,
//      batch): the roles swapped.  K and V of the block's keys stay in
//      shared memory, Q and dO tiles of 64 queries (with their 64 lse
//      and delta values) stream through the ring.  S^T = K Q^T and dP^T =
//      V dO^T (wgmma_ss, K-major); P^T and dS^T are the register A
//      operands of dV += P^T dO and dK += dS^T Q, which read the same
//      streamed Q and dO tiles MN-major.  lse and delta belong to the
//      columns here: each thread reads its 16 columns' values from the
//      stage.  The block writes its query head's dK, dV as fp32 partials.
//   3. flash_bwd_group_sum_kernel sums the partials over the query heads
//      of each kv head in order and casts them once.  One block per
//      (key tile, query head) rather than one block per key tile looping
//      over the group: at the path's shape 800 blocks of ~19 tile steps
//      against 160 of ~93, which one block an SM (the accumulators need
//      more than 128 registers a thread) spreads over 132 SMs in ~6 even
//      waves instead of 1.2 uneven ones, for ~52 MB more partial traffic.
//      Measured with chip_smoke.py on an H100 SXM at 700 W while both
//      designs were built: dk/dv 230 us + sum 22 us against 281 + 4 us
//      with the loop over the group (PERF.md).
//   Arithmetic: products of bf16 values accumulate in fp32; P and dS
//   are rounded to bf16 before their products (as the forward rounds P);
//   dQ, dK and dV accumulate in fp32 registers over the whole loop and
//   are cast once.  A fully masked row (lse = NEG_INF) and a row past the
//   end take p = exp2(-inf) = 0.  Bound: 2e-2 of each gradient's
//   max|plain|.  Operands: 16-byte aligned data pointers and (b, s, h)
//   strides that are multiples of 8 elements (the wrapper raises
//   otherwise).
//
// fp32 -> two launches on the tensor cores in split TF32 (wgmma, sm_90a;
//   wgmma.cuh: hi = tf32(x), lo = tf32(x - hi), a product lo hi + hi lo +
//   hi hi, the small products first; S and dP (or S^T and dP^T) take
//   lo_a hi_b as one product of N = T and hi_a [hi_b | lo_b] as one of
//   N = 2T from a pair tile, as the forward's S): ~16.2 and ~21.6 ms at
//   the federated hymba-1.5b and minicpm3-4b rounds' (16, 2048, 25/5, 64,
//   window 1024) and (8, 2048, 40/40, (96, 64)), where IEEE fp32 on the
//   CUDA cores took 31.7-33.5 and 49.1-49.5 (PERF.md; the library's fp32
//   backward 22.2 ms at the latter).  FA2's split, not the bf16 route's three
//   launches: at these folded batches the grids are large (12 800 and
//   2 560 blocks at hymba's shape), so dK and dV are summed over the GQA
//   group in registers and no partials go to memory.
//   1. flash_bwd_dq_f32_kernel, one block per (64 query rows, head,
//      batch); Q and dO split once.  S = Q K^T and dP = dO V^T (both
//      operands in shared memory), dS = P (dP - delta) scale split in
//      registers as dQ += dS K's A operand, K staged transposed (TF32
//      wgmma reads K-major only); the accumulator's columns are taken in
//      the order 0 2 4 6 1 3 5 7 and K^T's rows staged in that order, so
//      no shuffle (frag_tf32).  delta = rowsum(dO o O) is stored for
//      launch 2.
//   2. flash_bwd_dkdv_f32_kernel, one block per (64 keys, kv head,
//      batch), over the query tiles of each query head of the group in
//      order: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK +=
//      dS^T Q with Q^T and dO^T staged transposed.  Every 256 queries
//      the sums leave the accumulators for dk and dv in fp32 (each block
//      owns its rows), and the accumulators restart at 0: a wgmma
//      accumulator drifts over a long chain (dK 4.3e-5 of its scale over
//      hymba's five heads of 1024 queries, 5.3e-5 at (1, 2048, 25/5, 64,
//      window 1024), against 2e-5 allowed; 5.0e-6 and 5.2e-6 with the
//      flush; H100).
//   Both: the streamed rows (K and V, or Q, dO, lse and delta) come by
//   cp.async into a raw fp32 ring of two stages, two tiles ahead of their
//   use, and are split from it: the products of a tile run while its
//   transposed operand is split, the next products' while the next tile
//   is.  Two warpgroups a block where shared memory holds them: they
//   share the own tiles (Q and dO, or K and V, split once) and take
//   alternate stream tiles, each with its own stages, barriers (named, a
//   warpgroup's 128 threads) and accumulators; their sums reach dq, dk
//   and dv in order, so the bits do not depend on timing.  Budget (Dqk,
//   Dv): warpgroups and tile rows T of launch 1, of launch 2; shared
//   memory a block; registers (ptxas): (32, 32) 2 x 32, 2 x 32; 118 272
//   and 134 400 B; 227 and 207.  (64, 64) 2 x 16, 2 x 16; 149 504 and
//   165 632 B; 194 and 201.  (80, 80) 2 x 16, 2 x 16; 186 368 and 206 592
//   B; 200 and 228.  (96, 96) 2 x 16, 1 x 16; 223 232 and 173 056 B; 233
//   and 240.  (128, 128) 1 x 16, 1 x 16; 214 272 and 230 400 B; 255 and
//   255 (124 bytes of spill stores in launch 2: off the main paths).
//   (96, 64) 2 x 16, 2 x 16; 190 464 and 206 592 B; 194 and 226.  (80,
//   64) 2 x 16, 2 x 16; 169 984 and 186 112 B; 181 and 208.  One block an
//   SM.  At (96, 64) two warpgroups took the backward from 41.2 ms (one,
//   T = 32 and 64) to 23.6 ms, the N = 2T products to 21.6 (H100).
//   Measured against the plain backward: 6e-7 to 5.7e-6 of each
//   gradient's max|plain| (bound 2e-5).  Operands: 16-byte aligned data
//   pointers and (b, s, h) strides that are multiples of 4 elements.
//
// Both: no atomics, so every call gives the same bits.  Masks: causal
// k <= q, sliding window k > q - window, both, or none; keys and queries
// past the sequence end are masked (a ragged tail).  A fully masked row
// has p = 0 and gets zero gradients.  Positions, as the forward's
// (flash_attention.cu, positions.cuh): where the caller passes the
// forward's (B, S) int32 q_pos and k_pos, k and q are positions, a key at
// a negative position is never attended, and every kernel is the POS
// instance of its template: the streamed tiles' range comes from the
// streamed side's positions (pos::reach: the keys' in dQ, the queries' in
// dK/dV), each tile is classified from its positions' range and the own
// rows' (skipped on the bf16 route, unmasked, or masked per element), and
// a block that sees no pair writes zero gradients.  A pad query's row has
// lse = NEG_INF, so its p is 0 on every branch (lse_log2).  The
// index-masked instances compile to the SASS of kernels with no position
// code at all; through the POS
// instances arange positions read 388.1-389.1 against 400.0 us (bf16,
// hymba-1.5b's train step) and 17876.6 against 16878.3-16881.9 us (fp32,
// the federated round's shape), and a pad of 1000 takes the bf16 route to
// 315.2 us (H100 at 700 W, tools/time_kernel.py).  The POS instances
// spill at (128, 128), off every path with positions (ptxas: dK/dV 168
// bytes bf16 and 184 fp32, dQ fp32 40).  Operands are read through their
// (b, s, h) strides (the head dim contiguous); dq, dk, dv are written
// contiguous; lse and delta are (B, H, S) fp32.  The (DQK, DV) pairs
// are the forward's: (32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
// (96, 64) and (80, 64).  On the bf16 route a head dim of 80 or 96 needs
// no layout of its own, as in the forward: a row is stored as column
// atoms of 64 entries under the 128-byte swizzle, so 80 is one full atom
// and 16 columns of a second (a 160-byte row, which no power-of-two
// swizzle covers, is never laid out whole); the k16 steps of S and dP
// walk the atoms (80 = 5 x 16), and the N = 80 or 96 products (dQ and dK
// at N = DQK, dV at N = DV) read their B tile MN-major with the atoms LBO
// apart, the form the forward's P V takes at DV = 80.  So the backward
// uses the wgmma forms the forward does: m64n64k16 with both operands in
// shared memory and m64nNk16 with A in registers (and their m64nNk8 TF32
// forms on the fp32 route, whose 32-byte swizzle needs no atoms).  The
// wgmma building blocks are in wgmma.cuh.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the launches, each checked; launches on the caller's
// stream, in order, and never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "positions.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is contiguous
};

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool allowed(int kp, int qp, int seq, int causal,
                                        int window) {
  bool ok = kp < seq && qp < seq;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// lse in units of log2(e), or +inf for a fully masked row (lse = NEG_INF),
// so that its p = exp2(s - inf) = 0 on every branch
__device__ __forceinline__ float lse_log2(float lse) {
  return lse <= 0.5f * kNegInf ? INFINITY : lse * kLog2e;
}

// ---------------------------------------------------------------------------
// fp32 route: tensor cores, split TF32 (wgmma, sm_90a)
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 64;      // the block's own rows
constexpr int kSmemMax = 232448;  // a block's dynamic shared memory, sm_90
// dK and dV leave the accumulators for their outputs every 256 queries
constexpr int kFlushQueries = 256;

// bytes of a tile of `rows` x `cols` fp32 entries as TF32 hi and lo
__host__ __device__ constexpr int split_bytes(int rows, int cols) {
  return 2 * 4 * rows * cols;
}

// launch 1 with W warpgroups: Q and dO (own, shared by the warpgroups),
// the rows' delta; for each warpgroup K and V tiles of T keys, K^T and two
// raw stages of T keys' K and V; 256 bytes of slack to align the base to
// the 256-byte period of the 32-byte swizzle
template <int DQK, int DV, int T, int W>
__host__ __device__ constexpr int dq_f32_bytes() {
  return split_bytes(kF32Rows, DQK + DV) + kF32Rows * 4
         + W * (split_bytes(T, DQK + DV) + split_bytes(DQK, T)
                + 2 * 4 * raw_floats<DQK, DV, T>()) + 256;
}
// launch 2: K and V (own, shared); for each warpgroup Q and dO tiles of T
// queries, Q^T and dO^T, and two raw stages of T queries' Q, dO, lse and
// delta
template <int DQK, int DV, int T, int W>
__host__ __device__ constexpr int dkdv_f32_bytes() {
  return split_bytes(kF32Rows, DQK + DV)
         + W * (2 * split_bytes(T, DQK + DV)
                + 2 * 4 * raw_floats<DQK, DV, T>()) + 256;
}
// Warpgroups a block: two, which share the own tiles and take alternate
// tiles of the stream (each with its own stages and accumulators), where
// a block's shared memory holds them at 16 rows a tile; else one
template <int DQK, int DV>
__host__ __device__ constexpr int dq_wgs() {
  return dq_f32_bytes<DQK, DV, 16, 2>() <= kSmemMax ? 2 : 1;
}
template <int DQK, int DV>
__host__ __device__ constexpr int dkdv_wgs() {
  return dkdv_f32_bytes<DQK, DV, 16, 2>() <= kSmemMax ? 2 : 1;
}
// keys a tile in launch 1: 32 where the block holds them, else 16 (the
// registers of S and dP, 3 T / 2 a thread each, bound it)
template <int DQK, int DV>
__host__ __device__ constexpr int dq_f32_keys() {
  return dq_f32_bytes<DQK, DV, 32, dq_wgs<DQK, DV>()>() <= kSmemMax ? 32
                                                                    : 16;
}
// queries a tile in launch 2: as many (the registers of S^T and dP^T,
// and of P^T and dS^T as hi and lo, beside dK and dV's DQK / 2 + DV / 2
// bound it at 32)
template <int DQK, int DV>
__host__ __device__ constexpr int dkdv_f32_queries() {
  constexpr int W = dkdv_wgs<DQK, DV>();
  return dkdv_f32_bytes<DQK, DV, 32, W>() <= kSmemMax ? 32 : 16;
}

// a barrier of warpgroup wg's 128 threads alone (named barrier wg + 1)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// 1. dq (and delta) per 64 query rows of one (batch, head)
template <int DQK, int DV, bool POS>
__global__ void __launch_bounds__(dq_wgs<DQK, DV>() * 128)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        Strides ds, int seq, int heads, int kv_heads,
                        int causal, int window, float scale,
                        float scale_log2, const int* __restrict__ qpos,
                        const int* __restrict__ kpos) {
  constexpr int W = dq_wgs<DQK, DV>(), T = dq_f32_keys<DQK, DV>();
  constexpr uint32_t kQ = kF32Rows * DQK * 4, kO = kF32Rows * DV * 4,
                     kK = T * DQK * 4, kV = T * DV * 4;
  constexpr int kRaw = raw_floats<DQK, DV, T>(), kStride = DQK + DV + 4;
  constexpr uint32_t kWg = 2 * kK + 2 * kV + 2 * kK + 2 * kRaw * 4;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qh = align256(smem_raw);
  uint8_t* const ql = qh + kQ;
  uint8_t* const oh = ql + kQ;   // dO
  uint8_t* const ol = oh + kO;
  float* const dl_s = reinterpret_cast<float*>(ol + kO);
  // K and V as pair tiles (a k8 slice's hi rows, then its lo rows)
  uint8_t* const kp = reinterpret_cast<uint8_t*>(dl_s + kF32Rows) + wg * kWg;
  uint8_t* const vp = kp + 2 * kK;
  uint8_t* const kth = vp + 2 * kV;  // K^T: [T / 8][DQK][32 B]
  uint8_t* const ktl = kth + kK;
  float* const raw = reinterpret_cast<float*>(ktl + kK);  // two stages
  const uint32_t sqh = smem_addr(qh), sql = sqh + kQ, soh = sql + kQ,
                 sol = soh + kO, skp = smem_addr(kp), svp = skp + 2 * kK,
                 skth = svp + 2 * kV, sktl = skth + kK, sraw = smem_addr(raw);

  // the longest query tiles (most key tiles under a causal mask) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kF32Rows;
  const int hk = h / (heads / kv_heads);
  const int warp = wt >> 5, lane = wt & 31;
  const int qa = q0 + warp * 16 + (lane >> 2);   // this thread's: qa, qa+8
  const int cq = 2 * (lane & 3);

  // the key tiles the mask can reach (with positions: from the keys'
  // positions, positions.cuh); warpgroup wg takes tiles first + wg, first
  // + wg + W, ...
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
  // K and V of the warpgroup's i-th tile t come by cp.async into its raw
  // stage i % 2, two tiles ahead of their use; their hi and lo tiles are
  // split from it
  auto fetch = [&](int t) {
    const int i = (t - first) / W;
    fetch_rows<DQK, DV, T>(sraw + (uint32_t)((i & 1) * kRaw) * 4u, kb, ks.s,
                           vb, vs.s, t * T, seq, wt);
  };
  if (first + wg <= last) fetch(first + wg);
  cp_async_commit();
  if (first + wg + W <= last) fetch(first + wg + W);
  cp_async_commit();
  if (W == 1 || wg == 0)
    stage_tf32<DQK, kF32Rows>(qh, ql, q + b * qs.b + h * qs.h, qs.s, q0,
                              seq, wt);
  if (W == 1 || wg == 1) {
    stage_tf32<DV, kF32Rows>(oh, ol, dout + b * ds.b + h * ds.h, ds.s, q0,
                             seq, wt);
    // delta = rowsum(dO o O) over DV in fp32: two threads a row, DV / 2
    // entries each by 16-byte loads
    const int r = wt >> 1, half = wt & 1, row = q0 + r;
    float acc = 0.0f;
    if (row < seq) {
      const float* dr = dout + b * ds.b + (int64_t)row * ds.s + h * ds.h
                        + half * (DV / 2);
      const float* orow = o + b * os.b + (int64_t)row * os.s + h * os.h
                          + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(dr) + c);
        const float4 y = __ldg(reinterpret_cast<const float4*>(orow) + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[r] = acc;
      if (row < seq) delta[((int64_t)b * heads + h) * seq + row] = acc;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (first + wg <= last) {
    split_raw<DQK, T, kStride, 0>(kp, raw, wt);
    split_raw<DV, T, kStride, DQK>(vp, raw, wt);
  }
  fence_proxy_async();
  __syncthreads();
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    dl[r] = dl_s[row - q0];
    l2[r] = row < seq ? lse_log2(lse[((int64_t)b * heads + h) * seq + row])
                      : INFINITY;
  }

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;

  // Per key tile: S's and dP's products run while K^T is split, dQ's
  // while the next K and V are split and the tile after is fetched; each
  // waits for its products before the warpgroup's barrier that hands its
  // tiles over.
  for (int t = first + wg, i = 0; t <= last; t += W, ++i) {
    const int k0 = t * T;
    const float* rst = raw + (i & 1) * kRaw;
    // S = Q K^T over DQK and dP = dO V^T over DV: lo_a hi_b into s and
    // dp, hi_a [hi_b | lo_b] into s2 and dp2 as N = 2T products (the own
    // hi tile read once for both), summed small terms first once in
    float s[T / 2], dp[T / 2], s2[T], dp2[T];
#pragma unroll
    for (int j = 0; j < T / 2; ++j) s[j] = dp[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j) s2[j] = dp2[j] = 0.0f;
    pin(s);
    pin(dp);
    pin(s2);
    pin(dp2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 8; ++kk) {
      const uint32_t a = kk * kF32Rows * 32, bo = kk * 2 * T * 32;
      wgmma_tf32(s, kmajor32_desc(sql + a), kmajor32_desc(skp + bo), kk > 0);
      wgmma_tf32(s2, kmajor32_desc(sqh + a), kmajor32_desc(skp + bo),
                 kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 8; ++kk) {
      const uint32_t a = kk * kF32Rows * 32, bo = kk * 2 * T * 32;
      wgmma_tf32(dp, kmajor32_desc(sol + a), kmajor32_desc(svp + bo),
                 kk > 0);
      wgmma_tf32(dp2, kmajor32_desc(soh + a), kmajor32_desc(svp + bo),
                 kk > 0);
    }
    wgmma_commit();
    split_raw_t<DQK, T, kStride, 0>(kth, ktl, rst, wt);
    fence_proxy_async();
    wgmma_wait_all();
    pin(s);
    pin(dp);
    pin(s2);
    pin(dp2);
    wg_sync(wg);  // K^T of t is in; K and V of t are read
#pragma unroll
    for (int j = 0; j < T / 2; ++j) {
      s[j] = (s[j] + s2[j + T / 2]) + s2[j];
      dp[j] = (dp[j] + dp2[j + T / 2]) + dp2[j];
    }

    // dS = P (dP - delta) scale on the fragments: s[j] is row qa + 8
    // ((j >> 1) & 1), key k0 + 8 (j >> 2) + cq + (j & 1)
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
#pragma unroll
    for (int j = 0; j < T / 2; ++j) {
      const int r = (j >> 1) & 1;
      float p = exp2f(fmaf(s[j], scale_log2, -l2[r]));
      if (edge && !(POS ? pos::allowed(kv[POS ? 2 * (j >> 2) + (j & 1) : 0],
                                       qv[r], causal, window)
                        : allowed(k0 + 8 * (j >> 2) + cq + (j & 1),
                                  qa + 8 * r, seq, causal, window)))
        p = 0.0f;
      s[j] = p * (dp[j] - dl[r]) * scale;
    }
    uint32_t dh[T / 8][4], dlo[T / 8][4];
#pragma unroll
    for (int j = 0; j < T / 8; ++j) frag_tf32(s + 4 * j, dh[j], dlo[j]);

    // dQ += dS K over DQK, 8 keys a product, K^T's block j the B operand
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      wgmma_tf32(acc, dlo[j], kmajor32_desc(skth + j * DQK * 32));
      wgmma_tf32(acc, dh[j], kmajor32_desc(sktl + j * DQK * 32));
    }
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
      wgmma_tf32(acc, dh[j], kmajor32_desc(skth + j * DQK * 32));
    wgmma_commit();
    if (t + W <= last) {
      cp_async_wait_all();
      wg_sync(wg);  // tile t+W is in; tile t's stage is read
      if (t + 2 * W <= last) fetch(t + 2 * W);
      cp_async_commit();
      const float* nx = raw + ((i + 1) & 1) * kRaw;
      split_raw<DQK, T, kStride, 0>(kp, nx, wt);
      split_raw<DV, T, kStride, DQK>(vp, nx, wt);
      fence_proxy_async();
    }
    wgmma_wait_all();
    pin(acc);
    wg_sync(wg);  // K and V of t+W are in; K^T of t is read
  }

  // the warpgroups' sums, in order
#pragma unroll
  for (int g = 0; g < W; ++g) {
    if (W > 1) __syncthreads();
    if (wg != g) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qa + 8 * r;
      if (row >= seq) continue;
      float2* drow = reinterpret_cast<float2*>(
          dq + (((int64_t)b * seq + row) * heads + h) * DQK + cq);
#pragma unroll
      for (int j = 0; j < DQK / 8; ++j) {
        float2 x = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        if (g > 0) {
          const float2 y = drow[4 * j];
          x.x += y.x;
          x.y += y.y;
        }
        drow[4 * j] = x;
      }
    }
  }
}

// 2. dk, dv per 64 keys of one kv head, summed over its query heads
template <int DQK, int DV, bool POS>
__global__ void __launch_bounds__(dkdv_wgs<DQK, DV>() * 128)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Strides qs, Strides ks, Strides vs, Strides ds,
                          int seq, int heads, int kv_heads, int causal,
                          int window, float scale, float scale_log2,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos) {
  constexpr int W = dkdv_wgs<DQK, DV>(), T = dkdv_f32_queries<DQK, DV>();
  constexpr uint32_t kK = kF32Rows * DQK * 4, kV = kF32Rows * DV * 4,
                     kQ = T * DQK * 4, kO = T * DV * 4;
  constexpr int kRaw = raw_floats<DQK, DV, T>(), kStride = DQK + DV + 4;
  constexpr uint32_t kWg = 4 * kQ + 4 * kO + 2 * kRaw * 4;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const kh = align256(smem_raw);
  uint8_t* const kl = kh + kK;
  uint8_t* const vh = kl + kK;
  uint8_t* const vl = vh + kV;
  // Q and dO as pair tiles (a k8 slice's hi rows, then its lo rows)
  uint8_t* const qp = vl + kV + wg * kWg;
  uint8_t* const op = qp + 2 * kQ;  // dO
  uint8_t* const qth = op + 2 * kO;  // Q^T: [T / 8][DQK][32 B]
  uint8_t* const qtl = qth + kQ;
  uint8_t* const oth = qtl + kQ;   // dO^T: [T / 8][DV][32 B]
  uint8_t* const otl = oth + kO;
  // two raw stages: a step's Q and dO rows, then its lse and delta
  float* const raw = reinterpret_cast<float*>(otl + kO);
  const uint32_t skh = smem_addr(kh), skl = skh + kK, svh = skl + kK,
                 svl = svh + kV, sqp = smem_addr(qp), sop = sqp + 2 * kQ,
                 sqth = sop + 2 * kO, sqtl = sqth + kQ, soth = sqtl + kQ,
                 sotl = soth + kO, sraw = smem_addr(raw);

  // key tiles in order: under a causal mask the first see the most
  // queries
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kF32Rows;
  const int group = heads / kv_heads;
  const int warp = wt >> 5, lane = wt & 31;
  const int ka = k0 + warp * 16 + (lane >> 2);   // this thread's: ka, ka+8
  const int cq = 2 * (lane & 3);

  // the query tiles whose rows see the block's keys (with positions: from
  // the queries' positions, positions.cuh), for each query head of the
  // group in order: step it is head hk * group + it / nt, tile first + it
  // % nt; warpgroup wg takes steps wg, wg + W, ...
  int lo = 0, hi = seq - 1;
  if (causal) lo = k0;
  if (window > 0) hi = min(hi, k0 + kF32Rows - 1 + window - 1);
  int first = lo / T, nt = hi / T - first + 1;
  [[maybe_unused]] pos::Span own;
  [[maybe_unused]] int kv[2];
  if constexpr (POS) {
    __shared__ int reach_s[2];
    qpos += (int64_t)b * seq;
    kpos += (int64_t)b * seq;
    own = pos::warp_span<kF32Rows, true>(kpos, k0, seq, lane);
    const int2 r = pos::reach<false, T>(qpos, seq, own, causal, window,
                                        reach_s);
    first = r.x;
    nt = r.y - r.x + 1;
    kv[0] = pos::at(kpos, ka, seq);
    kv[1] = pos::at(kpos, ka + 8, seq);
  }
  const int steps = group * nt;
  // the warpgroup's i-th step's Q and dO rows, lse and delta by cp.async
  // into its raw stage i % 2, two steps ahead of their use (zeros past
  // the end, where the mask holds p at 0)
  auto fetch = [&](int it) {
    const int h = hk * group + it / nt, q0 = (first + it % nt) * T;
    const uint32_t dst = sraw + (uint32_t)((((it - wg) / W) & 1) * kRaw) * 4u;
    fetch_rows<DQK, DV, T>(dst, q + b * qs.b + h * qs.h, qs.s,
                           dout + b * ds.b + h * ds.h, ds.s, q0, seq, wt);
    if (wt < 2 * T) {
      const int c = wt % T, which = wt / T;
      const bool ok = q0 + c < seq;
      const int64_t rix = ((int64_t)b * heads + h) * seq + (ok ? q0 + c : 0);
      cp_async4(dst + (uint32_t)(T * kStride + wt) * 4u,
                (which ? delta : lse) + rix, ok);
    }
  };
  if (wg < steps) fetch(wg);
  cp_async_commit();
  if (wg + W < steps) fetch(wg + W);
  cp_async_commit();
  if (W == 1 || wg == 0)
    stage_tf32<DQK, kF32Rows>(kh, kl, k + b * ks.b + hk * ks.h, ks.s, k0,
                              seq, wt);
  if (W == 1 || wg == 1)
    stage_tf32<DV, kF32Rows>(vh, vl, v + b * vs.b + hk * vs.h, vs.s, k0,
                             seq, wt);
  cp_async_wait_all();
  __syncthreads();
  if (wg < steps) {
    split_raw<DQK, T, kStride, 0>(qp, raw, wt);
    split_raw<DV, T, kStride, DQK>(op, raw, wt);
  }
  fence_proxy_async();
  __syncthreads();

  float dka[DQK / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dka[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.0f;

  // Per step: S^T's and dP^T's products run while Q^T and dO^T are
  // split, dK's and dV's while the next Q and dO are split and the step
  // after is fetched.  In round r the warpgroups take steps r W .. r W +
  // W - 1.
  // with positions a block may see no query: one round then writes its
  // zero dK and dV
  const int rounds = POS ? max((steps + W - 1) / W, 1) : (steps + W - 1) / W;
  constexpr int kFlushRounds = kFlushQueries / T;
  for (int r = 0; r < rounds; ++r) {
    const int it = r * W + wg;
    if (it < steps) {
      const int q0 = (first + it % nt) * T;
      const float* rst = raw + (r & 1) * kRaw;
      // S^T = K Q^T over DQK and dP^T = V dO^T over DV: lo_a hi_b into s
      // and dp, hi_a [hi_b | lo_b] into s2 and dp2 as N = 2T products
      float s[T / 2], dp[T / 2], s2[T], dp2[T];
#pragma unroll
      for (int i = 0; i < T / 2; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < T; ++i) s2[i] = dp2[i] = 0.0f;
      pin(s);
      pin(dp);
      pin(s2);
      pin(dp2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 8; ++kk) {
        const uint32_t a = kk * kF32Rows * 32, bo = kk * 2 * T * 32;
        wgmma_tf32(s, kmajor32_desc(skl + a), kmajor32_desc(sqp + bo),
                   kk > 0);
        wgmma_tf32(s2, kmajor32_desc(skh + a), kmajor32_desc(sqp + bo),
                   kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 8; ++kk) {
        const uint32_t a = kk * kF32Rows * 32, bo = kk * 2 * T * 32;
        wgmma_tf32(dp, kmajor32_desc(svl + a), kmajor32_desc(sop + bo),
                   kk > 0);
        wgmma_tf32(dp2, kmajor32_desc(svh + a), kmajor32_desc(sop + bo),
                   kk > 0);
      }
      wgmma_commit();
      split_raw_t<DQK, T, kStride, 0>(qth, qtl, rst, wt);
      split_raw_t<DV, T, kStride, DQK>(oth, otl, rst, wt);
      fence_proxy_async();
      wgmma_wait_all();
      pin(s);
      pin(dp);
      pin(s2);
      pin(dp2);
      wg_sync(wg);  // Q^T and dO^T of this step are in; Q and dO read
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        s[i] = (s[i] + s2[i + T / 2]) + s2[i];
        dp[i] = (dp[i] + dp2[i + T / 2]) + dp2[i];
      }

      // P^T and dS^T on the fragments: s[4 jb + 2 r + e] is key ka + 8 r,
      // query q0 + 8 jb + cq + e, whose lse and delta are in the stage
      [[maybe_unused]] int cls = pos::kEdge;
      if constexpr (POS)
        cls = pos::classify(pos::warp_span<T, false>(qpos, q0, seq, lane),
                            own, causal, window);
      const bool edge = POS ? cls != pos::kClean
                            : (causal && k0 + kF32Rows - 1 > q0) ||
                                  (window > 0 && k0 <= q0 + T - 1 - window) ||
                                  q0 + T > seq || k0 + kF32Rows > seq;
      [[maybe_unused]] int qc[POS ? T / 4 : 1];
      if constexpr (POS) {
        if (edge) {
#pragma unroll
          for (int i = 0; i < T / 4; ++i)
            qc[i] = pos::at(qpos, q0 + 8 * (i >> 1) + cq + (i & 1), seq);
        }
      }
      const float* ls = rst + T * kStride;
      const float* dls = ls + T;
#pragma unroll
      for (int jb = 0; jb < T / 8; ++jb) {
        const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * jb + cq);
        const float2 lc = make_float2(lse_log2(lv.x), lse_log2(lv.y));
        const float2 dc =
            *reinterpret_cast<const float2*>(dls + 8 * jb + cq);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jb + 2 * rr + e;
            float p = exp2f(fmaf(s[i], scale_log2, e ? -lc.y : -lc.x));
            if (edge && !(POS ? pos::allowed(kv[rr],
                                             qc[POS ? 2 * jb + e : 0],
                                             causal, window)
                              : allowed(ka + 8 * rr, q0 + 8 * jb + cq + e,
                                        seq, causal, window)))
              p = 0.0f;
            dp[i] = p * (dp[i] - (e ? dc.y : dc.x)) * scale;
            s[i] = p;
          }
        }
      }
      uint32_t ph[T / 8][4], pl[T / 8][4], dh[T / 8][4], dlo[T / 8][4];
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        frag_tf32(s + 4 * j, ph[j], pl[j]);
        frag_tf32(dp + 4 * j, dh[j], dlo[j]);
      }

      // dV += P^T dO over DV and dK += dS^T Q over DQK, 8 queries a
      // product, the transposed tiles' block j the B operand
      pin(dka);
      pin(dva);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        wgmma_tf32(dva, pl[j], kmajor32_desc(soth + j * DV * 32));
        wgmma_tf32(dva, ph[j], kmajor32_desc(sotl + j * DV * 32));
        wgmma_tf32(dka, dlo[j], kmajor32_desc(sqth + j * DQK * 32));
        wgmma_tf32(dka, dh[j], kmajor32_desc(sqtl + j * DQK * 32));
      }
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        wgmma_tf32(dva, ph[j], kmajor32_desc(soth + j * DV * 32));
        wgmma_tf32(dka, dh[j], kmajor32_desc(sqth + j * DQK * 32));
      }
      wgmma_commit();
      if (it + W < steps) {
        cp_async_wait_all();
        wg_sync(wg);  // step it+W is in; step it's stage is read
        if (it + 2 * W < steps) fetch(it + 2 * W);
        cp_async_commit();
        const float* nx = raw + ((r + 1) & 1) * kRaw;
        split_raw<DQK, T, kStride, 0>(qp, nx, wt);
        split_raw<DV, T, kStride, DQK>(op, nx, wt);
        fence_proxy_async();
      }
      wgmma_wait_all();
      pin(dka);
      pin(dva);
      wg_sync(wg);  // the next Q and dO are in; Q^T and dO^T are read
    }
    // every kFlushQueries queries of each warpgroup and at the end, the
    // sums so far into dk and dv in fp32, warpgroup by warpgroup (each
    // block owns its rows: no atomics), and the accumulators restart from
    // 0: a wgmma accumulator drifts over a long chain of additions (dK
    // 4.3e-5 of its scale over hymba-1.5b's five heads of 1024 queries on
    // an H100, against ~1e-6 for dQ's 1024 keys)
    if ((r + 1) % kFlushRounds == 0 || r + 1 == rounds) {
#pragma unroll
      for (int g = 0; g < W; ++g) {
        if (W > 1) __syncthreads();
        if (wg != g) continue;
        const bool add = g > 0 || r >= kFlushRounds;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = ka + 8 * rr;
          if (row >= seq) continue;
          const int64_t off = ((int64_t)b * seq + row) * kv_heads + hk;
          float2* krow = reinterpret_cast<float2*>(dk + off * DQK + cq);
          float2* vrow = reinterpret_cast<float2*>(dv + off * DV + cq);
#pragma unroll
          for (int j = 0; j < DQK / 8; ++j) {
            float2 x = make_float2(dka[4 * j + 2 * rr],
                                   dka[4 * j + 2 * rr + 1]);
            if (add) {
              const float2 y = krow[4 * j];
              x.x += y.x;
              x.y += y.y;
            }
            krow[4 * j] = x;
          }
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            float2 x = make_float2(dva[4 * j + 2 * rr],
                                   dva[4 * j + 2 * rr + 1]);
            if (add) {
              const float2 y = vrow[4 * j];
              x.x += y.x;
              x.y += y.y;
            }
            vrow[4 * j] = x;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < DQK / 2; ++i) dka[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) dva[i] = 0.0f;
    }
  }
}

template <int DQK, int DV>
constexpr int f32_dq_smem() {
  return dq_f32_bytes<DQK, DV, dq_f32_keys<DQK, DV>(), dq_wgs<DQK, DV>()>();
}
template <int DQK, int DV>
constexpr int f32_dkdv_smem() {
  return dkdv_f32_bytes<DQK, DV, dkdv_f32_queries<DQK, DV>(),
                        dkdv_wgs<DQK, DV>()>();
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int DQK, int DV, bool POS>
int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, Strides qs,
               Strides ks, Strides vs, Strides os, Strides ds, int batch,
               int seq, int heads, int kv_heads, int causal, int window,
               float scale, const int* qpos, const int* kpos,
               cudaStream_t stream) {
  constexpr int smem_dq = f32_dq_smem<DQK, DV>();
  constexpr int smem_kv = f32_dkdv_smem<DQK, DV>();
  static_assert(smem_dq <= kSmemMax && smem_kv <= kSmemMax, "smem");
  auto kdq = flash_bwd_dq_f32_kernel<DQK, DV, POS>;
  auto kkv = flash_bwd_dkdv_f32_kernel<DQK, DV, POS>;
  cudaError_t e = allow_smem(kdq, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(kkv, smem_kv);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (seq + kF32Rows - 1) / kF32Rows;
  const float scale_log2 = scale * kLog2e;
  constexpr int threads_dq = dq_wgs<DQK, DV>() * 128;
  constexpr int threads_kv = dkdv_wgs<DQK, DV>() * 128;
  kdq<<<dim3(heads, batch, tiles), threads_dq, smem_dq, stream>>>(
      q, k, v, o, dout, lse, delta, dq, qs, ks, vs, os, ds, seq, heads,
      kv_heads, causal, window, scale, scale_log2, qpos, kpos);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3(kv_heads, batch, tiles), threads_kv, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, ds, seq, heads,
      kv_heads, causal, window, scale, scale_log2, qpos, kpos);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma)
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;    // the block's own rows: two warpgroups of 64
constexpr int kTcTile = 64;     // rows of a streamed tile
constexpr int kTcThreads = 256;
constexpr int kStages = 3;      // ring: tile t+1 loads while tile t
                                // multiplies and the products of t-1 drain
// rows [r0, r0 + ROWS) of a (B, S, H, D) operand at one (b, h) into a
// swizzled tile; rows past the end read as zeros.  D / 8 chunks a row
// need not divide evenly among the threads (D = 80, 64 rows: 640 chunks).
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int64_t ss, int r0, int seq,
                                          int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kTcThreads - 1) / kTcThreads; ++i) {
    const int idx = tid + i * kTcThreads;
    if (kTotal % kTcThreads != 0 && idx >= kTotal) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r0 + r < seq;
    const int64_t p = ok ? r0 + r : 0;
    cp_async16(dst + swz(ROWS, r, c), src + p * ss + c * 8, ok);
  }
}

// rows [r0, r0 + ROWS) of two operands, the first at head dim DA, the
// second at DB.  With one head dim whose chunks divide evenly among the
// threads, one loop issues both copies of a chunk, its index arithmetic
// and bounds test once (as the forward's load_kv); otherwise one loop each.
// Two loops for the first case too made the whole backward 4% slower at
// hymba's training shape on an H100 (tools/time_kernel.py).
template <int DA, int DB, int ROWS>
__device__ __forceinline__ void load_pair(uint32_t sa, uint32_t sb,
                                          const bf16* a, const bf16* b,
                                          int64_t ass, int64_t bss, int r0,
                                          int seq, int tid) {
  constexpr int kChunks = DA / 8;
  if constexpr (DA == DB && ROWS * kChunks % kTcThreads == 0) {
#pragma unroll
    for (int i = 0; i < ROWS * kChunks / kTcThreads; ++i) {
      const int idx = tid + i * kTcThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const bool ok = r0 + r < seq;
      const int64_t p = ok ? r0 + r : 0;
      cp_async16(sa + swz(ROWS, r, c), a + p * ass + c * 8, ok);
      cp_async16(sb + swz(ROWS, r, c), b + p * bss + c * 8, ok);
    }
  } else {
    load_rows<DA, ROWS>(sa, a, ass, r0, seq, tid);
    load_rows<DB, ROWS>(sb, b, bss, r0, seq, tid);
  }
}

template <int D>
__host__ __device__ constexpr uint32_t own_bytes() {  // one 128-row tile
  return ((D + 63) / 64) * kTcRows * kSwRow;
}
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {  // one 64-row tile
  return ((D + 63) / 64) * kTcTile * kSwRow;
}
// two own tiles (one at DQK, one at DV), a ring of kStages tiles at each
// head dim, then `extra` bytes of fp32 side values; 1024 bytes of slack
// to align the base to the swizzle's 1024-byte period
template <int DQK, int DV>
constexpr int tc_smem_bytes(int extra) {
  return (int)(own_bytes<DQK>() + own_bytes<DV>()
               + kStages * (tile_bytes<DQK>() + tile_bytes<DV>()))
         + extra + 1024;
}
template <int DQK, int DV>
constexpr int dq_smem_bytes() { return tc_smem_bytes<DQK, DV>(kTcRows * 4); }
template <int DQK, int DV>
constexpr int dkdv_smem_bytes() {
  return tc_smem_bytes<DQK, DV>(2 * kStages * kTcTile * 4);
}

// k16 steps of the S and dP products: the longer head dim's; the shorter
// product skips the steps past its own (the loop is unrolled, so the test
// is resolved at compile time)
template <int DQK, int DV>
__host__ __device__ constexpr int k_steps() {
  return (DQK > DV ? DQK : DV) / 16;
}

// 1. dq (and delta) per 128 query rows of one (batch, head)
template <int DQK, int DV, bool POS>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       Strides ds, int seq, int heads, int kv_heads,
                       int causal, int window, float scale,
                       float scale_log2, const int* __restrict__ qpos,
                       const int* __restrict__ kpos) {
  constexpr uint32_t kTileK = tile_bytes<DQK>(), kTileV = tile_bytes<DV>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = sq + own_bytes<DQK>(),
                 sk = sdo + own_bytes<DV>(), sv = sk + kStages * kTileK;
  float* dl_s = reinterpret_cast<float*>(
      smem_raw + (sv + kStages * kTileV - smem_addr(smem_raw)));

  // the longest query tiles (most key tiles under a causal mask) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int w0 = q0 + wg * 64;                   // the warpgroup's rows
  const int qa = w0 + warp * 16 + (lane >> 2);   // this thread's: qa, qa+8
  const int cq = 2 * (lane & 3);

  load_pair<DQK, DV, kTcRows>(sq, sdo, q + b * qs.b + h * qs.h,
                              dout + b * ds.b + h * ds.h, qs.s, ds.s, q0,
                              seq, tid);
  cp_async_commit();

  // the key tiles the mask can reach from the block's rows, and from this
  // warpgroup's (with positions: from the keys' positions, positions.cuh)
  int lo = 0, hi = seq - 1, wlo = 0, whi = seq - 1;
  if (window > 0) {
    lo = max(0, q0 - window + 1);
    wlo = max(0, w0 - window + 1);
  }
  if (causal) {
    hi = min(hi, q0 + kTcRows - 1);
    whi = min(whi, w0 + 63);
  }
  int first = lo / kTcTile, last = hi / kTcTile;
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
    const int2 r = pos::reach<true, kTcTile>(kpos, seq, own, causal, window,
                                             reach_s);
    first = r.x;
    last = r.y;
    qv[0] = pos::at(qpos, qa, seq);
    qv[1] = pos::at(qpos, qa + 8, seq);
  }
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  if (!POS || first <= last)
    load_pair<DQK, DV, kTcTile>(sk, sv, kb, vb, ks.s, vs.s, first * kTcTile,
                                seq, tid);
  cp_async_commit();

  // delta = rowsum(dO o O) over DV in fp32 while the tiles load: two
  // threads a row, DV/2 entries each by 16-byte loads
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.0f;
    if (row < seq) {
      const bf16* dr = dout + b * ds.b + (int64_t)row * ds.s + h * ds.h
                       + half * (DV / 2);
      const bf16* orow = o + b * os.b + (int64_t)row * os.s + h * os.h
                         + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 16; ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(dr + 8 * c);
        const uint4 y = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]);
          const float2 yf = __bfloat1622float2(yp[e]);
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[r] = acc;
      if (row < seq) delta[((int64_t)b * heads + h) * seq + row] = acc;
    }
  }
  __syncthreads();
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    dl[r] = dl_s[row - q0];
    l2[r] = row < seq ? lse_log2(lse[((int64_t)b * heads + h) * seq + row])
                      : INFINITY;
  }

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;

  // Ring stage of tile t: (t - first) % 3.  At iteration t the block
  // loads tile t+1 into the stage tile t-2 used; each warpgroup waited for
  // its dQ product of t-2 at iteration t-1, before this iteration's
  // barrier, so the product of t-1 may still run while tile t+1 loads.
  for (int t = first; t <= last; ++t) {
    const uint32_t stage = (uint32_t)((t - first) % kStages);
    const uint32_t stk = stage * kTileK, stv = stage * kTileV;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (t < last) {
      const uint32_t nx = (uint32_t)((t + 1 - first) % kStages);
      load_pair<DQK, DV, kTcTile>(sk + nx * kTileK, sv + nx * kTileV, kb, vb,
                                  ks.s, vs.s, (t + 1) * kTcTile, seq, tid);
      cp_async_commit();
    }
    const int k0 = t * kTcTile;
    [[maybe_unused]] int cls = pos::kEdge;
    if constexpr (POS)
      cls = pos::classify(wown, pos::warp_span<kTcTile, true>(kpos, k0, seq,
                                                             lane),
                          causal, window);
    if (POS ? cls == pos::kSkip
            : w0 >= seq || k0 > whi || k0 + kTcTile - 1 < wlo) {
      wgmma_wait_all();  // a skipped tile still retires the last product
      continue;
    }

    // S = Q K^T over DQK and dP = dO V^T over DV, 16 columns a wgmma
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k_steps<DQK, DV>(); ++kk) {
      const uint32_t col = (kk & 3) * 32;
      const uint32_t own = (kk >> 2) * kTcRows * kSwRow + wg * 64 * kSwRow
                           + col;
      const uint32_t tile = (kk >> 2) * kTcTile * kSwRow + col;
      if (kk < DQK / 16)
        wgmma_ss(s, kmajor_desc(sq + own), kmajor_desc(sk + stk + tile),
                 kk > 0);
      if (kk < DV / 16)
        wgmma_ss(dp, kmajor_desc(sdo + own), kmajor_desc(sv + stv + tile),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();  // S and dP of t, and the dQ product of t-1
    pin(s);
    pin(dp);
    pin(acc);

    // dS = P (dP - delta) scale on the fragments, packed to bf16: s[i]
    // is row qa + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + cq + (i & 1)
    const bool edge = POS ? cls == pos::kEdge
                          : (causal && k0 + kTcTile - 1 > w0) ||
                                (window > 0 && k0 <= w0 + 63 - window) ||
                                k0 + kTcTile > seq;
    [[maybe_unused]] int kv[POS ? kTcTile / 4 : 1];
    if constexpr (POS) {
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTcTile / 4; ++i)
          kv[i] = pos::at(kpos, k0 + 8 * (i >> 1) + cq + (i & 1), seq);
      }
    }
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = (i >> 1) & 1;
        float p = fast_exp2(fmaf(s[i + e], scale_log2, -l2[r]));
        if (edge && !(POS ? pos::allowed(kv[POS ? 2 * (i >> 2) + e : 0],
                                         qv[r], causal, window)
                          : allowed(k0 + 8 * (i >> 2) + cq + e, qa + 8 * r,
                                    seq, causal, window)))
          p = 0.0f;
        d[e] = p * (dp[i + e] - dl[r]) * scale;
      }
      da[i >> 1] = pack_bf16(d[0], d[1]);
    }

    // dQ += dS K (wgmma N = DQK), 16 keys a wgmma: K's rows 16j.. read
    // MN-major
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcTile / 16; ++j) {
      const uint32_t a[4] = {da[4 * j], da[4 * j + 1], da[4 * j + 2],
                             da[4 * j + 3]};
      wgmma_rs(acc, a,
               sw128_desc(sk + stk + j * 16 * kSwRow, kTcTile * kSwRow,
                          8 * kSwRow));
    }
    wgmma_commit();  // left in flight: waited for with the next S
  }
  wgmma_wait_all();
  pin(acc);
  if constexpr (POS) cp_async_wait_all();  // Q's and dO's, where no tile ran

  if (w0 >= seq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    if (row >= seq) continue;
    bf16* drow = dq + (((int64_t)b * seq + row) * heads + h) * DQK + cq;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// 2. dk, dv per 128 keys and one query head, as fp32 partials
template <int DQK, int DV, bool POS>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk_part,
                         float* __restrict__ dv_part, Strides qs,
                         Strides ks, Strides vs, Strides ds, int seq,
                         int heads, int kv_heads, int causal, int window,
                         float scale, float scale_log2,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kpos) {
  constexpr uint32_t kTileQ = tile_bytes<DQK>(), kTileO = tile_bytes<DV>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = sk + own_bytes<DQK>(),
                 sq = sv + own_bytes<DV>(), sdo = sq + kStages * kTileQ;
  const uint32_t sside = sdo + kStages * kTileO;  // lse, then delta
  const float* side = reinterpret_cast<const float*>(
      smem_raw + (sside - smem_addr(smem_raw)));

  // key tiles in order: under a causal mask the first see the most
  // queries
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTcRows;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int w0 = k0 + wg * 64;                   // the warpgroup's keys
  const int ka = w0 + warp * 16 + (lane >> 2);   // this thread's: ka, ka+8
  const int cq = 2 * (lane & 3);

  load_pair<DQK, DV, kTcRows>(sk, sv, k + b * ks.b + hk * ks.h,
                              v + b * vs.b + hk * vs.h, ks.s, vs.s, k0, seq,
                              tid);
  cp_async_commit();

  // the query tiles whose rows see the block's keys, and this
  // warpgroup's (with positions: from the queries' positions,
  // positions.cuh)
  int lo = 0, hi = seq - 1, wlo = 0, whi = seq - 1;
  if (causal) {
    lo = k0;
    wlo = w0;
  }
  if (window > 0) {
    hi = min(hi, k0 + kTcRows - 1 + window - 1);
    whi = min(whi, w0 + 63 + window - 1);
  }
  int first = lo / kTcTile, last = hi / kTcTile;
  [[maybe_unused]] pos::Span wown;
  [[maybe_unused]] int kv[2];
  if constexpr (POS) {
    __shared__ int reach_s[2];
    qpos += (int64_t)b * seq;
    kpos += (int64_t)b * seq;
    const pos::Span own = pos::warp_span<kTcRows, true>(kpos, k0, seq, lane);
    wown = pos::warp_span<64, true>(kpos, w0, seq, lane);
    const int2 r = pos::reach<false, kTcTile>(qpos, seq, own, causal, window,
                                              reach_s);
    first = r.x;
    last = r.y;
    kv[0] = pos::at(kpos, ka, seq);
    kv[1] = pos::at(kpos, ka + 8, seq);
  }
  const int64_t rbase = ((int64_t)b * heads + h) * seq;
  // query tile t's Q and dO, and its 64 lse and delta values, into a ring
  // stage
  auto load_tile = [&](int t, int stage) {
    load_pair<DQK, DV, kTcTile>(sq + (uint32_t)stage * kTileQ,
                                sdo + (uint32_t)stage * kTileO,
                                q + b * qs.b + h * qs.h,
                                dout + b * ds.b + h * ds.h, qs.s, ds.s,
                                t * kTcTile, seq, tid);
    if (tid < 2 * kTcTile) {
      const int c = tid % kTcTile, which = tid / kTcTile;
      const bool ok = t * kTcTile + c < seq;
      const float* src = (which ? delta : lse) + rbase
                         + (ok ? t * kTcTile + c : 0);
      cp_async4(sside + (uint32_t)((which * kStages + stage) * kTcTile + c)
                            * 4u, src, ok);
    }
  };
  if (!POS || first <= last) load_tile(first, 0);
  cp_async_commit();

  float dka[DQK / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dka[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.0f;

  // the ring as in launch 1: the dK, dV products of t-1 may still run
  // while t+1 loads
  for (int t = first; t <= last; ++t) {
    const int stage = (t - first) % kStages;
    const uint32_t stq = (uint32_t)stage * kTileQ,
                   sto = (uint32_t)stage * kTileO;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (t < last) {
      load_tile(t + 1, (t + 1 - first) % kStages);
      cp_async_commit();
    }
    const int q0 = t * kTcTile;
    [[maybe_unused]] int cls = pos::kEdge;
    if constexpr (POS)
      cls = pos::classify(pos::warp_span<kTcTile, false>(qpos, q0, seq,
                                                         lane),
                          wown, causal, window);
    if (POS ? cls == pos::kSkip
            : w0 >= seq || q0 > whi || q0 + kTcTile - 1 < wlo) {
      wgmma_wait_all();
      continue;
    }

    // S^T = K Q^T over DQK and dP^T = V dO^T over DV
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k_steps<DQK, DV>(); ++kk) {
      const uint32_t col = (kk & 3) * 32;
      const uint32_t own = (kk >> 2) * kTcRows * kSwRow + wg * 64 * kSwRow
                           + col;
      const uint32_t tile = (kk >> 2) * kTcTile * kSwRow + col;
      if (kk < DQK / 16)
        wgmma_ss(s, kmajor_desc(sk + own), kmajor_desc(sq + stq + tile),
                 kk > 0);
      if (kk < DV / 16)
        wgmma_ss(dp, kmajor_desc(sv + own), kmajor_desc(sdo + sto + tile),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();  // S^T and dP^T of t, and the products of t-1
    pin(s);
    pin(dp);
    pin(dka);
    pin(dva);

    // P^T and dS^T on the fragments, packed to bf16; the columns are
    // queries, their lse and delta from the stage
    const bool edge = POS ? cls == pos::kEdge
                          : (causal && w0 + 63 > q0) ||
                                (window > 0 &&
                                 w0 <= q0 + kTcTile - 1 - window) ||
                                q0 + kTcTile > seq || w0 + 64 > seq;
    [[maybe_unused]] int qc[POS ? kTcTile / 4 : 1];
    if constexpr (POS) {
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTcTile / 4; ++i)
          qc[i] = pos::at(qpos, q0 + 8 * (i >> 1) + cq + (i & 1), seq);
      }
    }
    const float* ls = side + stage * kTcTile;
    const float* dls = side + (kStages + stage) * kTcTile;
    uint32_t pa[16], da[16];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * jb + cq);
      const float2 dv2 = *reinterpret_cast<const float2*>(dls + 8 * jb + cq);
      const float lc[2] = {lse_log2(lv.x), lse_log2(lv.y)};
      const float dc[2] = {dv2.x, dv2.y};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2], d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jb + 2 * r + e;
          p[e] = fast_exp2(fmaf(s[i], scale_log2, -lc[e]));
          if (edge && !(POS ? pos::allowed(kv[r], qc[POS ? 2 * jb + e : 0],
                                           causal, window)
                            : allowed(ka + 8 * r, q0 + 8 * jb + cq + e, seq,
                                      causal, window)))
            p[e] = 0.0f;
          d[e] = p[e] * (dp[i] - dc[e]) * scale;
        }
        pa[2 * jb + r] = pack_bf16(p[0], p[1]);
        da[2 * jb + r] = pack_bf16(d[0], d[1]);
      }
    }

    // dV += P^T dO (N = DV) and dK += dS^T Q (N = DQK), 16 queries a
    // wgmma: the streamed tiles' rows 16j.. read MN-major
    pin(dka);
    pin(dva);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcTile / 16; ++j) {
      const uint32_t ap[4] = {pa[4 * j], pa[4 * j + 1], pa[4 * j + 2],
                              pa[4 * j + 3]};
      const uint32_t ad[4] = {da[4 * j], da[4 * j + 1], da[4 * j + 2],
                              da[4 * j + 3]};
      wgmma_rs(dva, ap,
               sw128_desc(sdo + sto + j * 16 * kSwRow, kTcTile * kSwRow,
                          8 * kSwRow));
      wgmma_rs(dka, ad,
               sw128_desc(sq + stq + j * 16 * kSwRow, kTcTile * kSwRow,
                          8 * kSwRow));
    }
    wgmma_commit();  // left in flight: waited for with the next S^T
  }
  wgmma_wait_all();
  pin(dka);
  pin(dva);
  if constexpr (POS) cp_async_wait_all();  // K's and V's, where no tile ran

  if (w0 >= seq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ka + 8 * r;
    if (row >= seq) continue;
    const int64_t prow = ((int64_t)b * seq + row) * heads + h;
    float* krow = dk_part + prow * DQK + cq;
    float* vrow = dv_part + prow * DV + cq;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<float2*>(krow + 8 * j) =
          make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(vrow + 8 * j) =
          make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
  }
}

// 3. dk (B, S, Hkv, DQK) and dv (B, S, Hkv, DV) bf16 = the partials
// (B, S, H, DQK) and (B, S, H, DV) fp32 summed over each kv head's group
// of query heads, in order: `nk` float4 groups of dk, then `nv` of dv
__global__ void __launch_bounds__(256)
flash_bwd_group_sum_kernel(const float4* __restrict__ dk_part,
                           const float4* __restrict__ dv_part,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int64_t nk, int64_t nv, int group, int dk4,
                           int dv4) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < nk + nv; i += (int64_t)gridDim.x * blockDim.x) {
    const bool is_k = i < nk;
    const int64_t j = is_k ? i : i - nk;
    const int64_t d4 = is_k ? dk4 : dv4;
    const float4* part = is_k ? dk_part : dv_part;
    // output row (b, s, hk) = j / d4 reads partial rows row * group + g
    const int64_t src = (j / d4) * group * d4 + j % d4;
    float4 a = part[src];
    for (int g = 1; g < group; ++g) {
      const float4 x = part[src + g * d4];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>((is_k ? dk : dv) + 4 * j);
    out[0] = __floats2bfloat162_rn(a.x, a.y);
    out[1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

template <int DQK, int DV, bool POS>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, float* delta, bf16* dq,
              bf16* dk, bf16* dv, float* part, Strides qs, Strides ks,
              Strides vs, Strides os, Strides ds, int batch, int seq,
              int heads, int kv_heads, int causal, int window, float scale,
              const int* qpos, const int* kpos, cudaStream_t stream) {
  auto kdq = flash_bwd_dq_tc_kernel<DQK, DV, POS>;
  auto kkv = flash_bwd_dkdv_tc_kernel<DQK, DV, POS>;
  constexpr int smem_dq = dq_smem_bytes<DQK, DV>();
  constexpr int smem_kv = dkdv_smem_bytes<DQK, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(heads, batch, (seq + kTcRows - 1) / kTcRows);
  const float scale_log2 = scale * kLog2e;
  kdq<<<grid, kTcThreads, smem_dq, stream>>>(
      q, k, v, o, dout, lse, delta, dq, qs, ks, vs, os, ds, seq, heads,
      kv_heads, causal, window, scale, scale_log2, qpos, kpos);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)batch * seq * heads;
  kkv<<<grid, kTcThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, part, part + rows * DQK, qs, ks, vs, ds,
      seq, heads, kv_heads, causal, window, scale, scale_log2, qpos, kpos);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t out_rows = (int64_t)batch * seq * kv_heads;
  const int64_t nk = out_rows * (DQK / 4), nv = out_rows * (DV / 4);
  const int64_t want = (nk + nv + 255) / 256;
  const int blocks = (int)(want < 8192 ? want : 8192);
  flash_bwd_group_sum_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part),
      reinterpret_cast<const float4*>(part + rows * DQK), dk, dv, nk, nv,
      heads / kv_heads, DQK / 4, DV / 4);
  return (int)cudaGetLastError();
}

// a 16-byte aligned data pointer and (b, s, h) strides of whole 16-byte
// chunks (`per16` entries of the dtype)
bool aligned16(const void* p, const Strides& st, int per16) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st.b % per16 == 0 &&
         st.s % per16 == 0 && st.h % per16 == 0;
}

// the instantiated (DQK, DV) pairs, as one key (the forward's)
constexpr int pair(int dqk, int dv) { return dqk * 1000 + dv; }

}  // namespace

// dynamic shared memory a block of the dq and dk/dv kernels (`which` 0
// and 1) of the bf16 (is_bf16 = 1) or fp32 route asks for at the head-dim
// pair (DQK, DV), or -1 for a pair they do not take
extern "C" int flash_attention_bwd_tc_smem_bytes(int head_dim,
                                                 int v_head_dim, int which,
                                                 int is_bf16) {
#define SMEM_PAIR(DQK, DV)                                            \
  case pair(DQK, DV):                                                 \
    if (is_bf16)                                                      \
      return which ? dkdv_smem_bytes<DQK, DV>() : dq_smem_bytes<DQK, DV>(); \
    return which ? f32_dkdv_smem<DQK, DV>() : f32_dq_smem<DQK, DV>();
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

// q: (B, S, H, DQK); k: (B, S, Hkv, DQK); v: (B, S, Hkv, DV); out, dout:
// (B, S, H, DV); each with its (b, s, h) strides in elements and a
// contiguous head dim, all of one dtype; lse (B, H, S) fp32 from the
// forward; delta a (B, H, S) fp32 scratch.  Writes dq (B, S, H, DQK), dk
// (B, S, Hkv, DQK) and dv (B, S, Hkv, DV) contiguous in the inputs' dtype.
// q_pos, k_pos: both null (the implicit arange(S), the index-masked
// instances), or both (B, S) int32 contiguous, the forward's.
// (head_dim, v_head_dim) = (DQK, DV) one of the forward's pairs; H a
// multiple of Hkv.  Both dtypes run on the tensor cores and need 16-byte
// aligned q, k, v, out, dout with (b, s, h) strides of whole 16-byte
// chunks, multiples of 8 (bf16) or 4 (fp32) entries (else
// cudaErrorMisalignedAddress).  bf16 (is_bf16 = 1) runs in three
// launches and needs `part`, an fp32 scratch of B * S * H * (DQK + DV)
// entries; fp32 runs in two launches and reads no `part`.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t d_sb, int64_t d_ss,
    int64_t d_sh, int batch, int seq, int heads, int kv_heads, int head_dim,
    int v_head_dim, int causal, int window, float scale, int is_bf16,
    float* part, const int* q_pos, const int* k_pos, void* stream) {
  if ((q_pos == nullptr) != (k_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && part == nullptr) return (int)cudaErrorInvalidValue;
  const int per16 = is_bf16 ? 8 : 4;
  if (!(aligned16(q, qs, per16) && aligned16(k, ks, per16) &&
        aligned16(v, vs, per16) && aligned16(o, os, per16) &&
        aligned16(dout, ds, per16)))
    return (int)cudaErrorMisalignedAddress;
#define TC_ARGS static_cast<const bf16*>(q), static_cast<const bf16*>(k),    \
    static_cast<const bf16*>(v), static_cast<const bf16*>(o),                \
    static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),      \
    static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, qs, ks, vs, os,    \
    ds, batch, seq, heads, kv_heads, causal, window, scale, q_pos, k_pos, s
#define F32_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
    static_cast<const float*>(v), static_cast<const float*>(o),              \
    static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),    \
    static_cast<float*>(dk), static_cast<float*>(dv), qs, ks, vs, os, ds,    \
    batch, seq, heads, kv_heads, causal, window, scale, q_pos, k_pos, s
#define BWD_PAIR(DQK, DV)                                               \
  case pair(DQK, DV):                                                   \
    if (q_pos != nullptr)                                               \
      return is_bf16 ? launch_tc<DQK, DV, true>(TC_ARGS)                \
                     : launch_f32<DQK, DV, true>(F32_ARGS);             \
    return is_bf16 ? launch_tc<DQK, DV, false>(TC_ARGS)                 \
                   : launch_f32<DQK, DV, false>(F32_ARGS);
  switch (pair(head_dim, v_head_dim)) {
    BWD_PAIR(32, 32)
    BWD_PAIR(64, 64)
    BWD_PAIR(80, 80)
    BWD_PAIR(96, 96)
    BWD_PAIR(128, 128)
    BWD_PAIR(96, 64)
    BWD_PAIR(80, 64)
  }
#undef BWD_PAIR
#undef F32_ARGS
#undef TC_ARGS
  return (int)cudaErrorInvalidValue;
}
