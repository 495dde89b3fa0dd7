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
// Two routes, chosen by dtype (a rule, not a fallback), as the forward:
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
// fp32 -> the port's first design, IEEE fp32 on the CUDA cores (the
//   card-vs-CPU bound for fp32 models, 2e-5, which bf16 or TF32 products
//   cannot hold), in two launches:
//   1. flash_bwd_dq_kernel, one block per (64 query rows, head, batch):
//      four threads per row split each head dim into 16-byte groups, so
//      q, dout and the dq accumulator of a row live in registers; the
//      row's delta is computed first (and stored for launch 2); K and V
//      tiles of 64 keys are staged in shared memory as fp32 and read as
//      broadcast float4 loads; s and dout . v are quad-shuffle sums.
//      Only the key tiles the mask can reach are visited.
//   2. flash_bwd_dkdv_kernel, one block per (64 keys, kv head, batch): the
//      same shape with the roles swapped: k, v, dk and dv of a key live in
//      registers; for each query head of the group, in order, the query
//      tiles the mask can reach stage q, dout, lse and delta in shared
//      memory.  dk and dv are summed over the group in registers.
//
// Both: no atomics, so every call gives the same bits.  Masks: causal
// k <= q, sliding window k > q - window, both, or none; keys and queries
// past the sequence end are masked (a ragged tail).  A fully masked row
// has p = 0 and gets zero gradients.  Operands are read through their
// (b, s, h) strides (the head dim contiguous); dq, dk, dv are written
// contiguous; lse and delta are (B, H, S) fp32.  The (DQK, DV) pairs
// are the forward's: (32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
// (96, 64) and (80, 64).  On the tensor cores a head dim of 80 or 96 needs
// no layout of its own, as in the forward: a row is stored as column
// atoms of 64 entries under the 128-byte swizzle, so 80 is one full atom
// and 16 columns of a second (a 160-byte row, which no power-of-two
// swizzle covers, is never laid out whole); the k16 steps of S and dP
// walk the atoms (80 = 5 x 16), and the N = 80 or 96 products (dQ and dK
// at N = DQK, dV at N = DV) read their B tile MN-major with the atoms LBO
// apart, the form the forward's P V takes at DV = 80.  So the backward
// uses the wgmma forms the forward does: m64n64k16 with both operands in
// shared memory and m64nNk16 with A in registers.  The wgmma building
// blocks are in wgmma.cuh.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the launches, each checked; launches on the caller's
// stream, in order, and never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kRows = 64;                 // query rows / keys per block
constexpr int kTpr = 4;                   // threads per row
constexpr int kThreads = kRows * kTpr;    // 256

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

// sum over the four threads of a row (lanes 4r .. 4r+3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// this thread's D/4 entries of a row, as float4 group i * 4 + part (the
// four threads of a row read four neighbouring 16-byte words)
template <int D>
__device__ __forceinline__ void load_row(float* r, const float* src, bool ok,
                                         int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[i * 4 + e] = ok ? src[(i * 4 + part) * 4 + e] : 0.0f;
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, const float* r,
                                          int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(i * 4 + part) * 4 + e] = r[i * 4 + e];
}

template <int G>
__device__ __forceinline__ float dot_part(const float* r, const float4* row,
                                          int part) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float4 v = row[i * 4 + part];
    s = fmaf(r[i * 4 + 0], v.x, s);
    s = fmaf(r[i * 4 + 1], v.y, s);
    s = fmaf(r[i * 4 + 2], v.z, s);
    s = fmaf(r[i * 4 + 3], v.w, s);
  }
  return s;
}

template <int G>
__device__ __forceinline__ void axpy_part(float* acc, float c,
                                          const float4* row, int part) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float4 v = row[i * 4 + part];
    acc[i * 4 + 0] = fmaf(c, v.x, acc[i * 4 + 0]);
    acc[i * 4 + 1] = fmaf(c, v.y, acc[i * 4 + 1]);
    acc[i * 4 + 2] = fmaf(c, v.z, acc[i * 4 + 2]);
    acc[i * 4 + 3] = fmaf(c, v.w, acc[i * 4 + 3]);
  }
}

// rows [r0, r0 + kRows) of a (B, S, H, D) operand at (b, h) into shared
// memory; rows past the end read as zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      int64_t s_stride, int r0, int seq,
                                      int tid) {
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[idx] = r0 + r < seq ? base[(int64_t)(r0 + r) * s_stride + c] : 0.0f;
  }
}

// 1. dq (and delta) per query tile
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq,
                    Strides qs,
                    Strides ks, Strides vs, Strides os, Strides ds,
                    int seq, int heads, int kv_heads, int causal, int window,
                    float scale) {
  constexpr int kGq = DQK / 16, kGv = DV / 16;  // float4 groups per thread
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kRows][DQK]
  float* v_s = k_s + kRows * DQK;                 // [kRows][DV]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x, row = tid / kTpr, part = tid % kTpr;
  const int qpos = q0 + row;
  const bool live = qpos < seq;

  float qr[kGq * 4], dor[kGv * 4], acc[kGq * 4];
  load_row<DQK>(qr, q + b * qs.b + (int64_t)qpos * qs.s + h * qs.h, live,
                part);
  load_row<DV>(dor, dout + b * ds.b + (int64_t)qpos * ds.s + h * ds.h, live,
               part);
  float dl = 0.0f;
  {
    float orow[kGv * 4];
    load_row<DV>(orow, o + b * os.b + (int64_t)qpos * os.s + h * os.h, live,
                 part);
#pragma unroll
    for (int i = 0; i < kGv * 4; ++i) dl = fmaf(dor[i], orow[i], dl);
  }
  dl = quad_sum(dl);
  const int64_t rix = ((int64_t)b * heads + h) * seq + qpos;
  const float lse_r = live ? lse[rix] : 0.0f;
  if (live && part == 0) delta[rix] = dl;
#pragma unroll
  for (int i = 0; i < kGq * 4; ++i) acc[i] = 0.0f;

  // the key tiles the mask can reach from rows [q0, q0 + kRows)
  int lo = 0, hi = seq - 1;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(hi, q0 + kRows - 1);
  const float* kbase = k + b * ks.b + hk * ks.h;
  const float* vbase = v + b * vs.b + hk * vs.h;

  for (int k0 = (lo / kRows) * kRows; k0 <= hi; k0 += kRows) {
    __syncthreads();  // every thread is done with the previous tile
    stage<DQK>(k_s, kbase, ks.s, k0, seq, tid);
    stage<DV>(v_s, vbase, vs.s, k0, seq, tid);
    __syncthreads();
    for (int j = 0; j < kRows; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * DQK);
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * DV);
      const float s = quad_sum(dot_part<kGq>(qr, kr, part));
      const float dp = quad_sum(dot_part<kGv>(dor, vr, part));
      const float p = allowed(k0 + j, qpos, seq, causal, window)
                          ? expf(s * scale - lse_r)
                          : 0.0f;
      axpy_part<kGq>(acc, p * (dp - dl) * scale, kr, part);
    }
  }
  if (live)
    store_row<DQK>(dq + (((int64_t)b * seq + qpos) * heads + h) * DQK, acc,
                   part);
}

// 2. dk, dv per key tile, summed over the query heads of the kv head
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Strides qs, Strides ks, Strides vs, Strides ds,
                      int seq, int heads, int kv_heads, int causal,
                      int window, float scale) {
  constexpr int kGq = DQK / 16, kGv = DV / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][DQK]
  float* do_s = q_s + kRows * DQK;                // [kRows][DV]
  float* lse_s = do_s + kRows * DV;               // [kRows]
  float* dl_s = lse_s + kRows;                    // [kRows]

  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x, row = tid / kTpr, part = tid % kTpr;
  const int kpos = k0 + row;
  const bool live = kpos < seq;

  float kr[kGq * 4], vr[kGv * 4], dka[kGq * 4], dva[kGv * 4];
  load_row<DQK>(kr, k + b * ks.b + (int64_t)kpos * ks.s + hk * ks.h, live,
                part);
  load_row<DV>(vr, v + b * vs.b + (int64_t)kpos * vs.s + hk * vs.h, live,
               part);
#pragma unroll
  for (int i = 0; i < kGq * 4; ++i) dka[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kGv * 4; ++i) dva[i] = 0.0f;

  // the query tiles whose rows can see keys [k0, k0 + kRows)
  int lo = 0, hi = seq - 1;
  if (causal) lo = k0;
  if (window > 0) hi = min(hi, k0 + kRows - 1 + window - 1);

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const float* qbase = q + b * qs.b + h * qs.h;
    const float* dbase = dout + b * ds.b + h * ds.h;
    const int64_t rbase = ((int64_t)b * heads + h) * seq;
    for (int q0 = (lo / kRows) * kRows; q0 <= hi; q0 += kRows) {
      __syncthreads();  // every thread is done with the previous tile
      stage<DQK>(q_s, qbase, qs.s, q0, seq, tid);
      stage<DV>(do_s, dbase, ds.s, q0, seq, tid);
      if (tid < kRows) {
        const bool ok = q0 + tid < seq;
        lse_s[tid] = ok ? lse[rbase + q0 + tid] : 0.0f;
        dl_s[tid] = ok ? delta[rbase + q0 + tid] : 0.0f;
      }
      __syncthreads();
      for (int i = 0; i < kRows; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + i * DQK);
        const float4* dr = reinterpret_cast<const float4*>(do_s + i * DV);
        const float s = quad_sum(dot_part<kGq>(kr, qr, part));
        const float dp = quad_sum(dot_part<kGv>(vr, dr, part));
        const float p = allowed(kpos, q0 + i, seq, causal, window)
                            ? expf(s * scale - lse_s[i])
                            : 0.0f;
        axpy_part<kGv>(dva, p, dr, part);
        axpy_part<kGq>(dka, p * (dp - dl_s[i]) * scale, qr, part);
      }
    }
  }
  if (live) {
    const int64_t row_off = ((int64_t)b * seq + kpos) * kv_heads + hk;
    store_row<DQK>(dk + row_off * DQK, dka, part);
    store_row<DV>(dv + row_off * DV, dva, part);
  }
}

template <int DQK, int DV>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, Strides qs, Strides ks, Strides vs,
           Strides os, Strides ds, int batch, int seq, int heads,
           int kv_heads, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem_dq = kRows * (DQK + DV) * (int)sizeof(float);
  const int smem_kv = smem_dq + 2 * kRows * (int)sizeof(float);
  auto kdq = flash_bwd_dq_kernel<DQK, DV>;
  auto kkv = flash_bwd_dkdv_kernel<DQK, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (seq + kRows - 1) / kRows;
  kdq<<<dim3(tiles, heads, batch), kThreads, smem_dq, stream>>>(
      q, k, v, o, dout, lse, delta, dq, qs, ks, vs, os, ds, seq, heads,
      kv_heads, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3(tiles, kv_heads, batch), kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, ds, seq, heads,
      kv_heads, causal, window, scale);
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
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// lse in units of log2(e), or +inf for a fully masked row (lse = NEG_INF),
// so that its p = exp2(s - inf) = 0 on every branch
__device__ __forceinline__ float lse_log2(float lse) {
  return lse <= 0.5f * kNegInf ? INFINITY : lse * kLog2e;
}

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
template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       Strides ds, int seq, int heads, int kv_heads,
                       int causal, int window, float scale,
                       float scale_log2) {
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
  const int first = lo / kTcTile, last = hi / kTcTile;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
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
    if (w0 >= seq || k0 > whi || k0 + kTcTile - 1 < wlo) {
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
    const bool edge = (causal && k0 + kTcTile - 1 > w0) ||
                      (window > 0 && k0 <= w0 + 63 - window) ||
                      k0 + kTcTile > seq;
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = (i >> 1) & 1;
        float p = fast_exp2(fmaf(s[i + e], scale_log2, -l2[r]));
        if (edge && !allowed(k0 + 8 * (i >> 2) + cq + e, qa + 8 * r, seq,
                             causal, window))
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
template <int DQK, int DV>
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
                         float scale, float scale_log2) {
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
  // warpgroup's
  int lo = 0, hi = seq - 1, wlo = 0, whi = seq - 1;
  if (causal) {
    lo = k0;
    wlo = w0;
  }
  if (window > 0) {
    hi = min(hi, k0 + kTcRows - 1 + window - 1);
    whi = min(whi, w0 + 63 + window - 1);
  }
  const int first = lo / kTcTile, last = hi / kTcTile;
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
  load_tile(first, 0);
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
    if (w0 >= seq || q0 > whi || q0 + kTcTile - 1 < wlo) {
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
    const bool edge = (causal && w0 + 63 > q0) ||
                      (window > 0 && w0 <= q0 + kTcTile - 1 - window) ||
                      q0 + kTcTile > seq || w0 + 64 > seq;
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
          if (edge && !allowed(ka + 8 * r, q0 + 8 * jb + cq + e, seq, causal,
                               window))
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

template <int DQK, int DV>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, float* delta, bf16* dq,
              bf16* dk, bf16* dv, float* part, Strides qs, Strides ks,
              Strides vs, Strides os, Strides ds, int batch, int seq,
              int heads, int kv_heads, int causal, int window, float scale,
              cudaStream_t stream) {
  auto kdq = flash_bwd_dq_tc_kernel<DQK, DV>;
  auto kkv = flash_bwd_dkdv_tc_kernel<DQK, DV>;
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
      kv_heads, causal, window, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)batch * seq * heads;
  kkv<<<grid, kTcThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, part, part + rows * DQK, qs, ks, vs, ds,
      seq, heads, kv_heads, causal, window, scale, scale_log2);
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

bool aligned16(const void* p, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

// the instantiated (DQK, DV) pairs, as one key (the forward's)
constexpr int pair(int dqk, int dv) { return dqk * 1000 + dv; }

}  // namespace

// dynamic shared memory a block of the bf16 (tensor-core) dq and dk/dv
// kernels asks for at the head-dim pair (DQK, DV) (`which` 0 and 1), or -1
// for a pair they do not take
extern "C" int flash_attention_bwd_tc_smem_bytes(int head_dim,
                                                 int v_head_dim, int which) {
#define SMEM_PAIR(DQK, DV)                                        \
  case pair(DQK, DV):                                             \
    return which ? dkdv_smem_bytes<DQK, DV>() : dq_smem_bytes<DQK, DV>();
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
// (head_dim, v_head_dim) = (DQK, DV) one of the forward's pairs; H a
// multiple of Hkv.  bf16 (is_bf16 = 1) runs on the tensor cores in three
// launches, needs 16-byte aligned q, k, v, out, dout with (b, s, h)
// strides that are multiples of 8 (else cudaErrorMisalignedAddress), and
// `part`, an fp32 scratch of B * S * H * (DQK + DV) entries; fp32 runs on
// the CUDA cores in two launches and reads no `part`.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t d_sb, int64_t d_ss,
    int64_t d_sh, int batch, int seq, int heads, int kv_heads, int head_dim,
    int v_head_dim, int causal, int window, float scale, int is_bf16,
    float* part, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (part == nullptr) return (int)cudaErrorInvalidValue;
    if (!(aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs) &&
          aligned16(o, os) && aligned16(dout, ds)))
      return (int)cudaErrorMisalignedAddress;
  }
#define TC_ARGS static_cast<const bf16*>(q), static_cast<const bf16*>(k),    \
    static_cast<const bf16*>(v), static_cast<const bf16*>(o),                \
    static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),      \
    static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, qs, ks, vs, os,    \
    ds, batch, seq, heads, kv_heads, causal, window, scale, s
#define SIMT_ARGS static_cast<const float*>(q), static_cast<const float*>(k), \
    static_cast<const float*>(v), static_cast<const float*>(o),              \
    static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),    \
    static_cast<float*>(dk), static_cast<float*>(dv), qs, ks, vs, os, ds,    \
    batch, seq, heads, kv_heads, causal, window, scale, s
#define BWD_PAIR(DQK, DV)                                         \
  case pair(DQK, DV):                                             \
    return is_bf16 ? launch_tc<DQK, DV>(TC_ARGS)                  \
                   : launch<DQK, DV>(SIMT_ARGS);
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
#undef SIMT_ARGS
#undef TC_ARGS
  return (int)cudaErrorInvalidValue;
}
