// Flash attention backward (causal / sliding-window / full, GQA), for Hopper.
//
// The gradient of B5 (flash_attention.cu).  The reference has no Pallas
// backward: it differentiates its attention core by the hand-written jnp
// VJP _flash_vjp_bwd (src/repro/models/layers/attention.py), which
// recomputes the probabilities chunk by chunk from (q, k, v, out, lse):
//
//   p[q,k]   = mask ? exp(s[q,k] - lse[q]) : 0,   s = (q . k) * scale
//   delta[q] = sum_d dout[q,d] out[q,d]
//   ds[q,k]  = p[q,k] (dout[q] . v[k] - delta[q]) * scale
//   dq[q]    = sum_k ds[q,k] k[k]
//   dk[k]    = sum_{h in group} sum_q ds[q,k] q[q]
//   dv[k]    = sum_{h in group} sum_q p[q,k] dout[q]
//
// GQA by index: kv head hk is read by the H/Hkv query heads
// [hk * H/Hkv, (hk + 1) * H/Hkv), and dk, dv sum over them.
//
// Bound on this card: operations.  At the hymba-1.5b training shape (B=1,
// S=4096, H=25, Hkv=5, D=64, window 1024, bf16) the window reaches ~92M
// (q, k) pairs, 10 * D flops each (s and dp recomputed, dv, dq, dk): ~59
// GFLOP, 59.4 us at the bf16 tensor cores' 989 TFLOP/s, against ~58 MB of
// q/k/v/out/dout/lse and gradients read and written once, 17.3 us at 3.35
// TB/s (H100 SXM data-sheet peaks at 700 W; chip_smoke.py works the same
// count out).
//
// Design (FA2's split, SIMT, fp32 arithmetic; no atomics, so every call
// gives the same bits):
//   1. flash_bwd_dq_kernel, one block per (64 query rows, head, batch):
//      four threads per row split the head dim into 16-byte groups, so
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
//   Arithmetic: inputs are read in their dtype (bf16 or fp32) and every
//   product and sum is IEEE fp32; gradients are cast to the inputs' dtypes
//   once.  The card-vs-CPU bounds: 2e-5 (fp32) and 2e-2 of max|plain|
//   (bf16).  The tensor cores (wgmma) and TMA are later work.
//
// Masks: causal k <= q, sliding window k > q - window, both, or none; keys
// and queries past the sequence end are masked (a ragged tail).  A fully
// masked row has p = 0 and gets zero gradients.  Operands are read through
// their (b, s, h) strides (the head dim contiguous); dq, dk, dv are written
// contiguous; lse and delta are (B, H, S) fp32.  Head dims 32, 64, 96, 128.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the two launches; launches on the caller's stream and
// never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;                 // query rows / keys per block
constexpr int kTpr = 4;                   // threads per row
constexpr int kThreads = kRows * kTpr;    // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
template <typename T, int D>
__device__ __forceinline__ void load_row(float* r, const T* src, bool ok,
                                         int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[i * 4 + e] = ok ? to_f32(src[(i * 4 + part) * 4 + e]) : 0.0f;
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* dst, const float* r, int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_val(dst + (i * 4 + part) * 4 + e, r[i * 4 + e]);
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
// memory as fp32; rows past the end read as zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      int64_t s_stride, int r0, int seq,
                                      int tid) {
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[idx] = r0 + r < seq ? to_f32(base[(int64_t)(r0 + r) * s_stride + c])
                            : 0.0f;
  }
}

// 1. dq (and delta) per query tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, Strides qs,
                    Strides ks, Strides vs, Strides os, Strides ds,
                    int seq, int heads, int kv_heads, int causal, int window,
                    float scale) {
  constexpr int kG = D / 16;  // float4 groups per thread
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* v_s = k_s + kRows * D;                   // [kRows][D]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x, row = tid / kTpr, part = tid % kTpr;
  const int qpos = q0 + row;
  const bool live = qpos < seq;

  float qr[kG * 4], dor[kG * 4], acc[kG * 4];
  load_row<T, D>(qr, q + b * qs.b + (int64_t)qpos * qs.s + h * qs.h, live,
                 part);
  load_row<T, D>(dor, dout + b * ds.b + (int64_t)qpos * ds.s + h * ds.h,
                 live, part);
  load_row<T, D>(acc, o + b * os.b + (int64_t)qpos * os.s + h * os.h, live,
                 part);
  float dl = 0.0f;
#pragma unroll
  for (int i = 0; i < kG * 4; ++i) dl = fmaf(dor[i], acc[i], dl);
  dl = quad_sum(dl);
  const int64_t rix = ((int64_t)b * heads + h) * seq + qpos;
  const float lse_r = live ? lse[rix] : 0.0f;
  if (live && part == 0) delta[rix] = dl;
#pragma unroll
  for (int i = 0; i < kG * 4; ++i) acc[i] = 0.0f;

  // the key tiles the mask can reach from rows [q0, q0 + kRows)
  int lo = 0, hi = seq - 1;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(hi, q0 + kRows - 1);
  const T* kbase = k + b * ks.b + hk * ks.h;
  const T* vbase = v + b * vs.b + hk * vs.h;

  for (int k0 = (lo / kRows) * kRows; k0 <= hi; k0 += kRows) {
    __syncthreads();  // every thread is done with the previous tile
    stage<T, D>(k_s, kbase, ks.s, k0, seq, tid);
    stage<T, D>(v_s, vbase, vs.s, k0, seq, tid);
    __syncthreads();
    for (int j = 0; j < kRows; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * D);
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * D);
      const float s = quad_sum(dot_part<kG>(qr, kr, part));
      const float dp = quad_sum(dot_part<kG>(dor, vr, part));
      const float p = allowed(k0 + j, qpos, seq, causal, window)
                          ? expf(s * scale - lse_r)
                          : 0.0f;
      axpy_part<kG>(acc, p * (dp - dl) * scale, kr, part);
    }
  }
  if (live)
    store_row<T, D>(dq + (((int64_t)b * seq + qpos) * heads + h) * D, acc,
                    part);
}

// 2. dk, dv per key tile, summed over the query heads of the kv head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                      Strides ds, int seq, int heads, int kv_heads,
                      int causal, int window, float scale) {
  constexpr int kG = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* do_s = q_s + kRows * D;                  // [kRows][D]
  float* lse_s = do_s + kRows * D;                // [kRows]
  float* dl_s = lse_s + kRows;                    // [kRows]

  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x, row = tid / kTpr, part = tid % kTpr;
  const int kpos = k0 + row;
  const bool live = kpos < seq;

  float kr[kG * 4], vr[kG * 4], dka[kG * 4], dva[kG * 4];
  load_row<T, D>(kr, k + b * ks.b + (int64_t)kpos * ks.s + hk * ks.h, live,
                 part);
  load_row<T, D>(vr, v + b * vs.b + (int64_t)kpos * vs.s + hk * vs.h, live,
                 part);
#pragma unroll
  for (int i = 0; i < kG * 4; ++i) dka[i] = dva[i] = 0.0f;

  // the query tiles whose rows can see keys [k0, k0 + kRows)
  int lo = 0, hi = seq - 1;
  if (causal) lo = k0;
  if (window > 0) hi = min(hi, k0 + kRows - 1 + window - 1);

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qbase = q + b * qs.b + h * qs.h;
    const T* dbase = dout + b * ds.b + h * ds.h;
    const int64_t rbase = ((int64_t)b * heads + h) * seq;
    for (int q0 = (lo / kRows) * kRows; q0 <= hi; q0 += kRows) {
      __syncthreads();  // every thread is done with the previous tile
      stage<T, D>(q_s, qbase, qs.s, q0, seq, tid);
      stage<T, D>(do_s, dbase, ds.s, q0, seq, tid);
      if (tid < kRows) {
        const bool ok = q0 + tid < seq;
        lse_s[tid] = ok ? lse[rbase + q0 + tid] : 0.0f;
        dl_s[tid] = ok ? delta[rbase + q0 + tid] : 0.0f;
      }
      __syncthreads();
      for (int i = 0; i < kRows; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + i * D);
        const float4* dr = reinterpret_cast<const float4*>(do_s + i * D);
        const float s = quad_sum(dot_part<kG>(kr, qr, part));
        const float dp = quad_sum(dot_part<kG>(vr, dr, part));
        const float p = allowed(kpos, q0 + i, seq, causal, window)
                            ? expf(s * scale - lse_s[i])
                            : 0.0f;
        axpy_part<kG>(dva, p, dr, part);
        axpy_part<kG>(dka, p * (dp - dl_s[i]) * scale, qr, part);
      }
    }
  }
  if (live) {
    const int64_t off = (((int64_t)b * seq + kpos) * kv_heads + hk) * D;
    store_row<T, D>(dk + off, dka, part);
    store_row<T, D>(dv + off, dva, part);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, Strides qs, Strides ks, Strides vs, Strides os,
           Strides ds, int batch, int seq, int heads, int kv_heads,
           int causal, int window, float scale, cudaStream_t stream) {
  const int smem_dq = 2 * kRows * D * (int)sizeof(float);
  const int smem_kv = smem_dq + 2 * kRows * (int)sizeof(float);
  auto kdq = flash_bwd_dq_kernel<T, D>;
  auto kkv = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (seq + kRows - 1) / kRows;
  kdq<<<dim3(tiles, heads, batch), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), qs, ks,
      vs, os, ds, seq, heads, kv_heads, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3(tiles, kv_heads, batch), kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), qs, ks, vs, ds, seq, heads,
      kv_heads, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, Strides qs, Strides ks, Strides vs,
             Strides os, Strides ds, int batch, int seq, int heads,
             int kv_heads, int causal, int window, float scale,
             cudaStream_t s) {
#define BWD_ARGS q, k, v, o, dout, lse, delta, dq, dk, dv, qs, ks, vs, os, \
                 ds, batch, seq, heads, kv_heads, causal, window, scale, s
  switch (head_dim) {
    case 32: return launch<T, 32>(BWD_ARGS);
    case 64: return launch<T, 64>(BWD_ARGS);
    case 96: return launch<T, 96>(BWD_ARGS);
    case 128: return launch<T, 128>(BWD_ARGS);
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout: (B, S, H, D); k, v: (B, S, Hkv, D); each with its (b, s, h)
// strides in elements and a contiguous head dim, all of one dtype (bf16
// when is_bf16, else fp32); lse (B, H, S) fp32 from the forward; delta a
// (B, H, S) fp32 scratch.  Writes dq (B, S, H, D) and dk, dv (B, S, Hkv, D)
// contiguous in the inputs' dtype.  head_dim in {32, 64, 96, 128}; H a
// multiple of Hkv.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t d_sb, int64_t d_ss,
    int64_t d_sh, int batch, int seq, int heads, int kv_heads, int head_dim,
    int causal, int window, float scale, int is_bf16, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<bf16>(head_dim, q, k, v, o, dout, lse, delta, dq, dk, dv,
                          qs, ks, vs, os, ds, batch, seq, heads, kv_heads,
                          causal, window, scale, s);
  return dispatch<float>(head_dim, q, k, v, o, dout, lse, delta, dq, dk, dv,
                         qs, ks, vs, os, ds, batch, seq, heads, kv_heads,
                         causal, window, scale, s);
}
