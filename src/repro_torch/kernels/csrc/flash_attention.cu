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
// H=25, Hkv=5, S=2048, D=64, window 1024, bf16) the window reaches ~1.57M
// (q, k) pairs per head, 4*D flops each: ~40 GFLOP against ~63 MB of
// q/k/v/out, far above the ~295 flop/byte at which bf16 tensor cores
// (989 TFLOP/s against 3.35 TB/s, H100 SXM data-sheet peaks at 700 W)
// stop waiting on memory.  This first version runs the products on the
// fp32 units (IEEE fp32, the arithmetic of the reference), not the
// tensor cores: wgmma/mma tiles, TMA and pipelining are later work.  What
// the design does about the bound:
//   * it never touches a key tile the mask cannot reach: each block loops
//     over the tiles in [q0 - window + 1, q0 + 63] only (causal), so the
//     work is the window's, not S^2;
//   * one block per (query tile of 64 rows, head, batch); two threads per
//     query row split the head dim, so q and the running (m, l, acc)
//     statistics live in registers and the 64 scores of a tile too;
//   * K and V tiles (64 keys) are staged once per block in shared memory
//     as fp32 and read back as broadcast float4 loads (every lane of a
//     warp reads the same key at the same time);
//   * GQA by index: query head h reads kv head h / (H / Hkv) (H/Hkv = 5
//     at hymba width is no power of two); K/V are never repeated;
//   * strided operands: the wrapper passes the (b, s, h) strides of each
//     of q, k, v and out, so (B,S,H,D) projections are read in place.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the launch; launches on the caller's stream and never
// synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 64;                 // keys per shared-memory tile
constexpr int kTpr = 2;                     // threads per query row
constexpr int kThreads = kBlockQ * kTpr;    // 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int seq, int heads,
                 int kv_heads, int causal, int window, float scale) {
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
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int batch, int seq, int heads,
           int kv_heads, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = 2 * kBlockK * D * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, seq,
      heads, kv_heads, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 void* o, Strides qs, Strides ks, Strides vs, Strides os,
                 int batch, int seq, int heads, int kv_heads, int causal,
                 int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, os, batch, seq, heads,
                           kv_heads, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, batch, seq, heads,
                           kv_heads, causal, window, scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, o, qs, ks, vs, os, batch, seq, heads,
                           kv_heads, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, batch, seq, heads,
                            kv_heads, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, Hkv, D); each with its (b, s, h)
// strides in elements and a contiguous head dim.  head_dim in
// {32, 64, 96, 128}; H a multiple of Hkv.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int batch, int seq, int heads, int kv_heads, int head_dim,
    int causal, int window, float scale, int is_bf16, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, qs, ks, vs, os,
                                       batch, seq, heads, kv_heads, causal,
                                       window, scale, s);
  return dispatch_dim<float>(head_dim, q, k, v, o, qs, ks, vs, os, batch,
                             seq, heads, kv_heads, causal, window, scale, s);
}
