// Mamba-2 SSD chunked scan (ngroups = 1, zero initial state), for Hopper.
//
// Replaces the TPU kernel ssd_scan_pallas (src/repro/kernels/ssd_scan.py,
// body _ssd_kernel), and on the port's model path the jnp scan ssd_chunked
// that the reference's mamba2_apply runs (src/repro/models/layers/mamba2.py).
// Per (batch, head), chunk by chunk of Q steps, with cum = cumsum(dt * a)
// inside the chunk and h the carried (P, N) state:
//
//   y[i,:]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[j,:]
//             + exp(cum_i) (h C_i)
//   h      <- exp(cum_Q) h + sum_j x[j,:]^T B_j exp(cum_Q - cum_j) dt_j
//
// Steps past the sequence end are read as dt = 0, x = B = C = 0, which
// leaves the state as it is (the padding property of the reference).
//
// Bound on this card: bytes.  At the hymba-1.5b prefill shape (B=4,
// S=2048, H=50, P=64, N=16, Q=256; x, B, C bf16, dt fp32) one pass reads
// x, dt, B, C once and writes y and h_last once (~107 MB, ~32 us at
// 3.35 TB/s), while the chunked form is ~10 GFLOP, ~10 us at the bf16
// tensor-core peak (989 TFLOP/s; H100 SXM data-sheet peaks at 700 W).
// This first version computes in IEEE fp32 on the fp32 units, the
// reference's arithmetic; tensor-core tiles are later work.  What the
// design does:
//   * one block per (batch, head): the loop over chunks runs inside the
//     block, in order, and carries the (P, N) fp32 state in shared memory
//     - the translation of the TPU's sequential chunk axis; 4 x 50 = 200
//     blocks of ~105 KB fill the 132 SMs, two blocks per SM;
//   * the (Q, Q) decay matrix (256 KB at Q = 256, more than the 227 KB a
//     block may hold) is never stored: each thread owns one query row i
//     and computes L[i, j] = exp(cum_i - cum_j) on the fly against every
//     earlier column j, with x[j, :] and B_j read as broadcast loads;
//   * the cumsum of dt * a is a block scan (warp shuffles, then the warp
//     totals);
//   * B and C are shared across heads (ngroups = 1) and re-read per head;
//     C_i sits in registers when N <= 16;
//   * strided operands: x, dt, B and C are read in place through their
//     strides (they are column slices of the conv output on the model
//     path), only the last dim must be contiguous.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the launch; launches on the caller's stream and never
// synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // one query row per thread
constexpr int kMaxChunk = 256;  // Q <= kThreads
constexpr int kSmallN = 16;     // N <= 16: C_i in registers, B rows padded

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  int64_t x_sb, x_ss, x_sh;    // x (B, S, H, P)
  int64_t dt_sb, dt_ss, dt_sh; // dt (B, S, H)
  int64_t b_sb, b_ss;          // B (B, S, N)
  int64_t c_sb, c_ss;          // C (B, S, N)
  int seq, heads, n, chunk;
};

// inclusive block scan of one value per thread (kThreads threads)
__device__ float block_inclusive_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_tot[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < kThreads / 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    if (lane < kThreads / 32) warp_tot[lane] = t;  // inclusive totals
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  return v;
}

template <typename T, int P, bool SMALL_N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bmat,
                const T* __restrict__ cmat, T* __restrict__ y,
                float* __restrict__ h_last, Args g) {
  const int n = g.n, q = g.chunk;
  const int nb = SMALL_N ? kSmallN : n;      // B row pitch (zero padded)
  const int cp = SMALL_N ? kSmallN : n + 1;  // C row pitch
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // [q][P]
  float* b_s = x_s + q * P;                       // [q][nb]
  float* c_s = b_s + q * nb;                      // [q][cp]
  float* h_s = c_s + q * cp;                      // [P][n]
  float* cum_s = h_s + P * n;                     // [q]
  float* dt_s = cum_s + q;                        // [q]
  float* w_s = dt_s + q;                          // [q]
  float* warp_tot = w_s + q;                      // [kThreads / 32]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / g.heads, hh = blockIdx.x % g.heads;
  const float a_h = a[hh];
  const T* xb = x + bi * g.x_sb + hh * g.x_sh;
  const float* dtb = dt + bi * g.dt_sb + hh * g.dt_sh;
  const T* bb = bmat + bi * g.b_sb;
  const T* cb = cmat + bi * g.c_sb;
  T* yb = y + ((int64_t)bi * g.seq * g.heads + hh) * P;
  const int64_t y_ss = (int64_t)g.heads * P;

  for (int o = tid; o < P * n; o += kThreads) h_s[o] = 0.0f;

  for (int c0 = 0; c0 < g.seq; c0 += q) {
    __syncthreads();  // the previous chunk's state update is done
    for (int idx = tid; idx < q * P; idx += kThreads) {
      const int r = idx / P, col = idx - r * P;
      x_s[idx] = c0 + r < g.seq
                     ? to_f32(xb[(int64_t)(c0 + r) * g.x_ss + col])
                     : 0.0f;
    }
    for (int idx = tid; idx < q * nb; idx += kThreads) {
      const int r = idx / nb, col = idx - r * nb;
      b_s[idx] = (c0 + r < g.seq && col < n)
                     ? to_f32(bb[(int64_t)(c0 + r) * g.b_ss + col])
                     : 0.0f;
    }
    for (int idx = tid; idx < q * cp; idx += kThreads) {
      const int r = idx / cp, col = idx - r * cp;
      c_s[idx] = (c0 + r < g.seq && col < n)
                     ? to_f32(cb[(int64_t)(c0 + r) * g.c_ss + col])
                     : 0.0f;
    }
    const float dt_t = (tid < q && c0 + tid < g.seq)
                           ? dtb[(int64_t)(c0 + tid) * g.dt_ss]
                           : 0.0f;
    const float cum_t = block_inclusive_scan(dt_t * a_h, warp_tot);
    if (tid < q) {
      cum_s[tid] = cum_t;
      dt_s[tid] = dt_t;
    }
    __syncthreads();
    const float cum_last = cum_s[q - 1];
    if (tid < q) w_s[tid] = expf(cum_last - cum_t) * dt_t;
    __syncthreads();

    // ---- outputs: thread i owns query row i of the chunk ---------------
    if (tid < q) {
      const int i = tid;
      const float cum_i = cum_s[i];
      float ci[SMALL_N ? kSmallN : 1];
      if constexpr (SMALL_N) {
#pragma unroll
        for (int nn = 0; nn < kSmallN; ++nn) ci[nn] = c_s[i * cp + nn];
      }
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.0f;
      for (int j = 0; j <= i; ++j) {
        float gij = 0.0f;  // C_i . B_j
        if constexpr (SMALL_N) {
          const float4* br = reinterpret_cast<const float4*>(b_s + j * nb);
#pragma unroll
          for (int v4 = 0; v4 < kSmallN / 4; ++v4) {
            const float4 bv = br[v4];
            gij = fmaf(ci[4 * v4 + 0], bv.x, gij);
            gij = fmaf(ci[4 * v4 + 1], bv.y, gij);
            gij = fmaf(ci[4 * v4 + 2], bv.z, gij);
            gij = fmaf(ci[4 * v4 + 3], bv.w, gij);
          }
        } else {
          for (int nn = 0; nn < n; ++nn)
            gij = fmaf(c_s[i * cp + nn], b_s[j * nb + nn], gij);
        }
        const float wgt = gij * expf(cum_i - cum_s[j]) * dt_s[j];
        const float4* xr = reinterpret_cast<const float4*>(x_s + j * P);
#pragma unroll
        for (int v4 = 0; v4 < P / 4; ++v4) {
          const float4 xv = xr[v4];
          acc[4 * v4 + 0] = fmaf(wgt, xv.x, acc[4 * v4 + 0]);
          acc[4 * v4 + 1] = fmaf(wgt, xv.y, acc[4 * v4 + 1]);
          acc[4 * v4 + 2] = fmaf(wgt, xv.z, acc[4 * v4 + 2]);
          acc[4 * v4 + 3] = fmaf(wgt, xv.w, acc[4 * v4 + 3]);
        }
      }
      // the carried state's term, then the row out
      const float e_i = expf(cum_i);
      if (c0 + i < g.seq) {
        T* yrow = yb + (int64_t)(c0 + i) * y_ss;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float hc = 0.0f;
          if constexpr (SMALL_N) {
#pragma unroll
            for (int nn = 0; nn < kSmallN; ++nn)
              if (nn < n) hc = fmaf(ci[nn], h_s[p * n + nn], hc);
          } else {
            for (int nn = 0; nn < n; ++nn)
              hc = fmaf(c_s[i * cp + nn], h_s[p * n + nn], hc);
          }
          store_val(yrow + p, acc[p] + e_i * hc);
        }
      }
    }
    __syncthreads();  // every row has read h before it moves on

    // ---- state update: h <- exp(cum_Q) h + X^T (B o w) -----------------
    const float e_last = expf(cum_last);
    for (int o = tid; o < P * n; o += kThreads) {
      const int p = o / n, nn = o - p * n;
      float s = 0.0f;
      for (int j = 0; j < q; ++j)
        s = fmaf(b_s[j * nb + nn] * w_s[j], x_s[j * P + p], s);
      h_s[o] = e_last * h_s[o] + s;
    }
  }
  __syncthreads();
  float* hl = h_last + ((int64_t)bi * g.heads + hh) * P * n;
  for (int o = tid; o < P * n; o += kThreads) hl[o] = h_s[o];
}

size_t smem_bytes(int p, int n, int q) {
  const int nb = n <= kSmallN ? kSmallN : n;
  const int cp = n <= kSmallN ? kSmallN : n + 1;
  return sizeof(float) * ((size_t)q * (p + nb + cp + 3) + (size_t)p * n +
                          kThreads / 32);
}

template <typename T, int P, bool SMALL_N>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, void* y, float* h_last, const Args& g, int batch,
           cudaStream_t stream) {
  const int smem = (int)smem_bytes(P, g.n, g.chunk);
  auto kern = ssd_scan_kernel<T, P, SMALL_N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<batch * g.heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), h_last, g);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const void* x, const float* dt, const float* a, const void* b,
               const void* c, void* y, float* h_last, const Args& g,
               int batch, cudaStream_t stream) {
  if (g.n <= kSmallN)
    return launch<T, P, true>(x, dt, a, b, c, y, h_last, g, batch, stream);
  return launch<T, P, false>(x, dt, a, b, c, y, h_last, g, batch, stream);
}

template <typename T>
int dispatch_p(int p, const void* x, const float* dt, const float* a,
               const void* b, const void* c, void* y, float* h_last,
               const Args& g, int batch, cudaStream_t stream) {
  switch (p) {
    case 16:
      return dispatch_n<T, 16>(x, dt, a, b, c, y, h_last, g, batch, stream);
    case 32:
      return dispatch_n<T, 32>(x, dt, a, b, c, y, h_last, g, batch, stream);
    case 64:
      return dispatch_n<T, 64>(x, dt, a, b, c, y, h_last, g, batch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block needs (the wrapper refuses what exceeds the
// card's per-block limit).
extern "C" int64_t ssd_scan_smem_bytes(int head_dim, int state_dim,
                                       int chunk) {
  return (int64_t)smem_bytes(head_dim, state_dim, chunk);
}

// x (B, S, H, P) and B, C (B, S, N) in one dtype (fp32 or bf16), dt
// (B, S, H) and a (H,) fp32, each with its strides in elements and a
// contiguous last dim; y (B, S, H, P) contiguous in x's dtype, h_last
// (B, H, P, N) contiguous fp32.  P in {16, 32, 64}, 1 <= chunk <= 256.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                            const void* b, const void* c, void* y,
                            float* h_last, int64_t x_sb, int64_t x_ss,
                            int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                            int64_t dt_sh, int64_t b_sb, int64_t b_ss,
                            int64_t c_sb, int64_t c_ss, int batch, int seq,
                            int heads, int head_dim, int state_dim,
                            int chunk, int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  const Args g{x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss,
               c_sb, c_ss, seq,  heads, state_dim, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(head_dim, x, dt, a, b, c, y, h_last, g,
                                     batch, s);
  return dispatch_p<float>(head_dim, x, dt, a, b, c, y, h_last, g, batch, s);
}
