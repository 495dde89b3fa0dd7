// Fused ProdLDA reconstruction term (forward), for Hopper.
//
// Replaces the TPU kernel topic_decoder_pallas
// (src/repro/kernels/topic_decoder.py, body _decoder_kernel):
//
//     l_v     = (theta_d . beta[:, v]) * scale_v
//     recon_d = -(S - NB * lse),  S = sum_v bow_dv l_v,  NB = sum_v bow_dv,
//                                 lse = m + log(max(sum_v exp(l_v - m), 1e-30))
//
// without materializing the (B, V) logits.  Zero-bow rows give S = NB = 0,
// hence recon 0; the vocabulary tail needs no padding because every thread
// loops over real columns only.
//
// Work layout.  The TPU kernel walks the vocabulary tiles in order on one
// core, carrying (m, l, S, NB) in scratch.  Here blocks run in parallel
// with nothing carried between them, so the walk is cut in two passes:
//   1. decoder_partial_kernel: grid (row tiles of kRows documents) x
//      (vocabulary chunks).  The tile's theta rows sit in shared memory,
//      topic-major as one float4 per topic (one 16-byte load feeds the
//      four rows' FMAs); each thread walks its chunk's columns
//      v = c0 + tid, + blockDim, ...,
//      computes the kRows logits of a column in fp32 FMAs from one read of
//      beta[:, v], and keeps per row an online max m, a sum of
//      exponentials l, S and NB in registers.  A warp-shuffle and then a
//      shared-memory reduction merge the block's threads; the block writes
//      one (m, l, S, NB) partial per row and chunk.
//   2. decoder_merge_kernel: one thread per document merges its chunks'
//      partials (the same rescaled log-sum-exp merge) into recon_d.
// The chunk count is chosen by the caller so that the first pass fills
// the card (a few blocks per SM) even at B = 256.  IEEE fp32 throughout
// (expf/logf, no fast-math, no TF32).
//
// Bound on this card: at the service's evaluate shape (B=256, K=50,
// V=5000) the 2*B*K*V flops of the product weigh about as much, against
// the H100 SXM's 67 TFLOP/s fp32 rate, as the bow matrix's bytes against
// its 3.35 TB/s (data-sheet peaks at the 700 W power limit).
// This simple kernel does not use the tensor cores and re-reads beta
// from L2 once per row tile; its design keeps the logits out of device
// memory and reuses each beta load across the tile's rows.
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launches; launches on the caller's stream and never synchronises.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;  // one float4 of theta per topic
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kThreads)
decoder_partial_kernel(const float* __restrict__ theta,
                       const float* __restrict__ beta,
                       const float* __restrict__ bow,
                       const float* __restrict__ scale,
                       float4* __restrict__ part, int b, int k, int v,
                       int chunk) {
  extern __shared__ float4 th4[];  // k entries: (theta[row0 + r, kk])_r
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, b - row0);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(v, c0 + chunk);
  float* th_s = reinterpret_cast<float*>(th4);
  for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
    const int r = i / k, kk = i - r * k;
    th_s[kk * kRows + r] =
        r < nrows ? theta[(int64_t)(row0 + r) * k + kk] : 0.f;
  }
  __syncthreads();

  float m[kRows], l[kRows], s[kRows], nb[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    s[r] = 0.f;
    nb[r] = 0.f;
  }
  for (int col = c0 + threadIdx.x; col < c1; col += kThreads) {
    float dot[kRows] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const float bv = beta[(int64_t)kk * v + col];
      const float4 t = th4[kk];
      dot[0] = fmaf(t.x, bv, dot[0]);
      dot[1] = fmaf(t.y, bv, dot[1]);
      dot[2] = fmaf(t.z, bv, dot[2]);
      dot[3] = fmaf(t.w, bv, dot[3]);
    }
    const float sc = scale != nullptr ? scale[col] : 1.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const float lg = dot[r] * sc;
        const float x = bow[(int64_t)(row0 + r) * v + col];
        if (lg > m[r]) {
          l[r] = l[r] * expf(m[r] - lg) + 1.f;
          m[r] = lg;
        } else {
          l[r] += expf(lg - m[r]);
        }
        s[r] = fmaf(x, lg, s[r]);
        nb[r] += x;
      }
    }
  }

  // block reduction: within each warp, then across the warps
  __shared__ float red[4][kRows][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      merge(m[r], l[r], m2, l2);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      nb[r] += __shfl_xor_sync(0xffffffffu, nb[r], off);
    }
    if (lane == 0) {
      red[0][r][warp] = m[r];
      red[1][r][warp] = l[r];
      red[2][r][warp] = s[r];
      red[3][r][warp] = nb[r];
    }
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float mm = lane < kWarps ? red[0][r][lane] : kNegInf;
    float ll = lane < kWarps ? red[1][r][lane] : 0.f;
    float ss = lane < kWarps ? red[2][r][lane] : 0.f;
    float nn = lane < kWarps ? red[3][r][lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mm, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, ll, off);
      merge(mm, ll, m2, l2);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      nn += __shfl_xor_sync(0xffffffffu, nn, off);
    }
    if (lane == 0 && r < nrows) {
      part[(int64_t)(row0 + r) * gridDim.y + blockIdx.y] =
          make_float4(mm, ll, ss, nn);
    }
  }
}

__global__ void decoder_merge_kernel(const float4* __restrict__ part,
                                     float* __restrict__ out, int b,
                                     int nchunk) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  float m = kNegInf, l = 0.f, s = 0.f, nb = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const float4 p = part[(int64_t)row * nchunk + c];
    merge(m, l, p.x, p.y);
    s += p.z;
    nb += p.w;
  }
  out[row] = -(s - nb * (m + logf(fmaxf(l, 1e-30f))));
}

}  // namespace

// part: scratch of b * nchunk * 4 floats (16-byte aligned), nchunk >= 1.
extern "C" int topic_decoder_fwd(const float* theta, const float* beta,
                                 const float* bow, const float* scale,
                                 float* out, float* part, int b, int k,
                                 int v, int nchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = (v + nchunk - 1) / nchunk;
  const dim3 grid((b + kRows - 1) / kRows, nchunk);
  const size_t smem = (size_t)kRows * k * sizeof(float);
  float4* p = reinterpret_cast<float4*>(part);
  decoder_partial_kernel<<<grid, kThreads, smem, s>>>(theta, beta, bow,
                                                      scale, p, b, k, v,
                                                      chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decoder_merge_kernel<<<(b + 255) / 256, 256, 0, s>>>(p, out, b, nchunk);
  return (int)cudaGetLastError();
}
