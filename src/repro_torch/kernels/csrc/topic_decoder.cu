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
// skips the columns past V.
//
// Bound on this card: at the service's evaluate shape (B=256, K=50,
// V=5000) the 2*B*K*V flops of the product weigh about as much, against
// the H100 SXM's 67 TFLOP/s fp32 rate, as the bow matrix's bytes against
// its 3.35 TB/s (data-sheet peaks at the 700 W power limit).  IEEE fp32
// throughout (fmaf, expf/logf, no fast-math, no TF32): the held-out ELBO
// is held to the reference within 1e-5.
//
// Work layout, one launch.  The TPU kernel walks the vocabulary tiles in
// order on one core, carrying (m, l, S, NB) in scratch.  Here blocks run
// in parallel with nothing carried between them:
//   * a block takes kDocs = 32 documents x kWords = 128 words; theta's and
//     beta's tiles are staged in shared memory kKc = 64 topics at a time,
//     so beta is read from L2 once per 32 documents (8 times at B = 256)
//     and theta once per 128 words;
//   * each thread computes a register block of 4 documents x 4
//     neighbouring words (beta and bow come in 16-byte loads where V is a
//     multiple of 4) with fp32 FMAs over the topics in order; a warp
//     holds 4 whole documents, so each document's (m, l, S, NB) over the
//     tile comes from warp shuffles (the max first, then one exponential
//     a logit against it) and is written as one partial per (document,
//     vocabulary tile);
//   * the last block of a document tile to finish (an atomic counter per
//     document tile, which that block resets to 0) merges the tile's
//     partials, a warp per 4 documents and a lane per partial (the
//     rescaled log-sum-exp merge, in a fixed order), and writes recon_d:
//     no second launch.
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launch; launches on the caller's stream and never synchronises.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDocs = 32;      // documents of a block
constexpr int kWords = 128;    // vocabulary words of a block
constexpr int kKc = 64;        // topics staged at a time
constexpr int kThreads = 256;  // 8 warps x 4 documents, 32 lanes x 4 words
constexpr float kNegInf = -1e30f;

// the four documents' maxima, and sums, over a warp: four independent
// shuffle chains
__device__ __forceinline__ void warp_max4(float (&v)[4]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
}
__device__ __forceinline__ void warp_sum4(float (&v)[4]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

__global__ void __launch_bounds__(kThreads)
decoder_kernel(const float* __restrict__ theta,
               const float* __restrict__ beta,
               const float* __restrict__ bow,
               const float* __restrict__ scale, float4* __restrict__ part,
               unsigned* __restrict__ counter, float* __restrict__ out,
               int b, int k, int v) {
  __shared__ float4 th_s[kKc][kDocs / 4];  // [topic][4 documents]
  __shared__ float4 be_s[kKc][kWords / 4]; // [topic][4 words]
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * kDocs, v0 = blockIdx.y * kWords;
  const int w0 = v0 + 4 * lane;  // this thread's 4 words: w0..w0+3
  // rows of 16-byte aligned beta and bow take 16-byte loads
  const bool vec = (v & 3) == 0;
  float* th = reinterpret_cast<float*>(th_s);
  float* be = reinterpret_cast<float*>(be_s);

  // bow, most of the kernel's bytes, first: its loads are in flight while
  // the logits are computed
  float xb[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int doc = d0 + 4 * warp + i;
    const float* row = bow + (int64_t)doc * v;
    if (vec) {
      const float4 q = doc < b && w0 < v
          ? *reinterpret_cast<const float4*>(row + w0)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      xb[i][0] = q.x;
      xb[i][1] = q.y;
      xb[i][2] = q.z;
      xb[i][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xb[i][e] = doc < b && w0 + e < v ? row[w0 + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  for (int k0 = 0; k0 < k; k0 += kKc) {
    const int kc = min(kKc, k - k0);
    __syncthreads();  // every thread is done with the previous topics
    for (int i = tid; i < kc * kDocs; i += kThreads) {
      const int kk = i / kDocs, d = i - kk * kDocs;
      th[kk * kDocs + d] =
          d0 + d < b ? theta[(int64_t)(d0 + d) * k + k0 + kk] : 0.f;
    }
    if (vec) {
      for (int i = tid; i < kc * (kWords / 4); i += kThreads) {
        const int kk = i / (kWords / 4), c = i - kk * (kWords / 4);
        const int col = v0 + 4 * c;
        be_s[kk][c] = col < v ? *reinterpret_cast<const float4*>(
                                    beta + (int64_t)(k0 + kk) * v + col)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < kc * kWords; i += kThreads) {
        const int kk = i / kWords, w = i - kk * kWords;
        be[kk * kWords + w] =
            v0 + w < v ? beta[(int64_t)(k0 + kk) * v + v0 + w] : 0.f;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float4 t = th_s[kk][warp];
      const float4 q = be_s[kk][lane];
      const float bv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][e] = fmaf(t.x, bv[e], acc[0][e]);
        acc[1][e] = fmaf(t.y, bv[e], acc[1][e]);
        acc[2][e] = fmaf(t.z, bv[e], acc[2][e]);
        acc[3][e] = fmaf(t.w, bv[e], acc[3][e]);
      }
    }
  }

  // each document's statistics over the tile's words: a warp holds 4
  // whole documents; the max first, then one exponential a logit against
  // it, then sums, each over the warp by shuffles
  float lg[4][4], m[4], l[4], sx[4], nb[4];
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ok[e] = w0 + e < v;
    const float sc = ok[e] && scale != nullptr ? scale[w0 + e] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) lg[i][e] = acc[i][e] * sc;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[e]) m[i] = fmaxf(m[i], lg[i][e]);
  }
  warp_max4(m);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = sx[i] = nb[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[e]) continue;
      l[i] += expf(lg[i][e] - m[i]);
      sx[i] = fmaf(xb[i][e], lg[i][e], sx[i]);
      nb[i] += xb[i][e];
    }
  }
  warp_sum4(l);
  warp_sum4(sx);
  warp_sum4(nb);
  const int nvt = gridDim.y;
  if (lane < 4) {
    // lane i writes document i's partial (registers indexed by constants)
    float4 p = make_float4(m[0], l[0], sx[0], nb[0]);
    if (lane == 1) p = make_float4(m[1], l[1], sx[1], nb[1]);
    if (lane == 2) p = make_float4(m[2], l[2], sx[2], nb[2]);
    if (lane == 3) p = make_float4(m[3], l[3], sx[3], nb[3]);
    const int doc = d0 + 4 * warp + lane;
    if (doc < b) part[(int64_t)doc * nvt + blockIdx.y] = p;
  }

  // the last block of this document tile merges its partials, warp w
  // documents 4w..4w+3, lane l partials l, l + 32, ... (the four
  // documents' loads in flight together), then the lanes by shuffles
  __syncthreads();  // the block's partials are written
  if (tid == 0) {
    __threadfence();  // released before the arrival is counted
    last = atomicAdd(counter + blockIdx.x, 1u) == (unsigned)nvt - 1;
    if (last) __threadfence();  // and the other blocks' acquired
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = sx[i] = nb[i] = 0.f;
  }
  for (int c = lane; c < nvt; c += 32) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int doc = d0 + 4 * warp + i;
      p[i] = doc < b ? __ldcg(part + (int64_t)doc * nvt + c)
                     : make_float4(kNegInf, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], p[i].x);
      l[i] = l[i] * expf(m[i] - mn) + p[i].y * expf(p[i].x - mn);
      m[i] = mn;
      sx[i] += p[i].z;
      nb[i] += p[i].w;
    }
  }
  float mw[4] = {m[0], m[1], m[2], m[3]};
  warp_max4(mw);
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] *= expf(m[i] - mw[i]);
  warp_sum4(l);
  warp_sum4(sx);
  warp_sum4(nb);
  if (lane < 4) {
    float4 p = make_float4(mw[0], l[0], sx[0], nb[0]);
    if (lane == 1) p = make_float4(mw[1], l[1], sx[1], nb[1]);
    if (lane == 2) p = make_float4(mw[2], l[2], sx[2], nb[2]);
    if (lane == 3) p = make_float4(mw[3], l[3], sx[3], nb[3]);
    const int doc = d0 + 4 * warp + lane;
    if (doc < b) out[doc] = -(p.z - p.w * (p.x + logf(fmaxf(p.y, 1e-30f))));
  }
  if (tid == 0) counter[blockIdx.x] = 0u;  // ready for the next call
}

}  // namespace

// part: scratch of b * ceil(v / kWords) float4s; counter: ceil(b / kDocs)
// unsigned ints, 0 on entry and left 0.  scale may be null.
extern "C" int topic_decoder_fwd(const float* theta, const float* beta,
                                 const float* bow, const float* scale,
                                 float* out, float* part, unsigned* counter,
                                 int b, int k, int v, void* stream) {
  const dim3 grid((b + kDocs - 1) / kDocs, (v + kWords - 1) / kWords);
  decoder_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      theta, beta, bow, scale, reinterpret_cast<float4*>(part), counter, out,
      b, k, v);
  return (int)cudaGetLastError();
}
