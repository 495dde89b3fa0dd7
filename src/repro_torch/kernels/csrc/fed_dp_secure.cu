// dp-noise + secure-mask application over a stacked (K, D) cohort, for
// Hopper.
//
// Replaces the TPU kernel fed_dp_secure_apply_pallas
// (src/repro/kernels/fed_aggregate.py, body _dp_secure_kernel):
//
//     out[k, j] = x[k, j] * coef[k]                 (kClip:  dp)
//               + noise_scale * noise[k, j]         (kNoise: dp)
//               + mask[k, j] / max(w[k], 1e-9)      (kMask:  secure)
//
// Each term is a template switch: an absent operand is never read.  The
// terms are evaluated in the reference's order with explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn), so nvcc cannot contract a
// multiply and an add into an fma, and the division stays a division
// (never a multiply by a reciprocal): every output is BITWISE the plain
// PyTorch version (kernels/ref.py, one rounding per operation).  That is
// what keeps the secure masks' dyadic-grid cancellation exact
// (src/repro/core/transforms.py): each masked message is rounded exactly
// as the plain path rounds it.
//
// Bound on this card: bytes.  Three (K, D) fp32 arrays move once (two
// read, one written) for 1-3 flops per element, far below the ~20
// flop/byte at which an H100 SXM's fp32 units (67 TFLOP/s against
// 3.35 TB/s, data-sheet peaks at the 700 W power limit) would limit.
// The design streams the (K, D) slab as one flat array:
//   * 16-byte float4 loads and stores, kUnroll float4s of each operand per
//     thread per iteration, every load issued before any arithmetic, so
//     many bytes are in flight per SM;
//   * streaming cache hints (__ldcs / __stcs): every byte is touched once;
//   * a grid-stride loop over a grid sized from the SM count;
//   * the row of each element (for coef[row] and w[row]) from its flat
//     index.  When D is a multiple of 4 a float4 never straddles two rows;
//     otherwise the float4s that do straddle take a scalar path, and only
//     they.  x, noise, mask and out must start on 16 bytes (the wrapper
//     copies an operand that does not).
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launch; launches on the caller's stream and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // float4s of each operand per iteration

struct Args {
  const float* x;
  const float* noise;
  const float* mask;
  const float* coef;
  const float* w;
  float noise_scale;
  float* out;
  int64_t d;       // row length
  int64_t total;   // K * D
};

// the reference's arithmetic for one element, given its row's c and
// max(w, 1e-9)
template <bool kClip, bool kNoise, bool kMask>
__device__ __forceinline__ float apply(float v, float n, float mk, float c,
                                       float wr, float noise_scale) {
  if (kClip) v = __fmul_rn(v, c);
  if (kNoise) v = __fadd_rn(v, __fmul_rn(noise_scale, n));
  if (kMask) v = __fadd_rn(v, __fdiv_rn(mk, wr));
  return v;
}

// the row of flat element e (32-bit division where the slab allows it)
__device__ __forceinline__ int64_t row_of(const Args& a, int64_t e) {
  if (a.total <= 0xffffffffll) return (uint32_t)e / (uint32_t)a.d;
  return e / a.d;
}

template <bool kClip, bool kNoise, bool kMask>
__device__ __forceinline__ void apply_one(const Args& a, int64_t e) {
  const int64_t row = row_of(a, e);
  const float c = kClip ? __ldg(a.coef + row) : 1.0f;
  const float wr = kMask ? fmaxf(__ldg(a.w + row), 1e-9f) : 1.0f;
  __stcs(a.out + e,
         apply<kClip, kNoise, kMask>(__ldcs(a.x + e),
                                     kNoise ? __ldcs(a.noise + e) : 0.0f,
                                     kMask ? __ldcs(a.mask + e) : 0.0f, c,
                                     wr, a.noise_scale));
}

template <bool kClip, bool kNoise, bool kMask>
__global__ void __launch_bounds__(kThreads)
dp_secure_kernel(Args a) {
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* n4 = reinterpret_cast<const float4*>(a.noise);
  const float4* m4 = reinterpret_cast<const float4*>(a.mask);
  float4* o4 = reinterpret_cast<float4*>(a.out);
  const int64_t nvec = a.total / 4;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t base =
           (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < nvec; base += step) {
    float4 xv[kUnroll], nv[kUnroll], mv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      nv[u] = mv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < nvec) {
        xv[u] = __ldcs(x4 + i);
        if (kNoise) nv[u] = __ldcs(n4 + i);
        if (kMask) mv[u] = __ldcs(m4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i >= nvec) continue;
      const int64_t e = 4 * i;
      const int64_t row = row_of(a, e);
      if (e + 3 >= (row + 1) * a.d) {  // straddles two rows
        for (int j = 0; j < 4; ++j)
          apply_one<kClip, kNoise, kMask>(a, e + j);
        continue;
      }
      const float c = kClip ? __ldg(a.coef + row) : 1.0f;
      const float wr = kMask ? fmaxf(__ldg(a.w + row), 1e-9f) : 1.0f;
      float4 r;
      r.x = apply<kClip, kNoise, kMask>(xv[u].x, nv[u].x, mv[u].x, c, wr,
                                        a.noise_scale);
      r.y = apply<kClip, kNoise, kMask>(xv[u].y, nv[u].y, mv[u].y, c, wr,
                                        a.noise_scale);
      r.z = apply<kClip, kNoise, kMask>(xv[u].z, nv[u].z, mv[u].z, c, wr,
                                        a.noise_scale);
      r.w = apply<kClip, kNoise, kMask>(xv[u].w, nv[u].w, mv[u].w, c, wr,
                                        a.noise_scale);
      __stcs(o4 + i, r);
    }
  }
  // the tail of fewer than 4 elements
  const int64_t tail = nvec * 4 + (int64_t)blockIdx.x * kThreads
                       + threadIdx.x;
  if (tail < a.total) apply_one<kClip, kNoise, kMask>(a, tail);
}

// one wave: as many blocks as fit on the card at once (fewer when the
// slab is small)
template <bool kClip, bool kNoise, bool kMask>
int launch(const Args& a, cudaStream_t s) {
  auto kern = dp_secure_kernel<kClip, kNoise, kMask>;
  static int occupancy = 0;  // blocks a multiprocessor holds
  constexpr int64_t per_block = (int64_t)kThreads * 4 * kUnroll;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && occupancy == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kern,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int64_t wave = (int64_t)sms * occupancy;
  int64_t blocks = (a.total + per_block - 1) / per_block;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// flags: bit 0 = clip (coef), bit 1 = noise, bit 2 = mask (mask and w).
// x, noise, mask and out start on 16 bytes (else
// cudaErrorMisalignedAddress).
extern "C" int fed_dp_secure_apply(const float* x, const float* noise,
                                   const float* mask, const float* coef,
                                   const float* w, float noise_scale,
                                   float* out, int64_t k, int64_t d,
                                   int flags, void* stream) {
  const Args a{x, noise, mask, coef, w, noise_scale, out, d, k * d};
  if (!(aligned16(x) && aligned16(out) &&
        (!(flags & 2) || aligned16(noise)) &&
        (!(flags & 4) || aligned16(mask))))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flags & 7) {
    case 0: return launch<false, false, false>(a, s);
    case 1: return launch<true, false, false>(a, s);
    case 2: return launch<false, true, false>(a, s);
    case 3: return launch<true, true, false>(a, s);
    case 4: return launch<false, false, true>(a, s);
    case 5: return launch<true, false, true>(a, s);
    case 6: return launch<false, true, true>(a, s);
    default: return launch<true, true, true>(a, s);
  }
}
