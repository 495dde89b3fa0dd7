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
// multiply and an add into an fma: every output is BITWISE the plain
// PyTorch version (kernels/ref.py, one rounding per operation).  That is
// what keeps the secure masks' dyadic-grid cancellation exact
// (src/repro/core/transforms.py): each masked message is rounded exactly
// as the plain path rounds it.
//
// Bound on this card: bytes.  Three (K, D) fp32 arrays move once (two
// read, one written) for 1-3 flops per element, far below the ~20
// flop/byte at which an H100 SXM's fp32 units (67 TFLOP/s against
// 3.35 TB/s, data-sheet peaks at the 700 W power limit) would limit.
// The design only streams: one block row per cohort row (grid.y), the
// row's coefficient and weight held in registers, consecutive threads on
// consecutive columns, a grid-stride loop over the row.
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launch; launches on the caller's stream and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRow = 1024;

template <bool kClip, bool kNoise, bool kMask>
__global__ void dp_secure_kernel(const float* __restrict__ x,
                                 const float* __restrict__ noise,
                                 const float* __restrict__ mask,
                                 const float* __restrict__ coef,
                                 const float* __restrict__ w,
                                 float noise_scale, float* __restrict__ out,
                                 int64_t d) {
  const int64_t row = blockIdx.y;
  const int64_t base = row * d;
  float c = 1.0f, wr = 1.0f;
  if (kClip) c = coef[row];
  if (kMask) wr = fmaxf(w[row], 1e-9f);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v = x[base + j];
    if (kClip) v = __fmul_rn(v, c);
    if (kNoise) v = __fadd_rn(v, __fmul_rn(noise_scale, noise[base + j]));
    if (kMask) v = __fadd_rn(v, __fdiv_rn(mask[base + j], wr));
    out[base + j] = v;
  }
}

template <bool kClip, bool kNoise, bool kMask>
void launch(dim3 grid, cudaStream_t s, const float* x, const float* noise,
            const float* mask, const float* coef, const float* w,
            float noise_scale, float* out, int64_t d) {
  dp_secure_kernel<kClip, kNoise, kMask><<<grid, kThreads, 0, s>>>(
      x, noise, mask, coef, w, noise_scale, out, d);
}

}  // namespace

// flags: bit 0 = clip (coef), bit 1 = noise, bit 2 = mask (mask and w).
extern "C" int fed_dp_secure_apply(const float* x, const float* noise,
                                   const float* mask, const float* coef,
                                   const float* w, float noise_scale,
                                   float* out, int64_t k, int64_t d,
                                   int flags, void* stream) {
  int64_t bx = (d + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  const dim3 grid((unsigned)bx, (unsigned)k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flags & 7) {
    case 0: launch<false, false, false>(grid, s, x, noise, mask, coef, w,
                                        noise_scale, out, d); break;
    case 1: launch<true, false, false>(grid, s, x, noise, mask, coef, w,
                                       noise_scale, out, d); break;
    case 2: launch<false, true, false>(grid, s, x, noise, mask, coef, w,
                                       noise_scale, out, d); break;
    case 3: launch<true, true, false>(grid, s, x, noise, mask, coef, w,
                                      noise_scale, out, d); break;
    case 4: launch<false, false, true>(grid, s, x, noise, mask, coef, w,
                                       noise_scale, out, d); break;
    case 5: launch<true, false, true>(grid, s, x, noise, mask, coef, w,
                                      noise_scale, out, d); break;
    case 6: launch<false, true, true>(grid, s, x, noise, mask, coef, w,
                                      noise_scale, out, d); break;
    default: launch<true, true, true>(grid, s, x, noise, mask, coef, w,
                                      noise_scale, out, d); break;
  }
  return (int)cudaGetLastError();
}
