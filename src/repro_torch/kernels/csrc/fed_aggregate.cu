// Eq. (2) weighted sum over a stacked (K, D) delta buffer, for Hopper.
//
// Replaces the TPU kernel fed_weighted_sum_pallas
// (src/repro/kernels/fed_aggregate.py, body _weighted_sum_kernel):
//
//     out[j] = sum_k (w[k] > 0 ? w[k] * x[k, j] : 0)        fp32 accumulate
//
// Zero-weight rows are ABSENT, not down-weighted: their payload may be a
// stale or non-finite slot (0 * nan is nan), so a row whose weight is not
// positive is never read.  bf16 rows are upcast with __bfloat162float.
// The division by max(sum w, 1e-12) stays with the caller, so the same
// kernel serves a staleness-discounted numerator.
//
// Bound on this card: bytes.  Every input element is read once and every
// output written once, 2 flops per element read — far below the ~20
// flop/byte at which an H100 SXM's fp32 units (67 TFLOP/s against
// 3.35 TB/s, data-sheet peaks at the 700 W power limit) would limit.  The
// design therefore only has to stream: one thread per output column,
// consecutive threads on consecutive addresses (coalesced rows), the K
// weights staged once per block in shared memory, the K-loop in registers.
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launch; launches on the caller's stream and never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void weighted_sum_kernel(const T* __restrict__ x,
                                    const float* __restrict__ w,
                                    float* __restrict__ out, int64_t k,
                                    int64_t d) {
  extern __shared__ float w_s[];
  for (int64_t r = threadIdx.x; r < k; r += blockDim.x) w_s[r] = w[r];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.0f;
    for (int64_t r = 0; r < k; ++r) {
      const float wr = w_s[r];
      if (wr > 0.0f) acc = fmaf(wr, to_f32(x[r * d + j]), acc);
    }
    out[j] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

}  // namespace

extern "C" int fed_weighted_sum(const void* x, const float* w, float* out,
                                int64_t k, int64_t d, int x_is_bf16,
                                void* stream) {
  int64_t blocks = (d + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = (size_t)k * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    weighted_sum_kernel<__nv_bfloat16><<<(int)blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, out, k, d);
  } else {
    weighted_sum_kernel<float><<<(int)blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), w, out, k, d);
  }
  return (int)cudaGetLastError();
}
