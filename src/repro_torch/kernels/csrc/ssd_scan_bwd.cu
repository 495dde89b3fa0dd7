// Mamba-2 SSD chunked scan backward (ngroups = 1, zero initial state), for
// Hopper.
//
// The gradient of B6 (ssd_scan.cu).  The reference has no Pallas backward:
// it differentiates ssd_chunked (src/repro/models/layers/mamba2.py) by
// jax.grad through its jax.checkpoint-ed chunk body.  Per (batch, head) and
// chunk of Q steps, with cum_i = sum_{r<=i} dt_r a inside the chunk, h0 the
// state entering the chunk and h1 the state leaving it:
//
//   y_i = sum_{j<=i} G_ij L_ij dt_j x_j + exp(cum_i) h0 C_i
//   h1  = exp(cum_Q) h0 + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
//   G_ij = C_i . B_j,   L_ij = exp(cum_i - cum_j),   cum_Q = cum_{Q-1}
//
// Given dy and dh1 (the gradient of the state leaving the chunk; dh_last
// for the last chunk), with D_ij = dy_i . x_j, w_j = exp(cum_Q - cum_j) dt_j
// and s_j = x_j^T dh1 B_j:
//
//   dx_j  = sum_{i>=j} G_ij L_ij dt_j dy_i + w_j dh1 B_j
//   dB_j  = sum_{i>=j} D_ij L_ij dt_j C_i + w_j dh1^T x_j      (per head)
//   dC_i  = sum_{j<=i} D_ij L_ij dt_j B_j + exp(cum_i) h0^T dy_i (per head)
//   ddt_j = sum_{i>=j} D_ij G_ij L_ij + exp(cum_Q - cum_j) s_j + a g_j
//   dh0   = exp(cum_Q) dh1 + sum_i exp(cum_i) dy_i C_i^T
//
// where g_r = sum_{i>=r} dcum_i is the gradient of dA_r = dt_r a (cum is a
// cumulative sum of dA), with
//
//   dcum_i = sum_{j<=i} M_ij - sum_{j>=i} M_ji + exp(cum_i) dy_i . h0 C_i
//            - w_i s_i + [i = Q-1] (exp(cum_Q) <dh1, h0> + sum_j w_j s_j),
//   M_ij = D_ij G_ij L_ij dt_j,
//
// and da_h = sum over batch and chunks of sum_r dt_r g_r.  dB and dC sum
// over the heads (B and C are shared by all of them).
//
// Four launches in either route, in order on the caller's stream, each
// checked; no atomics, so every call gives the same bits:
//   1. a rows kernel, one block per (head, chunk, batch): dC_i and the row
//      part of dcum_i over the key tiles j <= i, with the carried-state
//      terms from h0 (the states the forward kept), and U = sum_i
//      exp(cum_i) dy_i C_i^T, the chunk's own part of dh0;
//   2. ssd_bwd_state_pass_kernel, one thread per state entry of a (batch,
//      head): the reverse of the forward's state pass, over the chunks from
//      the last: dh1 of each chunk, then dh0 = exp(cum_Q) dh1 + U;
//   3. a columns kernel, the same shape with the roles swapped: dx, the
//      per-head dB, the direct ddt and the column part of dcum over the
//      rows i >= j; then, over the whole chunk, the reverse cumulative sum
//      g and with it ddt and the chunk's part of da (finish_chunk);
//   4. ssd_bwd_reduce_kernel: dB and dC summed over the heads, da over batch
//      and chunks, in a fixed order.
//   Scratch (the wrapper allocates it): dcum rows (B*H*chunks*Q), U then
//   dh1 (B*H*chunks*P*N), cum_Q (B*H*chunks), per-head dB and dC
//   (2*B*H*S*N), da parts (B*H*chunks), all fp32.
//
// Bound on this card: bytes.  At the hymba-1.5b training shape (B=1,
// S=4096, H=50, P=64, N=16, Q=256) the pairs j <= i of every chunk take
// about 6N + 4P flops (G, D and the dx, dB, dC updates) and every step
// 8PN more (the carried-state terms): ~10.9 GFLOP, 11.1 us at the bf16
// tensor cores' 989 TFLOP/s, against ~84 MB read and written once (x, dy
// and dx alone are 3 x 26 MB), 25.1 us at 3.35 TB/s (H100 SXM data-sheet
// peaks at 700 W; chip_smoke.py works the same count out).  The
// chunk-parallel split below recomputes G and D in both chunk kernels:
// 2N + 2P + 2N flops a pair in launch 1 (G, D, dC) and 2N + 2P + 2P + 2N
// in launch 3 (G, D, dx, dB), 8N + 6P = 512 at P=64, N=16 against the
// bound's 352: ~16 us of flops, still below the bytes' 25.1 us.
//
// Two routes, chosen by dtype (a rule, not a fallback), as the forward:
//
// bf16 -> the tensor cores (wgmma, sm_90a), in Mamba-2's chunk-parallel
//   split as the forward's ssd_chunk_scan_kernel: two warpgroups a block,
//   the chunk's x, dy, B, C loaded once by 16-byte cp.async in the
//   forward's layouts (x and dy as 64-column atoms under the 128-byte
//   swizzle, B, C and the bf16 state as 16-column blocks under the 32-byte
//   swizzle), the 64-row tiles the block owns balanced over the
//   warpgroups, the costliest first.  Each kernel is oriented so that the
//   tile it multiplies by is an m64n64 accumulator, whose fragments packed
//   to bf16 are the A-register operand of the next product (as B5-bwd),
//   so no weight tile goes through shared memory.
//   1. ssd_bwd_rows_tc_kernel: per row tile i, Z = dY_i h0 (k = P, h0 read
//      N-major) gives dC_i = exp(cum_i) Z_i and dcum_i = exp(cum_i) Z_i .
//      C_i; per key tile j <= i, G = C_i B_j^T (k = N) and D = dY_i X_j^T
//      (k = P), both K-major; W_D = D o L o dt_j on the fragments, factored
//      as the forward factors its W (ssd::decay_factors); M = W_D o G
//      summed along the rows; dC_i += W_D B_j (wgmma_rs, B_j N-major).
//      Then U = dY^T (C o exp(cum)): C o exp(cum) rounded to bf16 once into
//      B's place, dY^T read as an M-major A (the forward's chunk state).
//   3. ssd_bwd_cols_tc_kernel: per owned column tile j, T = B_j dh1^T (k =
//      N, dh1 K-major) and X_j dh1 (k = P, dh1 N-major) give the state
//      terms w_j T_j, w_j X_j dh1 and s_j = x_j . T_j; per row tile i >=
//      j, G^T = B_j C_i^T and D^T = X_j dY_i^T, W_G^T and W_D^T on the
//      fragments (the decay factored through the row before the column's
//      tile or 16-row group), dx_j += W_G^T dY_i and dB_j += W_D^T C_i
//      (wgmma_rs, dY_i and C_i N-major), and the row sums of D^T o G^T o
//      L^T for the direct ddt and the column part of dcum.  dx leaves
//      through X_j's own rows in 16-byte stores of whole rows.
//   M's diagonal enters dcum_i once from each side with opposite signs:
//   both kernels leave it out, so it cancels exactly (ddt keeps it).
//   Arithmetic: products of bf16 values accumulate in fp32, so G and D
//   differ from the reference only in summation order; W_D, W_G and C o
//   exp(cum) are each rounded to bf16 once, h0 and dh1 for their products
//   only (the plain emulation in tests/test_torch_kernels.py holds this
//   within 6e-3 of each gradient's max against jax.vjp, so no hi + lo
//   split is needed); dcum, ddt, g and da are summed from fp32 fragments;
//   dC and dB per head are fp32.  Bound: 2e-2 of each gradient's
//   max|plain|.  Operands: 16-byte aligned x, B, C, dy with (b, s, h)
//   strides of x, B, C that are multiples of 8 elements, N a multiple of
//   8 (the wrapper raises otherwise).  Shared memory: the whole chunk,
//   93 KB a block at P=64, N=16, chunk 256 and 222 KB at mamba2-1.3b's
//   N=128.  The cum of the chunk, the loads and the decay factors are the
//   forward's own code (ssd_common.cuh), so cum is the forward's to the
//   bit.
//
// fp32 -> the port's first design, IEEE fp32 on the CUDA cores (the
//   card-vs-CPU bound for fp32 models, 1e-4, which bf16 or TF32 products
//   cannot hold): ssd_bwd_rows_kernel and ssd_bwd_cols_kernel, 64-row
//   tiles with four threads per row i (or column j) holding its C_i and
//   dy_i (B_j and x_j) split over N and P in registers; the other side's
//   tiles staged in shared memory as fp32, G and D as quad-shuffle sums,
//   the carried-state terms as scalar loops over P x N.
//
// Inputs: x (B, S, H, P) and B, C (B, S, N) in one dtype (bf16 or fp32),
// read in place through their strides (last dims contiguous); dt (B, S, H)
// and a (H,) fp32; dy (B, S, H, P) contiguous in x's dtype; states (B, H,
// chunks, P, N) fp32, the state entering each chunk, kept by the forward;
// dh_last (B, H, P, N) fp32 or null (zero).  Outputs: dx (B, S, H, P) in
// x's dtype, ddt (B, S, H) fp32, da (H,) fp32, dB, dC (B, S, N) in x's
// dtype, all contiguous.  Steps past the sequence end (a ragged last chunk)
// read as dt = 0, x = B = C = dy = 0 and get no gradient.  P in {16, 32,
// 64}, N <= 128 (zero-padded to 16, 32, 64 or 128), chunk <= 256.
//
// Plain C interface (bound with ctypes): returns a CUDA error code (0 on
// success) after the launches; launches on the caller's stream and never
// synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 64 rows x 4 threads; the block scan's width
constexpr int kRows = 64;       // rows (or columns) of a tile
constexpr int kTpr = 4;         // threads per row
constexpr int kMaxChunk = 256;  // Q <= kThreads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  int64_t x_sb, x_ss, x_sh;    // x (B, S, H, P)
  int64_t dt_sb, dt_ss, dt_sh; // dt (B, S, H)
  int64_t b_sb, b_ss;          // B (B, S, N)
  int64_t c_sb, c_ss;          // C (B, S, N)
  int seq, heads, n, chunk, nc;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

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
  __syncthreads();  // warp_tot may be reused
  return v;
}

// sum over the block, in a fixed order (every thread gets the total)
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();  // red may be reused
  return t;
}

// dt and cum = cumsum(dt * a) of the chunk into shared memory, for all
// kMaxChunk entries (steps past the chunk or the sequence read dt = 0)
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dt,
                                          float a_h, const Args& g, int bi,
                                          int hh, int c0, float* dt_s,
                                          float* cum_s, float* warp_tot) {
  const int tid = threadIdx.x;
  const float dt_t = (tid < g.chunk && c0 + tid < g.seq)
                         ? dt[bi * g.dt_sb + (int64_t)(c0 + tid) * g.dt_ss +
                              hh * g.dt_sh]
                         : 0.0f;
  const float cum_t = block_inclusive_scan(dt_t * a_h, warp_tot);
  cum_s[tid] = cum_t;
  dt_s[tid] = dt_t;
  __syncthreads();
}

// chunk rows [r0, r0 + kRows) of a row-major operand (row stride s_stride,
// `width` valid columns) into shared memory as fp32 with row pitch `pitch`,
// zero-padded to `wpad` columns and past the chunk or the sequence
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int pitch, int width,
                                           int wpad, const T* base,
                                           int64_t s_stride, int c0, int r0,
                                           const Args& g) {
  for (int idx = threadIdx.x; idx < kRows * wpad; idx += kThreads) {
    const int r = idx / wpad, col = idx - r * wpad;
    const int i = r0 + r;
    const bool ok = i < g.chunk && c0 + i < g.seq && col < width;
    dst[r * pitch + col] =
        ok ? to_f32(base[(int64_t)(c0 + i) * s_stride + col]) : 0.0f;
  }
}

// this thread's entries k * 4 + part of a staged row
template <int K>
__device__ __forceinline__ float dot_part(const float* r, const float* row,
                                          int part) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) s = fmaf(r[k], row[k * 4 + part], s);
  return s;
}

template <int K>
__device__ __forceinline__ void axpy_part(float* acc, float c,
                                          const float* row, int part) {
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = fmaf(c, row[k * 4 + part], acc[k]);
}

template <int P, int NPT>
constexpr int rows_smem_floats() {
  return P * (4 * NPT + 1) + 2 * kRows * (4 * NPT + 1) + 2 * kRows * (P + 1) +
         3 * kMaxChunk + kThreads / 32;
}

template <int P, int NPT>
constexpr int cols_smem_floats() {
  return P * (4 * NPT + 1) + 2 * kRows * (4 * NPT + 1) + 2 * kRows * (P + 1) +
         4 * kMaxChunk + 2 * (kThreads / 32);
}

// The end of launch 3, over the whole chunk (kThreads threads): with the
// row part of dcum from launch 1, the block's column part dcm_s, its
// direct ddt_s, this thread's parts tsum of sum_j w_j s_j and dot_h of
// <dh1, h0>, the reverse cumulative sum g_r = sum_{i >= r} dcum_i, then
// ddt and the chunk's part of da.
__device__ void finish_chunk(const float* __restrict__ dcum,
                             const float* dcm_s, const float* ddt_s,
                             const float* dt_s, float a_h, float cq,
                             float tsum, float dot_h, const Args& g, int bi,
                             int hh, int ci, float* __restrict__ ddt,
                             float* __restrict__ da_part, float* warp_tot,
                             float* red) {
  const int tid = threadIdx.x, q = g.chunk, c0 = ci * q;
  const int64_t bh = (int64_t)bi * g.heads + hh;
  const float tq = block_sum(tsum, red);
  const float eh = expf(cq) * block_sum(dot_h, red);

  // g_r = sum_{i >= r} dcum_i: an inclusive scan over r = q - 1 - tid
  const int r = q - 1 - tid;
  float v = 0.0f;
  if (tid < q) {
    v = dcum[(bh * g.nc + ci) * q + r] + dcm_s[r];
    if (r == q - 1) v += eh + tq;
  }
  const float gr = block_inclusive_scan(v, warp_tot);
  float dap = 0.0f;
  if (tid < q) {
    if (c0 + r < g.seq)
      ddt[((int64_t)bi * g.seq + c0 + r) * g.heads + hh] =
          fmaf(a_h, gr, ddt_s[r]);
    dap = dt_s[r] * gr;
  }
  dap = block_sum(dap, red);
  if (tid == 0) da_part[bh * g.nc + ci] = dap;
}

// 1. dC (per head), the row part of dcum, U and cum_Q
template <typename T, int P, int NPT>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bmat,
                    const T* __restrict__ cmat, const T* __restrict__ dy,
                    const float* __restrict__ states,
                    float* __restrict__ dc_part, float* __restrict__ dcum,
                    float* __restrict__ u_out, float* __restrict__ cum_q,
                    Args g) {
  constexpr int NP = 4 * NPT, PPT = P / 4, NPP = NP + 1, PP = P + 1;
  constexpr int kU = (P * NP + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float* h0_s = reinterpret_cast<float*>(smem4);  // [P][NPP]
  float* c_s = h0_s + P * NPP;                     // [kRows][NPP] rows i
  float* dy_s = c_s + kRows * NPP;                 // [kRows][PP]
  float* b_s = dy_s + kRows * PP;                  // [kRows][NPP] keys j
  float* x_s = b_s + kRows * NPP;                  // [kRows][PP]
  float* cum_s = x_s + kRows * PP;                 // [kMaxChunk]
  float* dt_s = cum_s + kMaxChunk;                 // [kMaxChunk]
  float* e_s = dt_s + kMaxChunk;                   // [kMaxChunk] exp(cum)
  float* warp_tot = e_s + kMaxChunk;               // [kThreads / 32]

  const int tid = threadIdx.x, row = tid / kTpr, part = tid % kTpr;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int q = g.chunk, c0 = ci * q, n = g.n;
  const int64_t bh = (int64_t)bi * g.heads + hh;
  chunk_cum(dt, a[hh], g, bi, hh, c0, dt_s, cum_s, warp_tot);
  e_s[tid] = expf(cum_s[tid]);
  const float* h0 = states + (bh * g.nc + ci) * P * n;
  for (int o = tid; o < P * NP; o += kThreads) {
    const int p = o / NP, nn = o - p * NP;
    h0_s[p * NPP + nn] = nn < n ? h0[p * n + nn] : 0.0f;
  }
  float uacc[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) uacc[u] = 0.0f;

  const T* xb = x + bi * g.x_sb + hh * g.x_sh;
  const T* bb = bmat + bi * g.b_sb;
  const T* cb = cmat + bi * g.c_sb;
  const T* dyb = dy + ((int64_t)bi * g.seq * g.heads + hh) * P;
  const int64_t dy_ss = (int64_t)g.heads * P;
  const int tiles = (q + kRows - 1) / kRows;

  for (int rt = 0; rt < tiles; ++rt) {
    const int r0 = rt * kRows;
    __syncthreads();  // every thread is done with the previous tile
    stage_rows(c_s, NPP, n, NP, cb, g.c_ss, c0, r0, g);
    stage_rows(dy_s, PP, P, P, dyb, dy_ss, c0, r0, g);
    __syncthreads();
    const int i = r0 + row;
    const float cum_i = cum_s[i], e_i = e_s[i];
    float cr[NPT], dyr[PPT], dca[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) cr[k] = c_s[row * NPP + k * 4 + part];
#pragma unroll
    for (int k = 0; k < PPT; ++k) dyr[k] = dy_s[row * PP + k * 4 + part];
    // the carried state's terms: exp(cum_i) h0^T dy_i into dC_i, and
    // exp(cum_i) dy_i . h0 C_i into dcum_i
    float sd = 0.0f;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int nn = k * 4 + part;
      float s = 0.0f;
#pragma unroll 8
      for (int p = 0; p < P; ++p)
        s = fmaf(h0_s[p * NPP + nn], dy_s[row * PP + p], s);
      dca[k] = e_i * s;
      sd = fmaf(cr[k], s, sd);
    }
    float dcm = e_i * quad_sum(sd);

    for (int kt = 0; kt <= rt; ++kt) {
      __syncthreads();
      stage_rows(b_s, NPP, n, NP, bb, g.b_ss, c0, kt * kRows, g);
      stage_rows(x_s, PP, P, P, xb, g.x_ss, c0, kt * kRows, g);
      __syncthreads();
      for (int jj = 0; jj < kRows; ++jj) {
        const float* brow = b_s + jj * NPP;
        const float gij = quad_sum(dot_part<NPT>(cr, brow, part));
        const float dij = quad_sum(dot_part<PPT>(dyr, x_s + jj * PP, part));
        if (kt < rt || jj <= row) {  // j <= i
          const int j = kt * kRows + jj;
          const float coef = dij * expf(cum_i - cum_s[j]) * dt_s[j];
          axpy_part<NPT>(dca, coef, brow, part);
          dcm = fmaf(coef, gij, dcm);
        }
      }
    }
    if (i < q && c0 + i < g.seq) {
      float* dst = dc_part + (bh * g.seq + c0 + i) * n;
#pragma unroll
      for (int k = 0; k < NPT; ++k)
        if (k * 4 + part < n) dst[k * 4 + part] = dca[k];
    }
    if (i < q && part == 0) dcum[(bh * g.nc + ci) * q + i] = dcm;

    // U += sum over the tile's rows of exp(cum_i) dy_i C_i^T
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int o = tid + u * kThreads;
      if (o < P * NP) {
        const int p = o / NP, nn = o - p * NP;
        float s = 0.0f;
        for (int r = 0; r < kRows && r0 + r < q; ++r)
          s = fmaf(e_s[r0 + r] * dy_s[r * PP + p], c_s[r * NPP + nn], s);
        uacc[u] += s;
      }
    }
  }
  float* uo = u_out + (bh * g.nc + ci) * P * n;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int o = tid + u * kThreads;
    if (o < P * NP) {
      const int p = o / NP, nn = o - p * NP;
      if (nn < n) uo[p * n + nn] = uacc[u];
    }
  }
  if (tid == 0) cum_q[bh * g.nc + ci] = cum_s[q - 1];
}

// 2. the state gradients, from the last chunk back: on entry du holds each
// chunk's U, on exit the gradient of the state leaving the chunk
__global__ void __launch_bounds__(256)
ssd_bwd_state_pass_kernel(float* __restrict__ du,
                          const float* __restrict__ cum_q,
                          const float* __restrict__ dh_last, int pn, int nc) {
  const int e = blockIdx.y * 256 + threadIdx.x;
  if (e >= pn) return;
  const int64_t bh = blockIdx.x;
  float* d = du + bh * nc * pn + e;
  const float* cq = cum_q + bh * nc;
  float carry = dh_last != nullptr ? dh_last[bh * pn + e] : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const float u = d[(int64_t)c * pn];
    d[(int64_t)c * pn] = carry;
    carry = fmaf(expf(cq[c]), carry, u);
  }
}

// 3. dx, dB (per head), ddt and the chunk's part of da
template <typename T, int P, int NPT>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cols_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bmat,
                    const T* __restrict__ cmat, const T* __restrict__ dy,
                    const float* __restrict__ states,
                    const float* __restrict__ dh1_all,
                    const float* __restrict__ dcum, T* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ db_part,
                    float* __restrict__ da_part, Args g) {
  constexpr int NP = 4 * NPT, PPT = P / 4, NPP = NP + 1, PP = P + 1;
  extern __shared__ float4 smem4[];
  float* dh_s = reinterpret_cast<float*>(smem4);  // [P][NPP]
  float* b_s = dh_s + P * NPP;                     // [kRows][NPP] columns j
  float* x_s = b_s + kRows * NPP;                  // [kRows][PP]
  float* c_s = x_s + kRows * PP;                   // [kRows][NPP] rows i
  float* dy_s = c_s + kRows * NPP;                 // [kRows][PP]
  float* cum_s = dy_s + kRows * PP;                // [kMaxChunk]
  float* dt_s = cum_s + kMaxChunk;                 // [kMaxChunk]
  float* ddt_s = dt_s + kMaxChunk;                 // [kMaxChunk] direct ddt
  float* dcm_s = ddt_s + kMaxChunk;                // [kMaxChunk] column dcum
  float* warp_tot = dcm_s + kMaxChunk;             // [kThreads / 32]
  float* red = warp_tot + kThreads / 32;           // [kThreads / 32]

  const int tid = threadIdx.x, row = tid / kTpr, part = tid % kTpr;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int q = g.chunk, c0 = ci * q, n = g.n;
  const int64_t bh = (int64_t)bi * g.heads + hh;
  const float a_h = a[hh];
  chunk_cum(dt, a_h, g, bi, hh, c0, dt_s, cum_s, warp_tot);
  const float cq = cum_s[q - 1];
  const float* dh1 = dh1_all + (bh * g.nc + ci) * P * n;
  const float* h0 = states + (bh * g.nc + ci) * P * n;
  float dot_h = 0.0f;  // this thread's part of <dh1, h0>
  for (int o = tid; o < P * NP; o += kThreads) {
    const int p = o / NP, nn = o - p * NP;
    const float v = nn < n ? dh1[p * n + nn] : 0.0f;
    dh_s[p * NPP + nn] = v;
    if (nn < n) dot_h = fmaf(v, h0[p * n + nn], dot_h);
  }
  float tsum = 0.0f;  // this thread's part of sum_j w_j s_j

  const T* xb = x + bi * g.x_sb + hh * g.x_sh;
  const T* bb = bmat + bi * g.b_sb;
  const T* cb = cmat + bi * g.c_sb;
  const T* dyb = dy + ((int64_t)bi * g.seq * g.heads + hh) * P;
  const int64_t dy_ss = (int64_t)g.heads * P;
  const int tiles = (q + kRows - 1) / kRows;

  for (int ct = 0; ct < tiles; ++ct) {
    __syncthreads();  // every thread is done with the previous tiles
    stage_rows(b_s, NPP, n, NP, bb, g.b_ss, c0, ct * kRows, g);
    stage_rows(x_s, PP, P, P, xb, g.x_ss, c0, ct * kRows, g);
    __syncthreads();
    const int j = ct * kRows + row;
    const float dt_j = dt_s[j], cum_j = cum_s[j];
    const float e_j = expf(cq - cum_j), w_j = e_j * dt_j;
    float br[NPT], xr[PPT], dxa[PPT], dba[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) br[k] = b_s[row * NPP + k * 4 + part];
#pragma unroll
    for (int k = 0; k < PPT; ++k) xr[k] = x_s[row * PP + k * 4 + part];
    // the state-update terms: w_j dh1 B_j into dx_j, w_j dh1^T x_j into
    // dB_j, and s_j = x_j . dh1 B_j
    float sp = 0.0f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = k * 4 + part;
      float t = 0.0f;
#pragma unroll 8
      for (int nn = 0; nn < NP; ++nn)
        t = fmaf(dh_s[p * NPP + nn], b_s[row * NPP + nn], t);
      dxa[k] = w_j * t;
      sp = fmaf(xr[k], t, sp);
    }
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int nn = k * 4 + part;
      float t = 0.0f;
#pragma unroll 8
      for (int p = 0; p < P; ++p)
        t = fmaf(dh_s[p * NPP + nn], x_s[row * PP + p], t);
      dba[k] = w_j * t;
    }
    const float s_j = quad_sum(sp);
    float dd = e_j * s_j, dcm = -w_j * s_j;
    if (part == 0 && j < q) tsum = fmaf(w_j, s_j, tsum);

    for (int rt = ct; rt < tiles; ++rt) {
      __syncthreads();
      stage_rows(c_s, NPP, n, NP, cb, g.c_ss, c0, rt * kRows, g);
      stage_rows(dy_s, PP, P, P, dyb, dy_ss, c0, rt * kRows, g);
      __syncthreads();
      for (int ii = 0; ii < kRows; ++ii) {
        const float* crow = c_s + ii * NPP;
        const float* dyrow = dy_s + ii * PP;
        const float gij = quad_sum(dot_part<NPT>(br, crow, part));
        const float dij = quad_sum(dot_part<PPT>(xr, dyrow, part));
        const int i = rt * kRows + ii;
        if ((rt > ct || ii >= row) && i < q) {  // i >= j
          const float l = expf(cum_s[i] - cum_j);
          const float dl = dij * l;
          axpy_part<PPT>(dxa, gij * l * dt_j, dyrow, part);
          axpy_part<NPT>(dba, dl * dt_j, crow, part);
          dd = fmaf(dl, gij, dd);
          dcm = fmaf(-dl * gij, dt_j, dcm);
        }
      }
    }
    if (j < q && c0 + j < g.seq) {
      T* dxr = dx + (((int64_t)bi * g.seq + c0 + j) * g.heads + hh) * P;
#pragma unroll
      for (int k = 0; k < PPT; ++k) store_val(dxr + k * 4 + part, dxa[k]);
      float* dbr = db_part + (bh * g.seq + c0 + j) * n;
#pragma unroll
      for (int k = 0; k < NPT; ++k)
        if (k * 4 + part < n) dbr[k * 4 + part] = dba[k];
    }
    if (j < q && part == 0) {
      ddt_s[j] = dd;
      dcm_s[j] = dcm;
    }
  }
  finish_chunk(dcum, dcm_s, ddt_s, dt_s, a_h, cq, tsum, dot_h, g, bi, hh, ci,
               ddt, da_part, warp_tot, red);
}

// 4. dB, dC over the heads; da over batch and chunks
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ db_part,
                      const float* __restrict__ dc_part,
                      const float* __restrict__ da_part, T* __restrict__ db,
                      T* __restrict__ dc, float* __restrict__ da, int batch,
                      int seq, int heads, int n, int nc) {
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int64_t sn = (int64_t)seq * n, total = batch * sn;
  if (idx < total) {
    const int64_t bi = idx / sn, rem = idx - bi * sn;
    float sb = 0.0f, sc = 0.0f;
    for (int h = 0; h < heads; ++h) {
      const int64_t off = (bi * heads + h) * sn + rem;
      sb += db_part[off];
      sc += dc_part[off];
    }
    store_val(db + idx, sb);
    store_val(dc + idx, sc);
  } else if (idx < total + heads) {
    const int h = (int)(idx - total);
    float s = 0.0f;
    for (int bi = 0; bi < batch; ++bi)
      for (int c = 0; c < nc; ++c) s += da_part[((int64_t)bi * heads + h) * nc + c];
    da[h] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma)
// ---------------------------------------------------------------------------
using ssd::kTile;
constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kSide = 6;         // fp32 side values a row (see tc_smem)

// Shared memory of both chunk kernels, from a 1024-byte aligned base: dY
// and X (rows x 128 B each, 128-byte swizzle), C and B (NP/16 blocks of
// rows x 32 B each, 32-byte swizzle), the state h0 or dh1 in bf16 (NP/16
// blocks of P x 32 B), then kSide * rows + 32 fp32 side values.
struct TcSmem {
  uint8_t* base;
  uint32_t dy, x, c, b, h;  // shared-space addresses
  float* f;
  __device__ uint8_t* at(uint32_t addr) const { return base + (addr - dy); }
};

__device__ __forceinline__ TcSmem tc_smem(uint8_t* raw, int rows, int nkb,
                                          int p) {
  TcSmem t;
  t.base = raw + (((smem_addr(raw) + 1023u) & ~1023u) - smem_addr(raw));
  t.dy = smem_addr(t.base);
  t.x = t.dy + rows * kSwRow;
  t.c = t.x + rows * kSwRow;
  t.b = t.c + nkb * rows * 32;
  t.h = t.b + nkb * rows * 32;
  t.f = reinterpret_cast<float*>(t.at(t.h + nkb * p * 32));
  return t;
}

size_t tc_smem_bytes(int p, int np, int rows) {
  return 1024 + 2 * (size_t)rows * kSwRow +
         (size_t)(np / 16) * 32 * (2 * rows + p) +
         sizeof(float) * (kSide * rows + 32);
}

__device__ __forceinline__ float2 ld_bf2(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 1. dC (per head), the row part of dcum, U and cum_Q
template <int P, int NP>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bwd_rows_tc_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const bf16* __restrict__ bmat,
                       const bf16* __restrict__ cmat,
                       const bf16* __restrict__ dy,
                       const float* __restrict__ states,
                       float* __restrict__ dc_part, float* __restrict__ dcum,
                       float* __restrict__ u_out, float* __restrict__ cum_q,
                       Args g) {
  constexpr int kNkb = NP / 16, kNch = NP / 8;
  const int rows = ssd::tile_rows(g.chunk), q = g.chunk;
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem(smem_raw, rows, kNkb, P);
  float* dt_s = sm.f;
  float* cum_s = dt_s + rows;
  float* vl_s = cum_s + rows;   // exp(cum at the tile's last row - cum) dt
  float* vg_s = vl_s + rows;    // exp(cum at the group's last row - cum) dt
  float* tmax_s = sm.f + kSide * rows;  // [12]: see warp_chunk_cumsum

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int c0 = ci * q;
  const int64_t bh = (int64_t)bi * g.heads + hh;
  float dtv[2];
  ssd::load_dt(dtv, dt, g, bi, hh, c0);
  float4 hv[ssd::kStateChunks<P, kTcThreads>][2];
  ssd::load_state<P, kTcThreads>(hv, states + (bh * g.nc + ci) * P * g.n,
                                 g.n, kNch);
  ssd::load_bc(sm.c, cmat + bi * g.c_sb, g.c_ss, g, c0, rows, kNch);
  ssd::load_bc(sm.b, bmat + bi * g.b_sb, g.b_ss, g, c0, rows, kNch);
  ssd::load_x(sm.dy, dy + ((int64_t)bi * g.seq * g.heads + hh) * P,
              (int64_t)g.heads * P, g, c0, rows, P);
  ssd::load_x(sm.x, x + bi * g.x_sb + hh * g.x_sh, g.x_ss, g, c0, rows, P);
  cp_async_commit();
  ssd::store_state<P, kTcThreads>(sm.at(sm.h), hv, kNch);
  ssd::chunk_cum(dtv, a[hh], rows, dt_s, cum_s, tmax_s);
  ssd::decay_factors(cum_s, dt_s, vl_s, vg_s, rows);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  const uint8_t* c_tile = sm.at(sm.c);
  const int nt = rows / kTile;
  const unsigned mine = ssd::own_tiles(wgi, nt, true);
  for (int t = nt - 1; t >= 0; --t) {
    if (!((mine >> t) & 1u)) continue;
    const int row0 = t * kTile;
    const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;

    // the carried state: Z = dY_i h0 (k = P, h0 read N-major); dC_i gets
    // exp(cum_i) Z_i and dcum_i gets exp(cum_i) Z_i . C_i
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss_nt(acc, kmajor_desc(sm.dy + row0 * kSwRow + kk * 32),
                  mnmajor32_desc(sm.h + kk * 16 * 32, P * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    const float ea = expf(cum_s[ra]), eb = expf(cum_s[rb]);
    float dca = 0.0f, dcb = 0.0f;  // this thread's part of the rows' dcum
#pragma unroll
    for (int jb = 0; jb < NP / 8; ++jb) {
      const float2 ca = ld_bf2(c_tile + swz32(rows, ra, jb) + 2 * cq);
      const float2 cb = ld_bf2(c_tile + swz32(rows, rb, jb) + 2 * cq);
      dca = fmaf(acc[4 * jb], ca.x, fmaf(acc[4 * jb + 1], ca.y, dca));
      dcb = fmaf(acc[4 * jb + 2], cb.x, fmaf(acc[4 * jb + 3], cb.y, dcb));
    }
    dca *= ea;
    dcb *= eb;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] *= (i & 2) ? eb : ea;

    for (int j = 0; j <= t; ++j) {
      const int k0 = j * kTile;
      // G = C_i B_j^T (k = N) and D = dY_i X_j^T (k = P), all K-major
      float s[32], d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = d[i] = 0.0f;
      pin(s);  // (not acc: dC's product of j-1 may still run)
      pin(d);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kNkb; ++kb)
        wgmma_ss(s, kmajor32_desc(sm.c + (kb * rows + row0) * 32),
                 kmajor32_desc(sm.b + (kb * rows + k0) * 32), kb > 0);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        wgmma_ss(d, kmajor_desc(sm.dy + row0 * kSwRow + kk * 32),
                 kmajor_desc(sm.x + k0 * kSwRow + kk * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // G and D of j, and dC's product of j-1
      pin(s);
      pin(d);
      pin(acc);

      // W_D = D o L o dt_j on the fragments (s[4 jb + e] and d[4 jb + e]
      // are row ra + 8 (e >> 1), key k0 + 8 jb + cq + (e & 1)), factored
      // as the forward factors its W; M = W_D o G summed along the rows,
      // its diagonal left out (it enters launch 3's column part too, with
      // the opposite sign)
      const bool diag = j == t;
      const float ref = cum_s[k0 + kTile - 1];
      const bool factored = diag
          ? tmax_s[8 + t] != 0.0f
          : tmax_s[t] <= ref && tmax_s[4 + j] >= ref;
      uint32_t pa[16];
      if (factored && !diag) {
        const float ua = expf(cum_s[ra] - ref), ub = expf(cum_s[rb] - ref);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int key = k0 + 8 * (i >> 2) + cq;
          const float u = (i & 2) ? ub : ua;
          const float w0 = d[i] * u * vl_s[key];
          const float w1 = d[i + 1] * u * vl_s[key + 1];
          const float m = fmaf(w0, s[i], w1 * s[i + 1]);
          if (i & 2) dcb += m; else dca += m;
          pa[i >> 1] = pack_bf16(w0, w1);
        }
      } else {
        float ug[2][3];  // rows ra, rb against the groups before `warp`
#pragma unroll
        for (int gi = 0; gi < 3; ++gi) {
          const float cg = cum_s[k0 + 16 * gi + 15];
          const bool below = factored && gi < warp;
          ug[0][gi] = below ? expf(cum_s[ra] - cg) : 0.0f;
          ug[1][gi] = below ? expf(cum_s[rb] - cg) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int gi = i >> 3, key = k0 + 8 * (i >> 2) + cq;
          const int h = (i >> 1) & 1, row = h ? rb : ra;
          float w0 = 0.0f, w1 = 0.0f, m = 0.0f;
          if (factored && gi < warp) {
            const float u = ug[h][gi < 3 ? gi : 0];
            w0 = d[i] * u * vg_s[key];
            w1 = d[i + 1] * u * vg_s[key + 1];
            m = fmaf(w0, s[i], w1 * s[i + 1]);
          } else if (!factored || gi == warp) {
            const float cr = cum_s[row];
            if (key <= row)
              w0 = d[i] * __expf(cr - cum_s[key]) * dt_s[key];
            if (key + 1 <= row)
              w1 = d[i + 1] * __expf(cr - cum_s[key + 1]) * dt_s[key + 1];
            if (key < row) m = w0 * s[i];
            if (key + 1 < row) m = fmaf(w1, s[i + 1], m);
          }
          if (h) dcb += m; else dca += m;
          pa[i >> 1] = pack_bf16(w0, w1);
        }
      }

      // dC_i += W_D B_j, 16 keys a wgmma: B_j's rows read N-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t af[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                pa[4 * kk + 3]};
        wgmma_rs(acc, af,
                 mnmajor32_desc(sm.b + (k0 + 16 * kk) * 32, rows * 32));
      }
      wgmma_commit();  // left in flight: waited for with the next G, D
    }
    wgmma_wait_all();
    pin(acc);

    dca = quad_sum(dca);
    dcb = quad_sum(dcb);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (row >= q) continue;
      if (c0 + row < g.seq) {
        float* dst = dc_part + (bh * g.seq + c0 + row) * g.n;
#pragma unroll
        for (int jb = 0; jb < NP / 8; ++jb) {
          const int col = 8 * jb + cq;
          if (col < g.n)
            *reinterpret_cast<float2*>(dst + col) = make_float2(
                acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]);
        }
      }
      if ((lane & 3) == 0)
        dcum[(bh * g.nc + ci) * q + row] = half ? dcb : dca;
    }
  }

  // U = dY^T (C o exp(cum)), the chunk's own part of dh0: C o exp(cum)
  // rounded to bf16 once into B's place (every product reading B has
  // retired), then dY^T read as an M-major A and C o exp(cum) N-major, as
  // the forward's chunk state reads X^T and B o w
  __syncthreads();
  uint8_t* ce_tile = sm.at(sm.b);
  for (int idx = tid; idx < rows * kNch; idx += kTcThreads) {
    const int r = idx / kNch, c = idx - r * kNch;
    const uint32_t off = swz32(rows, r, c);
    const uint4 raw = *reinterpret_cast<const uint4*>(c_tile + off);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float er = expf(cum_s[r]);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      o[e] = pack_bf16(f.x * er, f.y * er);
    }
    *reinterpret_cast<uint4*>(ce_tile + off) = out;
  }
  fence_proxy_async();
  __syncthreads();
  if (wgi != 0) return;
  float u[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) u[i] = 0.0f;
  pin(u);
  wgmma_fence();
  const int ksteps = (q + 15) / 16;
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss_tt(u, sw128_desc(sm.dy + kk * 16 * kSwRow, rows * kSwRow,
                              8 * kSwRow),
                mnmajor32_desc(sm.b + kk * 16 * 32, rows * 32), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  pin(u);
  float* uo = u_out + (bh * g.nc + ci) * P * g.n;
  const int p0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int jb = 0; jb < NP / 8; ++jb) {
    const int col = 8 * jb + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + 8 * half;
      if (col < g.n && p < P)
        *reinterpret_cast<float2*>(uo + p * g.n + col) =
            make_float2(u[4 * jb + 2 * half], u[4 * jb + 2 * half + 1]);
    }
  }
  if (tid == 0) cum_q[bh * g.nc + ci] = cum_s[rows - 1];
}

// 3. dx, dB (per head), ddt and the chunk's part of da
template <int P, int NP>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bwd_cols_tc_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const bf16* __restrict__ bmat,
                       const bf16* __restrict__ cmat,
                       const bf16* __restrict__ dy,
                       const float* __restrict__ states,
                       const float* __restrict__ dh1_all,
                       const float* __restrict__ dcum, bf16* __restrict__ dx,
                       float* __restrict__ ddt, float* __restrict__ db_part,
                       float* __restrict__ da_part, Args g) {
  constexpr int kNkb = NP / 16, kNch = NP / 8;
  const int rows = ssd::tile_rows(g.chunk), q = g.chunk;
  extern __shared__ uint8_t smem_raw[];
  const TcSmem sm = tc_smem(smem_raw, rows, kNkb, P);
  float* dt_s = sm.f;
  float* cum_s = dt_s + rows;
  float* mu_s = cum_s + rows;   // see below
  float* nu_s = mu_s + rows;
  float* ddt_s = nu_s + rows;   // direct ddt
  float* dcm_s = ddt_s + rows;  // column part of dcum
  float* tmax_s = sm.f + kSide * rows;  // [12]: see warp_chunk_cumsum
  float* warp_tot = tmax_s + 12;        // [kThreads / 32]
  float* red = warp_tot + 8;            // [kThreads / 32]

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int c0 = ci * q;
  const int64_t bh = (int64_t)bi * g.heads + hh;
  const float a_h = a[hh];
  const float* dh1 = dh1_all + (bh * g.nc + ci) * P * g.n;
  float dtv[2];
  ssd::load_dt(dtv, dt, g, bi, hh, c0);
  float4 hv[ssd::kStateChunks<P, kTcThreads>][2];
  ssd::load_state<P, kTcThreads>(hv, dh1, g.n, kNch);
  ssd::load_bc(sm.c, cmat + bi * g.c_sb, g.c_ss, g, c0, rows, kNch);
  ssd::load_bc(sm.b, bmat + bi * g.b_sb, g.b_ss, g, c0, rows, kNch);
  ssd::load_x(sm.dy, dy + ((int64_t)bi * g.seq * g.heads + hh) * P,
              (int64_t)g.heads * P, g, c0, rows, P);
  ssd::load_x(sm.x, x + bi * g.x_sb + hh * g.x_sh, g.x_ss, g, c0, rows, P);
  cp_async_commit();
  ssd::store_state<P, kTcThreads>(sm.at(sm.h), hv, kNch);
  ssd::chunk_cum(dtv, a_h, rows, dt_s, cum_s, tmax_s);
  // The decay exp(cum_i - cum_j) of a row j and a later column i, where
  // cum never rises, factors through the row before the column's tile
  // (below the diagonal tile) or before its 16-row group (on it): the
  // column factors mu_s[i] and nu_s[i] here, both <= 1, the row factors
  // per thread; see ssd::decay_factors for the rows' side in launch 1.
  for (int r = tid; r < rows; r += kTcThreads) {
    mu_s[r] = r >= kTile
        ? expf(cum_s[r] - cum_s[(r & ~(kTile - 1)) - 1]) : 0.0f;
    nu_s[r] = (r & (kTile - 1)) >= 16
        ? expf(cum_s[r] - cum_s[(r & ~15) - 1]) : 0.0f;
  }
  float dot_h = 0.0f;  // this thread's part of <dh1, h0>, in fp32
  const float* h0 = states + (bh * g.nc + ci) * P * g.n;
  for (int o = tid; o < P * g.n; o += kTcThreads)
    dot_h = fmaf(dh1[o], h0[o], dot_h);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  const float cqv = cum_s[rows - 1];
  uint8_t* x_tile = sm.at(sm.x);
  const int nt = rows / kTile;
  const unsigned mine = ssd::own_tiles(wgi, nt, false);
  float tsum = 0.0f;  // this thread's part of sum_j w_j s_j
  for (int t = 0; t < nt; ++t) {
    if (!((mine >> t) & 1u)) continue;
    const int row0 = t * kTile;
    const int ja = row0 + warp * 16 + (lane >> 2), jb = ja + 8;

    // the state terms: T = B_j dh1^T (k = N, dh1 K-major) and X_j dh1
    // (k = P, dh1 N-major); dx_j gets w_j T_j, dB_j gets w_j X_j dh1, and
    // s_j = x_j . T_j
    float dxa[P / 2], dba[NP / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) dxa[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dba[i] = 0.0f;
    pin(dxa);
    pin(dba);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kNkb; ++kb)
      wgmma_ss(dxa, kmajor32_desc(sm.b + (kb * rows + row0) * 32),
               kmajor32_desc(sm.h + kb * P * 32), kb > 0);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss_nt(dba, kmajor_desc(sm.x + row0 * kSwRow + kk * 32),
                  mnmajor32_desc(sm.h + kk * 16 * 32, P * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(dxa);
    pin(dba);
    const float dta = dt_s[ja], dtb = dt_s[jb];
    const float eja = expf(cqv - cum_s[ja]), ejb = expf(cqv - cum_s[jb]);
    const float wa = eja * dta, wb = ejb * dtb;
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int pb = 0; pb < P / 8; ++pb) {
      const float2 xa = ld_bf2(x_tile + swz(rows, ja, pb) + 2 * cq);
      const float2 xb = ld_bf2(x_tile + swz(rows, jb, pb) + 2 * cq);
      sa = fmaf(dxa[4 * pb], xa.x, fmaf(dxa[4 * pb + 1], xa.y, sa));
      sb = fmaf(dxa[4 * pb + 2], xb.x, fmaf(dxa[4 * pb + 3], xb.y, sb));
    }
    sa = quad_sum(sa);
    sb = quad_sum(sb);
#pragma unroll
    for (int i = 0; i < P / 2; ++i) dxa[i] *= (i & 2) ? wb : wa;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dba[i] *= (i & 2) ? wb : wa;

    // sum_{i >= j} D_ij G_ij L_ij (all) and without i = j (off)
    float ra_all = 0.0f, rb_all = 0.0f, ra_off = 0.0f, rb_off = 0.0f;
    for (int it = t; it < nt; ++it) {
      const int i0 = it * kTile;
      // G^T = B_j C_i^T (k = N) and D^T = X_j dY_i^T (k = P), all K-major
      float s[32], d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = d[i] = 0.0f;
      pin(s);  // (not dxa, dba: their products of i-1 may still run)
      pin(d);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kNkb; ++kb)
        wgmma_ss(s, kmajor32_desc(sm.b + (kb * rows + row0) * 32),
                 kmajor32_desc(sm.c + (kb * rows + i0) * 32), kb > 0);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        wgmma_ss(d, kmajor_desc(sm.x + row0 * kSwRow + kk * 32),
                 kmajor_desc(sm.dy + i0 * kSwRow + kk * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // G^T and D^T of i, and the products of i-1
      pin(s);
      pin(d);
      pin(dxa);
      pin(dba);

      // W_G^T = G^T o L^T o dt_j and W_D^T = D^T o L^T o dt_j on the
      // fragments (s[4 ib + e] is row ja + 8 (e >> 1), column i0 + 8 ib +
      // cq + (e & 1)), and the row sums of D^T o G^T o L^T
      const bool diag = it == t;
      uint32_t pg[16], pd[16];
      bool factored;
      float ref = 0.0f;
      if (diag) {
        factored = tmax_s[8 + t] != 0.0f;
      } else {
        ref = cum_s[i0 - 1];
        factored = tmax_s[it] <= ref && tmax_s[4 + t] >= ref;
      }
      if (factored && !diag) {
        const float la = expf(ref - cum_s[ja]), lb = expf(ref - cum_s[jb]);
        const float fa = la * dta, fb = lb * dtb;
        float qa = 0.0f, qb = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = i0 + 8 * (i >> 2) + cq;
          const float m0 = mu_s[col], m1 = mu_s[col + 1];
          const float f = (i & 2) ? fb : fa;
          pg[i >> 1] = pack_bf16(s[i] * m0 * f, s[i + 1] * m1 * f);
          pd[i >> 1] = pack_bf16(d[i] * m0 * f, d[i + 1] * m1 * f);
          const float r = fmaf(d[i] * s[i], m0, d[i + 1] * s[i + 1] * m1);
          if (i & 2) qb += r; else qa += r;
        }
        ra_all = fmaf(la, qa, ra_all);
        ra_off = fmaf(la, qa, ra_off);
        rb_all = fmaf(lb, qb, rb_all);
        rb_off = fmaf(lb, qb, rb_off);
      } else {
        float lg[2][3];  // rows ja, jb against the groups after `warp`
#pragma unroll
        for (int gi = 1; gi < 4; ++gi) {
          const float cg = cum_s[i0 + 16 * gi - 1];
          const bool above = factored && gi > warp;
          lg[0][gi - 1] = above ? expf(cg - cum_s[ja]) : 0.0f;
          lg[1][gi - 1] = above ? expf(cg - cum_s[jb]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int gi = i >> 3, col = i0 + 8 * (i >> 2) + cq;
          const int h = (i >> 1) & 1, row = h ? jb : ja;
          float l0 = 0.0f, l1 = 0.0f;
          if (factored && gi > warp) {
            const float l = lg[h][gi > 0 ? gi - 1 : 0];
            l0 = l * nu_s[col];
            l1 = l * nu_s[col + 1];
          } else if (!factored || gi == warp) {
            const float cr = cum_s[row];
            if (col >= row) l0 = __expf(cum_s[col] - cr);
            if (col + 1 >= row) l1 = __expf(cum_s[col + 1] - cr);
          }
          const float dtr = h ? dtb : dta;
          pg[i >> 1] = pack_bf16(s[i] * l0 * dtr, s[i + 1] * l1 * dtr);
          pd[i >> 1] = pack_bf16(d[i] * l0 * dtr, d[i + 1] * l1 * dtr);
          const float r0 = d[i] * s[i] * l0, r1 = d[i + 1] * s[i + 1] * l1;
          const float off = (col != row ? r0 : 0.0f) +
                            (col + 1 != row ? r1 : 0.0f);
          if (h) {
            rb_all += r0 + r1;
            rb_off += off;
          } else {
            ra_all += r0 + r1;
            ra_off += off;
          }
        }
      }

      // dx_j += W_G^T dY_i and dB_j += W_D^T C_i, 16 columns a wgmma:
      // dY_i's and C_i's rows read N-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t ag[4] = {pg[4 * kk], pg[4 * kk + 1], pg[4 * kk + 2],
                                pg[4 * kk + 3]};
        const uint32_t ad[4] = {pd[4 * kk], pd[4 * kk + 1], pd[4 * kk + 2],
                                pd[4 * kk + 3]};
        wgmma_rs(dxa, ag,
                 sw128_desc(sm.dy + (i0 + 16 * kk) * kSwRow, rows * kSwRow,
                            8 * kSwRow));
        wgmma_rs(dba, ad,
                 mnmajor32_desc(sm.c + (i0 + 16 * kk) * 32, rows * 32));
      }
      wgmma_commit();  // left in flight: waited for with the next G^T, D^T
    }
    wgmma_wait_all();
    pin(dxa);
    pin(dba);

    ra_all = quad_sum(ra_all);
    rb_all = quad_sum(rb_all);
    ra_off = quad_sum(ra_off);
    rb_off = quad_sum(rb_off);
    if ((lane & 3) == 0) {
      ddt_s[ja] = fmaf(eja, sa, ra_all);
      ddt_s[jb] = fmaf(ejb, sb, rb_all);
      dcm_s[ja] = -dta * ra_off - wa * sa;
      dcm_s[jb] = -dtb * rb_off - wb * sb;
      if (ja < q) tsum = fmaf(wa, sa, tsum);
      if (jb < q) tsum = fmaf(wb, sb, tsum);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? jb : ja;
      if (row < q && c0 + row < g.seq) {
        float* dst = db_part + (bh * g.seq + c0 + row) * g.n;
#pragma unroll
        for (int nb = 0; nb < NP / 8; ++nb) {
          const int col = 8 * nb + cq;
          if (col < g.n)
            *reinterpret_cast<float2*>(dst + col) = make_float2(
                dba[4 * nb + 2 * half], dba[4 * nb + 2 * half + 1]);
        }
      }
    }
    // dx_j out through X_j's own rows (this warpgroup's alone, and every
    // read of them has retired), then 16-byte stores of whole rows
    ssd::wg_sync(wgi);
#pragma unroll
    for (int pb = 0; pb < P / 8; ++pb)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(
            x_tile + swz(rows, half ? jb : ja, pb) + 2 * cq) =
            pack_bf16(dxa[4 * pb + 2 * half], dxa[4 * pb + 2 * half + 1]);
    ssd::wg_sync(wgi);
    constexpr int kCh = P / 8;
#pragma unroll
    for (int i = 0; i < kTile * kCh / 128; ++i) {
      const int idx = (tid & 127) + 128 * i;
      const int r = idx / kCh, c = idx - r * kCh, row = row0 + r;
      if (row < q && c0 + row < g.seq)
        *reinterpret_cast<uint4*>(
            dx + (((int64_t)bi * g.seq + c0 + row) * g.heads + hh) * P +
            8 * c) =
            *reinterpret_cast<const uint4*>(x_tile + swz(rows, row, c));
    }
  }
  __syncthreads();  // ddt_s and dcm_s are whole
  finish_chunk(dcum, dcm_s, ddt_s, dt_s, a_h, cqv, tsum, dot_h, g, bi, hh,
               ci, ddt, da_part, warp_tot, red);
}

struct Out {
  void *dx, *db, *dc;
  float *ddt, *da;
};

struct Scratch {
  float *dcum, *du, *cum_q, *db_part, *dc_part, *da_part;
};

// The four launches, in order on the caller's stream, each checked: the
// rows kernel kr, the state pass, the columns kernel kc, the head sums.
template <typename T, typename KR, typename KC>
int launch_all(KR kr, KC kc, size_t smem_r, size_t smem_c, int threads,
               int p, const void* x, const float* dt, const float* a,
               const void* b, const void* c, const void* dy,
               const float* states, const float* dh_last, const Out& o,
               const Scratch& s, const Args& g, int batch,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kr, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_c);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.heads, g.nc, batch);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* dyt = static_cast<const T*>(dy);
  kr<<<grid, threads, smem_r, stream>>>(xt, dt, a, bt, ct, dyt, states,
                                        s.dc_part, s.dcum, s.du, s.cum_q, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int pn = p * g.n;
  ssd_bwd_state_pass_kernel<<<dim3(batch * g.heads, (pn + 255) / 256), 256,
                              0, stream>>>(s.du, s.cum_q, dh_last, pn, g.nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kc<<<grid, threads, smem_c, stream>>>(xt, dt, a, bt, ct, dyt, states,
                                        s.du, s.dcum, static_cast<T*>(o.dx),
                                        o.ddt, s.db_part, s.da_part, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t items = (int64_t)batch * g.seq * g.n + g.heads;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((items + 255) / 256), 256, 0,
                             stream>>>(s.db_part, s.dc_part, s.da_part,
                                       static_cast<T*>(o.db),
                                       static_cast<T*>(o.dc), o.da, batch,
                                       g.seq, g.heads, g.n, g.nc);
  return (int)cudaGetLastError();
}

#define BWD_PARAMS const void *x, const float *dt, const float *a,          \
    const void *b, const void *c, const void *dy, const float *states,     \
    const float *dh_last, const Out &o, const Scratch &s, const Args &g,   \
    int batch, cudaStream_t stream
#define BWD_ARGS x, dt, a, b, c, dy, states, dh_last, o, s, g, batch, stream

template <typename T, int P, int NPT>
int run(BWD_PARAMS) {
  return launch_all<T>(ssd_bwd_rows_kernel<T, P, NPT>,
                       ssd_bwd_cols_kernel<T, P, NPT>,
                       sizeof(float) * rows_smem_floats<P, NPT>(),
                       sizeof(float) * cols_smem_floats<P, NPT>(), kThreads,
                       P, BWD_ARGS);
}

template <typename T, int P>
int dispatch_n(BWD_PARAMS) {
  if (g.n <= 16) return run<T, P, 4>(BWD_ARGS);
  if (g.n <= 32) return run<T, P, 8>(BWD_ARGS);
  if (g.n <= 64) return run<T, P, 16>(BWD_ARGS);
  return run<T, P, 32>(BWD_ARGS);
}

template <typename T>
int dispatch_p(int p, BWD_PARAMS) {
  switch (p) {
    case 16: return dispatch_n<T, 16>(BWD_ARGS);
    case 32: return dispatch_n<T, 32>(BWD_ARGS);
    case 64: return dispatch_n<T, 64>(BWD_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

template <int P, int NP>
int run_tc(BWD_PARAMS) {
  const size_t smem = tc_smem_bytes(P, NP, ssd::tile_rows(g.chunk));
  return launch_all<bf16>(ssd_bwd_rows_tc_kernel<P, NP>,
                          ssd_bwd_cols_tc_kernel<P, NP>, smem, smem,
                          kTcThreads, P, BWD_ARGS);
}

template <int P>
int dispatch_tc_n(BWD_PARAMS) {
  switch (ssd::padded_state(g.n)) {
    case 16: return run_tc<P, 16>(BWD_ARGS);
    case 32: return run_tc<P, 32>(BWD_ARGS);
    case 64: return run_tc<P, 64>(BWD_ARGS);
  }
  return run_tc<P, 128>(BWD_ARGS);
}

int dispatch_tc(int p, BWD_PARAMS) {
  switch (p) {
    case 16: return dispatch_tc_n<16>(BWD_ARGS);
    case 32: return dispatch_tc_n<32>(BWD_ARGS);
    case 64: return dispatch_tc_n<64>(BWD_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
#undef BWD_ARGS
#undef BWD_PARAMS

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Shared memory a block of the larger of the two chunk kernels asks for
// (the wrapper refuses what exceeds the card's per-block limit), or -1 for
// a head dim, state size or chunk the kernels do not take.
extern "C" int64_t ssd_scan_bwd_smem_bytes(int head_dim, int state_dim,
                                           int chunk, int is_bf16) {
  if (state_dim < 1 || state_dim > 128 || chunk < 1 || chunk > kMaxChunk)
    return -1;
  if (head_dim != 16 && head_dim != 32 && head_dim != 64) return -1;
  if (is_bf16)
    return (int64_t)tc_smem_bytes(head_dim, ssd::padded_state(state_dim),
                                  ssd::tile_rows(chunk));
  const int npt = state_dim <= 16 ? 4 : state_dim <= 32 ? 8
                  : state_dim <= 64 ? 16 : 32;
  const int64_t pad = 4 * npt + 1;
  return (int64_t)sizeof(float) *
         (head_dim * pad + 2 * kRows * pad + 2 * kRows * (head_dim + 1) +
          4 * kMaxChunk + 2 * (kThreads / 32));
}

// See the note at the top for the operands.  Scratch: dcum B*H*chunks*chunk,
// du B*H*chunks*P*N, cum_q and da_part B*H*chunks, db_part and dc_part
// B*H*S*N, all fp32.  bf16 (is_bf16 = 1) runs on the tensor cores and
// needs N a multiple of 8 and 16-byte aligned x, B, C, dy with (b, s, h)
// strides of x, B, C that are multiples of 8 (else
// cudaErrorMisalignedAddress); fp32 on the CUDA cores.
extern "C" int ssd_scan_bwd(
    const void* x, const float* dt, const float* a, const void* b,
    const void* c, const void* dy, const float* states, const float* dh_last,
    void* dx, float* ddt, float* da, void* db, void* dc, float* dcum,
    float* du, float* cum_q, float* db_part, float* dc_part, float* da_part,
    int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
    int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
    int batch, int seq, int heads, int head_dim, int state_dim, int chunk,
    int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || state_dim < 1 || state_dim > 128)
    return (int)cudaErrorInvalidValue;
  const Args g{x_sb,  x_ss, x_sh,      dt_sb,     dt_ss, dt_sh,
               b_sb,  b_ss, c_sb,      c_ss,      seq,   heads,
               state_dim, chunk, (seq + chunk - 1) / chunk};
  const Out o{dx, db, dc, ddt, da};
  const Scratch s{dcum, du, cum_q, db_part, dc_part, da_part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (state_dim < 8 || state_dim % 8) return (int)cudaErrorInvalidValue;
    if (!(aligned16(x) && aligned16(b) && aligned16(c) && aligned16(dy)) ||
        (x_sb | x_ss | x_sh | b_sb | b_ss | c_sb | c_ss) % 8)
      return (int)cudaErrorMisalignedAddress;
    return dispatch_tc(head_dim, x, dt, a, b, c, dy, states, dh_last, o, s,
                       g, batch, st);
  }
  return dispatch_p<float>(head_dim, x, dt, a, b, c, dy, states, dh_last, o,
                           s, g, batch, st);
}
