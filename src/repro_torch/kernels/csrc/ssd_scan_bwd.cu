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
// Design (SIMT, fp32 arithmetic; no atomics, so every call gives the same
// bits), four launches:
//   1. ssd_bwd_rows_kernel, one block per (head, chunk, batch): for each
//      64-row tile of the chunk, four threads per row i hold C_i and dy_i
//      split over N and P in registers and sum dC_i and the row part of
//      dcum_i over the key tiles j <= i (B_j and x_j staged in shared memory
//      as fp32; G and D are quad-shuffle sums); the carried-state terms read
//      h0 from the states the forward kept; the block also sums
//      U = sum_i exp(cum_i) dy_i C_i^T, the chunk's own part of dh0.
//   2. ssd_bwd_state_pass_kernel, one thread per state entry of a (batch,
//      head): the reverse of the forward's state pass, over the chunks from
//      the last: dh1 of each chunk, then dh0 = exp(cum_Q) dh1 + U.
//   3. ssd_bwd_cols_kernel, one block per (head, chunk, batch): the same
//      shape with the roles swapped (B_j and x_j of a column in registers,
//      C_i and dy_i of the rows i >= j staged): dx, the per-head dB, the
//      direct ddt and the column part of dcum; then, over the whole chunk,
//      the reverse cumulative sum g and with it ddt and the chunk's part of
//      da.
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
// peaks at 700 W; chip_smoke.py works the same count out).  This first
// kernel runs on the CUDA cores; the tensor cores are later work.
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

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 64 rows x 4 threads; the block scan's width
constexpr int kRows = 64;       // rows (or columns) of a tile
constexpr int kTpr = 4;         // threads per row
constexpr int kMaxChunk = 256;  // Q <= kThreads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
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

struct Out {
  void *dx, *db, *dc;
  float *ddt, *da;
};

struct Scratch {
  float *dcum, *du, *cum_q, *db_part, *dc_part, *da_part;
};

template <typename T, int P, int NPT>
int run(const void* x, const float* dt, const float* a, const void* b,
        const void* c, const void* dy, const float* states,
        const float* dh_last, const Out& o, const Scratch& s, const Args& g,
        int batch, cudaStream_t stream) {
  const size_t smem_r = sizeof(float) * rows_smem_floats<P, NPT>();
  const size_t smem_c = sizeof(float) * cols_smem_floats<P, NPT>();
  auto kr = ssd_bwd_rows_kernel<T, P, NPT>;
  auto kc = ssd_bwd_cols_kernel<T, P, NPT>;
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
  kr<<<grid, kThreads, smem_r, stream>>>(xt, dt, a, bt, ct, dyt, states,
                                         s.dc_part, s.dcum, s.du, s.cum_q, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int pn = P * g.n;
  ssd_bwd_state_pass_kernel<<<dim3(batch * g.heads, (pn + 255) / 256), 256,
                              0, stream>>>(s.du, s.cum_q, dh_last, pn, g.nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kc<<<grid, kThreads, smem_c, stream>>>(xt, dt, a, bt, ct, dyt, states,
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

template <typename T, int P>
int dispatch_n(const void* x, const float* dt, const float* a, const void* b,
               const void* c, const void* dy, const float* states,
               const float* dh_last, const Out& o, const Scratch& s,
               const Args& g, int batch, cudaStream_t stream) {
#define BWD_ARGS x, dt, a, b, c, dy, states, dh_last, o, s, g, batch, stream
  if (g.n <= 16) return run<T, P, 4>(BWD_ARGS);
  if (g.n <= 32) return run<T, P, 8>(BWD_ARGS);
  if (g.n <= 64) return run<T, P, 16>(BWD_ARGS);
  return run<T, P, 32>(BWD_ARGS);
#undef BWD_ARGS
}

template <typename T>
int dispatch_p(int p, const void* x, const float* dt, const float* a,
               const void* b, const void* c, const void* dy,
               const float* states, const float* dh_last, const Out& o,
               const Scratch& s, const Args& g, int batch,
               cudaStream_t stream) {
#define BWD_ARGS x, dt, a, b, c, dy, states, dh_last, o, s, g, batch, stream
  switch (p) {
    case 16: return dispatch_n<T, 16>(BWD_ARGS);
    case 32: return dispatch_n<T, 32>(BWD_ARGS);
    case 64: return dispatch_n<T, 64>(BWD_ARGS);
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory a block of the larger of the two chunk kernels asks for
// (the wrapper refuses what exceeds the card's per-block limit), or -1 for
// a head dim or state size the kernels do not take.
extern "C" int64_t ssd_scan_bwd_smem_bytes(int head_dim, int state_dim) {
  if (state_dim < 1 || state_dim > 128) return -1;
  const int npt = state_dim <= 16 ? 4 : state_dim <= 32 ? 8
                  : state_dim <= 64 ? 16 : 32;
  const int64_t pad = 4 * npt + 1;
  if (head_dim != 16 && head_dim != 32 && head_dim != 64) return -1;
  return (int64_t)sizeof(float) *
         (head_dim * pad + 2 * kRows * pad + 2 * kRows * (head_dim + 1) +
          4 * kMaxChunk + 2 * (kThreads / 32));
}

// See the note at the top for the operands.  Scratch: dcum B*H*chunks*chunk,
// du B*H*chunks*P*N, cum_q and da_part B*H*chunks, db_part and dc_part
// B*H*S*N, all fp32.
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
  if (is_bf16)
    return dispatch_p<bf16>(head_dim, x, dt, a, b, c, dy, states, dh_last, o,
                            s, g, batch, st);
  return dispatch_p<float>(head_dim, x, dt, a, b, c, dy, states, dh_last, o,
                           s, g, batch, st);
}
