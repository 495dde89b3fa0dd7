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
//
// Two routes, chosen by dtype (a rule, not a fallback):
//
// bf16 -> three launches on the tensor cores (wgmma, sm_90a), Mamba-2's
//   own chunk-parallel split (arXiv:2405.21060: chunk_state, state_passing,
//   chunk_scan), so that every (batch, head, chunk) is a block of its own
//   (1600 at the hymba prefill shape) instead of one block carrying a
//   (batch, head) through its chunks in order:
//   1. ssd_chunk_state_kernel, one warpgroup per (batch, head, chunk):
//      dt's loads first, then B's and x's rows by 16-byte cp.async; cum by
//      one warp while they land; B scaled in place to B o w with
//      w_j = exp(cum_Q - cum_j) dt_j, rounded to bf16 once; the chunk's
//      own state X^T (B o w) as m64nNk16 wgmmas over the chunk's rows
//      (X^T read as an M-major A, P <= 64 of its 64 rows kept; B o w as
//      an N-major B).  The fp32 state and cum_Q go to a scratch the
//      wrapper allocates (B*H*chunks*P*N + B*H*chunks floats).
//   2. ssd_state_pass_kernel, one thread per state entry of a (batch,
//      head): h <- exp(cum_Q) h + state over the chunks in order (eight
//      chunks' loads in flight at once), leaving in the scratch the state
//      that enters each chunk, and h_last.
//   3. ssd_chunk_scan_kernel, two warpgroups per (batch, head, chunk), the
//      flash-attention shape of B5 with the decay in place of the softmax:
//      x, B, C of the chunk come once by 16-byte cp.async; for each
//      64-row query tile i (the longest first, balanced over the two
//      warpgroups) the carried-state term C_i h^T is one wgmma (k = N,
//      h rounded to bf16 for the product only), scaled by exp(cum_i) on
//      its fragments; then for each key tile j <= i, S = C_i B_j^T is a
//      wgmma (k = N), W = S o exp(cum_i - cum_j) o dt_j is formed on the
//      accumulator fragments, W is cast to bf16 in registers (the m64n64
//      accumulator is the A-register fragment of m64k16), and y += W X_j
//      with X_j read as an N-major B.  Tiles above the diagonal are never
//      visited.  Where cum never rises (every decaying step), the decay
//      factors into a row and a column factor, both <= 1, through the key
//      tile's last row below the diagonal and through a 16-row group's
//      last row on it, so only a thread's own 16-row group of the
//      diagonal tile takes an exponential per entry.  y leaves through a
//      shared-memory staging tile in 16-byte stores of whole rows (the
//      fragments' own 4-byte stores took more than half the kernel).
//   Layouts: x as column atoms of 64 entries under the 128-byte swizzle;
//   B, C (and h, and B o w) as blocks of 16 columns under the 32-byte
//   swizzle (a row of N=16 is 32 bytes); N is zero-padded to 16, 32, 64
//   or 128.  The wgmma building blocks are in wgmma.cuh; cum, the loads
//   and the decay factors in ssd_common.cuh, shared with the backward.
//   Arithmetic: products of bf16 values are exact in fp32, so C B^T
//   differs from the reference only in summation order; W, the carried
//   state in its product and B o w are each rounded to bf16 once (2^-9
//   relative); every sum is fp32 and the carried state stays fp32.  Bound:
//   2e-2 of max|plain| for y and h_last, the reference's own bf16 bound.
//   Operands: 16-byte aligned x, B, C with (b, s, h) strides that are
//   multiples of 8 elements (the wrapper raises otherwise); P in
//   {16, 32, 64}, N a multiple of 8 up to 128 (mamba2-1.3b's N=128 with
//   chunk 256 needs 197 KB of shared memory a block), chunk <= 256.
//
// fp32 -> ssd_scan_kernel, the port's first design, IEEE fp32 on the CUDA
//   cores: the card-vs-CPU agreement holds fp32 inputs to 1e-4 per kernel
//   case and 2e-4 end to end, which TF32 or bf16 products cannot.
//   * one block per (batch, head): the loop over chunks runs inside the
//     block, in order, and carries the (P, N) fp32 state in shared memory
//     - the translation of the TPU's sequential chunk axis;
//   * the (Q, Q) decay matrix (256 KB at Q = 256, more than the 227 KB a
//     block may hold) is never stored: each thread owns one query row i
//     and computes L[i, j] = exp(cum_i - cum_j) on the fly against every
//     earlier column j, with x[j, :] and B_j read as broadcast loads;
//   * the cumsum of dt * a is a block scan (warp shuffles, then the warp
//     totals);
//   * B and C are shared across heads (ngroups = 1) and re-read per head;
//     C_i sits in registers when N <= 16;
//   * given a non-null states (B, H, chunks, P, N) fp32, it also writes the
//     state entering each chunk there, for the backward (ssd_scan_bwd.cu);
//     a null pointer (the serve path) skips the store.  The bf16 route
//     leaves the same in its scratch.
//
// Both: strided operands (x, dt, B and C are read in place through their
// strides: they are column slices of the conv output on the model path;
// only the last dim must be contiguous).
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
using namespace ssd;

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;   // one query row per thread
constexpr int kMaxChunk = 256;  // Q <= kThreads
constexpr int kSmallN = 16;     // N <= 16: C_i in registers, B rows padded

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

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
                float* __restrict__ h_last, float* __restrict__ states,
                Args g) {
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

  const int nc = (g.seq + q - 1) / q;
  for (int c0 = 0; c0 < g.seq; c0 += q) {
    __syncthreads();  // the previous chunk's state update is done
    if (states != nullptr) {  // the state entering this chunk
      float* st = states + (((int64_t)bi * g.heads + hh) * nc + c0 / q) *
                               P * n;
      for (int o = tid; o < P * n; o += kThreads) st[o] = h_s[o];
    }
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
           const void* c, void* y, float* h_last, float* states,
           const Args& g, int batch, cudaStream_t stream) {
  const int smem = (int)smem_bytes(P, g.n, g.chunk);
  auto kern = ssd_scan_kernel<T, P, SMALL_N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<batch * g.heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), h_last, states, g);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const void* x, const float* dt, const float* a, const void* b,
               const void* c, void* y, float* h_last, float* states,
               const Args& g, int batch, cudaStream_t stream) {
  if (g.n <= kSmallN)
    return launch<T, P, true>(x, dt, a, b, c, y, h_last, states, g, batch,
                              stream);
  return launch<T, P, false>(x, dt, a, b, c, y, h_last, states, g, batch,
                             stream);
}

template <typename T>
int dispatch_p(int p, const void* x, const float* dt, const float* a,
               const void* b, const void* c, void* y, float* h_last,
               float* states, const Args& g, int batch, cudaStream_t stream) {
  switch (p) {
    case 16:
      return dispatch_n<T, 16>(x, dt, a, b, c, y, h_last, states, g, batch,
                               stream);
    case 32:
      return dispatch_n<T, 32>(x, dt, a, b, c, y, h_last, states, g, batch,
                               stream);
    case 64:
      return dispatch_n<T, 64>(x, dt, a, b, c, y, h_last, states, g, batch,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma), three launches
// ---------------------------------------------------------------------------
constexpr int kStateThreads = 128;  // chunk_state: one warpgroup
constexpr int kScanThreads = 256;   // chunk_scan: two warpgroups

size_t state_smem_bytes(int np, int rows) {
  return 1024 + (size_t)rows * (kSwRow + 2 * np) + 2 * sizeof(float) * rows
         + 64;
}

size_t scan_smem_bytes(int p, int np, int rows) {
  return 1024 + (size_t)rows * kSwRow + (size_t)(np / 16) * 32 *
         (2 * rows + p) + 2 * kTile * kSwRow + 4 * sizeof(float) * rows
         + 64;
}

// 1. the chunk's own state X^T (B o w) and cum_Q, into the scratch
template <int NP>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const bf16* __restrict__ bmat,
                       float* __restrict__ states, float* __restrict__ tot,
                       Args g, int p_dim) {
  const int rows = tile_rows(g.chunk);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + (((smem_addr(smem_raw) + 1023u) & ~1023u) -
                            smem_addr(smem_raw));
  const uint32_t s_x = smem_addr(sm);              // [rows][128 B]
  const uint32_t o_bw = rows * kSwRow;             // [NP / 16][rows][32 B]
  float* dt_s = reinterpret_cast<float*>(sm + o_bw + rows * 2 * NP);
  float* cum_s = dt_s + rows;
  float* tmax_s = cum_s + rows;  // [12]: see warp_chunk_cumsum

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int c0 = ci * g.chunk;
  float dtv[2];
  load_dt(dtv, dt, g, bi, hh, c0);
  // B first (it is scaled while x streams in), then x
  constexpr int kCh = NP / 8;
  load_bc(s_x + o_bw, bmat + bi * g.b_sb, g.b_ss, g, c0, rows, kCh);
  cp_async_commit();
  load_x(s_x, x + bi * g.x_sb + hh * g.x_sh, g.x_ss, g, c0, rows,
         p_dim);
  cp_async_commit();
  chunk_cum(dtv, a[hh], rows, dt_s, cum_s, tmax_s);
  const float cum_last = cum_s[rows - 1];

  // B o w with w_j = exp(cum_Q - cum_j) dt_j, rounded to bf16 once, in
  // place: each thread scales the chunks it copied
  cp_async_wait_one();
  for (int idx = tid; idx < rows * kCh; idx += kStateThreads) {
    const int r = idx / kCh, c = idx - r * kCh;
    uint4* q = reinterpret_cast<uint4*>(sm + o_bw + swz32(rows, r, c));
    const uint4 raw = *q;
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float w = expf(cum_last - cum_s[r]) * dt_s[r];
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      o[e] = pack_bf16(f.x * w, f.y * w);
    }
    *q = out;
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // state (P x N, P of the 64 rows) = X^T (B o w), 16 chunk rows a wgmma:
  // X^T as an M-major A (128-byte swizzle), B o w as an N-major B (32-byte
  // swizzle: 16-column blocks rows * 32 bytes apart)
  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;
  pin(acc);
  wgmma_fence();
  const int ksteps = (g.chunk + 15) / 16;
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss_tt(acc, sw128_desc(s_x + kk * 16 * kSwRow, rows * kSwRow,
                                8 * kSwRow),
                mnmajor32_desc(s_x + o_bw + kk * 16 * 32, rows * 32),
                kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);

  const int warp = tid >> 5, lane = tid & 31;
  const int64_t bh = (int64_t)bi * g.heads + hh;
  float* st = states + (bh * gridDim.y + ci) * p_dim * g.n;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int jb = 0; jb < NP / 8; ++jb) {
    const int col = 8 * jb + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (col < g.n && row < p_dim)
        *reinterpret_cast<float2*>(st + row * g.n + col) =
            make_float2(acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]);
    }
  }
  if (tid == 0) tot[bh * gridDim.y + ci] = cum_last;
}

// 2. the states entering each chunk, in order over the chunks
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ tot,
                      float* __restrict__ h_last, int pn, int nc) {
  const int e = blockIdx.y * 256 + threadIdx.x;
  if (e >= pn) return;
  const int64_t bh = blockIdx.x;
  float* st = states + bh * nc * pn + e;
  const float* tb = tot + bh * nc;
  float h = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float s[8], d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // eight chunks' loads in flight at once
      s[i] = c0 + i < nc ? st[(int64_t)(c0 + i) * pn] : 0.0f;
      d[i] = c0 + i < nc ? expf(tb[c0 + i]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i >= nc) break;
      st[(int64_t)(c0 + i) * pn] = h;
      h = d[i] * h + s[i];
    }
  }
  h_last[bh * pn + e] = h;
}

// 3. the chunk's outputs
template <int P>
__global__ void __launch_bounds__(kScanThreads, 2)
ssd_chunk_scan_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const bf16* __restrict__ bmat,
                      const bf16* __restrict__ cmat,
                      const float* __restrict__ states,
                      bf16* __restrict__ y, Args g, int np) {
  const int rows = tile_rows(g.chunk), nkb = np / 16, nch = np / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + (((smem_addr(smem_raw) + 1023u) & ~1023u) -
                            smem_addr(smem_raw));
  const uint32_t s_x = smem_addr(sm);                   // [rows][128 B]
  const uint32_t s_c = s_x + rows * kSwRow;             // [nkb][rows][32 B]
  const uint32_t s_b = s_c + nkb * rows * 32;           // [nkb][rows][32 B]
  const uint32_t o_h = (s_b - s_x) + nkb * rows * 32;   // [nkb][P][32 B]
  const uint32_t o_y = o_h + nkb * P * 32;             // [2][64][128 B]
  float* dt_s = reinterpret_cast<float*>(sm + o_y + 2 * kTile * kSwRow);
  float* cum_s = dt_s + rows;
  float* vl_s = cum_s + rows;  // exp(cum at the tile's last row - cum) dt
  float* vg_s = vl_s + rows;   // exp(cum at the 16-row group's last - cum) dt
  float* tmax_s = vg_s + rows;  // [12]: see warp_chunk_cumsum

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int c0 = ci * g.chunk;
  // dt and the state entering the chunk (fp32, 16-byte chunks of 8
  // entries) before the copies
  float dtv[2];
  load_dt(dtv, dt, g, bi, hh, c0);
  const float* st =
      states + (((int64_t)bi * g.heads + hh) * gridDim.y + ci) * P * g.n;
  float4 hv[kStateChunks<P, kScanThreads>][2];
  load_state<P, kScanThreads>(hv, st, g.n, nch);
  load_bc(s_c, cmat + bi * g.c_sb, g.c_ss, g, c0, rows, nch);
  load_bc(s_b, bmat + bi * g.b_sb, g.b_ss, g, c0, rows, nch);
  load_x(s_x, x + bi * g.x_sb + hh * g.x_sh, g.x_ss, g, c0, rows, P);
  cp_async_commit();
  // the entering state, rounded to bf16 for its product
  store_state<P, kScanThreads>(sm + o_h, hv, nch);
  chunk_cum(dtv, a[hh], rows, dt_s, cum_s, tmax_s);
  // the decay's column factors through a tile's last row (below the
  // diagonal) and a 16-row group's last row (on it)
  decay_factors(cum_s, dt_s, vl_s, vg_s, rows);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  const uint32_t s_h = s_x + o_h;
  uint8_t* y_s = sm + o_y + wgi * kTile * kSwRow;
  // query tiles, longest first, each to the less loaded warpgroup
  const int nqt = rows / kTile;
  const unsigned mine = own_tiles(wgi, nqt, true);
  for (int t = nqt - 1; t >= 0; --t) {
    const int row0 = t * kTile;
    if (!((mine >> t) & 1u) || c0 + row0 >= g.seq) continue;
    const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;

    // the carried state's term exp(cum_i) C_i h^T
    float acc[P / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] = 0.0f;
    pin(acc);
    wgmma_fence();
    for (int kb = 0; kb < nkb; ++kb)
      wgmma_ss(acc, kmajor32_desc(s_c + (kb * rows + row0) * 32),
               kmajor32_desc(s_h + kb * P * 32), kb > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    const float ea = expf(cum_s[ra]), eb = expf(cum_s[rb]);
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] *= (i & 2) ? eb : ea;

    for (int j = 0; j <= t; ++j) {
      const int k0 = j * kTile;
      // S = C_i B_j^T over the state dim, 16 entries a wgmma
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      pin(s);  // (not acc: W X of j-1 may still run)
      wgmma_fence();
      for (int kb = 0; kb < nkb; ++kb)
        wgmma_ss(s, kmajor32_desc(s_c + (kb * rows + row0) * 32),
                 kmajor32_desc(s_b + (kb * rows + k0) * 32), kb > 0);
      wgmma_commit();
      wgmma_wait_all();  // S of j, and W X of j-1 before W is rewritten
      pin(s);
      pin(acc);

      // W on the fragments: s[4 jb + e] is row ra + 8 (e >> 1), key
      // k0 + 8 jb + cq + (e & 1).  Where cum never rises (every decaying
      // step, dt a <= 0) the decay exp(cum_i - cum_j) factors as
      // exp(cum_i - cum_ref) exp(cum_ref - cum_j) with both factors <= 1
      // (a factor that underflows bounds a product that does too):
      // below the diagonal through the key tile's last row, and on it,
      // for key groups of 16 before the thread's own (its rows are group
      // `warp` of the tile), through the group's last row.  The thread's
      // own group, and every entry where cum rises, takes an exponential
      // per entry.
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
          pa[i >> 1] = pack_bf16(s[i] * u * vl_s[key],
                                 s[i + 1] * u * vl_s[key + 1]);
        }
      } else if (factored) {
        float ug[2][3];  // rows ra, rb against the groups before `warp`
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float cg = cum_s[k0 + 16 * g + 15];
          ug[0][g] = g < warp ? expf(cum_s[ra] - cg) : 0.0f;
          ug[1][g] = g < warp ? expf(cum_s[rb] - cg) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int g = i >> 3, key = k0 + 8 * (i >> 2) + cq;
          const int h = (i >> 1) & 1, row = h ? rb : ra;
          float w0 = 0.0f, w1 = 0.0f;
          if (g < warp) {
            w0 = s[i] * ug[h][g < 3 ? g : 0] * vg_s[key];
            w1 = s[i + 1] * ug[h][g < 3 ? g : 0] * vg_s[key + 1];
          } else if (g == warp) {
            const float cr = cum_s[row];
            if (key <= row)
              w0 = s[i] * __expf(cr - cum_s[key]) * dt_s[key];
            if (key + 1 <= row)
              w1 = s[i + 1] * __expf(cr - cum_s[key + 1]) * dt_s[key + 1];
          }
          pa[i >> 1] = pack_bf16(w0, w1);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int key = k0 + 8 * (i >> 2) + cq;
          const int row = (i & 2) ? rb : ra;
          const float cr = cum_s[row];
          const float w0 = key <= row
              ? s[i] * __expf(cr - cum_s[key]) * dt_s[key] : 0.0f;
          const float w1 = key + 1 <= row
              ? s[i + 1] * __expf(cr - cum_s[key + 1]) * dt_s[key + 1]
              : 0.0f;
          pa[i >> 1] = pack_bf16(w0, w1);
        }
      }

      // y += W X_j, 16 keys a wgmma; X's rows k0 + 16 kk.. start
      // 16 * 128 bytes further
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t af[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                pa[4 * kk + 3]};
        wgmma_rs(acc, af,
                 sw128_desc(s_x + (k0 + 16 * kk) * kSwRow, rows * kSwRow,
                            8 * kSwRow));
      }
      wgmma_commit();  // left in flight: waited for with the next S
    }
    wgmma_wait_all();
    pin(acc);

    // y's tile out through the warpgroup's staging tile (128-byte rows
    // under the 128-byte swizzle), then 16-byte stores of whole rows:
    // the fragments' own 4-byte stores cost more than the rest of the
    // kernel together
    const int r_a = ra - row0;
#pragma unroll
    for (int jb = 0; jb < P / 8; ++jb)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(
            y_s + swz(kTile, r_a + 8 * half, jb) + 2 * cq) =
            pack_bf16(acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]);
    wg_sync(wgi);
    constexpr int kCh = P / 8;
#pragma unroll
    for (int i = 0; i < kTile * kCh / 128; ++i) {
      const int idx = (tid & 127) + 128 * i;
      const int r = idx / kCh, c = idx - r * kCh, row = row0 + r;
      if (row < g.chunk && c0 + row < g.seq)
        *reinterpret_cast<uint4*>(
            y + (((int64_t)bi * g.seq + c0 + row) * g.heads + hh) * P +
            8 * c) =
            *reinterpret_cast<const uint4*>(y_s + swz(kTile, r, c));
    }
    wg_sync(wgi);  // the staging tile is free for the next query tile
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NP>
int launch_state(const void* x, const float* dt, const float* a,
                 const void* b, float* states, float* tot, const Args& g,
                 int batch, int p_dim, int nc, cudaStream_t stream) {
  const size_t smem = state_smem_bytes(NP, tile_rows(g.chunk));
  auto kern = ssd_chunk_state_kernel<NP>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(g.heads, nc, batch), kStateThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(b),
      states, tot, g, p_dim);
  return (int)cudaGetLastError();
}

template <int P>
int launch_scan(const void* x, const float* dt, const float* a,
                const void* b, const void* c, const float* states, void* y,
                const Args& g, int batch, int np, int nc,
                cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(P, np, tile_rows(g.chunk));
  auto kern = ssd_chunk_scan_kernel<P>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(g.heads, nc, batch), kScanThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), states, static_cast<bf16*>(y), g, np);
  return (int)cudaGetLastError();
}

int run_tc(int p, const void* x, const float* dt, const float* a,
           const void* b, const void* c, void* y, float* h_last,
           float* states, float* tot, const Args& g, int batch,
           cudaStream_t stream) {
  const int np = padded_state(g.n);
  const int nc = (g.seq + g.chunk - 1) / g.chunk;
  int err;
  switch (np) {
    case 16: err = launch_state<16>(x, dt, a, b, states, tot, g, batch, p,
                                    nc, stream); break;
    case 32: err = launch_state<32>(x, dt, a, b, states, tot, g, batch, p,
                                    nc, stream); break;
    case 64: err = launch_state<64>(x, dt, a, b, states, tot, g, batch, p,
                                    nc, stream); break;
    default: err = launch_state<128>(x, dt, a, b, states, tot, g, batch, p,
                                     nc, stream);
  }
  if (err) return err;
  const int pn = p * g.n;
  ssd_state_pass_kernel<<<dim3(batch * g.heads, (pn + 255) / 256), 256, 0,
                          stream>>>(states, tot, h_last, pn, nc);
  err = (int)cudaGetLastError();
  if (err) return err;
  switch (p) {
    case 16: return launch_scan<16>(x, dt, a, b, c, states, y, g, batch, np,
                                    nc, stream);
    case 32: return launch_scan<32>(x, dt, a, b, c, states, y, g, batch, np,
                                    nc, stream);
    default: return launch_scan<64>(x, dt, a, b, c, states, y, g, batch, np,
                                    nc, stream);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Shared memory one block needs, the larger of the route's kernels (the
// wrapper refuses what exceeds the card's per-block limit).
extern "C" int64_t ssd_scan_smem_bytes(int head_dim, int state_dim,
                                       int chunk, int is_bf16) {
  if (!is_bf16) return (int64_t)smem_bytes(head_dim, state_dim, chunk);
  const int np = padded_state(state_dim), rows = tile_rows(chunk);
  const size_t st = state_smem_bytes(np, rows);
  const size_t sc = scan_smem_bytes(head_dim, np, rows);
  return (int64_t)(st > sc ? st : sc);
}

// x (B, S, H, P) and B, C (B, S, N) in one dtype (fp32 or bf16), dt
// (B, S, H) and a (H,) fp32, each with its strides in elements and a
// contiguous last dim; y (B, S, H, P) contiguous in x's dtype, h_last
// (B, H, P, N) contiguous fp32.  P in {16, 32, 64}, 1 <= chunk <= 256.
// bf16 (is_bf16 = 1) runs on the tensor cores: N a multiple of 8 up to
// 128, 16-byte aligned x, B, C with strides that are multiples of 8
// (else cudaErrorMisalignedAddress), and a scratch of B*H*chunks*P*N
// (states) and B*H*chunks (tot) fp32, which leaves in states the state
// entering each chunk; fp32 on the CUDA cores (tot unused; states null, or
// B*H*chunks*P*N fp32 to keep the states entering the chunks).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                            const void* b, const void* c, void* y,
                            float* h_last, float* states, float* tot,
                            int64_t x_sb, int64_t x_ss, int64_t x_sh,
                            int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                            int64_t b_sb, int64_t b_ss, int64_t c_sb,
                            int64_t c_ss, int batch, int seq, int heads,
                            int head_dim, int state_dim, int chunk,
                            int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  const Args g{x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss,
               c_sb, c_ss, seq,  heads, state_dim, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return dispatch_p<float>(head_dim, x, dt, a, b, c, y, h_last, states, g,
                             batch, s);
  if (head_dim != 16 && head_dim != 32 && head_dim != 64)
    return (int)cudaErrorInvalidValue;
  if (state_dim < 8 || state_dim > 128 || state_dim % 8)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(x) && aligned16(b) && aligned16(c)) ||
      (x_sb | x_ss | x_sh | b_sb | b_ss | c_sb | c_ss) % 8)
    return (int)cudaErrorMisalignedAddress;
  return run_tc(head_dim, x, dt, a, b, c, y, h_last, states, tot, g, batch,
                s);
}
