// Mamba-2 SSD chunked scan (ngroups = 1, from a zero or a carried initial
// state), for Hopper.
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
// leaves the state as it is (the padding property of the reference).  h
// starts at zero, or at a carried state h0 (B, H, P, N) fp32 where one is
// given (the reference's ssd_chunked(..., h0=), a continued sequence):
// only the state pass reads it, as the state entering chunk 0, and both
// chunk-scan kernels take every chunk's carried-state term, chunk 0's
// among them, from the states it leaves, so h_last carries h0's decay.
// From h0 the launches read their time from zero (H100 at 700 W,
// tools/time_kernel.py: 133.8 against 133.0-135.2 us bf16 at hymba-1.5b's
// prefill, 484.1 against 485.3-489.7 us fp32 at one federated client's).
//
// Bound on this card: bytes.  At the hymba-1.5b prefill shape (B=4,
// S=2048, H=50, P=64, N=16, Q=256; x, B, C bf16, dt fp32) one pass reads
// x, dt, B, C once and writes y and h_last once (~107 MB, ~32 us at
// 3.35 TB/s), while the chunked form is ~10 GFLOP, ~10 us at the bf16
// tensor-core peak (989 TFLOP/s; H100 SXM data-sheet peaks at 700 W).
//
// Two routes, chosen by dtype (a rule, not a fallback), both on the tensor
// cores; the backward reads the state entering each chunk from the
// scratch either leaves (keep_states):
//
// bf16 -> three launches on the tensor cores (wgmma, sm_90a), Mamba-2's
//   own chunk-parallel split (arXiv:2405.21060: chunk_state, state_passing,
//   chunk_scan), so that every (batch, head, chunk) is a block of its own
//   (1600 at the hymba prefill shape) instead of one block carrying a
//   (batch, head) through its chunks in order:
//   1. ssd_chunk_state_kernel, one warpgroup per (batch, head, chunk):
//      dt's loads first, then B's and x's rows by 16-byte cp.async; cum by
//      one warp while they land; B scaled in place to B o w with
//      w_j = exp(cum_Q - cum_j) dt_j, rounded to bf16, and what the
//      rounding leaves into a second tile; the chunk's own state X^T
//      (B o w) as m64nNk16 wgmmas over the chunk's rows, once with each
//      tile (X^T read as an M-major A, P <= 64 of its 64 rows kept; B o w
//      as an N-major B).  The fp32 state and cum_Q go to a scratch the
//      wrapper allocates (B*H*chunks*P*N + B*H*chunks floats).
//   2. ssd_state_pass_kernel, one thread per state entry of a (batch,
//      head): from h0 (or 0), h <- exp(cum_Q) h + state over the chunks in
//      order (eight chunks' loads in flight at once), leaving in the
//      scratch the state that enters each chunk, and h_last.
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
//   differs from the reference only in summation order; W and the carried
//   state in its product are each rounded to bf16 once (2^-9 relative),
//   B o w is a hi + lo pair (~2^-16: B6-bwd's da, a sum that cancels,
//   reads the states kept here); every sum is fp32 and the carried state
//   stays fp32.  Bound:
//   2e-2 of max|plain| for y and h_last, the reference's own bf16 bound.
//   Operands: 16-byte aligned x, B, C with (b, s, h) strides that are
//   multiples of 8 elements (the wrapper raises otherwise); P in
//   {16, 32, 64}, N a multiple of 8 up to 128 (mamba2-1.3b's N=128 with
//   chunk 256 needs 197 KB of shared memory a block), chunk <= 256.
//
// fp32 -> the same three launches in split TF32 on the tensor cores
//   (wgmma, sm_90a), which holds the card-vs-CPU agreement of fp32 models
//   (1e-4 of max|plain| per kernel case, 2e-4 end to end) as IEEE fp32 on
//   the CUDA cores did (ssd_scan_kernel, one block a (batch, head) walking
//   the chunks in order: 1.20 ms at one hymba client's (4, 2048, 50, 64,
//   16, 256), and N=128 at chunk 256 needed 356 KB a block).  Now 486 us
//   there and 2.84 ms at mamba2-1.3b's (4, 2048, 64, 64, 128, 256) on an
//   H100 (PERF.md; split-TF32 bounds ~64 us and ~260 us):
//   1. ssd_chunk_state_f32_kernel, one warpgroup per (batch, head, chunk):
//      dt, cum and w_j = exp(cum_Q - cum_j) dt_j of the chunk, then its rows
//      kF32Keys (32) at a time: X^T and (B o w)^T split as they are staged
//      (both transposed in frag_tf32's order, so the product is
//      unchanged), state += X^T (B o w) (M = 64 rows of p, P kept; N = NP;
//      k8 over the rows).  The state and cum_Q go to the scratch, as the
//      bf16 route's.
//   2. ssd_state_pass_kernel, as above (fp32 already).
//   3. ssd_chunk_scan_f32_kernel, one warpgroup per (batch, head, chunk,
//      64-row query tile), the longest tiles first: C_i and the entering
//      state h split once (h in the place the key tiles take after it),
//      the carried term exp(cum_i) C_i h^T (k = N), then per key tile j of
//      32 keys up to the tile's last row S = C_i B_j^T (k = N), W = S o
//      exp(cum_i - cum_j) o dt_j on the accumulator (one expf an entry in
//      fp32, so a rising cum needs no branch of its own), and y += W X_j
//      with W's accumulator as the A-register operand (X_j^T staged in
//      frag_tf32's order: TF32 wgmma reads both operands K-major only).
//   The streamed tiles are loaded by the threads from device memory into
//   registers (ssd::Held) a tile ahead where N <= 64, so that their loads
//   run under the current tile's products, and split into shared memory
//   at the top of the next step (at hymba's shape 543 -> 486 us).
//   Arithmetic (wgmma.cuh): each fp32 operand is hi = tf32(x), lo = tf32(x
//   - hi), a product lo_a hi_b + hi_a lo_b + hi_a hi_b in one fp32
//   accumulator, the small terms first; cum, the decay and the carried
//   state stay fp32.  Tiles are fp32 under the 32-byte swizzle, one block
//   of 8 columns a k8 slice; N is zero-padded to 16, 32, 64 or 128.
//   tests/test_torch_ssd_split_tf32.py emulates it against the reference
//   (3e-7-9e-7 of max|y|; one TF32 product instead of three reads 6e-4).
//   Shared memory a block (state / scan kernel, bytes) and registers
//   (ptxas, sm_90a) by (P, NP): (64, 16) 23 872 / 31 040, 126 / 167;
//   (64, 128) 52 544 / 133 440, 206 / 255 (the scan kernel spills 20
//   bytes); (32, 128) 52 544 / 108 864, 206 / 255 (48 bytes); (16, 16)
//   23 872 / 18 752, 128 / 80: every (P <= 64, N <= 128, chunk <= 256)
//   fits one block.  Operands: 16-byte aligned x, B, C with (b, s, h)
//   strides that are multiples of 4 elements, N a multiple of 4 (the
//   wrapper raises otherwise).
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

struct Args {
  int64_t x_sb, x_ss, x_sh;    // x (B, S, H, P)
  int64_t dt_sb, dt_ss, dt_sh; // dt (B, S, H)
  int64_t b_sb, b_ss;          // B (B, S, N)
  int64_t c_sb, c_ss;          // C (B, S, N)
  int seq, heads, n, chunk;
  const float* h0;             // (B, H, P, N) fp32 entering chunk 0, or null
};

constexpr int kMaxChunk = 256;

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma), three launches
// ---------------------------------------------------------------------------
constexpr int kStateThreads = 128;  // chunk_state: one warpgroup
constexpr int kScanThreads = 256;   // chunk_scan: two warpgroups

size_t state_smem_bytes(int np, int rows) {
  return 1024 + (size_t)rows * (kSwRow + 4 * np) + 2 * sizeof(float) * rows
         + 64;
}

size_t scan_smem_bytes(int p, int np, int rows) {
  return 1024 + (size_t)rows * kSwRow + (size_t)(np / 16) * 32 *
         (2 * rows + p) + 2 * kTile * kSwRow + 4 * sizeof(float) * rows
         + 64;
}

// 1. the chunk's own state X^T (B o w) and cum_Q, into the scratch; B o w
// as a hi + lo pair of bf16 tiles, so the state carries ~16 bits (the
// backward's da, one sum a head over terms that cancel, reads the kept
// states)
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
  const uint32_t o_lo = o_bw + rows * 2 * NP;      // the same, its lo half
  float* dt_s = reinterpret_cast<float*>(sm + o_lo + rows * 2 * NP);
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

  // B o w with w_j = exp(cum_Q - cum_j) dt_j, rounded to bf16 in place and
  // what the rounding leaves into the lo tile: each thread scales the
  // chunks it copied
  cp_async_wait_one();
  for (int idx = tid; idx < rows * kCh; idx += kStateThreads) {
    const int r = idx / kCh, c = idx - r * kCh;
    uint4* q = reinterpret_cast<uint4*>(sm + o_bw + swz32(rows, r, c));
    const uint4 raw = *q;
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float w = expf(cum_last - cum_s[r]) * dt_s[r];
    uint4 out, rest;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
    uint32_t* l = reinterpret_cast<uint32_t*>(&rest);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      o[e] = pack_bf16(f.x * w, f.y * w);
      l[e] = pack_bf16_rest(f.x * w, f.y * w);
    }
    *q = out;
    *reinterpret_cast<uint4*>(sm + o_lo + swz32(rows, r, c)) = rest;
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
  for (int kk = 0; kk < ksteps; ++kk)
    wgmma_ss_tt(acc, sw128_desc(s_x + kk * 16 * kSwRow, rows * kSwRow,
                                8 * kSwRow),
                mnmajor32_desc(s_x + o_lo + kk * 16 * 32, rows * 32), true);
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
                      const float* __restrict__ h0,
                      float* __restrict__ h_last, int pn, int nc) {
  const int e = blockIdx.y * 256 + threadIdx.x;
  if (e >= pn) return;
  const int64_t bh = blockIdx.x;
  float* st = states + bh * nc * pn + e;
  const float* tb = tot + bh * nc;
  float h = h0 != nullptr ? h0[bh * pn + e] : 0.0f;
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

// ---------------------------------------------------------------------------
// fp32 route: tensor cores, split TF32 (wgmma, sm_90a), three launches
// ---------------------------------------------------------------------------
// 1. chunk state: X^T and (B o w)^T tiles of kF32Keys rows, hi and lo,
// then dt, cum and w of the chunk and cum's tile extremes
__host__ __device__ constexpr size_t f32_state_bytes(int np) {
  return 256 + 2 * 4 * kF32Keys * (kTile + np) + 4 * (3 * kMaxChunk + 16);
}

// 3. chunk scan: C_i (64 rows, hi and lo), then either the carried state
// h (P rows, hi and lo) or a key tile's B_j (hi and lo) and X_j^T (hi and
// lo) in the same place, then dt and cum of the chunk
__host__ __device__ constexpr size_t f32_scan_area(int p, int np) {
  return p * np > kF32Keys * (np + p) ? 2 * 4 * p * np
                                      : 2 * 4 * kF32Keys * (np + p);
}
__host__ __device__ constexpr size_t f32_scan_bytes(int p, int np) {
  return 256 + 2 * 4 * kTile * np + f32_scan_area(p, np) +
         4 * (2 * kMaxChunk + 16);
}

// 1. the chunk's own state X^T (B o w), w_j = exp(cum_Q - cum_j) dt_j, and
// cum_Q, into the scratch, as the bf16 route's ssd_chunk_state_kernel: the
// chunk's rows kF32Keys at a time, X^T and (B o w)^T split as they are
// staged (both transposed in frag_tf32's order, so the product is
// unchanged), M = 64 rows of p (P of them kept), N = NP
template <int P, int NP>
__global__ void __launch_bounds__(kF32Threads)
ssd_chunk_state_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const float* __restrict__ bmat,
                           float* __restrict__ states,
                           float* __restrict__ tot, Args g) {
  constexpr int K = kF32Keys;
  constexpr uint32_t kXT = K * kTile * 4, kBT = K * NP * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const xh = align256(smem_raw);
  uint8_t* const xl = xh + kXT;
  uint8_t* const bh = xl + kXT;
  uint8_t* const bl = bh + kBT;
  float* const dt_s = reinterpret_cast<float*>(bl + kBT);
  float* const cum_s = dt_s + kMaxChunk;
  float* const w_s = cum_s + kMaxChunk;
  float* const tmax_s = w_s + kMaxChunk;  // [12]: see warp_chunk_cumsum
  const uint32_t sxh = smem_addr(xh), sxl = sxh + kXT, sbh = sxl + kXT,
                 sbl = sbh + kBT;

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int c0 = ci * g.chunk, rows = tile_rows(g.chunk);
  const int lim = min(g.chunk, g.seq - c0);
  float dtv[2];
  load_dt(dtv, dt, g, bi, hh, c0);
  chunk_cum(dtv, a[hh], rows, dt_s, cum_s, tmax_s);
  const float cum_last = cum_s[rows - 1];
  for (int r = tid; r < rows; r += kF32Threads)
    w_s[r] = expf(cum_last - cum_s[r]) * dt_s[r];
  __syncthreads();

  const float* xb = x + bi * g.x_sb + hh * g.x_sh + (int64_t)c0 * g.x_ss;
  const float* bb = bmat + bi * g.b_sb + (int64_t)c0 * g.b_ss;
  // X and B o w of the chunk's rows, K at a time: the next tile's loads
  // are in flight while the current one's products run
  auto weight = [=](int r) { return w_s[r]; };
  Held<kTile, K> hx;
  Held<NP, K> hb;
  auto fetch = [&](int k0) {
    hx.fetch(rows_of(xb, g.x_ss, k0, lim, P), tid);
    hb.fetch(rows_of(bb, g.b_ss, k0, lim, g.n, weight), tid);
  };
  if (kHeldAhead<NP>) fetch(0);
  float acc[NP / 2];
  zero(acc);
  for (int k0 = 0; k0 < lim; k0 += K) {
    __syncthreads();  // the previous tile's products have retired
    if (!kHeldAhead<NP>) fetch(k0);
    hx.template put_t<true>(xh, xl, tid);
    hb.template put_t<true>(bh, bl, tid);
    fence_proxy_async();
    __syncthreads();
    if (kHeldAhead<NP> && k0 + K < lim) fetch(k0 + K);
    pin(acc);
    wgmma_fence();
    mma3<K>(acc, sxh, sxl, kTile * 32, sbh, sbl, NP * 32);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int64_t bhd = (int64_t)bi * g.heads + hh;
  float* st = states + (bhd * gridDim.y + ci) * P * g.n;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int jb = 0; jb < NP / 8; ++jb) {
    const int col = 8 * jb + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (col < g.n && row < P)
        *reinterpret_cast<float2*>(st + row * g.n + col) =
            make_float2(acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]);
    }
  }
  if (tid == 0) tot[bhd * gridDim.y + ci] = cum_last;
}

// 3. the outputs of one 64-row query tile i of a chunk: the carried
// state's term exp(cum_i) C_i h^T (k = N), then for each key tile j of
// kF32Keys keys up to the tile's last row S = C_i B_j^T (k = N), W = S o
// exp(cum_i - cum_j) o dt_j on the accumulator (the decay per entry, in
// fp32, so a rising cum needs no branch of its own) and y += W X_j with
// W's accumulator as the A operand (X_j^T staged in frag_tf32's order).
// Blocks (head, (tile, chunk), batch), the longest tiles first.
template <int P, int NP>
__global__ void __launch_bounds__(kF32Threads)
ssd_chunk_scan_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bmat,
                          const float* __restrict__ cmat,
                          const float* __restrict__ states,
                          float* __restrict__ y, Args g, int nc) {
  constexpr int K = kF32Keys;
  constexpr uint32_t kC = kTile * NP * 4, kH = P * NP * 4, kB = K * NP * 4,
                     kX = K * P * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ch = align256(smem_raw);
  uint8_t* const cl = ch + kC;
  uint8_t* const area = cl + kC;  // h, then B_j and X_j^T
  float* const dt_s = reinterpret_cast<float*>(area +
                                               f32_scan_area(P, NP));
  float* const cum_s = dt_s + kMaxChunk;
  float* const tmax_s = cum_s + kMaxChunk;  // [12]: see warp_chunk_cumsum
  const uint32_t sch = smem_addr(ch), scl = sch + kC, sa = scl + kC;
  const uint32_t shh = sa, shl = sa + kH;
  const uint32_t sbh = sa, sbl = sa + kB, sxh = sbl + kB, sxl = sxh + kX;

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, bi = blockIdx.z;
  const int nqt = gridDim.y / nc;
  const int t = nqt - 1 - (int)blockIdx.y / nc, ci = blockIdx.y % nc;
  const int c0 = ci * g.chunk, row0 = t * kTile;
  const int lim = min(g.chunk, g.seq - c0);
  if (row0 >= lim) return;
  float dtv[2];
  load_dt(dtv, dt, g, bi, hh, c0);
  const float* st =
      states + (((int64_t)bi * g.heads + hh) * nc + ci) * P * g.n;
  const float* xb = x + bi * g.x_sb + hh * g.x_sh + (int64_t)c0 * g.x_ss;
  const float* bb = bmat + bi * g.b_sb + (int64_t)c0 * g.b_ss;
  const float* cb = cmat + bi * g.c_sb + (int64_t)c0 * g.c_ss;
  split_rows<NP, kTile, 4, kTile>(ch, cl, rows_of(cb, g.c_ss, row0, lim, g.n),
                                  tid);
  split_rows<NP, P, 4, P>(area, area + kH, rows_of(st, g.n, 0, P, g.n), tid);
  chunk_cum(dtv, a[hh], tile_rows(g.chunk), dt_s, cum_s, tmax_s);
  fence_proxy_async();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, cq = 2 * (lane & 3);
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  // B_j and X_j of the key tiles, K at a time: the next tile's loads are
  // in flight while the current one's products run
  Held<NP, K> hb;
  Held<P, K> hx;
  auto fetch = [&](int k0) {
    hb.fetch(rows_of(bb, g.b_ss, k0, lim, g.n), tid);
    hx.fetch(rows_of(xb, g.x_ss, k0, lim, P), tid);
  };
  if (kHeldAhead<NP>) fetch(0);
  float acc[P / 2];
  zero(acc);
  pin(acc);
  wgmma_fence();
  mma3<NP>(acc, sch, scl, kTile * 32, shh, shl, P * 32);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
  const float ea = expf(cum_s[ra]), eb = expf(cum_s[rb]);
#pragma unroll
  for (int i = 0; i < P / 2; ++i) acc[i] *= (i & 2) ? eb : ea;

  const int nk = min(row0 + kTile, lim);
  for (int k0 = 0; k0 < nk; k0 += K) {
    __syncthreads();  // the previous products have retired
    if (!kHeldAhead<NP>) fetch(k0);
    hb.template put<K>(area, area + kB, tid);
    hx.template put_t<true>(area + 2 * kB, area + 2 * kB + kX, tid);
    fence_proxy_async();
    __syncthreads();
    if (kHeldAhead<NP> && k0 + K < nk) fetch(k0 + K);
    float s[K / 2];
    zero(s);
    pin(s);
    wgmma_fence();
    mma3<NP>(s, sch, scl, kTile * 32, sbh, sbl, K * 32);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    // W on the fragments: s[4 jb + e] is row ra + 8 (e >> 1), key k0 +
    // 8 jb + cq + (e & 1)
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
      const int row = (i & 2) ? rb : ra;
      s[i] = key <= row
                 ? s[i] * expf(cum_s[row] - cum_s[key]) * dt_s[key] : 0.0f;
    }
    wgmma_fence();
    mma3_rs<K>(acc, s, sxh, sxl, P * 32);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= lim) continue;
    float* yr = y + (((int64_t)bi * g.seq + c0 + row) * g.heads + hh) * P + cq;
#pragma unroll
    for (int jb = 0; jb < P / 8; ++jb)
      *reinterpret_cast<float2*>(yr + 8 * jb) =
          make_float2(acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]);
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
                          stream>>>(states, tot, g.h0, h_last, pn, nc);
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

template <int P, int NP>
int run_f32_pn(const void* x, const float* dt, const float* a, const void* b,
               const void* c, void* y, float* h_last, float* states,
               float* tot, const Args& g, int batch, cudaStream_t stream) {
  const int nc = (g.seq + g.chunk - 1) / g.chunk;
  const int nqt = tile_rows(g.chunk) / kTile;
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  auto k1 = ssd_chunk_state_f32_kernel<P, NP>;
  auto k3 = ssd_chunk_scan_f32_kernel<P, NP>;
  const size_t sm1 = f32_state_bytes(NP), sm3 = f32_scan_bytes(P, NP);
  cudaError_t e = set_smem(k1, sm1);
  if (e == cudaSuccess) e = set_smem(k3, sm3);
  if (e != cudaSuccess) return (int)e;
  k1<<<dim3(g.heads, nc, batch), kF32Threads, sm1, stream>>>(
      xf, dt, a, bf, states, tot, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int pn = P * g.n;
  ssd_state_pass_kernel<<<dim3(batch * g.heads, (pn + 255) / 256), 256, 0,
                          stream>>>(states, tot, g.h0, h_last, pn, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k3<<<dim3(g.heads, nc * nqt, batch), kF32Threads, sm3, stream>>>(
      xf, dt, a, bf, static_cast<const float*>(c), states,
      static_cast<float*>(y), g, nc);
  return (int)cudaGetLastError();
}

template <int P>
int run_f32_p(const void* x, const float* dt, const float* a, const void* b,
              const void* c, void* y, float* h_last, float* states,
              float* tot, const Args& g, int batch, cudaStream_t stream) {
  switch (padded_state(g.n)) {
    case 16: return run_f32_pn<P, 16>(x, dt, a, b, c, y, h_last, states, tot,
                                      g, batch, stream);
    case 32: return run_f32_pn<P, 32>(x, dt, a, b, c, y, h_last, states, tot,
                                      g, batch, stream);
    case 64: return run_f32_pn<P, 64>(x, dt, a, b, c, y, h_last, states, tot,
                                      g, batch, stream);
  }
  return run_f32_pn<P, 128>(x, dt, a, b, c, y, h_last, states, tot, g, batch,
                            stream);
}

int run_f32(int p, const void* x, const float* dt, const float* a,
            const void* b, const void* c, void* y, float* h_last,
            float* states, float* tot, const Args& g, int batch,
            cudaStream_t stream) {
  switch (p) {
    case 16: return run_f32_p<16>(x, dt, a, b, c, y, h_last, states, tot, g,
                                  batch, stream);
    case 32: return run_f32_p<32>(x, dt, a, b, c, y, h_last, states, tot, g,
                                  batch, stream);
  }
  return run_f32_p<64>(x, dt, a, b, c, y, h_last, states, tot, g, batch,
                       stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Shared memory one block needs, the larger of the route's kernels (the
// wrapper refuses what exceeds the card's per-block limit).
extern "C" int64_t ssd_scan_smem_bytes(int head_dim, int state_dim,
                                       int chunk, int is_bf16) {
  const int np = padded_state(state_dim), rows = tile_rows(chunk);
  const size_t st = is_bf16 ? state_smem_bytes(np, rows)
                            : f32_state_bytes(np);
  const size_t sc = is_bf16 ? scan_smem_bytes(head_dim, np, rows)
                            : f32_scan_bytes(head_dim, np);
  return (int64_t)(st > sc ? st : sc);
}

// x (B, S, H, P) and B, C (B, S, N) in one dtype (fp32 or bf16), dt
// (B, S, H) and a (H,) fp32, each with its strides in elements and a
// contiguous last dim; y (B, S, H, P) contiguous in x's dtype, h_last
// (B, H, P, N) contiguous fp32.  P in {16, 32, 64}, 1 <= chunk <= 256,
// and a scratch of B*H*chunks*P*N (states) and B*H*chunks (tot) fp32,
// which leaves in states the state entering each chunk; h0 the state
// entering chunk 0, (B, H, P, N) contiguous fp32, or null for zero.  bf16 (is_bf16 =
// 1) takes N a multiple of 8 up to 128 and 16-byte aligned x, B, C with
// strides that are multiples of 8; fp32 N a multiple of 4 up to 128 and
// 16-byte aligned x, B, C with strides that are multiples of 4 (else
// cudaErrorMisalignedAddress).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                            const void* b, const void* c, void* y,
                            float* h_last, float* states, float* tot,
                            const float* h0, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                            int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                            int64_t b_sb, int64_t b_ss, int64_t c_sb,
                            int64_t c_ss, int batch, int seq, int heads,
                            int head_dim, int state_dim, int chunk,
                            int is_bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (head_dim != 16 && head_dim != 32 && head_dim != 64)
    return (int)cudaErrorInvalidValue;
  const int unit = is_bf16 ? 8 : 4;
  if (state_dim < unit || state_dim > 128 || state_dim % unit)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(x) && aligned16(b) && aligned16(c)) ||
      (x_sb | x_ss | x_sh | b_sb | b_ss | c_sb | c_ss) % unit)
    return (int)cudaErrorMisalignedAddress;
  const Args g{x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss,
               c_sb, c_ss, seq,  heads, state_dim, chunk, h0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return run_f32(head_dim, x, dt, a, b, c, y, h_last, states, tot, g,
                   batch, s);
  return run_tc(head_dim, x, dt, a, b, c, y, h_last, states, tot, g, batch,
                s);
}
