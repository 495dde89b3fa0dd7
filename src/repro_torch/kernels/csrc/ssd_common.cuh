// Shared by the bf16 tensor-core routes of B6's forward (ssd_scan.cu) and
// its backward (ssd_scan_bwd.cu): the chunk's row tiles and their split
// over two warpgroups, the loads of dt, x-like and B/C-like rows and of
// a carried state into the swizzled layouts of wgmma.cuh, the cumulative
// sum cum = cumsum(dt a) of a chunk, and the decay's monotone factors.
// Every kernel of both routes computes cum here, by the same warp in the
// same order, so the backward sees the forward's cum to the bit.
//
// The functions that read operands take the route's own argument struct
// (Args): x_ss, b_ss, c_ss, dt_sb/ss/sh strides in elements, seq, n and
// chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace ssd {

constexpr int kTile = 64;  // rows of a tile of the chunk

__host__ __device__ __forceinline__ int tile_rows(int chunk) {
  return (chunk + kTile - 1) / kTile * kTile;
}

// N zero-padded to the state width the kernels are built for
__host__ __device__ __forceinline__ int padded_state(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

// dt of the rows this thread stores (row threadIdx.x + i * blockDim.x), 0
// past the chunk or the sequence: loaded before the chunk's copies are
// issued, so they lead the queue
template <class Args>
__device__ __forceinline__ void load_dt(float (&dtv)[2], const float* dt,
                                        const Args& g, int bi, int hh,
                                        int c0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = threadIdx.x + i * blockDim.x;
    dtv[i] = (r < g.chunk && c0 + r < g.seq)
                 ? dt[bi * g.dt_sb + (int64_t)(c0 + r) * g.dt_ss +
                      hh * g.dt_sh]
                 : 0.0f;
  }
}

// cum[r] = sum_{r' <= r} dt[r'] a over the `rows` rows of a chunk (rows <=
// 256; rows past the chunk hold dt = 0), by one warp: lane l sums rows
// 8l..8l+7 in order, then the lanes' totals are scanned.  Per 64-row tile
// t (lanes 8t..8t+7) it also keeps the largest and the smallest cum,
// tmax_s[t] and tmax_s[4 + t], and in tmax_s[8 + t] 1 if cum never rises
// over the tile (else 0, also for a NaN).
__device__ __forceinline__ void warp_chunk_cumsum(const float* dt_s,
                                                  float a_h, float* cum_s,
                                                  int rows, float* tmax_s) {
  const int lane = threadIdx.x & 31;
  float v[8], run = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = 8 * lane + e;
    run += r < rows ? dt_s[r] * a_h : 0.0f;
    v[e] = run;
  }
  float t = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, t, off);
    if (lane >= off) t += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, t, 1);
  if (lane == 0) excl = 0.0f;
  float hi = -INFINITY, lo = INFINITY, prev = INFINITY;
  bool mono = true;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float c = excl + v[e];
    if (8 * lane + e < rows) cum_s[8 * lane + e] = c;
    hi = fmaxf(hi, c);
    lo = fminf(lo, c);
    mono = mono && c <= prev;
    prev = c;
  }
  // the next lane's first row against this lane's last, inside a tile
  const float next = __shfl_down_sync(0xffffffffu, excl + v[0], 1);
  mono = mono && ((lane & 7) == 7 || next <= prev);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    const int other = __shfl_xor_sync(0xffffffffu, (int)mono, off);
    mono = mono && other;
  }
  if ((lane & 7) == 0 && 8 * lane < rows) {
    tmax_s[lane >> 3] = hi;
    tmax_s[4 + (lane >> 3)] = lo;
    tmax_s[8 + (lane >> 3)] = mono ? 1.0f : 0.0f;
  }
}

// dt into shared memory, then cum by one warp
__device__ __forceinline__ void chunk_cum(const float (&dtv)[2], float a_h,
                                          int rows, float* dt_s,
                                          float* cum_s, float* tmax_s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = threadIdx.x + i * blockDim.x;
    if (r < rows) dt_s[r] = dtv[i];
  }
  __syncthreads();
  if (threadIdx.x < 32)
    warp_chunk_cumsum(dt_s, a_h, cum_s, rows, tmax_s);
  __syncthreads();
}

// Where cum never rises (every decaying step, dt a <= 0) the decay
// exp(cum_i - cum_j) of a row i and an earlier column j factors through a
// row in between, both factors <= 1, so no exponential of a positive
// number is taken: through the column's 64-row tile's last row, vl_s[j] =
// exp(cum[j | 63] - cum_j) dt_j, and through its 16-row group's last row,
// vg_s[j] = exp(cum[j | 15] - cum_j) dt_j (each with the column's dt)
__device__ __forceinline__ void decay_factors(const float* cum_s,
                                              const float* dt_s, float* vl_s,
                                              float* vg_s, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    vl_s[r] = expf(cum_s[r | (kTile - 1)] - cum_s[r]) * dt_s[r];
    vg_s[r] = expf(cum_s[r | 15] - cum_s[r]) * dt_s[r];
  }
}

// `rows` rows of width p_dim (row stride x_ss elements) of one (batch,
// head, chunk) into the 128-byte swizzled tile at s_x, 16 bytes a copy;
// rows past the chunk or the sequence zero
template <class Args>
__device__ __forceinline__ void load_x(uint32_t s_x, const wg::bf16* xb,
                                       int64_t x_ss, const Args& g, int c0,
                                       int rows, int p_dim) {
  const int pch = p_dim / 8;
  for (int idx = threadIdx.x; idx < rows * pch; idx += blockDim.x) {
    const int r = idx / pch, c = idx - r * pch;
    const bool ok = r < g.chunk && c0 + r < g.seq;
    wg::cp_async16(s_x + wg::swz(rows, r, c),
                   xb + (ok ? (int64_t)(c0 + r) * x_ss : 0) + 8 * c, ok);
  }
}

// the rows of B or C (N zero-padded to nch 16-byte chunks) into the
// 32-byte swizzled tile at s_t
template <class Args>
__device__ __forceinline__ void load_bc(uint32_t s_t, const wg::bf16* tb,
                                        int64_t t_ss, const Args& g, int c0,
                                        int rows, int nch) {
  for (int idx = threadIdx.x; idx < rows * nch; idx += blockDim.x) {
    const int r = idx / nch, c = idx - r * nch;
    const bool ok = 8 * c < g.n && r < g.chunk && c0 + r < g.seq;
    wg::cp_async16(s_t + wg::swz32(rows, r, c),
                   tb + (ok ? (int64_t)(c0 + r) * t_ss + 8 * c : 0), ok);
  }
}

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wgi + 1) : "memory");
}

// The 64-row tiles of a chunk of nt tiles that warpgroup wgi (of two)
// owns: tile t costs t + 1 tile pairs where its rows meet the columns
// before them (rows = true) and nt - t where its columns meet the rows
// after them; the costliest first, each to the less loaded warpgroup.
__device__ __forceinline__ unsigned own_tiles(int wgi, int nt, bool rows) {
  int load0 = 0, load1 = 0;
  unsigned mine = 0;
  for (int k = 0; k < nt; ++k) {
    const int t = rows ? nt - 1 - k : k;
    const int cost = rows ? t + 1 : nt - t;
    const int owner = load1 < load0 ? 1 : 0;
    if (owner) load1 += cost; else load0 += cost;
    if (owner == wgi) mine |= 1u << t;
  }
  return mine;
}

// 16-byte chunks of 8 entries of a (P, N <= 128) state a thread of a
// THREADS-thread block holds
template <int P, int THREADS>
constexpr int kStateChunks = P * 16 / THREADS;

// the (P, n) fp32 state at st into registers, zero past n; issued before
// the chunk's copies, so they lead the queue
template <int P, int THREADS>
__device__ __forceinline__ void load_state(
    float4 (&hv)[kStateChunks<P, THREADS>][2], const float* st, int n,
    int nch) {
#pragma unroll
  for (int i = 0; i < kStateChunks<P, THREADS>; ++i) {
    const int idx = threadIdx.x + i * THREADS, p = idx / nch, c = idx % nch;
    if (idx < P * nch && 8 * c < n) {
      const float4* src = reinterpret_cast<const float4*>(st + p * n + 8 * c);
      hv[i][0] = src[0];
      hv[i][1] = src[1];
    } else {
      hv[i][0] = hv[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ... then rounded to bf16 for its products, as NP/16 blocks of P rows
// of 32 bytes under the 32-byte swizzle at dst
template <int P, int THREADS>
__device__ __forceinline__ void store_state(
    uint8_t* dst, const float4 (&hv)[kStateChunks<P, THREADS>][2],
    int nch) {
  using wg::pack_bf16;
#pragma unroll
  for (int i = 0; i < kStateChunks<P, THREADS>; ++i) {
    const int idx = threadIdx.x + i * THREADS, p = idx / nch, c = idx % nch;
    if (idx < P * nch)
      *reinterpret_cast<uint4*>(dst + wg::swz32(P, p, c)) = make_uint4(
          pack_bf16(hv[i][0].x, hv[i][0].y), pack_bf16(hv[i][0].z,
                                                       hv[i][0].w),
          pack_bf16(hv[i][1].x, hv[i][1].y), pack_bf16(hv[i][1].z,
                                                       hv[i][1].w));
  }
}

}  // namespace ssd
