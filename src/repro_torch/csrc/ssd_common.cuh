// Helpers shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): the tile's cumsum of dt * A, bf16 hi/lo pairs for
// operands with an fp32 factor, cp.async row loads, and the ldmatrix
// patterns that give mma.sync m16n8k16 fragments (hopper.cuh) from row-major
// tiles in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace repro {
namespace ssd {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return __halves2bfloat162(
      __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu)),
      __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16)));
}

// (v0, v1) -> bf16 pairs hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Warp 0: the inclusive cumsum L of dt * a over a tile's 64 steps, from
// dv[k] = dt of step lane + 32 k on each lane, into Ls, and dt into dts;
// returns L_last on every lane.
__device__ __forceinline__ float scan_tile(const float (&dv)[2], float a,
                                           float* Ls, float* dts) {
  const int lane = threadIdx.x & 31;
  float l[2] = {dv[0] * a, dv[1] * a};
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float o = __shfl_up_sync(0xffffffffu, l[k], off);
      if (lane >= off) l[k] += o;
    }
  }
  l[1] += __shfl_sync(0xffffffffu, l[0], 31);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Ls[lane + 32 * k] = l[k];
    dts[lane + 32 * k] = dv[k];
  }
  return __shfl_sync(0xffffffffu, l[1], 31);
}

// dt of a tile's steps lane and lane + 32 (0 at or past `valid`).
__device__ __forceinline__ void load_tile_dt(float (&dv)[2],
                                             const float* __restrict__ dt,
                                             size_t base, int h, int valid) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = lane + 32 * k;
    dv[k] = t < valid ? dt[base + static_cast<size_t>(t) * h] : 0.f;
  }
}

// Warp 0: dt of the tile's 64 steps (0 at or past `valid`) into dts, and
// L = inclusive cumsum of dt * a into Ls; returns L_last on every lane.
__device__ __forceinline__ float tile_cumsum(const float* __restrict__ dt,
                                             size_t base, int h, int valid,
                                             float a, float* Ls, float* dts) {
  float dv[2];
  load_tile_dt(dv, dt, base, h, valid);
  return scan_tile(dv, a, Ls, dts);
}

// `rows` rows of `cols` bf16 (a multiple of 8) from src (row stride
// `stride`) into dst (row stride ld) by cp.async, 16 bytes a thread of a
// block of `Threads`, the chunks Threads apart walked without a division;
// rows at or past `valid` are 0. The caller commits and waits.
template <int Threads>
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          size_t stride, int rows, int cols,
                                          int valid) {
  const int chunks = cols / 8;
  int r = threadIdx.x / chunks, ch = threadIdx.x - r * chunks;
  const int dr = Threads / chunks, dc = Threads - dr * chunks;
  while (r < rows) {
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * ld + ch * 8,
                     ok ? src + r * stride + ch * 8 : src, ok);
    r += dr;
    ch += dc;
    if (ch >= chunks) {
      ch -= chunks;
      ++r;
    }
  }
}

// Fragments of one mma.sync m16n8k16 step from bf16 tiles in shared memory
// (row stride ld elements, rows 16-byte aligned); lm = lane / 8, lr =
// lane % 8. A (16 x 16, m x k) at (m0, k0) of a tile stored [m][k] ...
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* s, int ld,
                                     int m0, int k0) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4(a, s + (m0 + (lm & 1) * 8 + lr) * ld + k0 + (lm >> 1) * 8);
}

// ... or stored [k][m] (its transpose, read with ldmatrix .trans).
__device__ __forceinline__ void ld_a_t(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4_t(a, s + (k0 + (lm >> 1) * 8 + lr) * ld + m0 + (lm & 1) * 8);
}

// B of two adjacent n8 tiles (k 16 x n 16 at (k0, n0)): b[0], b[1] of
// columns n0.., b[2], b[3] of n0 + 8..; from a tile stored [n][k] ...
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* s, int ld,
                                     int n0, int k0) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4(b, s + (n0 + (lm >> 1) * 8 + lr) * ld + k0 + (lm & 1) * 8);
}

// ... or stored [k][n] (read with .trans).
__device__ __forceinline__ void ld_b_t(uint32_t (&b)[4], const bf16* s,
                                       int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
  ldsm_x4_t(b, s + (k0 + (lm & 1) * 8 + lr) * ld + n0 + (lm >> 1) * 8);
}

}  // namespace ssd
}  // namespace repro
