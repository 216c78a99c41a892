// Causal or full GQA attention for prefill: q (b, sq, hq, d), k/v
// (b, skv, hkv, d) -> o (b, sq, hq, d), fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel), whose grid walks 128x128 q/kv tiles in order and carries the
// running max, sum and accumulator in VMEM scratch across the kv axis.
//
// Any head dim d from 1 to 256 (the Pallas kernel takes any d): the
// kernels of this file run at a padded D, the least of 16, 32, 64, 128, 160
// and 256 at or above d (padded_dim). Q and K columns d..D - 1 come in as
// zeros, so Q.K^T is unchanged; V's give output columns that are never
// stored; the scale is the caller's (1 / sqrt(d) of the real d). Above 256
// (the Pallas kernel takes any d), at the real d: bf16 up to kTcWideMaxDim
// on the tensor-core column tiles of flash_attention_wide.cu, forward and
// backward, on the caller's rows where tc_wide_route holds (d a multiple of
// 8) and where tc_wide_staged_route holds (the other d) on copies in rows
// of staged_ld(d) elements made by flash_stage_rows_kernel (namespace
// stage, below). Where simt_wide_route holds (fp32 above kSimtMaxDim, 32,
// and bf16 above kTcWideMaxDim), route "wide": the CUDA-core tiles of
// flash_attention_simt_wide.cuh, one tile up to 256
// (flash_attention_simt_tile.cu), column tiles as clusters above
// (flash_attention_simt_wide.cu), at the real d.
//
// Up to 256 in bf16, and up to 32 in fp32, three routes serve the forward
// and the backward alike, chosen by dtype and head dim:
//
// * flash_fwd_wgmma_kernel: bf16 where d is a multiple of 8 above 32
//   (tc_route; the TMA maps' row stride must be a multiple of 16 bytes):
//   D 64, 128, 160 or 256 (the serving path at 64, 128 and 160). The
//   tensor maps take the real d as their inner extent, so TMA fills each
//   box's columns past d with zeros.
//   Bound on the H100: at a few hundred tokens and b 1 the work is a few
//   GFLOP and K, V of a layer sit in L2, so the card is short of blocks
//   and of latency hiding, not of bandwidth. Design: one warpgroup (128 threads)
//   per 64 query rows of one q head; the grid is (q tiles x hq x b), q tiles
//   issued longest first (the diagonal-heavy tiles of a causal prefill).
//   Q and a 2-stage ring of K/V tiles (64 kv rows) come in by TMA with
//   128-byte swizzle, completion on mbarriers, so the load of tile j + 1
//   (and j + 2) overlaps the products of tile j. S = Q.K^T and O += P.V run
//   on the tensor cores (wgmma, bf16 in, fp32 accumulators); the online
//   softmax runs on the S accumulator in registers (row max and sum over
//   the 4 threads of a quad, exp2 with the scale folded into log2 e), and P
//   is rounded to bf16 and fed back as the register A operand of the P.V
//   wgmma (its accumulator layout is the A fragment layout). V is read
//   MN-major with the transpose bit. Tiles wholly above the diagonal are
//   never loaded; rows past sq and columns past skv come in as zeros
//   from TMA, are masked, and are never written. d 160 (stablelm-12b)
//   comes in as three 64-column boxes, the third's columns 160-191 past
//   the tensor map and so zeros from TMA: Q.K^T stops its k steps at 160,
//   and P.V runs at N = 192 (one m64n192k16 wgmma a k step), whose last
//   32 accumulator columns are zeros and never stored. 120 KB of shared
//   memory (one block an SM) and 96 fp32 accumulators a thread. D 256
//   (gemma-2b's head dim) takes four boxes, P.V at N 256 (m64n256k16), on
//   the same one warpgroup: its 128 O accumulators beside the 32 of S and
//   P's 16 packed registers fit one thread's 255; Q and the two-stage K/V
//   ring take 161 KB.
// * the same kernel in its kStaged instantiation: bf16 where staged_route
//   holds (d from 33 to 256, not a multiple of 8: the rows are not whole
//   16-byte chunks, so no TMA map can read them), on copies of Q, K and V
//   in rows of staged_ld(d) elements made by flash_stage_rows_group_kernel
//   (namespace stage), the output stored column by column at the real d.
// * flash_fwd_simt_kernel: both dtypes at d up to 32 (D 16 and 32). fp32
//   products on the CUDA cores: full fp32 products are what the fp32 path
//   is checked for (1e-4), which TF32 tensor cores would not hold. One
//   block of 256 threads per (q tile of 64 rows, q head, batch); it stages
//   one 64-row K tile and one V tile in shared memory as fp32 (rows padded
//   by one word against bank conflicts) and stops at the diagonal when
//   causal. Each thread owns 4 query rows and a 16-lane group shares a row,
//   so the row max and sum reduce with four shuffles.
//
// Both: the kv head of q head h is h / (hq / hkv), as in the JAX kernel's
// index map; l == 0 maps to 1. Unlike the JAX kernel (which asserts
// sq % block_q == 0), these mask the ragged edge themselves, so any
// sq, skv >= 1 is taken. Given a non-null `lse`, both also write each
// row's log-sum-exp of its scaled scores, (b, hq, sq) fp32, which the
// backward reads; serving passes null and writes nothing more.
//
// Backward (the JAX package has no backward kernel; its gradient is
// jax.grad of the forward): FlashAttention-2's, split so that no block
// adds into another block's output, hence no atomics and a bitwise
// repeatable step. With P = exp(S * scale - lse) recomputed tile by tile
// and delta = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - delta),  dK = dS^T Q * scale,
//   dQ = dS K * scale.
// flash_bwd_preprocess_kernel writes delta (16-byte loads, up to 32 lanes
// a row, delta_lanes; at a d below its D, flash_bwd_preprocess_rows_kernel,
// a warp a row, sums over the real d), then one of three routes, the
// forward's, at its padded D (route "wide" after
// flash_bwd_preprocess_rows_kernel):
// * bf16 where tc_route holds (the training paths at d 64, 128 and 160):
//   flash_bwd_dkdv_wgmma_kernel,
//   one warpgroup a (kv tile of 64, kv head, batch), causal kv tile 0
//   first; K and V come in once by TMA and Q, dO tiles of the group's q
//   heads (on or below the diagonal when causal) through a 2-stage TMA
//   ring on mbarriers. Per q tile, S^T = K Q^T and dP^T = V dO^T on the
//   tensor cores (wgmma, fp32 accumulators), P^T and dS^T formed in those
//   registers (lse and delta per column, from smem), rounded to bf16 and
//   fed back as the register A operand of dV += P^T dO and dK += dS^T Q
//   (dO, Q read MN-major); P^T is formed while dP^T is still on the
//   tensor cores, dS^T while dV's product is. dK and dV stay in registers
//   for the whole walk. flash_bwd_dq_wgmma_kernel, one warpgroup a (q
//   tile, q head, batch), longest q tiles first, streams K/V tiles up to
//   the diagonal: S = Q K^T, dP = dO V^T, dQ += dS K (P formed while dP
//   is on the tensor cores). S and dP are recomputed there
//   rather than passed between the kernels: summing dQ across kv-tile
//   blocks would need atomics (no bitwise resume), and writing dS out
//   would move about 2 x 16.8 MB more at the training shape, where the
//   recomputation is 2 of 7 products on the tensor cores. At d 160
//   (stablelm-12b) every tile comes in as the forward's three boxes, the
//   products into dK, dV and dQ run at N 192 over the third box's zero
//   columns, and the dK/dV kernel runs two warpgroups, one holding dV and
//   one dK, each forming P^T itself (dkdv_warpgroups): two sums of 96
//   accumulators would not fit one thread's registers beside S^T and dP^T.
//   D 256 takes four boxes, N 256, and the same two warpgroups (128
//   accumulators a thread beside S^T, dP^T and dS's fragments), with 194 KB
//   of shared memory.
// * bf16 where staged_route holds (d from 33 to 256, not a multiple of 8:
//   the rows are not whole 16-byte chunks, so no TMA map can read them):
//   flash_stage_rows_group_kernel (namespace stage; the forward's copy with
//   dO) copies Q, K, V and dO into a scratch of
//   rows staged_ld(d) elements long (the least multiple of 8), columns past
//   d zero, in loads of the widest width the row alignment allows (8, 4 or
//   2 bytes), and writes delta over the real d from the dO rows it copies
//   and the same columns of O; then the two wgmma kernels above run at the
//   padded D with maps on the copies (inner extent d, row stride
//   staged_ld(d)), in instantiations of their own (kStaged) whose only
//   difference is the store: dQ, dK and dV go straight to the caller's
//   tensors at the real d, each column masked (4-byte pairs where d is
//   even, else 2-byte stores), since an 8-column chunk past d would run
//   into the next head.
//   The copy moves the four inputs twice more (26.8 MB at 8/8 heads, d
//   100, b 8, s 256); the CUDA-core kernels it replaces there ran full
//   fp32 products.
// * both dtypes at d up to 32 (D 16 and 32):
//   flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, fp32 products on the
//   CUDA cores, the same split: one block of 256 threads a (kv tile, kv
//   head, batch) and a (q tile, q head, batch). Tiles are staged in
//   shared memory as fp32, rows padded by one word against bank
//   conflicts; each thread owns a 4 x 4 patch of the score tile and a
//   4-row, d / 16-column patch of its accumulators, as the forward's SIMT
//   kernel. Full fp32 products are what the fp32
//   path is checked for (1e-5), which TF32 would not hold.
// Bound: causal, the five products over the (query, key) pairs on or
// below the diagonal: 5 x 2 x d flops a pair and head, 5.4 GFLOP at b 8,
// s 256, 16 heads, d 128, against the bytes the call must move (q, k, v,
// o, dO, lse read once, dq, dk, dv written once, 50.5 MB): bytes bound it
// on the H100, at 0.0151 ms. The kernels run 7 products (S and dP twice)
// over whole 64 x 64 tiles, 9.4 GFLOP.
//
// Where simt_wide_route holds (fp32 above 32, bf16 above kTcWideMaxDim):
// route "wide" (namespace wide, flash_attention_simt_wide.cu), after
// flash_bwd_preprocess_rows_kernel for the backward's delta.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 256; // 16 row groups x 16 lanes
constexpr int kRows = 4;      // query rows per thread (kBQ / 16)
constexpr int kCols = 4;      // score columns per thread (kBK / 16)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          2 * static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

// bf16 at a head dim that is a whole number of 16-byte chunks (the TMA
// maps' row stride) and above 32: the wgmma designs, forward and backward.
bool tc_route(int d) { return d > 32 && d <= 256 && d % 8 == 0; }

// kPad: d below D, read at run time; else d is D and the code is the
// unpadded kernel's.
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int skv, int hq, int hkv,
                 int d_arg, float scale, int causal) {
  const int d = kPad ? d_arg : D;
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x LD
  float* Ks = Qs + kBQ * LD;        // kBK x LD
  float* Vs = Ks + kBK * LD;        // kBK x LD
  float* Ps = Vs + kBK * LD;        // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // row group: rows rg*4 .. rg*4+3
  const int lc = tid & 15;   // lane in the group

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    Qs[r * LD + c] = qi < sq && c < d
        ? to_f32(q[((static_cast<size_t>(b) * sq + qi) * hq + h) * d + c])
        : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int ki = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (ki < skv && c < d) {
        const size_t off =
            ((static_cast<size_t>(b) * skv + ki) * hkv + kvh) * d + c;
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
      }
      Ks[r * LD + c] = kval;
      Vs[r * LD + c] = vval;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4  // 8 spilled 16 B at bf16, D 16, kPad
    for (int c = 0; c < D; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(rg * kRows + i) * LD + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(lc + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + rg * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + lc + 16 * j;
        float val = s[i][j] * scale;
        if (col >= skv || (causal && col > row)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        Ps[(rg * kRows + i) * (kBK + 1) + lc + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group16_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBK, kv_end - k0);  // P is 0 past the valid columns
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = Ps[(rg * kRows + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = Vs[c * LD + lc + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    if (lse != nullptr && lc == 0)
      lse[(static_cast<size_t>(b) * hq + h) * sq + row] = m[i] + logf(denom);
    T* orow = o + ((static_cast<size_t>(b) * sq + row) * hq + h) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (lc + 16 * j < d) orow[lc + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D, bool kPad>
int launch_simt_as(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int skv, int hq, int hkv, int d,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<T, D, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_simt_kernel<T, D, kPad><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, hq, hkv,
      d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Called at d == D (16, 32) the unpadded instantiation, else the padded
// one.
template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int sq, int skv, int hq, int hkv, int d,
                float scale, int causal, cudaStream_t stream) {
  if (d == D)
    return launch_simt_as<T, D, false>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                       d, scale, causal, stream);
  return launch_simt_as<T, D, true>(q, k, v, o, lse, b, sq, skv, hq, hkv, d,
                                    scale, causal, stream);
}

// The CUDA-core forward at head dim d up to kSimtMaxDim, instantiated at
// its padded D (16 or 32).
template <typename T>
int dispatch_simt(int d, const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int sq, int skv, int hq, int hkv,
                  float scale, int causal, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 16: return launch_simt<T, 16>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, s);
    case 32: return launch_simt<T, 32>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (wgmma + TMA), D = 64, 128, 160 or 256.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;        // query rows per block (one wgmma M)
constexpr int kBK = 64;        // kv rows per tile (the S wgmma's N)
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // K/V ring depth
constexpr int kBox = 64 * 64;  // one TMA box: 64 rows x 64 bf16 (128 B)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 64-column boxes a row of head dim D: d 160 takes three, the third's
// columns 160-191 past the tensor map, which TMA fills with zeros.
template <int D>
__host__ __device__ constexpr int boxes() { return (D + 63) / 64; }

template <int D>
constexpr size_t smem_bytes() {
  // 1024 for the alignment of the swizzled boxes, Q, the K/V ring, barriers
  return 1024 + sizeof(bf16) * static_cast<size_t>(kBox) * boxes<D>() *
                    (1 + 2 * kStages) + 8 * (1 + kStages);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  wgmma_m64n64k16_rs_tb(o, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_m64n128k16_rs_tb(o, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<192>(float (&o)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_m64n192k16_rs_tb(o, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_m64n256k16_rs_tb(o, a, desc);
}

// acc (64 x 64) += A . B^T: A and B are 64-row tiles of d columns in
// smem, K-major in ceil(D / 64) swizzled boxes (as TMA writes them); the
// k steps stop at D, so a third box's zero columns are never read.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[32], const bf16* a,
                                        const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = (kk / 4) * kBox, step = 2 * (kk % 4);  // 32 B a k step
    wgmma_m64n64k16_ss(acc, desc_sw128(a + box, 16, 1024) + step,
                       desc_sw128(b + box, 16, 1024) + step);
  }
}

// acc (64 x N) += A . B: A (64 x 64) in registers, the bf16 pairs of an
// accumulator (registers 8 kk .. 8 kk + 7 are the A fragment of k step
// kk); B a 64-row tile of N / 64 whole boxes in smem, read MN-major.
template <int N>
__device__ __forceinline__ void mma_rb(float (&acc)[N / 2],
                                       const uint32_t (&a)[4][4],
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<N>(acc, a[kk],
                desc_sw128(b + kk * 16 * 64, kBox * sizeof(bf16), 1024));
}

// kMode: kUnpadded, d is D, as before there was padding; kPadded, d below
// D (or D 256), read at run time for the stores; kStaged (staged_route),
// the maps read the staged rows and the output is stored column by column
// at the real d (4-byte pairs where d is even, else 2-byte stores), since
// an 8-column chunk past d would run into the next head.
constexpr int kUnpadded = 0, kPadded = 1, kStaged = 2;

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse, int b,
                       int sq, int skv, int hq, int hkv, int d_arg,
                       int n_qtiles, float scale_log2, int causal) {
  const int d = kMode != kUnpadded ? d_arg : D;
  constexpr int NB = boxes<D>();  // 64-column boxes per row
  constexpr int NP = 64 * NB;     // P.V's N: D, or 160 padded to 192
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* Ks = Qs + NB * kBox;                // [kStages][NB][kBox]
  bf16* Vs = Ks + kStages * NB * kBox;      // [kStages][NB][kBox]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * NB * kBox);
  uint64_t* qbar = bars;                    // Q arrived
  uint64_t* kvbar = bars + 1;               // [kStages]: K/V tile arrived

  // Longest q tiles first: block 0 takes the last q tile of every head.
  const int heads = hq * b;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % hq;
  const int bb = (static_cast<int>(blockIdx.x) % heads) / hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int n_kv = (kv_end + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue_kv = [=](int stage, int j) {
    mbar_expect_tx(&kvbar[stage], 2 * NB * kBox * sizeof(bf16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(Ks + (stage * NB + nb) * kBox, mk, &kvbar[stage], nb * 64,
                  kvh, j * kBK, bb);
      tma_load_4d(Vs + (stage * NB + nb) * kBox, mv, &kvbar[stage], nb * 64,
                  kvh, j * kBK, bb);
    }
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&kvbar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, NB * kBox * sizeof(bf16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_load_4d(Qs + nb * kBox, &tq, qbar, nb * 64, h, q0, bb);
    for (int j = 0; j < min(kStages, n_kv); ++j) issue_kv(j, j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8
  const int col_t = 2 * (lane & 3);

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int stage = j % kStages;
    mbar_wait(&kvbar[stage], (j / kStages) & 1);
    const bf16* Kt = Ks + stage * NB * kBox;
    const bf16* Vt = Vs + stage * NB * kBox;

    // S = Q . K^T (64 x 64), K = d in steps of 16 (32 B inside a box row).
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    mma_abt<D>(s, Qs, Kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax on the accumulator: scale into log2 units, mask the
    // causal upper triangle and the columns past skv, row max over a quad.
    const int k0 = j * kBK;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + 8 * jj + col_t + c;
        float xa = s[4 * jj + c] * scale_log2;
        float xb = s[4 * jj + 2 + c] * scale_log2;
        if (col >= skv || (causal && col > row_a)) xa = kNegInf;
        if (col >= skv || (causal && col > row_a + 8)) xb = kNegInf;
        s[4 * jj + c] = xa;
        s[4 * jj + 2 + c] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * jj + c] = exp2f(s[4 * jj + c] - mn_a);
        s[4 * jj + 2 + c] = exp2f(s[4 * jj + 2 + c] - mn_b);
        sum_a += s[4 * jj + c];
        sum_b += s[4 * jj + 2 + c];
      }
    }
    l_a = l_a * alpha_a + sum_a;  // this thread's columns; quad sum at the end
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj) {
      acc[4 * jj] *= alpha_a;
      acc[4 * jj + 1] *= alpha_a;
      acc[4 * jj + 2] *= alpha_b;
      acc[4 * jj + 3] *= alpha_b;
    }

    // O += P . V: P in bf16 from registers, V (kv x d, d contiguous) read
    // MN-major; k steps of 16 kv rows are 16 x 128 B = 2048 B apart. At d
    // 160 the product runs over N = 192: V's columns past 160 are TMA's
    // zeros, and the accumulator columns they give are never stored.
    uint32_t p[4][4];
    pack_a(p, s);
    fence_regs(acc);
    wgmma_fence();
    mma_rb<NP>(acc, p, Vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every wgmma of this stage has read its tiles
    if (tid == 0 && j + kStages < n_kv) issue_kv(stage, j + kStages);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  if (lse != nullptr && (lane & 3) == 0) {
    // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2.
    float* lrow = lse + (static_cast<size_t>(bb) * hq + h) * sq;
    if (row_a < sq)
      lrow[row_a] = (m_a + (l_a == 0.f ? 0.f : log2f(l_a))) * kLn2;
    if (row_a + 8 < sq)
      lrow[row_a + 8] = (m_b + (l_b == 0.f ? 0.f : log2f(l_b))) * kLn2;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= sq) continue;
    const float inv = half ? inv_b : inv_a;
    bf16* orow = o + ((static_cast<size_t>(bb) * sq + row) * hq + h) * d;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if constexpr (kMode == kStaged) {
        const int c = 8 * jj + col_t;
        const float x0 = acc[4 * jj + 2 * half] * inv;
        const float x1 = acc[4 * jj + 2 * half + 1] * inv;
        if (d % 2 == 0) {
          if (c < d)
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(x0, x1);
        } else {
          if (c < d) orow[c] = __float2bfloat16(x0);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16(x1);
        }
      } else {
        if (8 * jj >= d) break;   // d is a multiple of 8
        *reinterpret_cast<uint32_t*>(orow + 8 * jj + col_t) =
            pack_bf16(acc[4 * jj + 2 * half] * inv,
                      acc[4 * jj + 2 * half + 1] * inv);
      }
    }
  }
}

// q, k, v: the caller's tensors, or with kStaged their staged copies, rows
// `ld` elements apart (d where ld is 0).
template <int D, int kMode>
int launch_as(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int sq, int skv, int hq, int hkv, int d,
              float scale, int causal, cudaStream_t stream, int ld = 0) {
  // Encoded on every call: the maps hold the tensors' pointers, and as
  // __grid_constant__ parameters a CUDA graph records them by value. Their
  // rows are the real d: the boxes' columns past it come in as zeros.
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, sq, hq, d, ld) ||
      !make_map(&tk, k, b, skv, hkv, d, ld) ||
      !make_map(&tv, v, b, skv, hkv, d, ld))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const dim3 grid(n_qtiles * hq * b);
  flash_fwd_wgmma_kernel<D, kMode><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, b, sq, skv, hq, hkv, d,
      n_qtiles, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// The unpadded instantiation at the head dims it took before (64, 128,
// 160, called at d == D), the padded one at every other d.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int hq, int hkv, int d, float scale,
           int causal, cudaStream_t stream) {
  if constexpr (D <= 160) {
    if (d == D)
      return launch_as<D, kUnpadded>(q, k, v, o, lse, b, sq, skv, hq, hkv, d,
                                     scale, causal, stream);
  }
  return launch_as<D, kPadded>(q, k, v, o, lse, b, sq, skv, hq, hkv, d,
                               scale, causal, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Backward: CUDA-core kernels, fp32 products, at D 16 and 32 (both dtypes
// up to kSimtMaxDim).
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int kB = 64;          // rows of a tile, fixed or streamed
constexpr int kThreads = 256;   // 16 row groups x 16 lanes
constexpr int kR = 4;           // tile rows a thread (kB / 16)

template <int D>
constexpr size_t dkdv_smem() {  // K, V, Q, dO tiles; P, dS; lse, delta
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <int D>
constexpr size_t dq_smem() {    // Q, dO, K, V tiles; dS
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1));
}

// Rows r < R of a (batch, rows, heads, d) tensor from row0, head h, as
// fp32 into smem (row stride D + 1); rows past n and columns past d read
// as 0.
template <typename T, int D, int R = kB>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int bb, int row0, int n, int heads,
                                      int h, int d) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n && c < d
            ? to_f32(src[((static_cast<size_t>(bb) * n + row) * heads + h) *
                             d + c])
            : 0.f;
  }
}

// Lanes a row of the delta pass: the row's 16-byte chunks (D / (16 /
// sizeof(T))) shared by the largest power of two up to 32 that divides
// their count; d 160 gives 4 lanes (bf16) or 8 (fp32) of 5 chunks each.
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  constexpr int n = D / (16 / static_cast<int>(sizeof(T)));
  return (n & -n) < 32 ? (n & -n) : 32;
}

// delta[b, h, i] = sum_c dO[b, i, h, c] * O[b, i, h, c]: each lane reads C
// 16-byte chunks of a row of O and of dO, L = delta_lanes lanes a row (32 /
// L rows a warp; lane l takes chunks l, l + L, ...), the rows of (b, sq,
// hq) in memory order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ o,
                            const T* __restrict__ dout,
                            float* __restrict__ delta, int b, int sq,
                            int hq) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int L = delta_lanes<T, D>();
  constexpr int C = D / V / L;       // chunks a lane
  static_assert(L * C * V == D && 32 % L == 0, "head dim");
  const int lane = threadIdx.x & 31;
  const size_t row = (static_cast<size_t>(blockIdx.x) * kThreads +
                      threadIdx.x) / L;
  const bool valid = row < static_cast<size_t>(b) * sq * hq;
  float s = 0.f;
  if (valid) {  // no return: the whole warp takes part in the shuffles
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* grow = reinterpret_cast<const uint4*>(dout + row * D);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint4 ov = orow[lane % L + c * L];
      const uint4 gv = grow[lane % L + c * L];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int i = 0; i < V; ++i) s = fmaf(to_f32(oe[i]), to_f32(ge[i]), s);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (valid && lane % L == 0) {
    const int h = static_cast<int>(row % hq);
    const size_t bi = row / hq;
    const int i = static_cast<int>(bi % sq);
    const int bb = static_cast<int>(bi / sq);
    delta[(static_cast<size_t>(bb) * hq + h) * sq + i] = s;
  }
}

// The same sum at a head dim no instantiation equals (its rows are not
// whole 16-byte chunks, or not a padded D): one warp a row, lane l
// taking elements l, l + 32, ... below d.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_rows_kernel(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int b, int sq,
                                 int hq, int d) {
  const int lane = threadIdx.x & 31;
  const size_t row = (static_cast<size_t>(blockIdx.x) * kThreads +
                      threadIdx.x) / 32;
  const bool valid = row < static_cast<size_t>(b) * sq * hq;
  float s = 0.f;
  if (valid)
    for (int c = lane; c < d; c += 32)
      s = fmaf(to_f32(o[row * d + c]), to_f32(dout[row * d + c]), s);
  s = warp_sum(s);
  if (valid && lane == 0) {
    const int h = static_cast<int>(row % hq);
    const size_t bi = row / hq;
    const int i = static_cast<int>(bi % sq);
    const int bb = static_cast<int>(bi / sq);
    delta[(static_cast<size_t>(bb) * hq + h) * sq + i] = s;
  }
}

template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int skv, int hq, int hkv,
                      int d_arg, float scale, int causal) {
  const int d = kPad ? d_arg : D;   // as the forward's
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  constexpr int QB = kB;                 // q rows a streamed tile
  constexpr int kC = QB / 16;            // score columns a thread
  constexpr int kLS = QB + 1;            // row stride of P and dS
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + QB * LD;
  float* Ps = dOs + QB * LD;    // [kv row][q row]
  float* dSs = Ps + kB * kLS;   // [kv row][q row]
  float* Ls = dSs + kB * kLS;   // lse of the q tile's rows
  float* Dl = Ls + QB;          // delta of the q tile's rows

  const int k0 = blockIdx.x * kB;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = hq / hkv;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // kv rows rg * 4 .. rg * 4 + 3
  const int lc = tid & 15;   // q columns lc + 16 j; d columns lc + 16 j

  stage<T, D>(Ks, k, bb, k0, skv, hkv, kvh, d);
  stage<T, D>(Vs, v, bb, k0, skv, hkv, kvh, d);

  float dk_acc[kR][DC], dv_acc[kR][DC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (sq + QB - 1) / QB;
  const int qt0 = causal ? k0 / QB : 0;  // q tiles above the diagonal: none
  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    const float* lse_h = lse + (static_cast<size_t>(bb) * hq + h) * sq;
    const float* del_h = delta + (static_cast<size_t>(bb) * hq + h) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * QB;
      __syncthreads();  // the previous tile's Q, dO, P, dS are no longer read
      stage<T, D, QB>(Qs, q, bb, q0, sq, hq, h, d);
      stage<T, D, QB>(dOs, dout, bb, q0, sq, hq, h, d);
      if (tid < QB) {
        const int qi = q0 + tid;
        Ls[tid] = qi < sq ? lse_h[qi] : 0.f;
        Dl[tid] = qi < sq ? del_h[qi] : 0.f;
      }
      __syncthreads();

      // S^T and (dO V^T)^T of the tile: kv rows x q columns.
      float s[kR][kC], dp[kR][kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kr[kR], vr[kR], qc[kC], oc[kC];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          kr[i] = Ks[(rg * kR + i) * LD + c];
          vr[i] = Vs[(rg * kR + i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          qc[j] = Qs[(lc + 16 * j) * LD + c];
          oc[j] = dOs[(lc + 16 * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kr_ = rg * kR + i;
        const int kvi = k0 + kr_;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int qc_ = lc + 16 * j;
          const int qi = q0 + qc_;
          const bool ok = kvi < skv && qi < sq && (!causal || kvi <= qi);
          const float p = ok ? expf(s[i][j] * scale - Ls[qc_]) : 0.f;
          Ps[kr_ * kLS + qc_] = p;
          dSs[kr_ * kLS + qc_] = p * (dp[i][j] - Dl[qc_]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's valid q rows.
      const int qn = min(QB, sq - q0);
#pragma unroll 4
      for (int r = 0; r < qn; ++r) {
        float pr[kR], dsr[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pr[i] = Ps[(rg * kR + i) * kLS + r];
          dsr[i] = dSs[(rg * kR + i) * kLS + r];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float ov = dOs[r * LD + lc + 16 * j];
          const float qv = Qs[r * LD + lc + 16 * j];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            dv_acc[i][j] = fmaf(pr[i], ov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsr[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int kvi = k0 + rg * kR + i;
    if (kvi >= skv) continue;
    const size_t off = ((static_cast<size_t>(bb) * skv + kvi) * hkv + kvh) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      if (lc + 16 * j >= d) continue;
      dk[off + lc + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[off + lc + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int skv, int hq, int hkv, int d_arg, float scale,
                    int causal) {
  const int d = kPad ? d_arg : D;
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  constexpr int KB = kB;                 // kv rows a streamed tile
  constexpr int kC = KB / 16;            // score columns a thread
  constexpr int kLS = KB + 1;            // row stride of dS
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + KB * LD;
  float* dSs = Vs + KB * LD;    // [q row][kv row]

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // q rows rg * 4 .. rg * 4 + 3
  const int lc = tid & 15;   // kv columns lc + 16 j; d columns lc + 16 j

  stage<T, D>(Qs, q, bb, q0, sq, hq, h, d);
  stage<T, D>(dOs, dout, bb, q0, sq, hq, h, d);
  float lr[kR], dl[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + rg * kR + i;
    const size_t off = (static_cast<size_t>(bb) * hq + h) * sq + qi;
    lr[i] = qi < sq ? lse[off] : 0.f;
    dl[i] = qi < sq ? delta[off] : 0.f;
  }
  float dq_acc[kR][DC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;

  const int kv_end = causal ? min(skv, q0 + kB) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += KB) {
    __syncthreads();  // the previous tile's K, V, dS are no longer read
    stage<T, D, KB>(Ks, k, bb, k0, skv, hkv, kvh, d);
    stage<T, D, KB>(Vs, v, bb, k0, skv, hkv, kvh, d);
    __syncthreads();

    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qr[kR], orr[kR], kc[kC], vc[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qr[i] = Qs[(rg * kR + i) * LD + c];
        orr[i] = dOs[(rg * kR + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        kc[j] = Ks[(lc + 16 * j) * LD + c];
        vc[j] = Vs[(lc + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(orr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qr_ = rg * kR + i;
      const int qi = q0 + qr_;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int kc_ = lc + 16 * j;
        const int ki = k0 + kc_;
        const bool ok = qi < sq && ki < skv && (!causal || ki <= qi);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dSs[qr_ * kLS + kc_] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

    const int kn = min(KB, kv_end - k0);
#pragma unroll 4
    for (int r = 0; r < kn; ++r) {
      float dsr[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsr[i] = dSs[(rg * kR + i) * kLS + r];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = Ks[r * LD + lc + 16 * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          dq_acc[i][j] = fmaf(dsr[i], kv, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + rg * kR + i;
    if (qi >= sq) continue;
    const size_t off = ((static_cast<size_t>(bb) * sq + qi) * hq + h) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (lc + 16 * j < d)
        dq[off + lc + 16 * j] = from_f32<T>(dq_acc[i][j] * scale);
  }
}

// delta at any d, one warp a row (route "wide" and the wgmma routes above
// 256).
template <typename T>
cudaError_t preprocess_rows(const void* o, const void* dout, float* delta,
                            int b, int sq, int hq, int d,
                            cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(b) * sq * hq;
  const size_t rows_a_block = kThreads / 32;
  flash_bwd_preprocess_rows_kernel<T>
      <<<static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block),
         kThreads, 0, stream>>>(static_cast<const T*>(o),
                                static_cast<const T*>(dout), delta, b, sq,
                                hq, d);
  return cudaGetLastError();
}

// delta = rowsum(dO * O) over the real d into (b, hq, sq) float32: the
// 16-byte kernel where d is the instantiated D, else one warp a row.
template <typename T, int D>
cudaError_t preprocess(const void* o, const void* dout, float* delta, int b,
                       int sq, int hq, int d, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(b) * sq * hq;
  if (d == D) {
    const size_t rows_a_block = kThreads / delta_lanes<T, D>();
    flash_bwd_preprocess_kernel<T, D>
        <<<static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block),
           kThreads, 0, stream>>>(static_cast<const T*>(o),
                                  static_cast<const T*>(dout), delta, b, sq,
                                  hq);
    return cudaGetLastError();
  }
  return preprocess_rows<T>(o, dout, delta, b, sq, hq, d, stream);
}

template <typename T, int D, bool kPad>
int launch_as(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
              int d, float scale, int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  cudaError_t err = preprocess<T, D>(o, dout, delta, b, sq, hq, d, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t s_kv = dkdv_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D, kPad>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, D, kPad>
      <<<dim3((skv + kB - 1) / kB, hkv, b), kThreads, s_kv, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), sq, skv, hq, hkv, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t s_q = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, kPad>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D, kPad>
      <<<dim3((sq + kB - 1) / kB, hq, b), kThreads, s_q, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), sq, skv, hq, hkv,
          d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The unpadded instantiation at d == D (as the forward's launch_simt), the
// padded one at every other d.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
           int d, float scale, int causal, cudaStream_t stream) {
  if (d == D)
    return launch_as<T, D, false>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  b, sq, skv, hq, hkv, d, scale, causal,
                                  stream);
  return launch_as<T, D, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                               sq, skv, hq, hkv, d, scale, causal, stream);
}

// Both dtypes up to kSimtMaxDim, at the padded D 16 or 32: above it fp32
// runs route "wide", bf16 the wgmma kernels (tc_route, or staged_route's
// copies).
template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, int b, int sq, int skv, int hq,
             int hkv, float scale, int causal, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The staged routes' copies, forward and backward: up to 256
// (staged_route) and above it (tc_wide_staged_route).
// ---------------------------------------------------------------------------
namespace stage {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;   // eight warps, a row each
constexpr int kPer = 3;         // 16-byte chunks a lane holds in one pass

// Rows of Q, K, V and, where the grid has a fourth y (the backward), dO
// (blockIdx.y 0-3) into rows of ld elements of the scratch, in that order,
// columns d..ld - 1 zero; ld is any multiple of 8 at or above d
// (staged_ld(d) on the routes). With dO, also delta = rowsum(dO * O) over
// the real d for each dO row into (b, hq, sq) float32, from the dO chunks
// the copy reads and the same chunks of O. A row takes one warp, lane
// j its chunks j, j + 32, j + 64 (ld / 8 chunks, up to kPer a lane in one
// pass: a row of up to 768 elements; wider rows take more passes), each
// stored whole, gathered from the source in W-element loads: 8 bytes where
// d % 4 == 0, 4 where d is even, 2 where it is odd, the widest the source
// rows' alignment allows (a row starts 2 d bytes after the last). A lane's
// loads of a pass are independent, in flight together; the warp sums delta
// with shuffles, so the mapping holds at any ld
// (flash_stage_rows_group_kernel below 256 gives a row a group of up to 32
// lanes, one chunk each).
// Bound by bytes: each input read once (O's d columns too), its staged copy
// and delta written once.
template <int W>
__global__ void __launch_bounds__(kThreads)
flash_stage_rows_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const bf16* __restrict__ o,
                        float* __restrict__ delta,
                        bf16* __restrict__ scratch, long long nq,
                        long long nk, int sq, int hq, int d, int ld) {
  const int which = blockIdx.y;
  const long long rows = which == 0 || which == 3 ? nq : nk;
  const bf16* src = which == 0 ? q : which == 1 ? k : which == 2 ? v : dout;
  const long long first = which == 0 ? 0
                          : which == 1 ? nq
                          : which == 2 ? nq + nk
                                       : nq + 2 * nk;
  const long long r = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) >> 5;
  if (r >= rows) return;    // whole warps: a row's lanes leave together
  const int lane = threadIdx.x & 31;
  const int chunks = ld / 8;
  const bool with_delta = which == 3;  // the whole warp alike
  bf16* dst = scratch + (first + r) * ld;
  float s = 0.f;    // zero past d: both chunks hold zeros there
  for (int base = 0; base < chunks; base += 32 * kPer) {
    __align__(16) unsigned short buf[kPer][8];
    __align__(16) unsigned short obuf[kPer][8];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c0 = 8 * (base + 32 * i + lane);
#pragma unroll
      for (int e = 0; e < 8; e += W) {
        // d is a multiple of W, so a W-element group lies wholly below d
        // or not
        const bool ok = c0 + e < d;
        const long long at = r * d + c0 + e;
        if constexpr (W == 4) {
          const uint2 z = make_uint2(0, 0);
          *reinterpret_cast<uint2*>(buf[i] + e) =
              ok ? __ldg(reinterpret_cast<const uint2*>(src + at)) : z;
          if (with_delta)
            *reinterpret_cast<uint2*>(obuf[i] + e) =
                ok ? __ldg(reinterpret_cast<const uint2*>(o + at)) : z;
        } else if constexpr (W == 2) {
          *reinterpret_cast<unsigned int*>(buf[i] + e) =
              ok ? __ldg(reinterpret_cast<const unsigned int*>(src + at))
                 : 0u;
          if (with_delta)
            *reinterpret_cast<unsigned int*>(obuf[i] + e) =
                ok ? __ldg(reinterpret_cast<const unsigned int*>(o + at))
                   : 0u;
        } else {
          const unsigned short z = 0;
          buf[i][e] =
              ok ? __ldg(reinterpret_cast<const unsigned short*>(src + at))
                 : z;
          if (with_delta)
            obuf[i][e] =
                ok ? __ldg(reinterpret_cast<const unsigned short*>(o + at))
                   : z;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = base + 32 * i + lane;
      if (c < chunks)
        *reinterpret_cast<uint4*>(dst + 8 * c) =
            *reinterpret_cast<const uint4*>(buf[i]);
      if (with_delta)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          s = fmaf(to_f32(reinterpret_cast<const bf16*>(obuf[i])[e]),
                   to_f32(reinterpret_cast<const bf16*>(buf[i])[e]), s);
    }
  }
  if (!with_delta) return;
  s = warp_sum(s);
  if (lane == 0) {
    const int h = static_cast<int>(r % hq);
    const long long bi = r / hq;
    const int i = static_cast<int>(bi % sq);
    delta[(bi / sq * hq + h) * sq + i] = s;
  }
}

template <int W>
cudaError_t copy_as(const void* q, const void* k, const void* v,
                    const void* dout, const void* o, float* delta,
                    bf16* scratch, long long nq, long long nk, int sq, int hq,
                    int d, int ld, cudaStream_t stream) {
  const long long threads = (nq > nk ? nq : nk) * 32;
  const dim3 grid(
      static_cast<unsigned>((threads + kThreads - 1) / kThreads),
      dout != nullptr ? 4 : 3);
  flash_stage_rows_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(o), delta, scratch, nq, nk, sq, hq, d, ld);
  return cudaGetLastError();
}

// q, k, v and, unless null, dout ((b, rows, heads, d) bf16; nq = b sq hq
// and nk = b skv hkv rows) into `scratch` ((2 nq + 2 nk) ld bf16 with dout,
// else (nq + 2 nk) ld), and with dout delta from it and o (dout's shape;
// null without dout).
cudaError_t copy(const void* q, const void* k, const void* v,
                 const void* dout, const void* o, float* delta,
                 bf16* scratch, long long nq, long long nk, int sq, int hq,
                 int d, int ld, cudaStream_t stream) {
  if (ld % 8 != 0 || ld < d || (o == nullptr) != (dout == nullptr))
    return cudaErrorInvalidValue;
  if (d % 4 == 0)
    return copy_as<4>(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d,
                      ld, stream);
  if (d % 2 == 0)
    return copy_as<2>(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d,
                      ld, stream);
  return copy_as<1>(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d, ld,
                    stream);
}

// The staged routes' copy up to 256 (staged_route), forward and backward:
// rows of Q, K, V and, where the grid has a fourth y (the backward), dO
// (blockIdx.y 0-3) into rows of ld = staged_ld(d) elements of the
// scratch, in that order, columns d..ld - 1 zero; and with dO, for each dO
// row delta = rowsum(dO * O) over the real d into (b, hq, sq) float32,
// from the dO chunks the copy reads anyway and the same chunks of O (a
// separate pass, flash_bwd_preprocess_rows_kernel, would read dO again and
// cost a launch; PERF.md §6 has the times). A row takes a group of P threads (P
// the least power of two at or above its ld / 8 16-byte chunks; 32 / P rows
// a warp), thread j of the group chunk j, stored whole, gathered from the
// source in W-element loads: 8 bytes where d % 4 == 0, 4 where d is even, 2
// where it is odd, the widest the source rows' alignment allows (a row
// starts 2 d bytes after the last). A thread's 8 / W loads are
// independent, in flight together; the group sums delta with shuffles.
// Bound by bytes: each input read once (O's d columns too), its staged copy
// and delta written once.
constexpr int kStageThreads = 256;

template <int W>
__global__ void __launch_bounds__(kStageThreads)
flash_stage_rows_group_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const bf16* __restrict__ o,
                              float* __restrict__ delta,
                              bf16* __restrict__ scratch, long long nq,
                              long long nk, int sq, int hq, int d, int ld,
                              int log2p) {
  const int which = blockIdx.y;
  const long long rows = which == 0 || which == 3 ? nq : nk;
  const bf16* src = which == 0 ? q : which == 1 ? k : which == 2 ? v : dout;
  const long long first = which == 0 ? 0
                          : which == 1 ? nq
                          : which == 2 ? nq + nk
                                       : nq + 2 * nk;
  const int p = 1 << log2p, j = threadIdx.x & (p - 1);
  const long long r = (static_cast<long long>(blockIdx.x) * kStageThreads +
                       threadIdx.x) >> log2p;
  if (r >= rows) return;    // whole groups: a row's threads leave together
  const int c0 = 8 * j;
  __align__(16) unsigned short buf[8];
  __align__(16) unsigned short obuf[8];
#pragma unroll
  for (int e = 0; e < 8; e += W) {
    // d is a multiple of W, so a W-element group lies wholly below d or not
    const bool ok = c0 + e < d;
    const long long at = r * d + c0 + e;
    if constexpr (W == 4) {
      const uint2 z = make_uint2(0, 0);
      *reinterpret_cast<uint2*>(buf + e) =
          ok ? __ldg(reinterpret_cast<const uint2*>(src + at)) : z;
      if (which == 3)
        *reinterpret_cast<uint2*>(obuf + e) =
            ok ? __ldg(reinterpret_cast<const uint2*>(o + at)) : z;
    } else if constexpr (W == 2) {
      *reinterpret_cast<unsigned int*>(buf + e) =
          ok ? __ldg(reinterpret_cast<const unsigned int*>(src + at)) : 0u;
      if (which == 3)
        *reinterpret_cast<unsigned int*>(obuf + e) =
            ok ? __ldg(reinterpret_cast<const unsigned int*>(o + at)) : 0u;
    } else {
      const unsigned short z = 0;
      buf[e] = ok ? __ldg(reinterpret_cast<const unsigned short*>(src + at))
                  : z;
      if (which == 3)
        obuf[e] = ok ? __ldg(reinterpret_cast<const unsigned short*>(o + at))
                     : z;
    }
  }
  if (c0 < ld)
    *reinterpret_cast<uint4*>(scratch + (first + r) * ld + c0) =
        *reinterpret_cast<const uint4*>(buf);
  if (which != 3) return;
  float s = 0.f;    // zero past d: both chunks hold zeros there
#pragma unroll
  for (int e = 0; e < 8; ++e)
    s = fmaf(to_f32(reinterpret_cast<const bf16*>(obuf)[e]),
             to_f32(reinterpret_cast<const bf16*>(buf)[e]), s);
  // The group's lanes only: at the tail a warp's later groups have left.
  const int lane = threadIdx.x & 31;
  const unsigned group =
      p == 32 ? 0xffffffffu : ((1u << p) - 1) << (lane & ~(p - 1));
  for (int off = 1; off < p; off <<= 1)
    s += __shfl_xor_sync(group, s, off);
  if (j == 0) {
    const int h = static_cast<int>(r % hq);
    const long long bi = r / hq;
    const int i = static_cast<int>(bi % sq);
    delta[(bi / sq * hq + h) * sq + i] = s;
  }
}

template <int W>
cudaError_t group_as(const void* q, const void* k, const void* v,
                     const void* dout, const void* o, float* delta,
                     bf16* scratch, long long nq, long long nk, int sq,
                     int hq, int d, int ld, cudaStream_t stream) {
  int log2p = 0;
  while ((1 << log2p) < ld / 8) ++log2p;
  const long long threads = (nq > nk ? nq : nk) << log2p;
  const dim3 grid(
      static_cast<unsigned>((threads + kStageThreads - 1) / kStageThreads),
      dout != nullptr ? 4 : 3);
  flash_stage_rows_group_kernel<W><<<grid, kStageThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(o), delta, scratch, nq, nk, sq, hq, d, ld,
      log2p);
  return cudaGetLastError();
}

// q, k, v and, unless null, dout (and with it o and delta), as copy()'s
// arguments, at staged_route's d.
cudaError_t copy_group(const void* q, const void* k, const void* v,
                       const void* dout, const void* o, float* delta,
                       bf16* scratch, long long nq, long long nk, int sq,
                       int hq, int d, int ld, cudaStream_t stream) {
  if (ld != staged_ld(d) || ld > 256 || (o == nullptr) != (dout == nullptr))
    return cudaErrorInvalidValue;
  if (d % 4 == 0)
    return group_as<4>(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d,
                       ld, stream);
  if (d % 2 == 0)
    return group_as<2>(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d,
                       ld, stream);
  return group_as<1>(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d, ld,
                     stream);
}

// The staged routes' copy up to 256 (staged_route), forward (dout null)
// and backward: a lane group a row.
cudaError_t copy_up_to_256(const void* q, const void* k, const void* v,
                           const void* dout, const void* o, float* delta,
                           bf16* scratch, long long nq, long long nk, int sq,
                           int hq, int d, cudaStream_t stream) {
  return copy_group(q, k, v, dout, o, delta, scratch, nq, nk, sq, hq, d,
                    staged_ld(d), stream);
}

}  // namespace stage

// ---------------------------------------------------------------------------
// Backward in bf16 on the tensor cores (wgmma + TMA), D = 64, 128, 160 or
// 256.
// ---------------------------------------------------------------------------
namespace bwd_tc {

using bf16 = __nv_bfloat16;
using tc::boxes;
using tc::kBox;
using tc::mma_abt;
using tc::mma_rb;
constexpr int kB = 64;          // rows a tile: one wgmma M, and the S tile's N
constexpr int kThreads = 128;   // one warpgroup
constexpr int kStages = 2;      // depth of the ring of streamed tiles

// Warpgroups of the dK/dV kernel. At d 64 and 128 one holds both dK and
// dV (2 x 64 fp32 accumulators a thread at 128). At d 160 the products
// into dK and dV run at N 192 (d 160 is not a whole number of 64-column
// swizzle atoms, so the third box is padded with TMA's zeros, as the
// forward's P.V): 2 x 96 accumulators beside S^T and dP^T would pass 255
// registers, so warpgroup 0 holds dV and warpgroup 1 dK, each recomputing
// S^T (warpgroup 1 also dP^T) from the same tiles. D 256 splits the same
// way, at N 256 (128 accumulators a thread).
template <int D>
__host__ __device__ constexpr int dkdv_warpgroups() {
  return D > 128 ? 2 : 1;
}

// Both kernels: two fixed tiles, a ring of two tiles a stage, barriers;
// the dK/dV kernel also the lse and delta of a q tile a stage. Tiles of
// 64 q rows and 64 kv rows, two stages, at every d: at 160 each tile is
// three 8 KB boxes, 144 KB of tiles and 146 KB in all (one block an SM).
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * static_cast<size_t>(kBox) * boxes<D>() *
                    (2 + 2 * kStages) +
         sizeof(float) * 2 * kStages * kB + 8 * (1 + kStages);
}

// This thread's two rows of a 64 x N accumulator (N >= D >= d), times
// `mul`, as bf16 into the d columns of rows `row_a` and `row_a` + 8 (those
// below `rows`) of a (b, rows, heads, d) tensor at (bb, h). d is a multiple
// of 8, or with kStaged any d: each column is masked, a pair stored as 4
// bytes where d is even (so the pair is whole and 4-byte aligned), else
// element by element.
template <int D, bool kStaged, int NA>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NA],
                                           float mul, int bb, int row_a,
                                           int rows, int heads, int h,
                                           int col_t, int d) {
  static_assert(2 * NA >= D, "accumulator narrower than the head dim");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= rows) continue;
    bf16* orow =
        out + ((static_cast<size_t>(bb) * rows + row) * heads + h) * d;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if constexpr (kStaged) {
        const int c = 8 * jj + col_t;
        const float x0 = acc[4 * jj + 2 * half] * mul;
        const float x1 = acc[4 * jj + 2 * half + 1] * mul;
        if (d % 2 == 0) {
          if (c < d)
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(x0, x1);
        } else {
          if (c < d) orow[c] = __float2bfloat16(x0);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16(x1);
        }
      } else if (8 * jj < d) {
        *reinterpret_cast<uint32_t*>(orow + 8 * jj + col_t) =
          pack_bf16(acc[4 * jj + 2 * half] * mul,
                        acc[4 * jj + 2 * half + 1] * mul);
      }
    }
  }
}

// One block a (kv tile of 64 rows, kv head, batch): K and V stay in smem,
// Q and dO tiles of the group's q heads stream through a TMA ring, and the
// dK, dV accumulators stay in registers for the whole walk (split between
// two warpgroups at d 160, dkdv_warpgroups). In the transposed score tile
// S^T (kv rows x q columns) lse and delta are per column, read from smem.
// kStaged: the maps read the staged rows (staged_route), and dK, dV are
// stored column by column (store_rows); the rest is the same code.
template <int D, bool kStaged>
__global__ void __launch_bounds__(kThreads * dkdv_warpgroups<D>())
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int b, int sq, int skv, int hq, int hkv, int d,
                            float scale, float scale_log2, int causal) {
  constexpr int NB = boxes<D>();  // 64-column boxes a row
  constexpr int NP = 64 * NB;     // dV's and dK's N: d, or 160 padded to 192
  constexpr int WGS = dkdv_warpgroups<D>();
  constexpr int NACC = WGS == 1 ? 2 : 1;  // accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* Vs = Ks + NB * kBox;
  bf16* Qs = Vs + NB * kBox;                  // [kStages][NB][kBox]
  bf16* dOs = Qs + kStages * NB * kBox;       // [kStages][NB][kBox]
  float* Ls = reinterpret_cast<float*>(dOs + kStages * NB * kBox);
  float* Dl = Ls + kStages * kB;              // [kStages][kB] each
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(Dl + kStages * kB);
  uint64_t* qbar = kvbar + 1;                 // [kStages]

  // Longest first: when causal, kv tile 0 of every (kv head, batch) walks
  // every q tile, the last kv tile only the last.
  const int heads = hkv * b;
  const int kt = static_cast<int>(blockIdx.x) / heads;
  const int kvh = static_cast<int>(blockIdx.x) % hkv;
  const int bb = (static_cast<int>(blockIdx.x) % heads) / hkv;
  const int k0 = kt * kB;
  const int g = hq / hkv;
  const int qt0 = causal ? kt : 0;  // q tiles above the diagonal: none
  const int nq = max((sq + kB - 1) / kB - qt0, 0);
  const int n_it = g * nq;          // (q head of the group, q tile) pairs
  const int tid = threadIdx.x;
  // Which sums this thread's warpgroup keeps (both with one warpgroup).
  const int wg = tid / kThreads;
  const bool does_dv = WGS == 1 || wg == 0;
  const bool does_dk = WGS == 1 || wg == 1;

  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  auto issue_q = [=](int stage, int it) {
    const int h = kvh * g + it / nq, q0 = (qt0 + it % nq) * kB;
    mbar_expect_tx(&qbar[stage], 2 * NB * kBox * sizeof(bf16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(Qs + (stage * NB + nb) * kBox, mq, &qbar[stage], nb * 64,
                  h, q0, bb);
      tma_load_4d(dOs + (stage * NB + nb) * kBox, mdo, &qbar[stage],
                  nb * 64, h, q0, bb);
    }
  };
  // Offset into lse/delta of row `tid` of step it's q tile (-1 past sq).
  auto row_off = [=](int it) -> long long {
    const int h = kvh * g + it / nq, qi = (qt0 + it % nq) * kB + tid;
    return qi < sq ? (static_cast<long long>(bb) * hq + h) * sq + qi : -1;
  };

  if (tid == 0) {
    mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&qbar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * NB * kBox * sizeof(bf16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(Ks + nb * kBox, &tk, kvbar, nb * 64, kvh, k0, bb);
      tma_load_4d(Vs + nb * kBox, &tv, kvbar, nb * 64, kvh, k0, bb);
    }
    for (int it = 0; it < min(kStages, n_it); ++it) issue_q(it, it);
  }
  if (tid < kB && n_it > 0) {
    const long long off = row_off(0);
    Ls[tid] = off < 0 ? 0.f : lse[off] * tc::kLog2e;
    Dl[tid] = off < 0 ? 0.f : delta[off];
  }
  __syncthreads();

  const int t = tid % kThreads;             // thread of its warpgroup
  const int warp = t >> 5, lane = t & 31;
  const int r_a = warp * 16 + (lane >> 2);  // tile row (kv) of the even pair
  const int kv_a = k0 + r_a, kv_b = kv_a + 8;
  const int col_t = 2 * (lane & 3);

  float acc[NACC][NP / 2];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[a][i] = 0.f;
  float (&dv_acc)[NP / 2] = acc[0];
  float (&dk_acc)[NP / 2] = acc[NACC - 1];

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % kStages;
    const int q0 = (qt0 + it % nq) * kB;
    // lse and delta of the next step's rows: loaded now, stored to their
    // slot while this step's first products run (the slot was last read
    // in the step before this one, which ended in a barrier).
    const bool pre = tid < kB && it + 1 < n_it;
    float next_l = 0.f, next_d = 0.f;
    if (pre) {
      const long long off = row_off(it + 1);
      if (off >= 0) {
        next_l = lse[off] * tc::kLog2e;
        next_d = delta[off];
      }
    }
    mbar_wait(&qbar[stage], (it / kStages) & 1);
    const bf16* Qt = Qs + stage * NB * kBox;
    const bf16* dOt = dOs + stage * NB * kBox;

    // S^T = K Q^T and, for dK, dP^T = V dO^T (kv rows x q columns), two
    // groups: P^T is formed while dP^T is still on the tensor cores.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt<D>(s, Ks, Qt);
    wgmma_commit();
    if (does_dk) {
      mma_abt<D>(dp, Vs, dOt);
      wgmma_commit();
    }
    if (pre) {
      Ls[(it + 1) % kStages * kB + tid] = next_l;
      Dl[(it + 1) % kStages * kB + tid] = next_d;
    }
    if (does_dk)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(s);

    // P^T = exp(S^T scale - lse) in fp32 in place; zero where kv > q
    // (causal), kv >= skv or q >= sq (those rows and columns came in as
    // TMA zeros): row r's valid columns are lo_r <= col < hi.
    const float* lrow = Ls + stage * kB;
    const float* drow = Dl + stage * kB;
    const int hi = sq - q0;
    const int lo_a = kv_a >= skv ? kB : (causal ? kv_a - q0 : 0);
    const int lo_b = kv_b >= skv ? kB : (causal ? kv_b - q0 : 0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + col_t + c;
        const float l2 = lrow[col];
        s[4 * jj + c] = col >= lo_a && col < hi
            ? exp2f(s[4 * jj + c] * scale_log2 - l2) : 0.f;
        s[4 * jj + 2 + c] = col >= lo_b && col < hi
            ? exp2f(s[4 * jj + 2 + c] * scale_log2 - l2) : 0.f;
      }
    }
    uint32_t p_frag[4][4], ds_frag[4][4];
    pack_a(p_frag, s);
    if (does_dk) {
      wgmma_wait<0>();
      fence_regs(dp);
    }

    // dV += P^T dO (P^T rounded to bf16 as the register A operand, dO read
    // MN-major) runs while dS^T = P^T (dP^T - delta) is formed; then
    // dK += dS^T Q.
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    if (does_dv) {
      mma_rb<NP>(dv_acc, p_frag, dOt);
      wgmma_commit();
    }
    if (does_dk) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = drow[8 * jj + col_t + c];
          dp[4 * jj + c] = s[4 * jj + c] * (dp[4 * jj + c] - dl);
          dp[4 * jj + 2 + c] = s[4 * jj + 2 + c] * (dp[4 * jj + 2 + c] - dl);
        }
      }
      pack_a(ds_frag, dp);
      wgmma_fence();
      mma_rb<NP>(dk_acc, ds_frag, Qt);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    __syncthreads();  // every wgmma and thread is done with this stage
    if (tid == 0 && it + kStages < n_it) issue_q(stage, it + kStages);
  }

  if (does_dk)
    store_rows<D, kStaged>(dk, dk_acc, scale, bb, kv_a, skv, hkv, kvh, col_t,
                           d);
  if (does_dv)
    store_rows<D, kStaged>(dv, dv_acc, 1.f, bb, kv_a, skv, hkv, kvh, col_t,
                           d);
}

// One block a (q tile of 64 rows, q head, batch): Q and dO stay in smem,
// K and V tiles up to the diagonal stream through a TMA ring; S and dP are
// recomputed here (not read from the dK/dV kernel), so no block adds into
// another's output. At d 160 dQ += dS K runs at N 192 (96 accumulators a
// thread), as the dK/dV kernel's products. kStaged as the dK/dV kernel's.
template <int D, bool kStaged>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int b, int sq, int skv,
                          int hq, int hkv, int d, int n_qtiles, float scale,
                          float scale_log2, int causal) {
  constexpr int NB = boxes<D>();
  constexpr int NP = 64 * NB;     // dQ's N: d, or 160 padded to 192
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* dOs = Qs + NB * kBox;
  bf16* Ks = dOs + NB * kBox;                 // [kStages][NB][kBox]
  bf16* Vs = Ks + kStages * NB * kBox;        // [kStages][NB][kBox]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + kStages * NB * kBox);
  uint64_t* kvbar = qbar + 1;                 // [kStages]

  // Longest q tiles first, as the forward.
  const int heads = hq * b;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % hq;
  const int bb = (static_cast<int>(blockIdx.x) % heads) / hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kB;
  const int kv_end = causal ? min(skv, q0 + kB) : skv;
  const int n_kv = (kv_end + kB - 1) / kB;
  const int tid = threadIdx.x;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue_kv = [=](int stage, int j) {
    mbar_expect_tx(&kvbar[stage], 2 * NB * kBox * sizeof(bf16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(Ks + (stage * NB + nb) * kBox, mk, &kvbar[stage], nb * 64,
                  kvh, j * kB, bb);
      tma_load_4d(Vs + (stage * NB + nb) * kBox, mv, &kvbar[stage], nb * 64,
                  kvh, j * kB, bb);
    }
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&kvbar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * NB * kBox * sizeof(bf16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(Qs + nb * kBox, &tq, qbar, nb * 64, h, q0, bb);
      tma_load_4d(dOs + nb * kBox, &tdo, qbar, nb * 64, h, q0, bb);
    }
    for (int j = 0; j < min(kStages, n_kv); ++j) issue_kv(j, j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8
  const int row_b = row_a + 8;
  const int col_t = 2 * (lane & 3);
  const size_t lbase = (static_cast<size_t>(bb) * hq + h) * sq;
  const float l_a = row_a < sq ? lse[lbase + row_a] * tc::kLog2e : 0.f;
  const float l_b = row_b < sq ? lse[lbase + row_b] * tc::kLog2e : 0.f;
  const float d_a = row_a < sq ? delta[lbase + row_a] : 0.f;
  const float d_b = row_b < sq ? delta[lbase + row_b] : 0.f;

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int stage = j % kStages;
    mbar_wait(&kvbar[stage], (j / kStages) & 1);
    const bf16* Kt = Ks + stage * NB * kBox;
    const bf16* Vt = Vs + stage * NB * kBox;

    // S = Q K^T and dP = dO V^T (q rows x kv columns), two groups: P is
    // formed while dP is still on the tensor cores.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt<D>(s, Qs, Kt);
    wgmma_commit();
    mma_abt<D>(dp, dOs, Vt);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P = exp(S scale - lse); zero where kv > q (causal), kv >= skv or
    // q >= sq: row r's valid columns are col < hi_r.
    const int k0 = j * kB;
    const int cap = skv - k0;
    const int hi_a =
        row_a >= sq ? 0 : (causal ? min(row_a - k0 + 1, cap) : cap);
    const int hi_b =
        row_b >= sq ? 0 : (causal ? min(row_b - k0 + 1, cap) : cap);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + col_t + c;
        s[4 * jj + c] =
            col < hi_a ? exp2f(s[4 * jj + c] * scale_log2 - l_a) : 0.f;
        s[4 * jj + 2 + c] =
            col < hi_b ? exp2f(s[4 * jj + 2 + c] * scale_log2 - l_b) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta).
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dp[4 * jj + c] = s[4 * jj + c] * (dp[4 * jj + c] - d_a);
        dp[4 * jj + 2 + c] = s[4 * jj + 2 + c] * (dp[4 * jj + 2 + c] - d_b);
      }
    }
    // dQ += dS K: dS rounded to bf16 as the register A operand, K read
    // MN-major.
    uint32_t ds_frag[4][4];
    pack_a(ds_frag, dp);
    fence_regs(acc);
    wgmma_fence();
    mma_rb<NP>(acc, ds_frag, Kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every wgmma of this stage has read its tiles
    if (tid == 0 && j + kStages < n_kv) issue_kv(stage, j + kStages);
  }

  store_rows<D, kStaged>(dq, acc, scale, bb, row_a, sq, hq, h, col_t, d);
}

// kStaged (staged_route): Q, K, V and dO are first copied into `scratch`
// ((2 b sq hq + 2 b skv hkv) staged_ld(d) bf16) by
// flash_stage_rows_group_kernel, which also writes delta, and the maps read
// the copies (inner extent d, row stride staged_ld(d)); dQ, dK and dV are
// written straight into the caller's tensors at the real d.
template <int D, bool kStaged = false>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
           int d, float scale, int causal, cudaStream_t stream,
           void* scratch = nullptr) {
  // The tiles the maps read: the inputs, or their staged copies.
  const void *mq = q, *mk = k, *mv = v, *mdo = dout;
  int ld = d;
  if constexpr (kStaged) {
    if (scratch == nullptr || !staged_route(d))
      return static_cast<int>(cudaErrorInvalidValue);
    ld = staged_ld(d);
    const long long nq = static_cast<long long>(b) * sq * hq;
    const long long nk = static_cast<long long>(b) * skv * hkv;
    bf16* st = static_cast<bf16*>(scratch);
    const cudaError_t err = stage::copy_up_to_256(q, k, v, dout, o, delta,
                                                  st, nq, nk, sq, hq, d,
                                                  stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    mq = st;
    mk = st + nq * ld;
    mv = st + (nq + nk) * ld;
    mdo = st + (nq + 2 * nk) * ld;
  }
  // Encoded on every call, as the forward's (a CUDA graph records the maps
  // by value), at the real d. Any failure is returned: there is no other
  // route.
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, mq, b, sq, hq, d, ld) ||
      !make_map(&tk, mk, b, skv, hkv, d, ld) ||
      !make_map(&tv, mv, b, skv, hkv, d, ld) ||
      !make_map(&tdo, mdo, b, sq, hq, d, ld))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if constexpr (!kStaged) {
    err = bwd::preprocess<bf16, D>(o, dout, delta, b, sq, hq, d, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D, kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D, kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * tc::kLog2e;
  const int n_kt = (skv + kB - 1) / kB, n_qt = (sq + kB - 1) / kB;
  flash_bwd_dkdv_wgmma_kernel<D, kStaged>
      <<<n_kt * hkv * b, kThreads * dkdv_warpgroups<D>(), smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), b, sq, skv, hq, hkv, d, scale, scale_log2,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_kernel<D, kStaged>
      <<<n_qt * hq * b, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), b, sq, skv, hq,
      hkv, d, n_qt, scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd_tc



}  // namespace

// bf16 above 256 where tc_wide_route holds (ld 0: the caller's rows) or
// tc_wide_staged_route does (ld staged_ld(d): the copies'):
// flash_attention_wide.cu.
namespace wgmma_wide {
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream, int ld);
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream, int ld);
}  // namespace wgmma_wide

// Where simt_wide_route holds (fp32 above kSimtMaxDim, bf16 above
// kTcWideMaxDim): flash_attention_simt_wide.cu and, at one tile,
// flash_attention_simt_tile.cu (the backward's delta comes first; scratch,
// the dK/dV parts' partial sums where simt_wide_kv_parts plans more than
// one).
namespace wide {
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, int dtype, cudaStream_t stream);
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, void* scratch, int b, int sq, int skv, int hq,
               int hkv, int d, float scale, int causal, int dtype,
               cudaStream_t stream);
}  // namespace wide
}  // namespace repro

// lse: null, or (b, hq, sq) float32 that takes each row's log-sum-exp.
// scratch: for bf16 where staged_route holds (d 33-256) or
// tc_wide_staged_route does (above 256), (b sq hq + 2 b skv hkv)
// staged_ld(d) bf16 that the staged routes' copy (namespace stage) fills
// with copies of q, k and v, which the wgmma kernels then read (a failed
// copy, TMA encode, attribute or launch is returned, never served by
// another route); null on every other route, where it is not read.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     void* scratch, int b, int sq, int skv,
                                     int hq, int hkv, int d, float scale,
                                     int causal, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nq = static_cast<long long>(b) * sq * hq;
  const long long nk = static_cast<long long>(b) * skv * hkv;
  __nv_bfloat16* st = static_cast<__nv_bfloat16*>(scratch);
  if (dtype == kBF16 && tc_wide_route(d))
    return wgmma_wide::launch_fwd(q, k, v, o, l, b, sq, skv, hq, hkv, d,
                                  scale, causal, s, 0);
  if (dtype == kBF16 && tc_wide_staged_route(d)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int ld = staged_ld(d);
    const cudaError_t err = stage::copy(q, k, v, nullptr, nullptr, nullptr,
                                        st, nq, nk, sq, hq, d, ld, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return wgmma_wide::launch_fwd(st, st + nq * ld, st + (nq + nk) * ld, o,
                                  l, b, sq, skv, hq, hkv, d, scale, causal,
                                  s, ld);
  }
  if (simt_wide_route(dtype == kF32, d))
    return wide::launch_fwd(q, k, v, o, l, b, sq, skv, hq, hkv, d, scale,
                            causal, dtype, s);
  if (dtype == kF32)
    return dispatch_simt<float>(d, q, k, v, o, l, b, sq, skv, hq, hkv, scale,
                                causal, s);
  if (tc_route(d)) {
    switch (padded_dim(d)) {
      case 64: return tc::launch<64>(q, k, v, o, l, b, sq, skv, hq, hkv, d, scale, causal, s);
      case 128: return tc::launch<128>(q, k, v, o, l, b, sq, skv, hq, hkv, d, scale, causal, s);
      case 160: return tc::launch<160>(q, k, v, o, l, b, sq, skv, hq, hkv, d, scale, causal, s);
      case 256: return tc::launch<256>(q, k, v, o, l, b, sq, skv, hq, hkv, d, scale, causal, s);
    }
  }
  if (staged_route(d)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int ld = staged_ld(d);
    const cudaError_t err = stage::copy_up_to_256(
        q, k, v, nullptr, nullptr, nullptr, st, nq, nk, sq, hq, d, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void *sk = st + nq * ld, *sv = st + (nq + nk) * ld;
    switch (padded_dim(d)) {
      case 64: return tc::launch_as<64, tc::kStaged>(st, sk, sv, o, l, b, sq, skv, hq, hkv, d, scale, causal, s, ld);
      case 128: return tc::launch_as<128, tc::kStaged>(st, sk, sv, o, l, b, sq, skv, hq, hkv, d, scale, causal, s, ld);
      case 160: return tc::launch_as<160, tc::kStaged>(st, sk, sv, o, l, b, sq, skv, hq, hkv, d, scale, causal, s, ld);
      case 256: return tc::launch_as<256, tc::kStaged>(st, sk, sv, o, l, b, sq, skv, hq, hkv, d, scale, causal, s, ld);
    }
  }
  return dispatch_simt<__nv_bfloat16>(d, q, k, v, o, l, b, sq, skv, hq, hkv,
                                      scale, causal, s);
}

// Backward of repro_flash_attention: q, o, dout, dq (b, sq, hq, d); k, v,
// dk, dv (b, skv, hkv, d), all contiguous in dtype; lse (b, hq, sq) float32
// from the forward; delta (b, hq, sq) float32 scratch. On the forward's
// route: bf16 where tc_route holds, flash_bwd_preprocess_kernel (delta),
// then flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel (a failed
// TMA encode, attribute or launch is returned, never served by another
// route); bf16 where staged_route holds, the copy of q, k, v and dout into
// `scratch` ((2 b sq hq + 2 b skv hkv) staged_ld(d) bf16), which writes
// delta, then the staged instantiations of the two wgmma kernels (failures
// returned likewise); where simt_wide_route holds (fp32 above 32, bf16
// above kTcWideMaxDim), flash_bwd_preprocess_rows_kernel, then the
// CUDA-core tiles of route "wide" (`scratch`: where simt_wide_kv_parts
// plans more than one part, 2 parts b skv hkv d float32 for the dK/dV
// parts' sums; failures returned likewise); both dtypes up to 32,
// flash_bwd_preprocess_kernel, flash_bwd_dkdv_kernel and
// flash_bwd_dq_kernel. Above 256 in bf16 up to kTcWideMaxDim:
// flash_bwd_preprocess_rows_kernel, then the wgmma column-tile kernels of
// flash_attention_wide.cu where tc_wide_route holds; where
// tc_wide_staged_route holds, flash_stage_rows_kernel into `scratch` (the
// size above) and delta, then the staged instantiations of those kernels
// (failures returned likewise). All on the stream.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* scratch, int b, int sq, int skv, int hq, int hkv, int d,
    float scale, int causal, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == kBF16 && tc_wide_route(d)) {
    const cudaError_t err = bwd::preprocess_rows<__nv_bfloat16>(
        o, dout, dl, b, sq, hq, d, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return wgmma_wide::launch_bwd(q, k, v, dout, l, dl, dq, dk, dv, b, sq,
                                  skv, hq, hkv, d, scale, causal, s, 0);
  }
  if (dtype == kBF16 && tc_wide_staged_route(d)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int ld = staged_ld(d);
    const long long nq = static_cast<long long>(b) * sq * hq;
    const long long nk = static_cast<long long>(b) * skv * hkv;
    __nv_bfloat16* st = static_cast<__nv_bfloat16*>(scratch);
    const cudaError_t err = stage::copy(q, k, v, dout, o, dl, st, nq, nk,
                                        sq, hq, d, ld, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return wgmma_wide::launch_bwd(
        st, st + nq * ld, st + (nq + nk) * ld, st + (nq + 2 * nk) * ld, l,
        dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s, ld);
  }
  if (simt_wide_route(dtype == kF32, d)) {
    const cudaError_t err =
        dtype == kF32
            ? bwd::preprocess_rows<float>(o, dout, dl, b, sq, hq, d, s)
            : bwd::preprocess_rows<__nv_bfloat16>(o, dout, dl, b, sq, hq, d,
                                                  s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return wide::launch_bwd(q, k, v, dout, l, dl, dq, dk, dv, scratch, b, sq,
                            skv, hq, hkv, d, scale, causal, dtype, s);
  }
  if (dtype == kF32)
    return bwd::dispatch<float>(d, q, k, v, o, dout, l, dl, dq, dk, dv, b, sq,
                                skv, hq, hkv, scale, causal, s);
  if (tc_route(d)) {
    switch (padded_dim(d)) {
      case 64: return bwd_tc::launch<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s);
      case 128: return bwd_tc::launch<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s);
      case 160: return bwd_tc::launch<160>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s);
      case 256: return bwd_tc::launch<256>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s);
    }
  }
  if (staged_route(d)) {
    switch (padded_dim(d)) {
      case 64: return bwd_tc::launch<64, true>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s, scratch);
      case 128: return bwd_tc::launch<128, true>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s, scratch);
      case 160: return bwd_tc::launch<160, true>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s, scratch);
      case 256: return bwd_tc::launch<256, true>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, s, scratch);
    }
  }
  return bwd::dispatch<__nv_bfloat16>(d, q, k, v, o, dout, l, dl, dq, dk, dv,
                                      b, sq, skv, hq, hkv, scale, causal, s);
}
