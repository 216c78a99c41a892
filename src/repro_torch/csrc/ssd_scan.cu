// Mamba-2 SSD chunked scan, per (batch, head):
//   l_t = dt_t * A_h,  L = inclusive cumsum of l within a tile,
//   y_t = C_t . (exp(L_t) h_in + sum_{j<=t} exp(L_t - L_j) dt_j B_j x_j)
//         + D_h x_t                        (fp32, one rounding to x's dtype)
//   h_out = exp(L_last) h_in + sum_j exp(L_last - L_j) dt_j B_j (x) x_j
// with the (n, p) state h in fp32, zero at the start.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), which runs a sequential grid axis over chunks and carries
// the state across it in VMEM scratch. Semantics of record: the plain
// version ref.ssd_chunked, which adds the D skip in fp32 before the one
// rounding (the Pallas wrapper adds it in x's dtype after rounding y).
// Both designs below run their own tile of kT = 64 steps, whatever the
// chunk of the JAX contract (the wrapper checks it): the math does not
// depend on the tile. Steps at or past s are masked as dt = 0 and
// B = C = x = 0, which leaves y and the state of the valid steps
// unchanged. exp is only taken of L_t - L_j for j <= t, which is <= 0
// (A < 0, dt > 0): no positive exponent, no inf * 0.
//
// Bound on the H100, main path (b 1, s 512, h 24, p 64, n 128, bf16): it
// reads x, B, C, dt and writes y and the state once, about 4.2 MB, 1.3 us
// at 3.35 TB/s; the chunked algorithm's products (0.6 GFLOP at chunk 256)
// take less than that on the bf16 tensor cores.
//
// Two designs; kernels/ssd_scan.py::plan picks one by dtype, n and p:
//
// * tc (bf16, n and p multiples of 16, n <= 256, p <= 64; the serving
//   path): Mamba-2's own state-space-duality split, parallel over the
//   sequence's tiles, every product on the tensor cores (mma.sync m16n8k16,
//   bf16 operands, fp32 accumulators), in three launches on the caller's
//   stream, with scratch from the caller (G, decay fp32; Hp bf16):
//   1. ssd_tc_states_kernel, grid (tile, head, batch): the tile's state
//      G_c = sum_j exp(L_last - L_j) dt_j B_j (x) x_j, stored (p, n), and
//      its decay a_c = exp(L_last).
//   2. ssd_tc_pass_kernel, grid (p n / 1024, b h): the recurrence
//      H_c = a_c H_{c-1} + G_c over the tiles in fp32; the state entering
//      each tile c >= 1 goes to Hp as a bf16 hi/lo pair, the last H to the
//      final state (b, h, p, n).
//   3. ssd_tc_outputs_kernel, grid (tile, head, batch): CB = C . B^T (once
//      per batch, tile and head; 64 x 64, K = n, the column tiles at or
//      left of the diagonal only), turned in the accumulator's registers
//      into M = CB exp(L_t - L_j) dt_j for j <= t, then y = M . x +
//      exp(L_t) C . H_{c-1} + D x in fp32, one rounding. Sixteen warps:
//      four groups of 16 rows times four parts of the columns (of CB, then
//      of p), M passed between them through shared memory.
//   B, C and x are bf16 already, so their products are exact. An operand
//   with an fp32 factor (w_j x_j in 1, M and H_{c-1} in 3) goes in as a
//   bf16 hi/lo pair, hi = bf16(v), lo = bf16(v - hi), two mma into the
//   same accumulator: about 2^-17 of each term, where one rounding (2^-9)
//   would break the state's 2e-4. Operands sit in shared memory in their
//   global layout (rows of steps, rows padded by 16 bytes so ldmatrix is
//   free of bank conflicts), loaded by 16-byte cp.async, all of a block's
//   loads in flight at once; ldmatrix .trans gives the fragments whose k
//   runs along the steps. mma.sync rather than wgmma: the products are
//   small (a 64-step tile) and the hi/lo split is made on register
//   fragments, where wgmma's 64-row operands from swizzled shared memory
//   would add layouts and not speed (the products are far from the bound).
//   What holds it back (PERF.md, the per-kernel device times): the 192
//   blocks of a 512-step call load their tiles at once, about 14 MB from
//   L2 in the outputs kernel (C and B re-read by every head, H_{c-1} as a
//   pair), and 60 of the 132 SMs run two blocks.
// * simt (float32 at any shape, bfloat16 where tc does not fit, any n):
//   the CUDA-core kernel of the first port. One block owns a (batch, head,
//   slice of kPS columns of p) and loops over the sequence itself, its
//   state slice (n x kPS, fp32) in shared memory from tile to tile; the
//   columns of x, y and the state along p are independent, so slicing p is
//   exact. Each tile, with B and C held transposed in shared memory as
//   fp32:
//   1. M[t, j] = (C_t . B_j) exp(L_t - L_j) dt_j for j <= t: 4 x 4 outputs
//      a thread from float4 reads (the blocks above the diagonal idle);
//   2. y_t = sum_{j<=t} M[t, j] x_j + exp(L_t) C_t . h_in + D x_t;
//   3. h = exp(L_last) h + sum_j exp(L_last - L_j) dt_j B_j (x) x_j.
//   fp32 products on the CUDA cores are what the fp32 path is checked for
//   (2e-4 on y and the state). d_state comes in tiles of kNT = 256 columns
//   (the shared memory of B, C and the state at n 256): the state's rows
//   are independent in 3., and the sums over n in 1. and 2. run over the
//   tiles in a fixed order; past one tile the state is carried from step
//   tile to step tile in the output's own rows.
#include "common.cuh"
#include "hopper.cuh"
#include "ssd_common.cuh"

namespace repro {
namespace {

namespace simt {

constexpr int kT = 64;          // steps per tile
constexpr int kPS = 16;         // columns of p per block
constexpr int kLd = kT + 4;     // row stride of the transposed B, C and M
constexpr int kThreads = 256;
constexpr int kNT = 256;        // columns of n a tile of B, C and the state

// Shared memory of a block whose tiles hold nt columns of n (min(n, kNT)).
__host__ __device__ constexpr int ssd_smem_floats(int nt) {
  return 2 * nt * kLd + kT * kLd + kT * kPS + nt * kPS + 4 * kT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ state, int s, int h,
                int p, int n) {
  // d_state in tiles of nt columns. One tile (n <= kNT): B, C and the
  // carried state stay in shared memory whole. More: each step tile walks
  // the n tiles in order, B and C of each loaded in turn, and the state
  // of each carried between step tiles in `state` itself (the block's own
  // (p0 .. p0 + kPS, n) rows, final once the last step tile is done). The
  // sums over n (C.B^T and C.h_in) run over the tiles in order, so the
  // result does not depend on the timing, and with one tile it is the
  // same sum as ever.
  const int nt = n < kNT ? n : kNT;
  const int n_tiles = (n + nt - 1) / nt;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ct = smem;                    // [nt][kLd], C of the tile, transposed
  float* Bt = Ct + nt * kLd;           // [nt][kLd]
  float* Ms = Bt + nt * kLd;           // [kT][kLd]
  float* xs = Ms + kT * kLd;           // [kT][kPS]
  float* hs = xs + kT * kPS;           // [nt][kPS], the carried state
  float* Ls = hs + nt * kPS;           // [kT] cumsum of dt * A
  float* eL = Ls + kT;                 // [kT] exp(L_t)
  float* ws = eL + kT;                 // [kT] exp(L_last - L_j) dt_j
  float* dts = ws + kT;                // [kT] dt (0 past s)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPS;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const float a = A[hi];
  const float d_skip = D[hi];
  const size_t row_x = static_cast<size_t>(h) * p;   // x, y step stride
  float* st = state + ((static_cast<size_t>(bi) * h + hi) * p + p0) * n;
  const int pp_y = tid % kPS, tg = tid / kPS;        // y: (t, pp) a thread

  if (n_tiles == 1)
    for (int i = tid; i < n * kPS; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < s; t0 += kT) {
    // --- 1. load the tile; warp 0 scans dt * A --------------------------
    if (tid < 32) {
      const int lane = tid;
      float l[2], dv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = t0 + lane + 32 * k;
        dv[k] = t < s ? dt[(static_cast<size_t>(bi) * s + t) * h + hi] : 0.f;
        l[k] = dv[k] * a;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float o = __shfl_up_sync(0xffffffffu, l[k], off);
          if (lane >= off) l[k] += o;
        }
      }
      l[1] += __shfl_sync(0xffffffffu, l[0], 31);
      const float last = __shfl_sync(0xffffffffu, l[1], 31);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        Ls[t] = l[k];
        eL[t] = expf(l[k]);
        ws[t] = expf(last - l[k]) * dv[k];
        dts[t] = dv[k];
      }
    }
    for (int i = tid; i < kT * kPS; i += kThreads) {
      const int t = i / kPS, pp = i - t * kPS;
      const bool ok = t0 + t < s && p0 + pp < p;
      xs[i] = ok ? to_f32(x[(static_cast<size_t>(bi) * s + t0 + t) * row_x +
                            static_cast<size_t>(hi) * p + p0 + pp])
                 : 0.f;
    }

    float mc[4][4] = {};     // C_t . B_j, this thread's 4 x 4 of M
    float inter[4] = {};     // C_t . h_in of this thread's (t, pp)
    const int ti = tid / 16, tj = tid % 16;
    for (int k = 0; k < n_tiles; ++k) {
      const int n0 = k * nt, nw = min(nt, n - n0);
      if (k > 0) __syncthreads();  // the previous n tile is no longer read
      for (int i = tid; i < kT * nw; i += kThreads) {
        const int t = i / nw, nn = i - t * nw;
        const bool ok = t0 + t < s;
        const size_t g = (static_cast<size_t>(bi) * s + t0 + t) * n + n0 + nn;
        Bt[nn * kLd + t] = ok ? to_f32(B[g]) : 0.f;
        Ct[nn * kLd + t] = ok ? to_f32(C[g]) : 0.f;
      }
      if (n_tiles > 1) {     // this n tile's state, from the last step tile
        for (int i = tid; i < kPS * nw; i += kThreads) {
          const int pp = i / nw, nn = i - pp * nw;
          hs[nn * kPS + pp] =
              t0 > 0 && p0 + pp < p ? st[static_cast<size_t>(pp) * n + n0 + nn]
                                    : 0.f;
        }
      }
      __syncthreads();

      // --- 2. M[t, j] = (C_t . B_j) exp(L_t - L_j) dt_j, j <= t: the sum
      //        over this n tile ---------------------------------------------
      if (tj <= ti) {
        for (int nn = 0; nn < nw; ++nn) {
          const float4 cv = *reinterpret_cast<const float4*>(
              Ct + nn * kLd + ti * 4);
          const float4 bv = *reinterpret_cast<const float4*>(
              Bt + nn * kLd + tj * 4);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) mc[r][c] += c4[r] * b4[c];
        }
      }

      // --- 3a. C_t . h_in over this n tile -------------------------------
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = tg + q * (kThreads / kPS);
        for (int nn = 0; nn < nw; ++nn)
          inter[q] += Ct[nn * kLd + t] * hs[nn * kPS + pp_y];
      }
      __syncthreads();   // h_in is read before the update below

      // --- 4. h = exp(L_last) h + sum_j exp(L_last - L_j) dt_j B_j (x) x_j
      {
        const int pp = tid % kPS, ng = tid / kPS;
        const float a_last = eL[kT - 1];
        for (int nn = ng; nn < nw; nn += kThreads / kPS) {
          float g = 0.f;
          for (int j = 0; j < kT; ++j)
            g += ws[j] * Bt[nn * kLd + j] * xs[j * kPS + pp];
          const float hv = a_last * hs[nn * kPS + pp] + g;
          hs[nn * kPS + pp] = hv;
          if (n_tiles > 1 && p0 + pp < p)
            st[static_cast<size_t>(pp) * n + n0 + nn] = hv;
        }
      }
    }

    if (tj <= ti) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ti * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj * 4 + c;
          if (j <= t) Ms[t * kLd + j] = mc[r][c] * expf(Ls[t] - Ls[j]) * dts[j];
        }
      }
    }
    __syncthreads();

    // --- 3b. y_t = sum_{j<=t} M[t, j] x_j + exp(L_t) C_t . h_in + D x_t ---
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = tg + q * (kThreads / kPS);
      if (t0 + t >= s || p0 + pp_y >= p) continue;
      float intra = 0.f;
      for (int j = 0; j <= t; ++j)
        intra += Ms[t * kLd + j] * xs[j * kPS + pp_y];
      const float yv = (intra + eL[t] * inter[q]) + xs[t * kPS + pp_y] * d_skip;
      y[(static_cast<size_t>(bi) * s + t0 + t) * row_x +
        static_cast<size_t>(hi) * p + p0 + pp_y] = from_f32<T>(yv);
    }
    __syncthreads();
  }

  // final state, (b, h, p, n) fp32 (with several n tiles already there)
  if (n_tiles == 1) {
    for (int i = tid; i < kPS * n; i += kThreads) {
      const int pp = i / n, nn = i - pp * n;
      if (p0 + pp < p) st[static_cast<size_t>(pp) * n + nn] = hs[nn * kPS + pp];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* state, int b, int s, int h, int p, int n,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ssd_smem_floats(n < kNT ? n : kNT);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kPS - 1) / kPS, h, b);
  ssd_scan_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, static_cast<T*>(y), state, s, h, p, n);
  return cudaGetLastError();
}


}  // namespace simt

namespace tc {

using namespace ssd;
constexpr int kT = 64;          // steps per tile: four groups of 16 rows
constexpr int kParts = 4;       // warps a group of rows: parts of the columns
constexpr int kThreads = 32 * 4 * kParts;
constexpr int kWarps = kThreads / 32;
constexpr int kJQ = 4 / kParts;     // 16-column pairs of CB a warp
constexpr int kPC = 64 / kParts;    // columns of p a warp
constexpr int kUnitN = 64;          // columns of n a warp's unit of G
constexpr int kPad = 8;         // bf16 a shared-memory row is padded by
constexpr int kLdM = kT + kPad; // row stride of M in shared memory
constexpr int kMaxN = 256;      // d_state
constexpr int kMaxP = 64;       // head dim: the kParts x kPC columns of y
static_assert(kParts * kPC == kMaxP && kParts * kJQ == 4, "warp split");
constexpr int kPassThreads = 256;
constexpr int kPassTiles = 8;   // tiles whose loads the pass issues at once

__host__ __device__ constexpr size_t states_smem(int n, int p) {
  return sizeof(bf16) * static_cast<size_t>(kT) * ((n + kPad) + (p + kPad)) +
         sizeof(float) * 2 * kT;
}

__host__ __device__ constexpr size_t outputs_smem(int n, int p) {
  return sizeof(bf16) * (2 * static_cast<size_t>(kT) * (n + kPad) +
                         static_cast<size_t>(kT) * (p + kPad) +
                         2 * static_cast<size_t>(p) * (n + kPad) +
                         2 * static_cast<size_t>(kT) * kLdM) +
         sizeof(float) * 3 * kT;
}

// 1. G_c^T[pp, nn] = sum_j (w_j x_j[pp]) B_j[nn], w_j = exp(L_last - L_j)
//    dt_j, as an mma with m = p, n = d_state, k = the tile's steps. Each
//    warp takes units of 16 rows of p x 64 columns of n; the A fragments
//    of x^T are scaled by w and split into bf16 hi/lo pairs in registers.
__global__ void __launch_bounds__(kThreads)
ssd_tc_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ B,
                     float* __restrict__ G, float* __restrict__ decay, int s,
                     int h, int p, int n, int nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = n + kPad, ldp = p + kPad;
  bf16* Bs = reinterpret_cast<bf16*>(smem);   // [kT][ldn]
  bf16* Xs = Bs + kT * ldn;                   // [kT][ldp]
  float* Ls = reinterpret_cast<float*>(Xs + kT * ldp);  // [kT]
  float* ws = Ls + kT;                        // [kT]: dt, then w

  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * kT, valid = min(kT, s - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(bi) * s + t0;   // first step
  const size_t xrow = static_cast<size_t>(h) * p;          // x step stride

  load_rows<kThreads>(Bs, ldn, B + row0 * n, n, kT, n, valid);
  load_rows<kThreads>(Xs, ldp, x + row0 * xrow + static_cast<size_t>(hi) * p,
                      xrow, kT, p, valid);
  cp_async_commit();
  if (warp == 0) {
    const float last = tile_cumsum(dt, row0 * h + hi, h, valid, A[hi], Ls,
                                   ws);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = lane + 32 * k;
      ws[t] = expf(last - Ls[t]) * ws[t];
    }
    if (lane == 0)
      decay[(static_cast<size_t>(bi) * h + hi) * nt + c] = expf(last);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;   // ldmatrix: row, matrix
  const int groups = (n + kUnitN - 1) / kUnitN;
  float* Gc = G + ((static_cast<size_t>(bi) * h + hi) * nt + c) *
                      static_cast<size_t>(p) * n;
  for (int u = warp; u < (p / 16) * groups; u += kWarps) {
    const int m0 = 16 * (u / groups), nb = kUnitN * (u % groups);
    float acc[kUnitN / 8][4];
#pragma unroll
    for (int i = 0; i < kUnitN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // A = (w x)^T: x stored [k = step][m = pp], read transposed; a[0],
      // a[1] hold steps 16 kk + 2 q (+1), a[2], a[3] those + 8.
      uint32_t xa[4], ah[4], al[4];
      ldsm_x4_t(xa, Xs + (16 * kk + (lm >> 1) * 8 + lr) * ldp + m0 +
                        (lm & 1) * 8);
      const float* wk = ws + 16 * kk + 2 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(as_bf162(xa[r]));
        const int o = r < 2 ? 0 : 8;
        split2(f.x * wk[o], f.y * wk[o + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int qq = 0; qq < kUnitN / 16; ++qq) {
        if (nb + 16 * qq < n) {
          // B: stored [k = step][n = nn], read transposed; two n tiles.
          uint32_t b[4];
          ldsm_x4_t(b, Bs + (16 * kk + (lm & 1) * 8 + lr) * ldn + nb +
                           16 * qq + (lm >> 1) * 8);
          mma_bf16(acc[2 * qq], ah, b[0], b[1]);
          mma_bf16(acc[2 * qq + 1], ah, b[2], b[3]);
          mma_bf16(acc[2 * qq], al, b[0], b[1]);
          mma_bf16(acc[2 * qq + 1], al, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kUnitN / 8; ++i) {
      const int col = nb + 8 * i + 2 * q;
      if (nb + 8 * i < n) {
        *reinterpret_cast<float2*>(Gc + static_cast<size_t>(m0 + g) * n +
                                   col) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(Gc + static_cast<size_t>(m0 + g + 8) * n +
                                   col) = make_float2(acc[i][2], acc[i][3]);
      }
    }
  }
}

// 2. H_c = a_c H_{c-1} + G_c in fp32, one float4 of (p, n) a thread; the
//    state entering tile c >= 1 goes to Hp as a bf16 hi/lo pair (hi (p, n),
//    then lo (p, n)), the last H to the final state. The loads of
//    kPassTiles tiles are issued before their sums.
__global__ void __launch_bounds__(kPassThreads)
ssd_tc_pass_kernel(const float* __restrict__ G,
                   const float* __restrict__ decay, bf16* __restrict__ Hp,
                   float* __restrict__ state, int nt, int pn) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (4 * e >= pn) return;
  const size_t bh = blockIdx.y;
  const float4* gp = reinterpret_cast<const float4*>(G + bh * nt * pn) + e;
  const float* a = decay + bh * nt;
  bf16* hp = Hp + bh * nt * 2 * pn + 4 * e;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nt; c0 += kPassTiles) {
    float4 gv[kPassTiles];
    float av[kPassTiles];
#pragma unroll
    for (int k = 0; k < kPassTiles; ++k) {
      if (c0 + k < nt) {
        gv[k] = gp[static_cast<size_t>(c0 + k) * (pn / 4)];
        av[k] = a[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kPassTiles; ++k) {
      const int c = c0 + k;
      if (c < nt) {
        if (c > 0) {
          uint32_t h0, h1, l0, l1;
          split2(hv.x, hv.y, h0, l0);
          split2(hv.z, hv.w, h1, l1);
          bf16* dst = hp + static_cast<size_t>(c) * 2 * pn;
          *reinterpret_cast<uint2*>(dst) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(dst + pn) = make_uint2(l0, l1);
        }
        hv = make_float4(hv.x * av[k] + gv[k].x, hv.y * av[k] + gv[k].y,
                         hv.z * av[k] + gv[k].z, hv.w * av[k] + gv[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(state + bh * pn + 4 * e) = hv;
}

// 3. Warp w owns the tile's rows t = 16 r .. 16 r + 15, r = w % 4, and
//    part w / 4 of the columns: of CB = C . B^T (16 x 64 / kParts, k = n,
//    column tiles at or left of the diagonal only), turned into M = CB
//    exp(L_t - L_j) dt_j (j <= t) in its registers and shared as a bf16
//    hi/lo pair through shared memory; then of y (kPC columns of p):
//    M . x (k = j) + exp(L_t) C . H_{c-1} (k = n) + D x.
__global__ void __launch_bounds__(kThreads)
ssd_tc_outputs_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ B,
                      const bf16* __restrict__ C, const float* __restrict__ D,
                      const bf16* __restrict__ Hp, bf16* __restrict__ y,
                      int s, int h, int p, int n, int nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = n + kPad, ldp = p + kPad;
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // [kT][ldn]
  bf16* Bs = Cs + kT * ldn;                   // [kT][ldn]
  bf16* Xs = Bs + kT * ldn;                   // [kT][ldp]
  bf16* Hh = Xs + kT * ldp;                   // [p][ldn], hi of H_{c-1}
  bf16* Hl = Hh + p * ldn;                    // [p][ldn], lo
  bf16* Mh = Hl + p * ldn;                    // [kT][kLdM], hi of M
  bf16* Ml = Mh + kT * kLdM;                  // [kT][kLdM], lo
  float* Ls = reinterpret_cast<float*>(Ml + kT * kLdM);  // [kT]
  float* dts = Ls + kT;                       // [kT]
  float* eL = dts + kT;                       // [kT] exp(L_t)

  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * kT, valid = min(kT, s - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(bi) * s + t0;
  const size_t xrow = static_cast<size_t>(h) * p;   // x, y step stride

  load_rows<kThreads>(Cs, ldn, C + row0 * n, n, kT, n, valid);
  load_rows<kThreads>(Bs, ldn, B + row0 * n, n, kT, n, valid);
  load_rows<kThreads>(Xs, ldp, x + row0 * xrow + static_cast<size_t>(hi) * p,
                      xrow, kT, p, valid);
  if (c > 0) {    // H_{c-1}; 0 for the first tile, whose C . H is skipped
    const bf16* hp = Hp + ((static_cast<size_t>(bi) * h + hi) * nt + c) * 2 *
                              static_cast<size_t>(p) * n;
    load_rows<kThreads>(Hh, ldn, hp, n, p, n, p);
    load_rows<kThreads>(Hl, ldn, hp + static_cast<size_t>(p) * n, n, p, n,
                        p);
  }
  cp_async_commit();
  if (warp == 0) {
    tile_cumsum(dt, row0 * h + hi, h, valid, A[hi], Ls, dts);
#pragma unroll
    for (int k = 0; k < 2; ++k) eL[lane + 32 * k] = expf(Ls[lane + 32 * k]);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;   // ldmatrix: row, matrix
  const int rg = warp & 3, part = warp >> 2;
  const int r0 = 16 * rg;
  const int ta = r0 + g, tb = ta + 8;        // this lane's rows
  // A = C rows r0.., stored [m = t][k = nn]: ldmatrix row of this lane.
  const bf16* Crow = Cs + (r0 + (lm & 1) * 8 + lr) * ldn + (lm >> 1) * 8;

  // CB, column tiles 2 kJQ part .. (j = 16 kJQ part ..), those at or left
  // of the diagonal (16-column pairs jq <= rg).
  if (kJQ * part <= rg) {
    float cb[2 * kJQ][4];
#pragma unroll
    for (int i = 0; i < 2 * kJQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[i][e] = 0.f;
    for (int kk = 0; kk < n / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Crow + 16 * kk);
#pragma unroll
      for (int u = 0; u < kJQ; ++u) {
        const int jq = kJQ * part + u;
        if (jq <= rg) {
          // B operand (k = nn, n = j) is B stored [j][nn]: read as is.
          uint32_t b[4];
          ldsm_x4(b, Bs + (16 * jq + (lm >> 1) * 8 + lr) * ldn + 16 * kk +
                         (lm & 1) * 8);
          mma_bf16(cb[2 * u], a, b[0], b[1]);
          mma_bf16(cb[2 * u + 1], a, b[2], b[3]);
        }
      }
    }
    // M = CB exp(L_t - L_j) dt_j for j <= t, as bf16 hi/lo pairs.
    const float La = Ls[ta], Lb = Ls[tb];
#pragma unroll
    for (int i = 0; i < 2 * kJQ; ++i) {
      const int jt = 2 * kJQ * part + i;
      if (jt <= 2 * rg + 1) {
        float m[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * jt + 2 * q + e;
          const float Lj = Ls[j], dj = dts[j];
          m[e] = j <= ta ? cb[i][e] * expf(La - Lj) * dj : 0.f;
          m[2 + e] = j <= tb ? cb[i][2 + e] * expf(Lb - Lj) * dj : 0.f;
        }
        const int col = 8 * jt + 2 * q;
        uint32_t h0, l0, h1, l1;
        split2(m[0], m[1], h0, l0);
        split2(m[2], m[3], h1, l1);
        *reinterpret_cast<uint32_t*>(Mh + ta * kLdM + col) = h0;
        *reinterpret_cast<uint32_t*>(Ml + ta * kLdM + col) = l0;
        *reinterpret_cast<uint32_t*>(Mh + tb * kLdM + col) = h1;
        *reinterpret_cast<uint32_t*>(Ml + tb * kLdM + col) = l1;
      }
    }
  }
  __syncthreads();   // M

  const int ps = kPC * part;   // this warp's columns of p: ps .. ps + kPC - 1
  if (ps >= p) return;
  float yi[kPC / 8][4], ye[kPC / 8][4];
#pragma unroll
  for (int i = 0; i < kPC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[i][e] = ye[i][e] = 0.f;
  // y_intra = M . x over the j tiles at or left of the diagonal: A = M
  // stored [t][j]; B operand (k = j, n = pp) is x stored [j][pp], read
  // transposed.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk <= rg) {
      const int off = (r0 + (lm & 1) * 8 + lr) * kLdM + 16 * kk +
                      (lm >> 1) * 8;
      uint32_t mh[4], ml[4];
      ldsm_x4(mh, Mh + off);
      ldsm_x4(ml, Ml + off);
#pragma unroll
      for (int qq = 0; qq < kPC / 16; ++qq) {
        if (ps + 16 * qq < p) {
          uint32_t b[4];
          ldsm_x4_t(b, Xs + (16 * kk + (lm & 1) * 8 + lr) * ldp + ps +
                           16 * qq + (lm >> 1) * 8);
          mma_bf16(yi[2 * qq], mh, b[0], b[1]);
          mma_bf16(yi[2 * qq + 1], mh, b[2], b[3]);
          mma_bf16(yi[2 * qq], ml, b[0], b[1]);
          mma_bf16(yi[2 * qq + 1], ml, b[2], b[3]);
        }
      }
    }
  }
  // y_inter = C . H_{c-1}: B operand (k = nn, n = pp) is H stored
  // [pp][nn]: read as is.
  if (c > 0) {
    for (int kk = 0; kk < n / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Crow + 16 * kk);
#pragma unroll
      for (int qq = 0; qq < kPC / 16; ++qq) {
        if (ps + 16 * qq < p) {
          const int off = (ps + 16 * qq + (lm >> 1) * 8 + lr) * ldn +
                          16 * kk + (lm & 1) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, Hh + off);
          ldsm_x4(bl, Hl + off);
          mma_bf16(ye[2 * qq], a, bh[0], bh[1]);
          mma_bf16(ye[2 * qq + 1], a, bh[2], bh[3]);
          mma_bf16(ye[2 * qq], a, bl[0], bl[1]);
          mma_bf16(ye[2 * qq + 1], a, bl[2], bl[3]);
        }
      }
    }
  }
  const float d_skip = D[hi];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r ? tb : ta;
    const float el = eL[t];
    bf16* yrow = y + (row0 + t) * xrow + static_cast<size_t>(hi) * p;
#pragma unroll
    for (int i = 0; i < kPC / 8; ++i) {
      const int col = ps + 8 * i + 2 * q;
      if (t < valid && ps + 8 * i < p) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Xs + t * ldp + col));
        const float v0 = (yi[i][2 * r] + el * ye[i][2 * r]) + xv.x * d_skip;
        const float v1 = (yi[i][2 * r + 1] + el * ye[i][2 * r + 1]) +
                         xv.y * d_skip;
        *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

bool fits(int p, int n) {
  return n % 16 == 0 && p % 16 == 0 && n >= 16 && p >= 16 && n <= kMaxN &&
         p <= kMaxP;
}

cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* state, float* G, float* decay, void* Hp, int b,
                   int s, int h, int p, int n, cudaStream_t stream) {
  if (!fits(p, n) || G == nullptr || decay == nullptr || Hp == nullptr)
    return cudaErrorInvalidValue;
  const int nt = (s + kT - 1) / kT;
  const size_t sm1 = states_smem(n, p), sm3 = outputs_smem(n, p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_tc_outputs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm3));
  if (err != cudaSuccess) return err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(B);
  const dim3 grid(nt, h, b);
  ssd_tc_states_kernel<<<grid, kThreads, sm1, stream>>>(
      xb, dt, A, Bb, G, decay, s, h, p, n, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn = p * n;
  bf16* hp = static_cast<bf16*>(Hp);
  ssd_tc_pass_kernel<<<dim3((pn / 4 + kPassThreads - 1) / kPassThreads,
                            b * h),
                       kPassThreads, 0, stream>>>(G, decay, hp, state, nt,
                                                  pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_tc_outputs_kernel<<<grid, kThreads, sm3, stream>>>(
      xb, dt, A, Bb, static_cast<const bf16*>(C), D, hp,
      static_cast<bf16*>(y), s, h, p, n, nt);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace
}  // namespace repro

// x, y: (b, s, h, p) and B, C: (b, s, n) in float32 or bfloat16 (dtype);
// dt: (b, s, h), A, D: (h,), state: (b, h, p, n), all float32; contiguous.
// design 0: the CUDA-core kernel (scratch unused); design 1: the
// tensor-core kernels (bfloat16 only), with scratch G (b, h, tiles of 64
// steps, p, n) fp32, decay (b, h, tiles) fp32 and Hp (b, h, tiles, 2, p,
// n) bf16.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* D,
                              void* y, void* state, void* G, void* decay,
                              void* Hp, int b, int s, int h, int p, int n,
                              int dtype, int design, void* stream) {
  using namespace repro;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  cudaError_t err = cudaErrorInvalidValue;
  if (design == 1 && dtype == kBF16)
    err = tc::launch(x, dtf, Af, B, C, Df, y, sf, static_cast<float*>(G),
                     static_cast<float*>(decay), Hp, b, s, h, p, n, st);
  else if (design == 0 && dtype == kF32)
    err = simt::launch<float>(x, dtf, Af, B, C, Df, y, sf, b, s, h, p, n, st);
  else if (design == 0 && dtype == kBF16)
    err = simt::launch<__nv_bfloat16>(x, dtf, Af, B, C, Df, y, sf, b, s, h,
                                      p, n, st);
  return static_cast<int>(err);
}
