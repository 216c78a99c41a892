// Backward of the Mamba-2 SSD chunked scan of csrc/ssd_scan.cu, per
// (batch, head), in a tile of kT = 64 steps (the math does not depend on
// the tile): with l_k = dt_k A, L its inclusive cumsum within the tile, T
// the tile's last step, u_j = dt_j x_j, H the fp32 (n, p) state entering
// the tile, dS the gradient of the state leaving it, K[t, j] = C_t . B_j,
// E[t, j] = exp(L_t - L_j) for j <= t (else 0), P[t, j] = dy_t . u_j and
// Q = K E P:
//   du_j = sum_t K E[t, j] dy_t + exp(L_T - L_j) dS^T B_j
//   dx_j = dt_j du_j + D dy_j,   ddt_j = x_j . du_j + A dl_j
//   dC_t = sum_j E P[t, j] B_j + exp(L_t) H dy_t
//   dB_j = sum_t E P[t, j] C_t + exp(L_T - L_j) dS u_j   (both summed over
//          the heads: B and C are shared across them)
//   dD = sum dy . x,  dA = sum dt_k dl_k
//   dH = exp(L_T) dS + sum_t exp(L_t) C_t dy_t^T: the previous tile's dS
//   dl_k = sum_{t >= k} sum_{j < k} Q[t, j] + sum_{t >= k} exp(L_t)
//          (C_t^T H) . dy_t + exp(L_T) <H, dS> + sum_{j < k} exp(L_T - L_j)
//          B_j^T dS u_j
// dl_k takes every term whose decay spans step k; taken so, no two large
// sums cancel (the cumsum's own backward subtracts column sums of Q from
// row sums). The plain version is ref.ssd_chunked_bwd_ref, in the same
// closed form.
//
// Replaces the backward of the TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_scan (_ssd_kernel), which has none: the JAX package trains through
// jax.grad of ref.ssd_chunked.
//
// Bound on the H100, the training path (b 8, s 256, h 24, p 64, n 128,
// bf16, the final state's gradient None): it reads x, dy, dt, B and C and
// writes dx, ddt, dB and dC once, 21.4 MB, 6.38 us at 3.35 TB/s; the
// chunked algorithm's products at the model's chunk of 256 (C.B^T shared
// by the heads; per head P and the products of du, dB and dC over the
// causal pairs) are 4.9 GFLOP, 5.0 us on the bf16 tensor cores: bound by
// bytes. One chunk and no dstate need no state terms (the state entering
// the chunk and dS are zero); each boundary between chunks adds 10 q n p a
// head and a nonzero dstate 4 q n p.
//
// Two designs, both in a tile of kT = 64 steps, both summing in a fixed
// order with no float atomics (two calls give the same bits), scratch from
// the caller; kernels/ssd_scan.py::bwd_design picks one by dtype, n and p.
//
// * tc (bfloat16, n and p multiples of 16, n <= 128, p <= 64; the
//   training path), three launches:
//   1. ssd_bwd_tc_states_kernel, grid (2 x 64-column units of n, head,
//      batch): the state path, a block walking the tiles with the state in
//      its mma accumulators, acc <- exp(L_T) acc + (w x)^T B forward (H
//      entering each tile) and acc <- exp(L_T) acc + (e dy)^T C backward
//      from dstate (dS leaving each tile), each stored once as a bf16 hi/lo
//      pair. The pass is folded in: no in-place rewrite. The states are
//      recomputed, so the forward under grad launches what it launches
//      under no_grad.
//   2. ssd_bwd_tc_local_kernel, grid (groups of heads, tile, batch), each
//      block min(4, h) of a (tile, batch)'s groups (6 heads each at h 24:
//      128 blocks, one wave on 132 SMs): every product on the tensor cores
//      (mma.sync m16n8k16, bf16 operands, fp32 accumulators). K = C B^T
//      once a block; per head P' = dy x^T, exact, scaled by dt_j in the
//      accumulator's registers (u = dt x is not split); du = KE^T dy +
//      exp(L_T - L_j) B dS^T, and the state terms dy H and x dS, their
//      fp32-factor operands (KE, H, dS) as bf16 hi/lo pairs, two mma into
//      one accumulator (about 2^-17 of a term; one rounding, 2^-9, would
//      break the 2e-4 the gradients are held to); the factors exp(L_t) and
//      exp(L_T - L_j) dt_j applied in registers. B and C are shared by the
//      heads, so dC = W B + sum_h exp(L_t) dy_h H_h and dB = W^T C +
//      sum_h exp(L_T - L_j) dt_j x_h dS_h with W = sum_h E P_h: W and the
//      state terms are summed over the block's heads in registers (dB and
//      dC of 64 x n, n / 2 registers a thread, hence n <= 128), W B and
//      W^T C taken once, and the block writes its group's fp32 dB, dC sums
//      (b, groups, s, n): no (b, h, s, n) partials. The next head's x, dy
//      and dt load while a head computes, and its H and dS while it
//      computes what needs neither.
//   3. ssd_bwd_tc_reduce_kernel: dB and dC, the groups' sums added in group
//      order; dA and dD from (b, h, tiles) partials.
//   Scratch traffic at the training shape: H and dS are written once and
//   read once, only where nonzero (H past the first tile, dS before the
//   last without dstate): 6 tiles x 192 heads x 32 KB = 37.7 MB each way;
//   the groups' dB and dC sums 8.4 MB each way: 92.3 MB in all, against
//   about 300 MB of the CUDA-core design (G and Gd written, rewritten in
//   place and read, 200 MB; the per-head dB, dC partials, 100 MB). A
//   128-step tile would halve the tile boundaries, but its 128 x 128
//   products and 128 x n dB, dC accumulators do not fit a block's
//   registers and shared memory. A thread-block cluster of the four
//   groups, summing dB and dC through distributed shared memory, would
//   save the 16.8 MB, but an H100 holds only 30 clusters of four such
//   blocks at once (its GPCs), so 2 of the 32 run in a second wave.
// * simt (float32 at any shape the forward takes, and bfloat16 where tc
//   does not fit: any n, any p): CUDA cores and fp32 accumulators, in four
//   launches:
//   1. ssd_bwd_states_kernel, grid (tile, head, batch): the tile's state
//      G = sum_j exp(L_T - L_j) dt_j x_j B_j^T, its decay exp(L_T) and
//      Gd = sum_t exp(L_t) dy_t C_t^T, each stored (p, n).
//   2. ssd_bwd_pass_kernel, grid (p n / 256, b h): in place, the forward
//      recurrence over the tiles turns G into the state entering each tile,
//      the reverse one (seeded by the final state's gradient, or 0) turns
//      Gd into the gradient of the state leaving each tile. The states are
//      recomputed rather than saved by the forward, so the forward under
//      grad launches what it launches under no_grad.
//   3. ssd_bwd_local_kernel, grid (tile, head, batch): everything above
//      that is local to the tile. B and C of the tile stay in shared memory
//      in their dtype; K and P are 4 x 4 outputs a thread (rows 16 apart,
//      so the row-strided shared-memory reads are free of bank conflicts);
//      KE, EP and Q go to shared memory, and dl's straddling sum is a row
//      prefix of Q followed by column sums. x, dy and the states stream
//      through in chunks of kPC columns of p (and kNC of n). Past kNT =
//      256 columns of n, B and C come in tiles of kNT, loaded again in each
//      phase that walks n, whose sums run over the tiles in order (the
//      shared memory of B and C at n 256). dx and ddt are
//      written once; dB and dC of each head go to fp32 partials, dA and dD
//      of each block too.
//   4. ssd_bwd_reduce_kernel: the partials of dB and dC summed over the
//      heads, those of dA and dD over batches and tiles, each in a fixed
//      order. No float atomics: two calls give the same bits.
// Steps at or past s are loaded as dt = 0 and x = dy = B = C = 0, as in the
// forward, and nothing is written for them.
#include "common.cuh"
#include "hopper.cuh"
#include "ssd_common.cuh"

namespace repro {
namespace {
namespace ssd_bwd {

using ssd::tile_cumsum;

constexpr int kT = 64;            // steps a tile
constexpr int kThreads = 256;
constexpr int kLdM = kT + 1;      // row stride of the 64 x 64 matrices
constexpr int kPC = 16;           // columns of p a chunk of the local kernel
constexpr int kLdP = kPC + 1;
constexpr int kNC = 32;           // columns of n a chunk of the local kernel
constexpr int kLdN = kNC + 1;
constexpr int kSC = 32;           // columns of p and n a chunk of the states
constexpr int kLdS = kSC + 1;
constexpr int kPassThreads = 256;
constexpr int kPassTiles = 8;     // tiles whose loads the pass issues at once
constexpr int kNT = 256;          // columns of n a B, C tile (local kernel)
constexpr int kMaxSmem = 232448;  // shared memory a block may use (sm_90)

// Row stride, in elements, of B and C held in shared memory: an odd
// number of 32-bit words for fp32 (n + 1) and, for n even, for bf16 (n + 2).
template <typename T>
__host__ __device__ constexpr int ld_bc(int n) {
  return n + (sizeof(T) == 2 ? 2 : 1);
}

// Of a local kernel whose B, C tiles hold nt columns of n (min(n, kNT)).
__host__ __device__ constexpr int stage_floats(int nt) {
  return 2 * kT * kLdP +
         (kPC * (nt + 1) > 2 * kPC * kLdN ? kPC * (nt + 1) : 2 * kPC * kLdN);
}

template <typename T>
__host__ __device__ constexpr size_t local_smem(int nt) {
  return sizeof(float) * (3 * kT * kLdM + 8 * kT + 32 + stage_floats(nt)) +
         sizeof(T) * 2 * static_cast<size_t>(kT) * ld_bc<T>(nt);
}
static_assert(local_smem<float>(kNT) <= kMaxSmem &&
                  local_smem<__nv_bfloat16>(kNT) <= kMaxSmem,
              "the local kernel's shared memory must fit a block at a "
              "whole tile of n");

// 1. G[pp][nn] = sum_j (w_j x_j[pp]) B_j[nn], w_j = exp(L_T - L_j) dt_j, and
//    Gd[pp][nn] = sum_t (exp(L_t) dy_t[pp]) C_t[nn], in chunks of kSC x kSC
//    outputs, four of each a thread; decay = exp(L_T).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, const T* __restrict__ dy,
                      float* __restrict__ G, float* __restrict__ Gd,
                      float* __restrict__ decay, int s, int h, int p, int n,
                      int nt) {
  __shared__ float Xs[kT][kLdS], Ys[kT][kLdS], Bs[kT][kLdS], Cs[kT][kLdS];
  __shared__ float Ls[kT], dts[kT], ws[kT], eL[kT];
  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * kT, valid = min(kT, s - t0);
  const size_t row0 = static_cast<size_t>(bi) * s + t0;
  const size_t xrow = static_cast<size_t>(h) * p;
  if (tid < 32) {
    const float last = tile_cumsum(dt, row0 * h + hi, h, valid, A[hi], Ls,
                                   dts);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = tid + 32 * k;
      ws[t] = expf(last - Ls[t]) * dts[t];
      eL[t] = expf(Ls[t]);
    }
    if (tid == 0)
      decay[(static_cast<size_t>(bi) * h + hi) * nt + c] = expf(last);
  }
  __syncthreads();
  const size_t base = ((static_cast<size_t>(bi) * h + hi) * nt + c) *
                      static_cast<size_t>(p) * n;
  const int pp = tid / 8, nq = tid % 8;   // outputs (pp, nq + 8 k)
  for (int p0 = 0; p0 < p; p0 += kSC) {
    for (int n0 = 0; n0 < n; n0 += kSC) {
      __syncthreads();
      for (int i = tid; i < kT * kSC; i += kThreads) {
        const int t = i / kSC, cc = i - t * kSC;
        const bool okt = t < valid;
        const bool okp = okt && p0 + cc < p, okn = okt && n0 + cc < n;
        const size_t gx = (row0 + t) * xrow + static_cast<size_t>(hi) * p +
                          p0 + cc;
        const size_t gb = (row0 + t) * n + n0 + cc;
        Xs[t][cc] = okp ? ws[t] * to_f32(x[gx]) : 0.f;
        Ys[t][cc] = okp ? eL[t] * to_f32(dy[gx]) : 0.f;
        Bs[t][cc] = okn ? to_f32(B[gb]) : 0.f;
        Cs[t][cc] = okn ? to_f32(C[gb]) : 0.f;
      }
      __syncthreads();
      float g[4] = {0.f, 0.f, 0.f, 0.f}, gd[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < kT; ++t) {
        const float xv = Xs[t][pp], yv = Ys[t][pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          g[k] += xv * Bs[t][nq + 8 * k];
          gd[k] += yv * Cs[t][nq + 8 * k];
        }
      }
      if (p0 + pp < p) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int nn = n0 + nq + 8 * k;
          if (nn < n) {
            const size_t o = base + static_cast<size_t>(p0 + pp) * n + nn;
            G[o] = g[k];
            Gd[o] = gd[k];
          }
        }
      }
    }
  }
}

// 2. In place over the tiles of one (batch, head), one element of (p, n) a
//    thread: G[c] <- the state entering tile c (0 for the first), Gd[c] <-
//    the gradient of the state leaving tile c (dstate, or 0, for the last).
//    The loads of kPassTiles tiles are issued before their stores, so a
//    thread has that many in flight rather than one.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass_kernel(float* __restrict__ G, float* __restrict__ Gd,
                    const float* __restrict__ decay,
                    const float* __restrict__ dstate, int nt, int pn) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= pn) return;
  const size_t bh = blockIdx.y;
  float* g = G + bh * nt * pn + e;
  float* gd = Gd + bh * nt * pn + e;
  const float* a = decay + bh * nt;
  float hv = 0.f;
  for (int c0 = 0; c0 < nt; c0 += kPassTiles) {
    float v[kPassTiles];
#pragma unroll
    for (int k = 0; k < kPassTiles; ++k)
      if (c0 + k < nt) v[k] = g[static_cast<size_t>(c0 + k) * pn];
#pragma unroll
    for (int k = 0; k < kPassTiles; ++k) {
      if (c0 + k < nt) {
        g[static_cast<size_t>(c0 + k) * pn] = hv;
        hv = hv * a[c0 + k] + v[k];
      }
    }
  }
  float dv = dstate != nullptr ? dstate[bh * pn + e] : 0.f;
  for (int c0 = nt - 1; c0 >= 0; c0 -= kPassTiles) {
    float v[kPassTiles];
#pragma unroll
    for (int k = 0; k < kPassTiles; ++k)
      if (c0 - k >= 0) v[k] = gd[static_cast<size_t>(c0 - k) * pn];
#pragma unroll
    for (int k = 0; k < kPassTiles; ++k) {
      if (c0 - k >= 0) {
        gd[static_cast<size_t>(c0 - k) * pn] = dv;
        dv = dv * a[c0 - k] + v[k];
      }
    }
  }
}

// 3. The tile's local gradients (see the header), in phases:
//    0. B, C of the tile into shared memory; warp 0 scans dt * A.
//    1. K = C B^T and P = dy u^T, rows ti + 16 r and columns tj + 16 q a
//       thread; P and dD's partial over chunks of kPC columns of p.
//    2. E, then KE, EP and Q into shared memory.
//    3. dl's straddling sum: Q's exclusive row prefix, then column sums.
//    4. per chunk of kPC columns of p: du (KE^T dy + exp(L_T - L_j) B dS),
//       dx, and x . du summed over the chunks in order.
//    5. per chunk of kNC columns of n: dC and dB of this head (EP B, EP^T
//       C, plus H dy and dS u over chunks of p), the sums (C_t^T H) . dy_t
//       and B_j^T dS u_j over the chunks in order, and <H, dS>.
//    6. dl, ddt; the block's dA and dD partials.
// kTiled: n above kNT, B and C walked in tiles; else one tile of n, as
// before there were tiles.
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_local_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C, const float* __restrict__ D,
                     const T* __restrict__ dy, const float* __restrict__ Hin,
                     const float* __restrict__ dSo, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBh,
                     float* __restrict__ dCh, float* __restrict__ partA,
                     float* __restrict__ partD, int s, int h, int p, int n,
                     int nt) {
  extern __shared__ float4 smem4[];
  float* KE = reinterpret_cast<float*>(smem4);   // [kT][kLdM]
  float* EP = KE + kT * kLdM;                    // [kT][kLdM]
  float* Qm = EP + kT * kLdM;                    // [kT][kLdM]
  float* Ls = Qm + kT * kLdM;                    // [kT] each:
  float* dts = Ls + kT;
  float* eL = dts + kT;                          // exp(L_t)
  float* wl = eL + kT;                           // exp(L_T - L_j)
  float* xdu = wl + kT;                          // x_j . du_j
  float* iy = xdu + kT;                          // (C_t^T H) . dy_t, scaled
  float* rr = iy + kT;                           // B_j^T dS u_j, scaled
  float* dli = rr + kT;                          // dl's straddling sum
  float* red = dli + kT;                         // [32] block sums
  float* S1 = red + 32;                          // [kT][kLdP]
  float* S2 = S1 + kT * kLdP;                    // [kT][kLdP]
  float* S3 = S2 + kT * kLdP;                    // [kPC][tn + 1] or [kPC][kLdN]
  float* S4 = S3 + kPC * kLdN;                   // [kPC][kLdN]
  // d_state in tiles of tn columns: B and C of one tile in shared memory
  // at a time (all of them when n <= kNT), loaded again where a phase
  // walks n; every sum over n runs over the tiles in order.
  const int tn = kTiled ? kNT : n;
  const int n_tiles = kTiled ? (n + kNT - 1) / kNT : 1;
  const int ldb = ld_bc<T>(tn);
  T* Bs = reinterpret_cast<T*>(S1 + stage_floats(tn));  // [kT][ldb]
  T* Cs = Bs + kT * ldb;                                // [kT][ldb]

  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * kT, valid = min(kT, s - t0);
  const size_t row0 = static_cast<size_t>(bi) * s + t0;
  const size_t xrow = static_cast<size_t>(h) * p;
  const size_t xcol = static_cast<size_t>(hi) * p;
  const size_t tile = ((static_cast<size_t>(bi) * h + hi) * nt + c) *
                      static_cast<size_t>(p) * n;
  const float a = A[hi], d_skip = D[hi];
  // B, C columns [k tn, k tn + nw) of the tile into Bs, Cs (the caller
  // brackets it with barriers).
  auto load_bc = [&](int k) {
    const int n0 = k * tn, nw = min(tn, n - n0);
    for (int i = tid; i < kT * nw; i += kThreads) {
      const int t = i / nw, nn = i - t * nw;
      const bool ok = t < valid;
      const size_t g = (row0 + t) * n + n0 + nn;
      Bs[t * ldb + nn] = ok ? B[g] : from_f32<T>(0.f);
      Cs[t * ldb + nn] = ok ? C[g] : from_f32<T>(0.f);
    }
  };
  int resident = 0;                // the n tile in Bs, Cs
  auto use_tile = [&](int k) {     // uniform across the block
    if (k == resident) return;
    __syncthreads();
    load_bc(k);
    __syncthreads();
    resident = k;
  };

  // --- 0. ---------------------------------------------------------------
  load_bc(0);
  if (warp == 0) {
    const float last = tile_cumsum(dt, row0 * h + hi, h, valid, a, Ls, dts);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = lane + 32 * k;
      eL[t] = expf(Ls[t]);
      wl[t] = expf(last - Ls[t]);
      xdu[t] = iy[t] = rr[t] = 0.f;
    }
  }
  __syncthreads();

  // --- 1. ---------------------------------------------------------------
  const int ti = tid >> 4, tj = tid & 15;
  float K[4][4], P[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) K[r][q] = P[r][q] = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    use_tile(k);
    const int nw = min(tn, n - k * tn);
    for (int nn = 0; nn < nw; ++nn) {
      float cr[4], bq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cr[r] = to_f32(Cs[(ti + 16 * r) * ldb + nn]);
        bq[r] = to_f32(Bs[(tj + 16 * r) * ldb + nn]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) K[r][q] += cr[r] * bq[q];
    }
  }
  float ddp = 0.f;   // dD: this thread's share of sum dy . x
  for (int p0 = 0; p0 < p; p0 += kPC) {
    __syncthreads();
    for (int i = tid; i < kT * kPC; i += kThreads) {
      const int t = i / kPC, cc = i - t * kPC;
      const bool ok = t < valid && p0 + cc < p;
      const size_t g = (row0 + t) * xrow + xcol + p0 + cc;
      const float yv = ok ? to_f32(dy[g]) : 0.f;
      const float xv = ok ? to_f32(x[g]) : 0.f;
      S1[t * kLdP + cc] = yv;
      S2[t * kLdP + cc] = dts[t] * xv;
      ddp += yv * xv;
    }
    __syncthreads();
    for (int cc = 0; cc < kPC; ++cc) {
      float yr[4], uq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        yr[r] = S1[(ti + 16 * r) * kLdP + cc];
        uq[r] = S2[(tj + 16 * r) * kLdP + cc];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) P[r][q] += yr[r] * uq[q];
    }
  }

  // --- 2. ---------------------------------------------------------------
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = ti + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tj + 16 * q;
      const float e = j <= t ? expf(Ls[t] - Ls[j]) : 0.f;
      const float ke = K[r][q] * e;
      KE[t * kLdM + j] = ke;
      EP[t * kLdM + j] = e * P[r][q];
      Qm[t * kLdM + j] = ke * P[r][q];
    }
  }
  __syncthreads();

  // --- 3. ---------------------------------------------------------------
  if (tid < kT) {
    float run = 0.f;
    for (int j = 0; j < kT; ++j) {
      const float v = Qm[tid * kLdM + j];
      Qm[tid * kLdM + j] = run;
      run += v;
    }
  }
  __syncthreads();
  if (tid < kT) {
    float sum = 0.f;
    for (int t = tid; t < kT; ++t) sum += Qm[t * kLdM + tid];
    dli[tid] = sum;
  }

  // --- 4. ---------------------------------------------------------------
  {
    const int jr = tid >> 2, c0 = (tid & 3) * 4;
    const int ldd = tn + 1;
    // dS columns [n0, n0 + nw) of chunk p0 into S3.
    auto load_ds = [&](int p0, int n0, int nw) {
      for (int i = tid; i < kPC * nw; i += kThreads) {
        const int cc = i / nw, nn = i - cc * nw;
        S3[cc * ldd + nn] =
            p0 + cc < p
                ? dSo[tile + static_cast<size_t>(p0 + cc) * n + n0 + nn]
                : 0.f;
      }
    };
    for (int p0 = 0; p0 < p; p0 += kPC) {
      __syncthreads();
      for (int i = tid; i < kT * kPC; i += kThreads) {
        const int t = i / kPC, cc = i - t * kPC;
        const bool ok = t < valid && p0 + cc < p;
        const size_t g = (row0 + t) * xrow + xcol + p0 + cc;
        S1[t * kLdP + cc] = ok ? to_f32(dy[g]) : 0.f;
        S2[t * kLdP + cc] = ok ? to_f32(x[g]) : 0.f;
      }
      if (n_tiles == 1) load_ds(p0, 0, n);
      __syncthreads();
      float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = jr; t < kT; ++t) {
        const float ke = KE[t * kLdM + jr];
#pragma unroll
        for (int k = 0; k < 4; ++k) a1[k] += ke * S1[t * kLdP + c0 + k];
      }
      for (int kn = 0; kn < n_tiles; ++kn) {
        const int nw = min(tn, n - kn * tn);
        if (n_tiles > 1) {   // this n tile's B and dS
          __syncthreads();
          if (kn != resident) load_bc(kn);
          resident = kn;
          load_ds(p0, kn * tn, nw);
          __syncthreads();
        }
        for (int nn = 0; nn < nw; ++nn) {
          const float bv = to_f32(Bs[jr * ldb + nn]);
#pragma unroll
          for (int k = 0; k < 4; ++k) a2[k] += bv * S3[(c0 + k) * ldd + nn];
        }
      }
      float xd = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = c0 + k;
        const float du = a1[k] + wl[jr] * a2[k];
        xd += S2[jr * kLdP + cc] * du;
        if (jr < valid && p0 + cc < p)
          dx[(row0 + jr) * xrow + xcol + p0 + cc] =
              from_f32<T>(dts[jr] * du + d_skip * S1[jr * kLdP + cc]);
      }
      xd += __shfl_xor_sync(0xffffffffu, xd, 1);
      xd += __shfl_xor_sync(0xffffffffu, xd, 2);
      if ((tid & 3) == 0) xdu[jr] += xd;
    }
  }

  // --- 5. ---------------------------------------------------------------
  float hds = 0.f;   // this thread's share of <H, dS>
  {
    const int rw = tid >> 2, nq = tid & 3;   // row t (dC), j (dB); nq + 4 k
    const size_t out_row = (static_cast<size_t>(bi) * h + hi) * s + t0 + rw;
    for (int kn = 0; kn < n_tiles; ++kn) {
      use_tile(kn);
      const int nb = kn * tn, nw = min(tn, n - nb);   // the tile's columns
      for (int c0n = 0; c0n < nw; c0n += kNC) {
        const int n0 = nb + c0n;                      // in the whole of n
        float aC[8], aB[8], hy[8], su[8];
        int col[8];                                   // in the tile
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          aC[k] = aB[k] = hy[k] = su[k] = 0.f;
          col[k] = min(c0n + nq + 4 * k, nw - 1);   // past n: read, not kept
        }
        for (int j = 0; j <= rw; ++j) {
          const float ep = EP[rw * kLdM + j];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            aC[k] += ep * to_f32(Bs[j * ldb + col[k]]);
        }
        for (int t = rw; t < kT; ++t) {
          const float ep = EP[t * kLdM + rw];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            aB[k] += ep * to_f32(Cs[t * ldb + col[k]]);
        }
        for (int p0 = 0; p0 < p; p0 += kPC) {
          __syncthreads();
          for (int i = tid; i < kT * kPC; i += kThreads) {
            const int t = i / kPC, cc = i - t * kPC;
            const bool ok = t < valid && p0 + cc < p;
            const size_t g = (row0 + t) * xrow + xcol + p0 + cc;
            S1[t * kLdP + cc] = ok ? to_f32(dy[g]) : 0.f;
            S2[t * kLdP + cc] = ok ? dts[t] * to_f32(x[g]) : 0.f;
          }
          for (int i = tid; i < kPC * kNC; i += kThreads) {
            const int cc = i / kNC, nc = i - cc * kNC;
            const bool ok = p0 + cc < p && c0n + nc < nw;
            const size_t g = tile + static_cast<size_t>(p0 + cc) * n + n0 + nc;
            const float hv = ok ? Hin[g] : 0.f, dv = ok ? dSo[g] : 0.f;
            S3[cc * kLdN + nc] = hv;
            S4[cc * kLdN + nc] = dv;
            hds += hv * dv;
          }
          __syncthreads();
          for (int cc = 0; cc < kPC; ++cc) {
            const float yv = S1[rw * kLdP + cc], uv = S2[rw * kLdP + cc];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              hy[k] += yv * S3[cc * kLdN + nq + 4 * k];
              su[k] += uv * S4[cc * kLdN + nq + 4 * k];
            }
          }
        }
        float iyp = 0.f, rp = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int nn = c0n + nq + 4 * k;
          if (nn < nw) {
            iyp += to_f32(Cs[rw * ldb + nn]) * hy[k];
            rp += to_f32(Bs[rw * ldb + nn]) * su[k];
            if (rw < valid) {
              dCh[out_row * n + nb + nn] = aC[k] + eL[rw] * hy[k];
              dBh[out_row * n + nb + nn] = aB[k] + wl[rw] * su[k];
            }
          }
        }
        iyp += __shfl_xor_sync(0xffffffffu, iyp, 1);
        iyp += __shfl_xor_sync(0xffffffffu, iyp, 2);
        rp += __shfl_xor_sync(0xffffffffu, rp, 1);
        rp += __shfl_xor_sync(0xffffffffu, rp, 2);
        if (nq == 0) {
          iy[rw] += eL[rw] * iyp;
          rr[rw] += wl[rw] * rp;
        }
      }
    }
  }

  // --- 6. ---------------------------------------------------------------
  hds = warp_sum(hds);
  ddp = warp_sum(ddp);
  if (lane == 0) {
    red[warp] = hds;
    red[8 + warp] = ddp;
  }
  __syncthreads();
  if (tid < kT) {
    float hsum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) hsum += red[w];
    float suf = 0.f, pre = 0.f;
    for (int t = tid; t < kT; ++t) suf += iy[t];
    for (int j = 0; j < tid; ++j) pre += rr[j];
    const float dl = dli[tid] + suf + eL[kT - 1] * hsum + pre;
    if (tid < valid) ddt[(row0 + tid) * h + hi] = xdu[tid] + a * dl;
    const float ap = warp_sum(dts[tid] * dl);
    if (lane == 0) red[16 + warp] = ap;
  }
  __syncthreads();
  if (tid == 0) {
    float dsum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) dsum += red[8 + w];
    const size_t o = (static_cast<size_t>(bi) * h + hi) * nt + c;
    partA[o] = red[16] + red[17];
    partD[o] = dsum;
  }
}

// 4. dB, dC = the heads' partials summed in order, one element a thread;
//    block 0 also sums dA, dD over batches and tiles, in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                      const float* __restrict__ dCh,
                      const float* __restrict__ partA,
                      const float* __restrict__ partD, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ dA,
                      float* __restrict__ dD, int b, int s, int h, int n,
                      int nt) {
  const size_t sn = static_cast<size_t>(s) * n;
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < b * sn) {
    const size_t bi = e / sn, r = e - bi * sn;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < h; ++hh) {
      const size_t o = (bi * h + hh) * sn + r;
      sb += dBh[o];
      sc += dCh[o];
    }
    dB[e] = from_f32<T>(sb);
    dC[e] = from_f32<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < h; hh += kThreads) {
      float sa = 0.f, sd = 0.f;
      for (int bi = 0; bi < b; ++bi)
        for (int c = 0; c < nt; ++c) {
          const size_t o = (static_cast<size_t>(bi) * h + hh) * nt + c;
          sa += partA[o];
          sd += partD[o];
        }
      dA[hh] = sa;
      dD[hh] = sd;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D,
                   const void* dy, const float* dstate, void* dx, float* ddt,
                   float* dA, void* dB, void* dC, float* dD, float* work,
                   int b, int s, int h, int p, int n, cudaStream_t stream) {
  const int nt = (s + kT - 1) / kT;
  const size_t bh = static_cast<size_t>(b) * h;
  const size_t pn = static_cast<size_t>(p) * n;
  float* G = work;
  float* Gd = G + bh * nt * pn;
  float* decay = Gd + bh * nt * pn;
  float* dBh = decay + bh * nt;
  float* dCh = dBh + bh * s * n;
  float* partA = dCh + bh * s * n;
  float* partD = partA + bh * nt;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* dyt = static_cast<const T*>(dy);
  const bool tiled = n > kNT;
  const size_t smem = local_smem<T>(tiled ? kNT : n);
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err =
      tiled ? cudaFuncSetAttribute(ssd_bwd_local_kernel<T, true>, attr,
                                   static_cast<int>(smem))
            : cudaFuncSetAttribute(ssd_bwd_local_kernel<T, false>, attr,
                                   static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nt, h, b);
  ssd_bwd_states_kernel<T><<<grid, kThreads, 0, stream>>>(
      xt, dt, A, Bt, Ct, dyt, G, Gd, decay, s, h, p, n, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_pass_kernel<<<dim3((pn + kPassThreads - 1) / kPassThreads, bh),
                        kPassThreads, 0, stream>>>(G, Gd, decay, dstate, nt,
                                                   static_cast<int>(pn));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (tiled)
    ssd_bwd_local_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        xt, dt, A, Bt, Ct, D, dyt, G, Gd, static_cast<T*>(dx), ddt, dBh, dCh,
        partA, partD, s, h, p, n, nt);
  else
    ssd_bwd_local_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        xt, dt, A, Bt, Ct, D, dyt, G, Gd, static_cast<T*>(dx), ddt, dBh, dCh,
        partA, partD, s, h, p, n, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t elems = static_cast<size_t>(b) * s * n;
  ssd_bwd_reduce_kernel<T><<<(elems + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(dBh, dCh, partA, partD,
                                       static_cast<T*>(dB),
                                       static_cast<T*>(dC), dA, dD, b, s, h,
                                       n, nt);
  return cudaGetLastError();
}

}  // namespace ssd_bwd

// The tensor-core design (see the header): ssd_bwd_tc_states_kernel,
// ssd_bwd_tc_local_kernel over groups of heads, and
// ssd_bwd_tc_reduce_kernel.
namespace ssd_bwd_tc {

using namespace ssd;

constexpr int kT = 64;            // steps a tile
constexpr int kMaxN = 128;        // d_state: dB, dC accumulators in registers
constexpr int kMaxP = 64;         // head dim
constexpr int kGroups = 4;        // blocks a (tile, batch): groups of heads
constexpr int kPad = 8;           // bf16 a shared-memory row is padded by
constexpr int kLdT = kT + kPad;   // row stride of the 64 x 64 bf16 tiles
constexpr int kLdQ = kT + 1;      // row stride of Q (fp32)
constexpr int kThreads = 256;     // local kernel: 4 groups of 16 rows x 2
constexpr int kWarps = kThreads / 32;
constexpr int kStThreads = 128;   // states kernel: a warp per 16 rows of p
constexpr int kUnitN = 64;        // columns of n a states block
constexpr int kVecs = 10;         // the local kernel's fp32 step vectors
constexpr int kMaxSmem = 232448;  // shared memory a block may use (sm_90)
constexpr int kNPairs = kMaxN / 32;   // 16-column pairs of n a warp
static_assert(kUnitN == kMaxP, "the states kernel's tiles share a stride");

__host__ __device__ constexpr size_t st_bytes(int n, int p) {
  return 4 * static_cast<size_t>(p) * (n + kPad) * 2 >
                 2 * static_cast<size_t>(kT) * n * 4
             ? 4 * static_cast<size_t>(p) * (n + kPad) * 2
             : 2 * static_cast<size_t>(kT) * n * 4;
}

// Shared memory of the local kernel: C, B and x, dy of a head and of the
// next (bf16, rows padded by kPad); H and dS of a head as hi/lo pairs, or
// after the heads the block's fp32 dC and dB on their way out; KE (then
// W) as a hi/lo pair; Q (fp32); dl's column partials, the per-step
// vectors and the block sums.
__host__ __device__ constexpr size_t local_smem(int n, int p) {
  return 2 * static_cast<size_t>(kT) * (n + kPad) * 2 +
         4 * static_cast<size_t>(kT) * (p + kPad) * 2 + st_bytes(n, p) +
         2 * static_cast<size_t>(kT) * kLdT * 2 +
         4 * (static_cast<size_t>(kT) * kLdQ + kWarps * kT + kVecs * kT +
              32);
}
static_assert(local_smem(kMaxN, kMaxP) <= kMaxSmem,
              "the local kernel's shared memory must fit a block at the "
              "largest d_state and head dim the design takes");

bool fits(int p, int n) {
  return n % 16 == 0 && p % 16 == 0 && n >= 16 && p >= 16 && n <= kMaxN &&
         p <= kMaxP;
}

// Heads a block: min(kGroups, h) groups of heads, none empty.
int heads_per_block(int h) {
  const int g = h < kGroups ? h : kGroups;
  return (h + g - 1) / g;
}

// The state in a warp's accumulators (rows 16 of p from its m0, columns
// nb + 8 i + 2 q, + 1) to o (hi (p, n), then lo (p, n)) as a bf16 hi/lo
// pair, through the warp's staging tile st ([2][16][kLdS]) so that each
// lane stores 16 bytes and 8 lanes a 128-byte row.
constexpr int kLdS = kUnitN + kPad;
__device__ __forceinline__ void store_state(const float (&acc)[kUnitN / 8][4],
                                            bf16* st, bf16* o, size_t pn,
                                            int n, int m0, int nb,
                                            int ncols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < kUnitN / 8; ++i) {
    uint32_t h0, l0, h1, l1;
    split2(acc[i][0], acc[i][1], h0, l0);
    split2(acc[i][2], acc[i][3], h1, l1);
    const int r = g * kLdS + 8 * i + 2 * q;
    *reinterpret_cast<uint32_t*>(st + r) = h0;
    *reinterpret_cast<uint32_t*>(st + 16 * kLdS + r) = l0;
    *reinterpret_cast<uint32_t*>(st + r + 8 * kLdS) = h1;
    *reinterpret_cast<uint32_t*>(st + 16 * kLdS + r + 8 * kLdS) = l1;
  }
  __syncwarp();
  const int chunks = ncols / 8;            // 16-byte chunks a row
  for (int i = lane; i < 2 * 16 * chunks; i += 32) {
    const int part = i / (16 * chunks), rem = i - part * 16 * chunks;
    const int r = rem / chunks, ch = rem - r * chunks;
    *reinterpret_cast<uint4*>(o + part * pn +
                              static_cast<size_t>(m0 + r) * n + nb + 8 * ch) =
        *reinterpret_cast<const uint4*>(st + (part * 16 + r) * kLdS + 8 * ch);
  }
  __syncwarp();
}

// 1. The state path, one block a (direction, 64 columns of n, head,
//    batch), a warp a 16-row slice of p, walking the tiles with the state
//    in its accumulators. Direction 0, forward: acc <- a_c acc + G_c with
//    G_c = sum_j (w_j x_j) B_j^T, w_j = exp(L_T - L_j) dt_j, stored as
//    H_{c+1} (the state entering tile c + 1). Direction 1, backward from
//    dstate (stored as dS_{nt-1}) or 0: acc <- a_c acc + sum_t (e_t dy_t)
//    C_t^T, e_t = exp(L_t), stored as dS_{c-1}. a_c = exp(L_T) of tile c.
//    The A operand (w x or e dy, (p x steps)) is split into a bf16 hi/lo
//    pair in registers; stores are hi/lo pairs, (b, h, tiles, 2, p, n).
__global__ void __launch_bounds__(kStThreads)
ssd_bwd_tc_states_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ B,
                         const bf16* __restrict__ C,
                         const bf16* __restrict__ dy,
                         const float* __restrict__ dstate,
                         bf16* __restrict__ Hs, bf16* __restrict__ dSs,
                         int s, int h, int p, int n, int nt) {
  __shared__ __align__(16) bf16 Xs[kT * kLdS];
  __shared__ __align__(16) bf16 Bs[kT * kLdS];
  __shared__ __align__(16) bf16 St[kStThreads / 32][2 * 16 * kLdS];
  __shared__ float Ls[kT], ws[kT], decay[1];
  const int units = (n + kUnitN - 1) / kUnitN;
  const int dir = blockIdx.x / units;
  const int nb = kUnitN * (blockIdx.x - dir * units);
  const int ncols = min(kUnitN, n - nb);
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = 16 * warp;            // this warp's rows of p
  const size_t xrow = static_cast<size_t>(h) * p;
  const size_t pn = static_cast<size_t>(p) * n;
  const size_t bh = static_cast<size_t>(bi) * h + hi;
  bf16* out = (dir == 0 ? Hs : dSs) + bh * nt * 2 * pn;
  const bf16* xin = dir == 0 ? x : dy;
  const bf16* bin = dir == 0 ? B : C;

  float acc[kUnitN / 8][4];
#pragma unroll
  for (int i = 0; i < kUnitN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  if (dir == 1 && dstate != nullptr && m0 < p) {
    const float* ds = dstate + bh * pn;
#pragma unroll
    for (int i = 0; i < kUnitN / 8; ++i) {
      if (8 * i < ncols) {
        const size_t r = static_cast<size_t>(m0 + g) * n + nb + 8 * i + 2 * q;
        acc[i][0] = ds[r];
        acc[i][1] = ds[r + 1];
        acc[i][2] = ds[r + 8 * n];
        acc[i][3] = ds[r + 8 * n + 1];
      }
    }
    store_state(acc, St[warp], out + (nt - 1) * 2 * pn, pn, n, m0, nb,
                ncols);
  }
  for (int k = 0; k < nt - 1; ++k) {
    const int c = dir == 0 ? k : nt - 1 - k;
    const int valid = min(kT, s - c * kT);
    const size_t row0 = static_cast<size_t>(bi) * s + c * kT;
    __syncthreads();     // the previous tile's reads of Xs, Bs, ws
    load_rows<kStThreads>(Xs, kLdS,
                          xin + row0 * xrow + static_cast<size_t>(hi) * p,
                          xrow, kT, p, valid);
    load_rows<kStThreads>(Bs, kLdS, bin + row0 * n + nb, n, kT, ncols,
                          valid);
    cp_async_commit();
    if (warp == 0) {
      const float last = tile_cumsum(dt, row0 * h + hi, h, valid, A[hi], Ls,
                                     ws);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int t = lane + 32 * kk;
        ws[t] = dir == 0 ? expf(last - Ls[t]) * ws[t] : expf(Ls[t]);
      }
      if (lane == 0) decay[0] = expf(last);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (m0 >= p) continue;
    const float a = decay[0];
#pragma unroll
    for (int i = 0; i < kUnitN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= a;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // A = (w x)^T: x stored [k = step][m = pp]; a[0], a[1] hold steps
      // 16 kk + 2 q (+1), a[2], a[3] those + 8.
      uint32_t xa[4], ah[4], al[4];
      ld_a_t(xa, Xs, kLdS, m0, 16 * kk);
      const float* wk = ws + 16 * kk + 2 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(as_bf162(xa[r]));
        const int o = r < 2 ? 0 : 8;
        split2(f.x * wk[o], f.y * wk[o + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int u = 0; u < kUnitN / 16; ++u) {
        if (16 * u < ncols) {
          // B (k = step, n = nn): B or C stored [step][nn].
          uint32_t b[4];
          ld_b_t(b, Bs, kLdS, 16 * u, 16 * kk);
          mma_bf16(acc[2 * u], ah, b[0], b[1]);
          mma_bf16(acc[2 * u + 1], ah, b[2], b[3]);
          mma_bf16(acc[2 * u], al, b[0], b[1]);
          mma_bf16(acc[2 * u + 1], al, b[2], b[3]);
        }
      }
    }
    store_state(acc, St[warp], out + (dir == 0 ? c + 1 : c - 1) * 2 * pn,
                pn, n, m0, nb, ncols);
  }
}

// 2. One block a (group of heads, tile, batch). Warp w owns rows
//    r0 = 16 (w % 4) of each 64-row
//    output and half ch = w / 4 of its columns (of a 64 x 64 one: 32
//    columns; of a 64 x n one: the 16-column pairs jn = ch + 2 v). Once:
//    K = C B^T (fragments at or left of the diagonal). Per head of the
//    group, with x, dy and the head's H and dS (hi/lo pairs) in shared
//    memory:
//      P' = dy x^T; in registers E, P = P' dt_j, KE (to shared memory as a
//      hi/lo pair), EP (summed into W), Q = KE P (to shared memory);
//      dl's straddling sum from Q's exclusive row prefix; du = KE^T dy +
//      exp(L_T - L_j) V with V = B dS^T; dx; x . du and x . V (the dl term
//      of dS u); Y = dy H, scaled by exp(L_t) into dC and dotted with C
//      (the dl term of H); Z = x dS, scaled by exp(L_T - L_j) dt_j into
//      dB; <H, dS>; then warp 0 sums dl and writes ddt and the dA, dD
//      partials.
//    After the heads: dC += W B and dB += W^T C (W as a hi/lo pair), out
//    through shared memory, 16 bytes a thread, to the group's fp32 sums
//    (b, groups, s, n).
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tc_local_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const bf16* __restrict__ B,
                        const bf16* __restrict__ C,
                        const float* __restrict__ D,
                        const bf16* __restrict__ dy,
                        const bf16* __restrict__ Hs,
                        const bf16* __restrict__ dSs, int has_dstate,
                        bf16* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ pC, float* __restrict__ pB,
                        float* __restrict__ partA, float* __restrict__ partD,
                        int s, int h, int p, int n, int nt, int hpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = n + kPad, ldp = p + kPad;
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // [kT][ldn]
  bf16* Bs = Cs + kT * ldn;                   // [kT][ldn]
  bf16* Xb = Bs + kT * ldn;                   // [2][kT][ldp]: x, by head
  bf16* Yb = Xb + 2 * kT * ldp;               // [2][kT][ldp]: dy
  bf16* Hh = Yb + 2 * kT * ldp;               // [p][ldn]: H hi,
  bf16* Hl = Hh + p * ldn;                    //   H lo,
  bf16* Sh = Hl + p * ldn;                    //   dS hi,
  bf16* Sl = Sh + p * ldn;                    //   dS lo
  float* stC = reinterpret_cast<float*>(Hh);  // [kT][n] after the heads
  float* stB = stC + kT * n;                  // [kT][n]
  bf16* Eh = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Hh) +
                                     st_bytes(n, p));   // [kT][kLdT]
  bf16* El = Eh + kT * kLdT;                  // KE (then W) hi, lo
  float* Qs = reinterpret_cast<float*>(El + kT * kLdT);   // [kT][kLdQ]
  float* part = Qs + kT * kLdQ;               // [kWarps][kT]
  float* Ls = part + kWarps * kT;             // [kT] each:
  float* dts = Ls + kT;
  float* eL = dts + kT;                       // exp(L_t)
  float* wl = eL + kT;                        // exp(L_T - L_j)
  float* xd = wl + kT;                        // [2][kT] x . du by half
  float* rv = xd + 2 * kT;                    // [2][kT] x . V
  float* iy = rv + 2 * kT;                    // [2][kT] C . (dy H)
  float* red = iy + 2 * kT;                   // [32] block sums

  const int grp = blockIdx.x, groups = gridDim.x;
  const int c = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int rg = warp & 3, ch = warp >> 2, r0 = 16 * rg;
  const int t0 = c * kT, valid = min(kT, s - t0);
  const size_t row0 = static_cast<size_t>(bi) * s + t0;
  const size_t xrow = static_cast<size_t>(h) * p;
  const size_t pn = static_cast<size_t>(p) * n;
  const bool hasH = c > 0, hasS = c < nt - 1 || has_dstate != 0;
  const int h0 = grp * hpb, h1 = min(h, h0 + hpb);

  // Loads in flight ahead of their use, in cp.async groups: C and B; x
  // and dy of the first head (then of each next head while one computes);
  // each head's H and dS while it computes what needs neither. Warp 0
  // holds dt of the next head in dv.
  auto load_xy = [&](int hh, int buf) {
    const size_t xoff = row0 * xrow + static_cast<size_t>(hh) * p;
    load_rows<kThreads>(Xb + buf * kT * ldp, ldp, x + xoff, xrow, kT, p,
                        valid);
    load_rows<kThreads>(Yb + buf * kT * ldp, ldp, dy + xoff, xrow, kT, p,
                        valid);
    cp_async_commit();
  };
  float dv[2] = {0.f, 0.f};
  load_rows<kThreads>(Cs, ldn, C + row0 * n, n, kT, n, valid);
  load_rows<kThreads>(Bs, ldn, B + row0 * n, n, kT, n, valid);
  cp_async_commit();
  if (h0 < h1) {
    load_xy(h0, 0);
    if (warp == 0) load_tile_dt(dv, dt, row0 * h + h0, h, valid);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // K = C B^T: rows r0.., the 16-column pairs 2 ch + u at or left of the
  // diagonal (B operand, k = nn, n = j: B stored [j][nn]).
  float K[4][4], W[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) K[i][e] = W[i][e] = 0.f;
  for (int kk = 0; kk < n / 16; ++kk) {
    uint32_t a[4];
    ld_a(a, Cs, ldn, r0, 16 * kk);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (2 * ch + u <= rg) {
        uint32_t b[4];
        ld_b(b, Bs, ldn, 16 * (2 * ch + u), 16 * kk);
        mma_bf16(K[2 * u], a, b[0], b[1]);
        mma_bf16(K[2 * u + 1], a, b[2], b[3]);
      }
    }
  }
  float dCa[kNPairs][2][4], dBa[kNPairs][2][4];
#pragma unroll
  for (int v = 0; v < kNPairs; ++v)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dCa[v][i][e] = dBa[v][i][e] = 0.f;

  for (int hh = h0; hh < h1; ++hh) {
    const int buf = (hh - h0) & 1;
    const bool next = hh + 1 < h1;
    const bf16* Xs = Xb + buf * kT * ldp;
    const bf16* Ys = Yb + buf * kT * ldp;
    const size_t slot = ((static_cast<size_t>(bi) * h + hh) * nt + c) * 2 *
                        pn;
    const float a = A[hh], dsk = D[hh];
    __syncthreads();   // the previous head's reads of shared memory
    if (hasH) {
      load_rows<kThreads>(Hh, ldn, Hs + slot, n, p, n, p);
      load_rows<kThreads>(Hl, ldn, Hs + slot + pn, n, p, n, p);
    }
    if (hasS) {
      load_rows<kThreads>(Sh, ldn, dSs + slot, n, p, n, p);
      load_rows<kThreads>(Sl, ldn, dSs + slot + pn, n, p, n, p);
    }
    cp_async_commit();
    if (next) load_xy(hh + 1, buf ^ 1);
    if (warp == 0) {
      const float last = scan_tile(dv, a, Ls, dts);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        eL[t] = expf(Ls[t]);
        wl[t] = expf(last - Ls[t]);
      }
      if (next) load_tile_dt(dv, dt, row0 * h + hh + 1, h, valid);
    }
    if (next)            // this head's x and dy
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();

    // P' = dy x^T (A: dy stored [t][pp]; B operand, k = pp, n = j: x
    // stored [j][pp]).
    float P[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) P[i][e] = 0.f;
    for (int kk = 0; kk < p / 16; ++kk) {
      uint32_t ya[4];
      ld_a(ya, Ys, ldp, r0, 16 * kk);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (2 * ch + u <= rg) {
          uint32_t b[4];
          ld_b(b, Xs, ldp, 16 * (2 * ch + u), 16 * kk);
          mma_bf16(P[2 * u], ya, b[0], b[1]);
          mma_bf16(P[2 * u + 1], ya, b[2], b[3]);
        }
      }
    }
    // E, P = P' dt_j, KE, EP (into W), Q over j <= t; zeros elsewhere.
    float dd = 0.f;   // this lane's share of sum dy . x: P' on the diagonal
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live = 2 * ch + (i >> 1) <= rg;
      float ke[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e >> 1);
        const int j = 32 * ch + 8 * i + 2 * q + (e & 1);
        float qv = 0.f;
        ke[e] = 0.f;
        if (live && j <= t) {
          const float ev = expf(Ls[t] - Ls[j]);
          const float pv = P[i][e] * dts[j];
          ke[e] = K[i][e] * ev;
          W[i][e] += ev * pv;
          qv = ke[e] * pv;
          if (j == t) dd += P[i][e];
        }
        Qs[t * kLdQ + j] = qv;
      }
      const int o = (r0 + g) * kLdT + 32 * ch + 8 * i + 2 * q;
      uint32_t h0, l0, h1, l1;
      split2(ke[0], ke[1], h0, l0);
      split2(ke[2], ke[3], h1, l1);
      *reinterpret_cast<uint32_t*>(Eh + o) = h0;
      *reinterpret_cast<uint32_t*>(El + o) = l0;
      *reinterpret_cast<uint32_t*>(Eh + o + 8 * kLdT) = h1;
      *reinterpret_cast<uint32_t*>(El + o + 8 * kLdT) = l1;
    }
    __syncthreads();   // KE, Q

    // dl's straddling sum: rows t = warp + 8 r, the exclusive prefix of Q
    // along j in the warp; the column sums over t >= k by warp, in part.
    {
      float col0 = 0.f, col1 = 0.f;
#pragma unroll
      for (int r = 0; r < kT / kWarps; ++r) {
        const int t = warp + kWarps * r;
        const float v0 = Qs[t * kLdQ + lane], v1 = Qs[t * kLdQ + lane + 32];
        float s0 = v0, s1 = v1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o0 = __shfl_up_sync(0xffffffffu, s0, off);
          const float o1 = __shfl_up_sync(0xffffffffu, s1, off);
          if (lane >= off) {
            s0 += o0;
            s1 += o1;
          }
        }
        const float tot0 = __shfl_sync(0xffffffffu, s0, 31);
        const float e0 = __shfl_up_sync(0xffffffffu, s0, 1);
        const float e1 = __shfl_up_sync(0xffffffffu, s1, 1);
        if (t >= lane) col0 += lane == 0 ? 0.f : e0;
        if (t >= lane + 32) col1 += lane == 0 ? tot0 : tot0 + e1;
      }
      part[warp * kT + lane] = col0;
      part[warp * kT + lane + 32] = col1;
    }

    // du = KE^T dy + exp(L_T - L_j) V, V = B dS^T: rows j = r0.., columns
    // pp = 32 ch + 16 u... KE^T (m = j, k = t) is KE stored [t][j], read
    // transposed, over t >= j; dy (k = t, n = pp) stored [t][pp]. B (m = j,
    // k = nn) stored [j][nn]; dS (k = nn, n = pp) stored [pp][nn].
    float du[4][4], vs[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) du[i][e] = vs[i][e] = 0.f;
    for (int kk = rg; kk < kT / 16; ++kk) {
      uint32_t ah[4], al[4];
      ld_a_t(ah, Eh, kLdT, r0, 16 * kk);
      ld_a_t(al, El, kLdT, r0, 16 * kk);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (32 * ch + 16 * u < p) {
          uint32_t b[4];
          ld_b_t(b, Ys, ldp, 32 * ch + 16 * u, 16 * kk);
          mma_bf16(du[2 * u], ah, b[0], b[1]);
          mma_bf16(du[2 * u + 1], ah, b[2], b[3]);
          mma_bf16(du[2 * u], al, b[0], b[1]);
          mma_bf16(du[2 * u + 1], al, b[2], b[3]);
        }
      }
    }
    if (next)            // this head's H and dS
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (hasS) {
      for (int kk = 0; kk < n / 16; ++kk) {
        uint32_t ba[4];
        ld_a(ba, Bs, ldn, r0, 16 * kk);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (32 * ch + 16 * u < p) {
            uint32_t bh[4], bl[4];
            ld_b(bh, Sh, ldn, 32 * ch + 16 * u, 16 * kk);
            ld_b(bl, Sl, ldn, 32 * ch + 16 * u, 16 * kk);
            mma_bf16(vs[2 * u], ba, bh[0], bh[1]);
            mma_bf16(vs[2 * u + 1], ba, bh[2], bh[3]);
            mma_bf16(vs[2 * u], ba, bl[0], bl[1]);
            mma_bf16(vs[2 * u + 1], ba, bl[2], bl[3]);
          }
        }
      }
    }
    {
      float xdp[2] = {0.f, 0.f}, rvp[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * ch + 8 * i + 2 * q;
        if (32 * ch + 8 * i < p) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = r0 + g + 8 * r;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(Xs + j * ldp + col));
            const float2 yv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(Ys + j * ldp + col));
            const float v0 = vs[i][2 * r], v1 = vs[i][2 * r + 1];
            const float d0 = du[i][2 * r] + wl[j] * v0;
            const float d1 = du[i][2 * r + 1] + wl[j] * v1;
            xdp[r] += xv.x * d0 + xv.y * d1;
            rvp[r] += xv.x * v0 + xv.y * v1;
            if (j < valid)
              *reinterpret_cast<__nv_bfloat162*>(
                  dx + (row0 + j) * xrow + static_cast<size_t>(hh) * p +
                  col) = __floats2bfloat162_rn(dts[j] * d0 + dsk * yv.x,
                                               dts[j] * d1 + dsk * yv.y);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xdp[r] += __shfl_xor_sync(0xffffffffu, xdp[r], 1);
        xdp[r] += __shfl_xor_sync(0xffffffffu, xdp[r], 2);
        rvp[r] += __shfl_xor_sync(0xffffffffu, rvp[r], 1);
        rvp[r] += __shfl_xor_sync(0xffffffffu, rvp[r], 2);
        if (q == 0) {
          xd[ch * kT + r0 + g + 8 * r] = xdp[r];
          rv[ch * kT + r0 + g + 8 * r] = rvp[r];
        }
      }
    }

    // Y = dy H (A: dy stored [t][pp]; B operand, k = pp, n = nn: H stored
    // [pp][nn], read transposed) and Z = x dS, a 16-column pair of n at a
    // time: exp(L_t) Y into dC, C . Y into iy, exp(L_T - L_j) dt_j Z into
    // dB.
    {
      float iyp[2] = {0.f, 0.f};
      if (hasH || hasS) {
        uint32_t ya[kMaxP / 16][4], xa[kMaxP / 16][4];
#pragma unroll
        for (int kk = 0; kk < kMaxP / 16; ++kk) {
          if (16 * kk < p) {
            ld_a(ya[kk], Ys, ldp, r0, 16 * kk);
            ld_a(xa[kk], Xs, ldp, r0, 16 * kk);
          }
        }
#pragma unroll
        for (int v = 0; v < kNPairs; ++v) {
          const int nc = 16 * (ch + 2 * v);
          if (nc >= n) continue;
          if (hasH) {
            float y[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < kMaxP / 16; ++kk) {
              if (16 * kk < p) {
                uint32_t bh[4], bl[4];
                ld_b_t(bh, Hh, ldn, nc, 16 * kk);
                ld_b_t(bl, Hl, ldn, nc, 16 * kk);
                mma_bf16(y[0], ya[kk], bh[0], bh[1]);
                mma_bf16(y[1], ya[kk], bh[2], bh[3]);
                mma_bf16(y[0], ya[kk], bl[0], bl[1]);
                mma_bf16(y[1], ya[kk], bl[2], bl[3]);
              }
            }
#pragma unroll
            for (int tt = 0; tt < 2; ++tt) {
              const int col = nc + 8 * tt + 2 * q;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int t = r0 + g + 8 * r;
                const float2 cv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(Cs + t * ldn +
                                                             col));
                const float y0 = y[tt][2 * r], y1 = y[tt][2 * r + 1];
                iyp[r] += cv.x * y0 + cv.y * y1;
                dCa[v][tt][2 * r] += eL[t] * y0;
                dCa[v][tt][2 * r + 1] += eL[t] * y1;
              }
            }
          }
          if (hasS) {
            float z[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < kMaxP / 16; ++kk) {
              if (16 * kk < p) {
                uint32_t bh[4], bl[4];
                ld_b_t(bh, Sh, ldn, nc, 16 * kk);
                ld_b_t(bl, Sl, ldn, nc, 16 * kk);
                mma_bf16(z[0], xa[kk], bh[0], bh[1]);
                mma_bf16(z[1], xa[kk], bh[2], bh[3]);
                mma_bf16(z[0], xa[kk], bl[0], bl[1]);
                mma_bf16(z[1], xa[kk], bl[2], bl[3]);
              }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = r0 + g + 8 * r;
              const float f = wl[j] * dts[j];
#pragma unroll
              for (int tt = 0; tt < 2; ++tt) {
                dBa[v][tt][2 * r] += f * z[tt][2 * r];
                dBa[v][tt][2 * r + 1] += f * z[tt][2 * r + 1];
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        iyp[r] += __shfl_xor_sync(0xffffffffu, iyp[r], 1);
        iyp[r] += __shfl_xor_sync(0xffffffffu, iyp[r], 2);
        if (q == 0) iy[ch * kT + r0 + g + 8 * r] = iyp[r];
      }
    }

    // <H, dS>, each thread its fixed 16-byte chunks of the four tiles.
    float hd = 0.f;
    if (hasH && hasS) {
      const int cpr = n / 8;
      for (int i = tid; i < p * cpr; i += kThreads) {
        const int r = i / cpr, o = r * ldn + 8 * (i - r * cpr);
        const uint4 h4 = *reinterpret_cast<const uint4*>(Hh + o);
        const uint4 l4 = *reinterpret_cast<const uint4*>(Hl + o);
        const uint4 s4 = *reinterpret_cast<const uint4*>(Sh + o);
        const uint4 t4 = *reinterpret_cast<const uint4*>(Sl + o);
        const uint32_t hw[4] = {h4.x, h4.y, h4.z, h4.w};
        const uint32_t lw[4] = {l4.x, l4.y, l4.z, l4.w};
        const uint32_t sw[4] = {s4.x, s4.y, s4.z, s4.w};
        const uint32_t tw[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a0 = __bfloat1622float2(as_bf162(hw[k]));
          const float2 a1 = __bfloat1622float2(as_bf162(lw[k]));
          const float2 b0 = __bfloat1622float2(as_bf162(sw[k]));
          const float2 b1 = __bfloat1622float2(as_bf162(tw[k]));
          hd += (a0.x + a1.x) * (b0.x + b1.x) + (a0.y + a1.y) * (b0.y + b1.y);
        }
      }
    }
    hd = warp_sum(hd);
    dd = warp_sum(dd);
    if (lane == 0) {
      red[warp] = hd;
      red[kWarps + warp] = dd;
    }
    __syncthreads();

    // dl_k = dli_k + sum_{t >= k} iy_t + exp(L_T) <H, dS> + sum_{j < k}
    // rr_j; ddt = x . du + A dl; the dA and dD partials.
    if (warp == 0) {
      float hds = 0.f, dsum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        hds += red[w];
        dsum += red[kWarps + w];
      }
      float dl[2], iv[2], rr[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        float dli = 0.f;
        for (int w = 0; w < kWarps; ++w) dli += part[w * kT + t];
        iv[k] = eL[t] * (iy[t] + iy[kT + t]);
        rr[k] = wl[t] * dts[t] * (rv[t] + rv[kT + t]);
        dl[k] = dli + eL[kT - 1] * hds;
      }
      // suffix sums of iv and exclusive prefix sums of rr over the 64 steps
      float sv[2] = {iv[0], iv[1]}, pv[2] = {rr[0], rr[1]};
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float o = __shfl_down_sync(0xffffffffu, sv[k], off);
          const float u = __shfl_up_sync(0xffffffffu, pv[k], off);
          if (lane + off < 32) sv[k] += o;
          if (lane >= off) pv[k] += u;
        }
      }
      const float upper = __shfl_sync(0xffffffffu, sv[1], 0);
      const float lower = __shfl_sync(0xffffffffu, pv[0], 31);
      const float e0 = __shfl_up_sync(0xffffffffu, pv[0], 1);
      const float e1 = __shfl_up_sync(0xffffffffu, pv[1], 1);
      dl[0] += (sv[0] + upper) + (lane == 0 ? 0.f : e0);
      dl[1] += sv[1] + (lane == 0 ? lower : lower + e1);
      float ap = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = lane + 32 * k;
        if (t < valid)
          ddt[(row0 + t) * h + hh] = (xd[t] + xd[kT + t]) + a * dl[k];
        ap += dts[t] * dl[k];
      }
      ap = warp_sum(ap);
      if (lane == 0) {
        const size_t o = (static_cast<size_t>(bi) * h + hh) * nt + c;
        partA[o] = ap;
        partD[o] = dsum;
      }
    }
  }

  // W as a bf16 hi/lo pair, [t][j], zeros right of the diagonal.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = (r0 + g) * kLdT + 32 * ch + 8 * i + 2 * q;
    uint32_t h0, l0, h1, l1;
    split2(W[i][0], W[i][1], h0, l0);
    split2(W[i][2], W[i][3], h1, l1);
    *reinterpret_cast<uint32_t*>(Eh + o) = h0;
    *reinterpret_cast<uint32_t*>(El + o) = l0;
    *reinterpret_cast<uint32_t*>(Eh + o + 8 * kLdT) = h1;
    *reinterpret_cast<uint32_t*>(El + o + 8 * kLdT) = l1;
  }
  __syncthreads();
  // dC += W B (A: W stored [t][j], over j <= t; B operand, k = j, n = nn:
  // B stored [j][nn], read transposed); dB += W^T C (A: W^T, W read
  // transposed, over t >= j; C stored [t][nn]).
#pragma unroll
  for (int v = 0; v < kNPairs; ++v) {
    const int nc = 16 * (ch + 2 * v);
    if (nc >= n) continue;
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t ah[4], al[4], b[4];
      if (kk <= rg) {
        ld_a(ah, Eh, kLdT, r0, 16 * kk);
        ld_a(al, El, kLdT, r0, 16 * kk);
        ld_b_t(b, Bs, ldn, nc, 16 * kk);
        mma_bf16(dCa[v][0], ah, b[0], b[1]);
        mma_bf16(dCa[v][1], ah, b[2], b[3]);
        mma_bf16(dCa[v][0], al, b[0], b[1]);
        mma_bf16(dCa[v][1], al, b[2], b[3]);
      }
      if (kk >= rg) {
        ld_a_t(ah, Eh, kLdT, r0, 16 * kk);
        ld_a_t(al, El, kLdT, r0, 16 * kk);
        ld_b_t(b, Cs, ldn, nc, 16 * kk);
        mma_bf16(dBa[v][0], ah, b[0], b[1]);
        mma_bf16(dBa[v][1], ah, b[2], b[3]);
        mma_bf16(dBa[v][0], al, b[0], b[1]);
        mma_bf16(dBa[v][1], al, b[2], b[3]);
      }
    }
    // into shared memory (over H and dS, which the heads no longer read)
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = (r0 + g + 8 * r) * n + nc + 8 * tt + 2 * q;
        *reinterpret_cast<float2*>(stC + o) =
            make_float2(dCa[v][tt][2 * r], dCa[v][tt][2 * r + 1]);
        *reinterpret_cast<float2*>(stB + o) =
            make_float2(dBa[v][tt][2 * r], dBa[v][tt][2 * r + 1]);
      }
    }
  }
  __syncthreads();
  {
    const size_t o = ((static_cast<size_t>(bi) * groups + grp) * s + t0) * n;
    const int cpr = n / 4;
    for (int i = tid; i < valid * cpr; i += kThreads) {
      const int r = i / cpr, col = 4 * (i - r * cpr);
      *reinterpret_cast<float4*>(pC + o + r * n + col) =
          *reinterpret_cast<const float4*>(stC + r * n + col);
      *reinterpret_cast<float4*>(pB + o + r * n + col) =
          *reinterpret_cast<const float4*>(stB + r * n + col);
    }
  }
}

// 3. dC, dB: the groups' sums added in group order, four elements a
//    thread; block 0 also sums dA, dD over batches, then tiles, in order,
//    a thread a head.
__global__ void __launch_bounds__(256)
ssd_bwd_tc_reduce_kernel(const float* __restrict__ pC,
                         const float* __restrict__ pB,
                         const float* __restrict__ partA,
                         const float* __restrict__ partD,
                         bf16* __restrict__ dB, bf16* __restrict__ dC,
                         float* __restrict__ dA, float* __restrict__ dD,
                         int b, int s, int h, int n, int nt, int groups) {
  const size_t sn = static_cast<size_t>(s) * n;
  const size_t e = 4 * (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x);
  if (e < b * sn) {
    const size_t bi = e / sn, r = e - bi * sn;
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f), sb = sc;
    for (int k = 0; k < groups; ++k) {
      const size_t o = (bi * groups + k) * sn + r;
      const float4 vc = *reinterpret_cast<const float4*>(pC + o);
      const float4 vb = *reinterpret_cast<const float4*>(pB + o);
      sc = make_float4(sc.x + vc.x, sc.y + vc.y, sc.z + vc.z, sc.w + vc.w);
      sb = make_float4(sb.x + vb.x, sb.y + vb.y, sb.z + vb.z, sb.w + vb.w);
    }
    *reinterpret_cast<uint2*>(dC + e) =
        make_uint2(as_u32(__floats2bfloat162_rn(sc.x, sc.y)),
                   as_u32(__floats2bfloat162_rn(sc.z, sc.w)));
    *reinterpret_cast<uint2*>(dB + e) =
        make_uint2(as_u32(__floats2bfloat162_rn(sb.x, sb.y)),
                   as_u32(__floats2bfloat162_rn(sb.z, sb.w)));
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < h; hh += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int bi = 0; bi < b; ++bi)
        for (int c = 0; c < nt; ++c) {
          const size_t o = (static_cast<size_t>(bi) * h + hh) * nt + c;
          sa += partA[o];
          sd += partD[o];
        }
      dA[hh] = sa;
      dD[hh] = sd;
    }
  }
}

cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D,
                   const void* dy, const float* dstate, void* dx, float* ddt,
                   float* dA, void* dB, void* dC, float* dD, float* work,
                   int b, int s, int h, int p, int n, cudaStream_t stream) {
  if (!fits(p, n)) return cudaErrorInvalidValue;
  const int nt = (s + kT - 1) / kT;
  const size_t bh = static_cast<size_t>(b) * h;
  const size_t pn = static_cast<size_t>(p) * n;
  const int hpb = heads_per_block(h);
  const int groups = (h + hpb - 1) / hpb;
  const size_t gsn = static_cast<size_t>(b) * groups * s * n;
  bf16* Hs = reinterpret_cast<bf16*>(work);
  bf16* dSs = Hs + bh * nt * 2 * pn;
  float* pC = reinterpret_cast<float*>(dSs + bh * nt * 2 * pn);
  float* pB = pC + gsn;
  float* partA = pB + gsn;
  float* partD = partA + bh * nt;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(B);
  const bf16* Cb = static_cast<const bf16*>(C);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const int units = (n + kUnitN - 1) / kUnitN;
  ssd_bwd_tc_states_kernel<<<dim3(2 * units, h, b), kStThreads, 0,
                             stream>>>(xb, dt, A, Bb, Cb, dyb, dstate, Hs,
                                       dSs, s, h, p, n, nt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = local_smem(n, p);
  err = cudaFuncSetAttribute(ssd_bwd_tc_local_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_bwd_tc_local_kernel<<<dim3(groups, nt, b), kThreads, smem, stream>>>(
      xb, dt, A, Bb, Cb, D, dyb, Hs, dSs, dstate != nullptr ? 1 : 0,
      static_cast<bf16*>(dx), ddt, pC, pB, partA, partD, s, h, p, n, nt, hpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t quads = static_cast<size_t>(b) * s * n / 4;
  ssd_bwd_tc_reduce_kernel<<<(quads + 255) / 256, 256, 0, stream>>>(
      pC, pB, partA, partD, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      dA, dD, b, s, h, n, nt, groups);
  return cudaGetLastError();
}

}  // namespace ssd_bwd_tc
}  // namespace
}  // namespace repro

// Inputs as repro_ssd_scan's (x, B, C in float32 or bfloat16, dtype; dt,
// A, D float32), dy (b, s, h, p) in x's dtype, dstate (b, h, p, n) float32
// or null for zero; outputs dx (b, s, h, p), dB, dC (b, s, n) in x's dtype,
// ddt (b, s, h), dA, dD (h,) float32; all contiguous, x, B, C and dy
// 16-byte aligned for design 1. work, 16-byte aligned (tiles of 64 steps):
// design 0, the CUDA-core kernels: fp32 scratch of 2 b h tiles p n +
// 3 b h tiles + 2 b h s n floats; design 1, the tensor-core kernels
// (bfloat16, n and p multiples of 16, n <= 128, p <= 64): H and dS as bf16
// hi/lo pairs, 2 (b, h, tiles, 2, p, n), the groups' dC and dB sums,
// 2 b groups s n floats (groups = ceil(h / heads_per_block(h)), at most
// min(4, h)), then 2 b h tiles floats. Launches
// on `stream`: four for design 0, three for design 1.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* dy,
                                  const void* dstate, void* dx, void* ddt,
                                  void* dA, void* dB, void* dC, void* dD,
                                  void* work, int b, int s, int h, int p,
                                  int n, int dtype, int design,
                                  void* stream) {
  using namespace repro;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* dsf = static_cast<const float*>(dstate);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* dDf = static_cast<float*>(dD);
  float* wf = static_cast<float*>(work);
  cudaError_t err = cudaErrorInvalidValue;
  if (design == 1 && dtype == kBF16)
    err = ssd_bwd_tc::launch(x, dtf, Af, B, C, Df, dy, dsf, dx, ddtf, dAf, dB,
                             dC, dDf, wf, b, s, h, p, n, st);
  else if (design == 0 && dtype == kF32)
    err = ssd_bwd::launch<float>(x, dtf, Af, B, C, Df, dy, dsf, dx, ddtf, dAf,
                                 dB, dC, dDf, wf, b, s, h, p, n, st);
  else if (design == 0 && dtype == kBF16)
    err = ssd_bwd::launch<__nv_bfloat16>(x, dtf, Af, B, C, Df, dy, dsf, dx,
                                         ddtf, dAf, dB, dC, dDf, wf, b, s, h,
                                         p, n, st);
  return static_cast<int>(err);
}
