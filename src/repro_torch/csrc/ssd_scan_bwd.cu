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
// writes dx, ddt, dB and dC once, 21.4 MB, 6.4 us at 3.35 TB/s; the
// chunked algorithm's products at the model's chunk of 256 (C.B^T shared
// by the heads; per head P and the products of du, dB and dC over the
// causal pairs) are 4.9 GFLOP, 5.0 us on the bf16 tensor cores: bound by
// bytes. One chunk and no dstate need no state terms (the state entering
// the chunk and dS are zero); each boundary between chunks adds 10 q n p a
// head and a nonzero dstate 4 q n p.
//
// The design, CUDA cores and fp32 accumulators, every dtype and shape the
// forward takes (float32 or bfloat16, 1 <= n <= 256, any p), in four
// launches on the caller's stream with fp32 scratch from the caller:
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
//      through in chunks of kPC columns of p (and kNC of n). dx and ddt are
//      written once; dB and dC of each head go to fp32 partials, dA and dD
//      of each block too.
//   4. ssd_bwd_reduce_kernel: the partials of dB and dC summed over the
//      heads, those of dA and dD over batches and tiles, each in a fixed
//      order. No float atomics: two calls give the same bits.
// Steps at or past s are loaded as dt = 0 and x = dy = B = C = 0, as in the
// forward, and nothing is written for them.
#include "common.cuh"

namespace repro {
namespace {
namespace ssd_bwd {

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
constexpr int kMaxState = 256;    // d_state the forward takes
constexpr int kMaxSmem = 232448;  // shared memory a block may use (sm_90)

// Row stride, in elements, of B and C held in shared memory: an odd
// number of 32-bit words for fp32 (n + 1) and, for n even, for bf16 (n + 2).
template <typename T>
__host__ __device__ constexpr int ld_bc(int n) {
  return n + (sizeof(T) == 2 ? 2 : 1);
}

__host__ __device__ constexpr int stage_floats(int n) {
  return 2 * kT * kLdP +
         (kPC * (n + 1) > 2 * kPC * kLdN ? kPC * (n + 1) : 2 * kPC * kLdN);
}

template <typename T>
__host__ __device__ constexpr size_t local_smem(int n) {
  return sizeof(float) * (3 * kT * kLdM + 8 * kT + 32 + stage_floats(n)) +
         sizeof(T) * 2 * static_cast<size_t>(kT) * ld_bc<T>(n);
}
static_assert(local_smem<float>(kMaxState) <= kMaxSmem &&
                  local_smem<__nv_bfloat16>(kMaxState) <= kMaxSmem,
              "the local kernel's shared memory must fit a block at every "
              "d_state the forward takes");

// Warp 0: dt of the tile's steps (0 at or past `valid`) into dts, and
// L = inclusive cumsum of dt * a into Ls; returns L_last on every lane.
__device__ __forceinline__ float tile_cumsum(const float* __restrict__ dt,
                                             size_t base, int h, int valid,
                                             float a, float* Ls, float* dts) {
  const int lane = threadIdx.x & 31;
  float l[2], dv[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int t = lane + 32 * k;
    dv[k] = t < valid ? dt[base + static_cast<size_t>(t) * h] : 0.f;
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
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    Ls[lane + 32 * k] = l[k];
    dts[lane + 32 * k] = dv[k];
  }
  return __shfl_sync(0xffffffffu, l[1], 31);
}

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
template <typename T>
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
  float* S3 = S2 + kT * kLdP;                    // [kPC][n + 1] or [kPC][kLdN]
  float* S4 = S3 + kPC * kLdN;                   // [kPC][kLdN]
  const int ldb = ld_bc<T>(n);
  T* Bs = reinterpret_cast<T*>(S1 + stage_floats(n));   // [kT][ldb]
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

  // --- 0. ---------------------------------------------------------------
  for (int i = tid; i < kT * n; i += kThreads) {
    const int t = i / n, nn = i - t * n;
    const bool ok = t < valid;
    const size_t g = (row0 + t) * n + nn;
    Bs[t * ldb + nn] = ok ? B[g] : from_f32<T>(0.f);
    Cs[t * ldb + nn] = ok ? C[g] : from_f32<T>(0.f);
  }
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
  for (int nn = 0; nn < n; ++nn) {
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
    const int ldd = n + 1;
    for (int p0 = 0; p0 < p; p0 += kPC) {
      __syncthreads();
      for (int i = tid; i < kT * kPC; i += kThreads) {
        const int t = i / kPC, cc = i - t * kPC;
        const bool ok = t < valid && p0 + cc < p;
        const size_t g = (row0 + t) * xrow + xcol + p0 + cc;
        S1[t * kLdP + cc] = ok ? to_f32(dy[g]) : 0.f;
        S2[t * kLdP + cc] = ok ? to_f32(x[g]) : 0.f;
      }
      for (int i = tid; i < kPC * n; i += kThreads) {
        const int cc = i / n, nn = i - cc * n;
        S3[cc * ldd + nn] =
            p0 + cc < p ? dSo[tile + static_cast<size_t>(p0 + cc) * n + nn]
                        : 0.f;
      }
      __syncthreads();
      float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = jr; t < kT; ++t) {
        const float ke = KE[t * kLdM + jr];
#pragma unroll
        for (int k = 0; k < 4; ++k) a1[k] += ke * S1[t * kLdP + c0 + k];
      }
      for (int nn = 0; nn < n; ++nn) {
        const float bv = to_f32(Bs[jr * ldb + nn]);
#pragma unroll
        for (int k = 0; k < 4; ++k) a2[k] += bv * S3[(c0 + k) * ldd + nn];
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
    for (int n0 = 0; n0 < n; n0 += kNC) {
      float aC[8], aB[8], hy[8], su[8];
      int col[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        aC[k] = aB[k] = hy[k] = su[k] = 0.f;
        col[k] = min(n0 + nq + 4 * k, n - 1);   // past n: read, not kept
      }
      for (int j = 0; j <= rw; ++j) {
        const float ep = EP[rw * kLdM + j];
#pragma unroll
        for (int k = 0; k < 8; ++k) aC[k] += ep * to_f32(Bs[j * ldb + col[k]]);
      }
      for (int t = rw; t < kT; ++t) {
        const float ep = EP[t * kLdM + rw];
#pragma unroll
        for (int k = 0; k < 8; ++k) aB[k] += ep * to_f32(Cs[t * ldb + col[k]]);
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
          const bool ok = p0 + cc < p && n0 + nc < n;
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
        const int nn = n0 + nq + 4 * k;
        if (nn < n) {
          iyp += to_f32(Cs[rw * ldb + nn]) * hy[k];
          rp += to_f32(Bs[rw * ldb + nn]) * su[k];
          if (rw < valid) {
            dCh[out_row * n + nn] = aC[k] + eL[rw] * hy[k];
            dBh[out_row * n + nn] = aB[k] + wl[rw] * su[k];
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
  const size_t smem = local_smem<T>(n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_local_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  ssd_bwd_local_kernel<T><<<grid, kThreads, smem, stream>>>(
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
}  // namespace
}  // namespace repro

// Inputs as repro_ssd_scan's (x, B, C in float32 or bfloat16, dtype; dt,
// A, D float32), dy (b, s, h, p) in x's dtype, dstate (b, h, p, n) float32
// or null for zero; outputs dx (b, s, h, p), dB, dC (b, s, n) in x's dtype,
// ddt (b, s, h), dA, dD (h,) float32; work: fp32 scratch of
// 2 b h tiles p n + 3 b h tiles + 2 b h s n floats (tiles of 64 steps);
// all contiguous. Four launches on `stream`.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* dy,
                                  const void* dstate, void* dx, void* ddt,
                                  void* dA, void* dB, void* dC, void* dD,
                                  void* work, int b, int s, int h, int p,
                                  int n, int dtype, void* stream) {
  using namespace repro;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 ||
      n > ssd_bwd::kMaxState)
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
  if (dtype == kF32)
    err = ssd_bwd::launch<float>(x, dtf, Af, B, C, Df, dy, dsf, dx, ddtf, dAf,
                                 dB, dC, dDf, wf, b, s, h, p, n, st);
  else if (dtype == kBF16)
    err = ssd_bwd::launch<__nv_bfloat16>(x, dtf, Af, B, C, Df, dy, dsf, dx,
                                         ddtf, dAf, dB, dC, dDf, wf, b, s, h,
                                         p, n, st);
  return static_cast<int>(err);
}
