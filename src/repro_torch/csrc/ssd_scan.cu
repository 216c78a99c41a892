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
//
// Design. CUDA blocks run in no order, so one block owns a (batch, head,
// slice of kPS columns of p) and loops over the sequence itself, in tiles
// of kT steps; its state slice (n x kPS, fp32) stays in shared memory from
// tile to tile. The columns of x, y and the state along p are independent,
// so slicing p is exact, and it gives b * h * p / kPS blocks (96 at the
// main path's batch 1, 24 heads, p 64) instead of 24 for 132 SMs. The math
// does not depend on the tile (the chunk of the JAX contract is checked by
// the wrapper, then the kernel runs its own kT): steps at or past s are
// masked as dt = 0 and x = 0, which leaves y and the state of the valid
// steps unchanged. exp is only taken of L_t - L_j for j <= t, which is
// <= 0 (A < 0, dt > 0): no positive exponent, no inf * 0.
// Each tile, with B and C held transposed in shared memory as fp32:
//   1. M[t, j] = (C_t . B_j) exp(L_t - L_j) dt_j for j <= t: 4 x 4 outputs
//      a thread from float4 reads (the blocks above the diagonal idle);
//   2. y_t = sum_{j<=t} M[t, j] x_j + exp(L_t) C_t . h_in + D x_t;
//   3. h = exp(L_last) h + sum_j exp(L_last - L_j) dt_j B_j (x) x_j.
//
// Bound on the H100, main path (b 1, s 512, h 24, p 64, n 128, bf16): it
// reads x, B, C, dt and writes y and the state once, about 4.2 MB, 1.3 us
// at 3.35 TB/s. The chunked algorithm's products (0.6 GFLOP at chunk 256,
// causal pairs only) take less than that on the bf16 tensor cores, but
// about 9 us on the fp32 CUDA cores this kernel uses, and it recomputes
// C . B^T in every head and every p slice (a 96x redundancy at the main
// path's shape). Tensor cores (mma.sync / wgmma), TMA and one C . B^T per
// (batch, tile) shared across heads are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kT = 64;          // steps per tile
constexpr int kPS = 16;         // columns of p per block
constexpr int kLd = kT + 4;     // row stride of the transposed B, C and M
constexpr int kThreads = 256;

__host__ __device__ constexpr int ssd_smem_floats(int n) {
  return 2 * n * kLd + kT * kLd + kT * kPS + n * kPS + 4 * kT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ state, int s, int h,
                int p, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ct = smem;                    // [n][kLd], C of the tile, transposed
  float* Bt = Ct + n * kLd;            // [n][kLd]
  float* Ms = Bt + n * kLd;            // [kT][kLd]
  float* xs = Ms + kT * kLd;           // [kT][kPS]
  float* hs = xs + kT * kPS;           // [n][kPS], the carried state
  float* Ls = hs + n * kPS;            // [kT] cumsum of dt * A
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
    for (int i = tid; i < kT * n; i += kThreads) {
      const int t = i / n, nn = i - t * n;
      const bool ok = t0 + t < s;
      const size_t g = (static_cast<size_t>(bi) * s + t0 + t) * n + nn;
      Bt[nn * kLd + t] = ok ? to_f32(B[g]) : 0.f;
      Ct[nn * kLd + t] = ok ? to_f32(C[g]) : 0.f;
    }
    for (int i = tid; i < kT * kPS; i += kThreads) {
      const int t = i / kPS, pp = i - t * kPS;
      const bool ok = t0 + t < s && p0 + pp < p;
      xs[i] = ok ? to_f32(x[(static_cast<size_t>(bi) * s + t0 + t) * row_x +
                            static_cast<size_t>(hi) * p + p0 + pp])
                 : 0.f;
    }
    __syncthreads();

    // --- 2. M[t, j] = (C_t . B_j) exp(L_t - L_j) dt_j, j <= t -------------
    {
      const int ti = tid / 16, tj = tid % 16;
      if (tj <= ti) {
        float acc[4][4] = {};
        for (int nn = 0; nn < n; ++nn) {
          const float4 cv = *reinterpret_cast<const float4*>(
              Ct + nn * kLd + ti * 4);
          const float4 bv = *reinterpret_cast<const float4*>(
              Bt + nn * kLd + tj * 4);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += c4[r] * b4[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = ti * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tj * 4 + c;
            if (j <= t)
              Ms[t * kLd + j] = acc[r][c] * expf(Ls[t] - Ls[j]) * dts[j];
          }
        }
      }
    }
    __syncthreads();

    // --- 3. y_t = sum_{j<=t} M[t, j] x_j + exp(L_t) C_t . h_in + D x_t ----
    {
      const int pp = tid % kPS, tg = tid / kPS;
      for (int t = tg; t < kT; t += kThreads / kPS) {
        if (t0 + t >= s || p0 + pp >= p) continue;
        float intra = 0.f;
        for (int j = 0; j <= t; ++j) intra += Ms[t * kLd + j] * xs[j * kPS + pp];
        float inter = 0.f;
        for (int nn = 0; nn < n; ++nn)
          inter += Ct[nn * kLd + t] * hs[nn * kPS + pp];
        const float yv = (intra + eL[t] * inter) + xs[t * kPS + pp] * d_skip;
        y[(static_cast<size_t>(bi) * s + t0 + t) * row_x +
          static_cast<size_t>(hi) * p + p0 + pp] = from_f32<T>(yv);
      }
    }
    __syncthreads();

    // --- 4. h = exp(L_last) h + sum_j exp(L_last - L_j) dt_j B_j (x) x_j --
    {
      const int pp = tid % kPS, ng = tid / kPS;
      const float a_last = eL[kT - 1];
      for (int nn = ng; nn < n; nn += kThreads / kPS) {
        float g = 0.f;
        for (int j = 0; j < kT; ++j)
          g += ws[j] * Bt[nn * kLd + j] * xs[j * kPS + pp];
        hs[nn * kPS + pp] = a_last * hs[nn * kPS + pp] + g;
      }
    }
    __syncthreads();
  }

  // final state, (b, h, p, n) fp32
  for (int i = tid; i < kPS * n; i += kThreads) {
    const int pp = i / n, nn = i - pp * n;
    if (p0 + pp < p)
      state[((static_cast<size_t>(bi) * h + hi) * p + p0 + pp) * n + nn] =
          hs[nn * kPS + pp];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* state, int b, int s, int h, int p, int n,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ssd_smem_floats(n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kPS - 1) / kPS, h, b);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, static_cast<T*>(y), state, s, h, p, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, y: (b, s, h, p) and B, C: (b, s, n) in float32 or bfloat16 (dtype);
// dt: (b, s, h), A, D: (h,), state: (b, h, p, n), all float32; contiguous.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* D,
                              void* y, void* state, int b, int s, int h,
                              int p, int n, int dtype, void* stream) {
  using namespace repro;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || n > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float>(x, dtf, Af, B, C, Df, y, sf, b, s, h, p, n, st);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(x, dtf, Af, B, C, Df, y, sf, b, s, h, p, n,
                                st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
