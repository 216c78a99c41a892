// W8A8 matmul: out[m, n] = (float(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]
// with int8 operands, an exact int32 sum over k, and the epilogue in fp32
// in the reference's order (ref.int8_matmul_ref), stored as float32 or
// bfloat16.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py::int8_matmul
// (_mm_kernel), which accumulates 128 x 128 output blocks over K blocks of
// 512 in an int32 VMEM scratch and needs m, n, k divisible by its blocks.
// This kernel takes any m, k, n: the ragged edges load as zeros, which add
// nothing to an int32 sum.
//
// Bound on the H100: bytes. At 333 x 2048 x 8192 (an MLP up projection of
// a 333-token prefill) the 23 MB of operands and bf16 output take 6.85 us
// at 3.35 TB/s (8.5 us with a float32 output), the 11 GOP 5.6 us at the
// 1979 TOP/s of the int8 tensor cores; at 512 x 1024 x 512, 0.47 us of
// bytes (bf16 out) against 0.27 us of operations. Design:
// * The products run on the int8 tensor cores: wgmma m64nNk32 s8 from two
//   shared-memory descriptors, one warpgroup for each 64 rows of the
//   output tile, N = 128 or 64 columns, the int32 sum in registers. int32
//   sums are exact in any order, so the result is the reference's bit for
//   bit.
// * Output tiles of 192 x 128, 128 x 128, 64 x 128 or 64 x 64; the wrapper
//   (kernels/int8_matmul.py::plan) takes the largest that keeps half the
//   SMs busy. At 333 x 2048 x 8192, 192 x 128 gives one wave of 128 blocks
//   (128 x 128: two waves of 192), and the larger the tile, the fewer bytes
//   cross from L2 for each product, which is what holds the kernel back.
// * k advances 128 bytes a stage (one row of the 128-byte swizzle) through
//   a ring of 4-5 stages in shared memory, filled by 16-byte cp.async: a
//   stage is issued kStages - 1 iterations before its product. One barrier
//   an iteration.
// * The layout of W: wgmma reads 8-bit operands K-major only, and w_q is
//   (k, n) row-major, N-major. W arrives N-major in the ring, with its
//   16-byte chunks swizzled by k row; one iteration before its product,
//   each thread loads 4 k rows x 16 columns from it, transposes every
//   4 x 4 bytes in registers with 8 byte permutes (prmt), and stores 16
//   words of 4 k, one column each, into the K-major swizzled tile wgmma
//   reads. The 32 lanes of a warp store one 128-byte row, one bank each,
//   and load on distinct banks. This runs while the tensor cores multiply
//   the stage before.
// * Two load routines feed the same loop: 16-byte cp.async when k and n
//   are multiples of 16 and both operands are 16-byte aligned, else masked
//   byte loads stored at once (the wrapper picks).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kBK = 128;      // k bytes a stage: one 128-byte swizzle row

// Offset of 16-byte chunk c of row r in a tile of 128-byte rows with the
// 128-byte swizzle (TMA's SWIZZLE_128B, what desc_sw128 describes): within
// each 1024-byte atom of 8 rows, chunk c of row r sits at c ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Orders this thread's generic-proxy writes to shared memory (stores,
// completed cp.async) before later reads by the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D (64 x 128, s32) += A (64 x 32, s8, smem, K-major) * B (128 x 32, s8,
// smem, K-major)^T.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 64, s32) += A (64 x 32, s8, smem, K-major) * B (64 x 32, s8,
// smem, K-major)^T.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// r0..r3 hold the bytes of columns n..n+3 of k rows 0..3; o[j] gets the
// bytes of k rows 0..3 of column n + j.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// 16 bytes at p, the bytes at or past `valid` read as 0.
__device__ __forceinline__ uint4 load_bytes(const int8_t* p, int valid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < valid)
      w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + b)))
                  << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

// Shared memory of a tile: 1024 bytes of slack to align the swizzle atoms,
// a ring of STAGES stages of X (BM rows of 128 k bytes) and of W as loaded
// (128 k rows of BN bytes), then two stages of W transposed (BN rows of 128
// k bytes).
template <int BM, int BN, int STAGES>
constexpr int smem_bytes() {
  return 1024 + STAGES * (BM + BN) * kBK + 2 * BN * kBK;
}

// Block tile BM = 64 * WGS rows x BN columns; warpgroup g owns rows
// 64 g .. 64 g + 63 and all BN columns. kVec: 16-byte cp.async loads
// (k % 16 == 0, n % 16 == 0, aligned operands), else masked byte loads
// stored at once.
template <int WGS, int BN, int STAGES, bool kVec, typename T>
__global__ void __launch_bounds__(WGS * 128)
int8_wgmma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const int8_t* __restrict__ wq, const float* __restrict__ sw,
                  T* __restrict__ out, int m, int k, int n) {
  constexpr int BM = 64 * WGS, kThreads = WGS * 128;
  constexpr int kC = BN / 16;                          // 16-byte chunks of n
  // Work items a stage, and each thread's share (the last may be short).
  constexpr int kXItems = BM * (kBK / 16), kWItems = kBK * kC;
  constexpr int kTItems = (kBK / 4) * kC;                // 4 k x 16 n each
  constexpr int kXChunks = (kXItems + kThreads - 1) / kThreads;
  constexpr int kWChunks = (kWItems + kThreads - 1) / kThreads;
  constexpr int kTGroups = (kTItems + kThreads - 1) / kThreads;
  constexpr int kStages = STAGES;
  static_assert(kStages >= 3, "the ring needs 3 stages");
  static_assert(BN == 64 || BN == 128, "wgmma width");
  constexpr int kXBytes = BM * kBK, kWBytes = kBK * BN, kWtBytes = BN * kBK;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const xs0 =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const wr0 = xs0 + kStages * kXBytes;
  uint8_t* const wt0 = wr0 + kStages * kWBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (k + kBK - 1) / kBK;

  // Stage j (k bytes 128 j ..) into ring slot j % kStages, one commit
  // group a stage (empty past the last). X goes to the 128-byte swizzle
  // that wgmma reads; W's 16-byte chunk c of k row r to chunk
  // c ^ ((r / 4) % kC), so the transpose's 8 lanes of a shared load
  // (k rows 4 kw + q, kw = 8 p .. 8 p + 7) fall on distinct banks.
  auto issue = [&](int j) {
    if (j < nk) {
      const int k0 = j * kBK;
      uint8_t* xs = xs0 + (j % kStages) * kXBytes;
      uint8_t* wr = wr0 + (j % kStages) * kWBytes;
#pragma unroll
      for (int i = 0; i < kXChunks; ++i) {
        const int q = tid + i * kThreads;
        if (kXItems % kThreads && q >= kXItems) break;
        const int row = q / (kBK / 16), c = q % (kBK / 16);
        const int gm = m0 + row, gk = k0 + c * 16;
        const int8_t* src = xq + static_cast<size_t>(gm) * k + gk;
        uint8_t* dst = xs + sw128(row, c);
        if constexpr (kVec) {
          const bool ok = gm < m && gk < k;
          cp_async16_zfill(dst, ok ? src : xq, ok);
        } else {
          *reinterpret_cast<uint4*>(dst) =
              load_bytes(src, gm < m ? k - gk : 0);
        }
      }
#pragma unroll
      for (int i = 0; i < kWChunks; ++i) {
        const int q = tid + i * kThreads;
        if (kWItems % kThreads && q >= kWItems) break;
        const int r = q / kC, c = q % kC;
        const int gk = k0 + r, gn = n0 + c * 16;
        const int8_t* src = wq + static_cast<size_t>(gk) * n + gn;
        uint8_t* dst = wr + r * BN + ((c ^ ((r >> 2) & (kC - 1))) << 4);
        if constexpr (kVec) {
          const bool ok = gk < k && gn < n;
          cp_async16_zfill(dst, ok ? src : wq, ok);
        } else {
          *reinterpret_cast<uint4*>(dst) =
              load_bytes(src, gk < k ? n - gn : 0);
        }
      }
    }
    cp_async_commit();
  };

  // W of stage j, N-major, into transposed slot j % 2 (K-major, swizzled):
  // each thread takes k rows 4 kw .. 4 kw + 3 of columns 16 nc ..
  // 16 nc + 15 (four 16-byte shared loads), turns every 4 x 4 bytes with 8
  // byte permutes and stores 16 words of 4 k, one column each; the 32 lanes
  // of a warp (32 consecutive kw) fill one 128-byte row, one bank each.
  auto transpose = [&](int j) {
    const uint8_t* wr = wr0 + (j % kStages) * kWBytes;
    uint8_t* wt = wt0 + (j % 2) * kWtBytes;
#pragma unroll
    for (int i = 0; i < kTGroups; ++i) {
      const int q = tid + i * kThreads;
      if (kTItems % kThreads && q >= kTItems) break;
      const int kw = q % (kBK / 4), nc = q / (kBK / 4);
      uint32_t r[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            wr + (4 * kw + rr) * BN + ((nc ^ (kw & (kC - 1))) << 4));
        r[rr][0] = v.x; r[rr][1] = v.y; r[rr][2] = v.z; r[rr][3] = v.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t o[4];
        transpose4x4(r[0][jj], r[1][jj], r[2][jj], r[3][jj], o);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint32_t*>(wt + sw128(16 * nc + 4 * jj + c,
                                                  kw >> 2) +
                                       (kw & 3) * 4) = o[c];
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // Stage j is issued kStages - 1 iterations ahead, transposed one ahead,
  // and multiplied at iteration j while stage j + 1 is transposed and stage
  // j + kStages - 1 issued. One barrier an iteration; at its end, stages up
  // to j + 2 have landed.
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  cp_async_wait<kStages - 3>();
  __syncthreads();
  transpose(0);
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const uint8_t* xs = xs0 + (kt % kStages) * kXBytes + wg * 64 * kBK;
    const uint8_t* wt = wt0 + (kt % 2) * kWtBytes;
    const uint64_t da = desc_sw128(xs, 16, 1024);
    const uint64_t db = desc_sw128(wt, 16, 1024);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)   // 32 k bytes: +2 in 16 B units
      wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    // While the tensor cores multiply. (ptxas 12.9 crashes on a cp.async
    // wait or a proxy fence between a wgmma's commit and its wait.)
    if (kt + 1 < nk) transpose(kt + 1);
    issue(kt + kStages - 1);
    wgmma_wait<0>();
    fence_acc(acc);
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    __syncthreads();
  }

  // Epilogue, the accumulator layout of wgmma m64nN: warp w of the
  // warpgroup holds rows 16 w + g and 16 w + g + 8, columns 8 i + 2 t and
  // 8 i + 2 t + 1 in acc[4 i .. 4 i + 3].
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + wg * 64 + (warp % 4) * 16 + g + 8 * h;
    if (gm >= m) continue;
    const float rs = sx[gm];
    T* orow = out + static_cast<size_t>(gm) * n;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int gn = n0 + 8 * i + 2 * t4;
      const int a0 = acc[4 * i + 2 * h], a1 = acc[4 * i + 2 * h + 1];
      // (acc * sx) * sw, each product rounded to fp32: the reference's order
      if constexpr (kVec) {   // n % 16 == 0: both columns or neither
        if (gn < n)
          store_pair(orow + gn,
                     __fmul_rn(__fmul_rn(__int2float_rn(a0), rs), sw[gn]),
                     __fmul_rn(__fmul_rn(__int2float_rn(a1), rs), sw[gn + 1]));
      } else {
        if (gn < n)
          orow[gn] = from_f32<T>(
              __fmul_rn(__fmul_rn(__int2float_rn(a0), rs), sw[gn]));
        if (gn + 1 < n)
          orow[gn + 1] = from_f32<T>(
              __fmul_rn(__fmul_rn(__int2float_rn(a1), rs), sw[gn + 1]));
      }
    }
  }
}

template <int WGS, int BN, int STAGES, typename T>
cudaError_t launch(const int8_t* xq, const float* sx, const int8_t* wq,
                   const float* sw, T* out, int m, int k, int n, bool vec,
                   cudaStream_t st) {
  constexpr int BM = 64 * WGS;
  constexpr int kSmem = smem_bytes<BM, BN, STAGES>();
  auto kern = vec ? int8_wgmma_kernel<WGS, BN, STAGES, true, T>
                  : int8_wgmma_kernel<WGS, BN, STAGES, false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, WGS * 128, kSmem, st>>>(xq, sx, wq, sw, out, m, k, n);
  return cudaGetLastError();
}

// tile: the index into kernels/int8_matmul.py TILES.
template <typename T>
cudaError_t dispatch(const int8_t* xq, const float* sx, const int8_t* wq,
                     const float* sw, T* out, int m, int k, int n, bool vec,
                     int tile, cudaStream_t st) {
  switch (tile) {
    case 0: return launch<3, 128, 4, T>(xq, sx, wq, sw, out, m, k, n, vec, st);
    case 1: return launch<2, 128, 5, T>(xq, sx, wq, sw, out, m, k, n, vec, st);
    case 2: return launch<1, 128, 5, T>(xq, sx, wq, sw, out, m, k, n, vec, st);
    case 3: return launch<1, 64, 5, T>(xq, sx, wq, sw, out, m, k, n, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// x_q: (m, k) int8, sx: (m,) f32, w_q: (k, n) int8, sw: (n,) f32,
// out: (m, n) float32 or bfloat16 (out_dtype); all contiguous. vec, tile:
// the plan of kernels/int8_matmul.py::plan; vec needs k and n multiples of
// 16 and x_q, w_q 16-byte aligned.
extern "C" int repro_int8_matmul(const void* xq, const void* sx,
                                 const void* wq, const void* sw, void* out,
                                 int m, int k, int n, int out_dtype, int vec,
                                 int tile, void* stream) {
  using namespace repro;
  if (m <= 0 || k <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (k % 16 || n % 16 || reinterpret_cast<uintptr_t>(xq) % 16 ||
              reinterpret_cast<uintptr_t>(wq) % 16 ||
              reinterpret_cast<uintptr_t>(out) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  cudaError_t err;
  if (out_dtype == kF32)
    err = dispatch(x8, sxf, w8, swf, static_cast<float*>(out), m, k, n,
                   vec != 0, tile, st);
  else if (out_dtype == kBF16)
    err = dispatch(x8, sxf, w8, swf, static_cast<__nv_bfloat16*>(out), m, k,
                   n, vec != 0, tile, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
