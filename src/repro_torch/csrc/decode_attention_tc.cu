// Decode attention in bf16 at the padded head dim 256 on the tensor cores:
// q (b, hq, d), k/v (b, skv, hkv, d), length (b,) int32 -> o (b, hq, d),
// for d 168-256 a multiple of 8 (decode_mma_route; gemma-2b's 8/1 at d 256).
//
// Replaces, at those shapes, the TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (_dec_kernel), as
// decode_attention.cu's decode_split_kernel does at every other shape: one
// query token a q head against the cache rows below length[b], the kv head
// of q head h being h / (hq / hkv).
//
// Bound on the H100: memory bytes (each K and V row below length read once
// for all the q heads that share it; a fraction of a flop a byte). At 4
// slots, one kv head and a cache of a few hundred rows the call moves under
// 2 MB, so what holds it back is latency: blocks in flight, and the serial
// work of each. decode_split_kernel formed the scores with one thread a
// (row, head group), about 2048 serial FMAs a thread a tile at D 256, and
// ran 48 blocks on 132 SMs there.
//
// Design: split-KV flash-decode in one launch, as decode_split_kernel's.
// * Grid (splits, hkv x slices, b), 256 threads (eight warps) a block:
//   block (s, (h, slice), b) takes the cache rows of split s of kv head h
//   for the slice's G <= 16 q heads (a group above 16 in ceil(G / 16)
//   slices). The splits follow from skv and the number of (b, kv head,
//   slice) units alone (decode_mma_split_rows: about kDecodeMmaBlocks
//   blocks, in tiles of 64 rows, at most 32 splits, at least 64 rows a
//   split), never from `length`, so the
//   launch reads nothing back and a CUDA graph can hold it. Each block
//   clamps its own length[b] to [0, skv] and reads no row at or past it.
// * The slice's q heads are the 16 rows of the A operand of mma.sync
//   m16n8k16 (bf16 in, fp32 sums; rows past G and columns past d zero),
//   loaded once into registers. K and V tiles of 64 rows come in by
//   cp.async into rows padded by 16 bytes (ldmatrix reads them without
//   bank conflicts), rows at or past length and columns past d zero-filled
//   (nothing is read for them), two tiles in flight when a split has more.
// * Scores: S = Q K^T over the tile, the eight warps eight rows each; rows
//   at or past length take kNegInf. The max and the sum of each head over
//   the tile are exchanged through shared memory, so every warp keeps the
//   same running max and sum. P = exp2(S scale log2 e - max) is rounded to
//   bf16 (as the wgmma flash kernels round P) into shared memory.
// * P.V on the tensor cores: each warp owns 32 of the 256 output columns
//   for all 16 heads over all the tile's rows (V read with ldmatrix .trans),
//   16 fp32 accumulators a thread. Eight warps and 64-row tiles beat four
//   warps and 32-row tiles at 8/1 d 256 (4 slots, cache 740; PERF.md §6):
//   twice the loads in flight a block, and twice the threads in the
//   combine.
// * Combine in the same launch, with decode_attention.cu's counter protocol:
//   each block writes its fp32 partial (m, l, acc[G][d], unnormalised),
//   fences and counts itself on its unit's counter; the last sets it back to
//   0 and combines the splits below ceil(length / split_rows). The weights
//   of all (head, split) pairs are formed at once (16 threads a head),
//   then the output spread over (head, four columns), each thread summing
//   its items together so that their 16-byte loads of a split's partial
//   are in flight at once. Partial mode writes each head's log-sum-exp, -inf at length 0.
//
// Departure from the Pallas kernel: P.V multiplies P rounded to bf16 (the
// Pallas kernel keeps P in fp32); the sums are fp32.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace decode_tc {
namespace {

using bf16 = __nv_bfloat16;
constexpr int D = 256;                  // the padded head dim
constexpr int kTile = kDecodeMmaTile;   // cache rows a tile
constexpr int kWarps = kTile / 8;       // each scores 8 rows of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 16;              // the mma's M: q heads a slice
constexpr int kMaxSplits = 32;          // the combine: one split a lane
constexpr int LDS = D + 8;              // smem row of Q, K and V (+16 bytes)
constexpr int LDP = kTile + 8;          // smem row of P (+16 bytes)
constexpr int kStageElems = 2 * kTile * LDS;    // a K and a V tile
constexpr int kColsPerWarp = D / kWarps;        // P.V's output columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kTile % 16 == 0, "P.V's k steps");
constexpr int kTph = kThreads / kHeads;       // the combine's threads a head
constexpr int kSpt = kMaxSplits / kTph;       // and splits a thread
static_assert(kTph * kHeads == kThreads && kTph <= 32, "combine threads");
constexpr int kItems = kHeads * D / 4 / kThreads;   // combine items a thread

size_t smem_bytes(int stages) {
  return sizeof(bf16) * (static_cast<size_t>(stages) * kStageElems +
                         kHeads * LDS + kHeads * LDP) +
         sizeof(float) * 2 * kWarps * kHeads;
}

// Rows [r0, r0 + kTile) of K and V into one stage (kTile x LDS each), one
// cp.async commit group each, so the scores can start while V is on its
// way; rows at or past row_end and chunks past d (cd chunks) come in as
// zeros, reading nothing.
__device__ __forceinline__ void load_tile(bf16* stage, const bf16* kb,
                                          const bf16* vb, int r0,
                                          int row_end, size_t row_stride,
                                          int cd) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    bf16* dst = stage + part * kTile * LDS;
    const bf16* src = part ? vb : kb;
#pragma unroll
    for (int i = 0; i < kTile * (D / 8) / kThreads; ++i) {
      const int c = static_cast<int>(threadIdx.x) + i * kThreads;
      const int r = c / (D / 8), cc = c % (D / 8);
      const bool ok = r0 + r < row_end && cc < cd;
      cp_async16_zfill(dst + r * LDS + cc * 8,
                       src + (ok ? (r0 + r) * row_stride + cc * 8 : 0), ok);
    }
    cp_async_commit();
  }
}

// Max and sum over the kTph threads of a head in the combine.
__device__ __forceinline__ float head_max(float v) {
#pragma unroll
  for (int off = 1; off < kTph; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int off = 1; off < kTph; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, kWarps <= 4 ? 2 : 1)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ length,
                  bf16* __restrict__ o, float* __restrict__ lse,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int* __restrict__ counter, int skv, int hq, int hkv, int d,
                  int splits, int split_rows, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = split_rows > kTile ? 2 : 1;
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [stages][K, V][kTile][LDS]
  bf16* q_sm = tiles + stages * kStageElems;        // [kHeads][LDS]
  bf16* p_sm = q_sm + kHeads * LDS;                 // [kHeads][LDP]
  float* red_m = reinterpret_cast<float*>(p_sm + kHeads * LDP);  // [warp][head]
  float* red_l = red_m + kWarps * kHeads;
  __shared__ int is_last;

  const int g_all = hq / hkv;
  const int gs = (g_all + kHeads - 1) / kHeads;     // q-head slices
  const int kvh = blockIdx.y / gs, slice = blockIdx.y - kvh * gs;
  const int G = min(kHeads, g_all - slice * kHeads);
  const int GS = min(kHeads, g_all);                // the partials' stride
  const int h0 = kvh * g_all + slice * kHeads;
  const int split = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, qd = lane & 3;  // the fragments' row and pair
  const int len = min(max(length[b], 0), skv);
  const int row0 = split * split_rows;
  const int unit = b * hkv * gs + blockIdx.y;       // (b, kv head, slice)
  const int pidx = unit * splits + split;
  const int cd = d / 8;                             // 16-byte chunks of d
  const int nk = (d + 15) / 16;                     // k steps over d
  const size_t row_stride = static_cast<size_t>(hkv) * d;
  const bf16* kb = k + static_cast<size_t>(b) * skv * row_stride +
                   static_cast<size_t>(kvh) * d;
  const bf16* vb = v + static_cast<size_t>(b) * skv * row_stride +
                   static_cast<size_t>(kvh) * d;

  if (row0 < len) {
    const int row_end = min(len, row0 + split_rows);
    const int ntiles = (row_end - row0 + kTile - 1) / kTile;
    // Q: the slice's G heads, rows past G and chunks past d zero; in the
    // commit group of tile 0's K.
    const bf16* qb = q + (static_cast<size_t>(b) * hq + h0) * d;
#pragma unroll
    for (int i = 0; i < kHeads * (D / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int h = c / (D / 8), cc = c % (D / 8);
      const bool ok = h < G && cc < cd;
      cp_async16_zfill(q_sm + h * LDS + cc * 8,
                       qb + (ok ? static_cast<size_t>(h) * d + cc * 8 : 0),
                       ok);
    }
    load_tile(tiles, kb, vb, row0, row_end, row_stride, cd);

    // Running max (log2 units) and sum of heads gq and gq + 8, the same in
    // every warp; this warp's kColsPerWarp output columns as n8 tiles.
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float acc[kColsPerWarp / 8][4];
#pragma unroll
    for (int j = 0; j < kColsPerWarp / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    uint32_t qf[D / 16][4];     // Q's A fragments, one a k step

    for (int t = 0; t < ntiles; ++t) {
      // Two stages where a split has more than one tile: tile t + 1 loads
      // while t computes; one: tile t loads after t - 1's last barrier.
      const int stage = stages == 2 ? t & 1 : 0;
      const bool ahead = stages == 2 && t + 1 < ntiles;
      if (stages == 1 && t > 0)
        load_tile(tiles, kb, vb, row0 + t * kTile, row_end, row_stride, cd);
      if (ahead)
        load_tile(tiles + (stage ^ 1) * kStageElems, kb, vb,
                  row0 + (t + 1) * kTile, row_end, row_stride, cd);
      // Pending groups, oldest first: K(t), V(t) [, K(t + 1), V(t + 1)].
      if (ahead) cp_async_wait<3>(); else cp_async_wait<1>();
      __syncthreads();  // K of tile t (and Q) visible to all
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], q_sm + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS +
                              16 * kk + 8 * (lane >> 4));
      }
      const bf16* ks = tiles + stage * kStageElems;
      const bf16* vs = ks + kTile * LDS;
      const int nr = min(kTile, row_end - (row0 + t * kTile));

      // S (16 heads x this warp's 8 rows): s[0..1] head gq, rows r_t and
      // r_t + 1; s[2..3] head gq + 8.
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* krow =
          ks + (8 * warp + (lane & 7)) * LDS + 8 * (lane >> 3);
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        if (kk < nk) {
          uint32_t bk[4];   // k steps kk and kk + 1 of the warp's 8 rows
          ldsm_x4(bk, krow + 16 * kk);
          mma_bf16(s, qf[kk], bk[0], bk[1]);
          if (kk + 1 < nk) mma_bf16(s, qf[kk + 1], bk[2], bk[3]);
        }
      }
      const int r_t = 8 * warp + 2 * qd;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = r_t + (e & 1) < nr ? s[e] * scale_log2 : kNegInf;
      float mx0 = quad_max(fmaxf(s[0], s[1]));
      float mx1 = quad_max(fmaxf(s[2], s[3]));
      if (qd == 0) {
        red_m[warp * kHeads + gq] = mx0;
        red_m[warp * kHeads + gq + 8] = mx1;
      }
      __syncthreads();  // every warp's max
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mx0 = fmaxf(mx0, red_m[w * kHeads + gq]);
        mx1 = fmaxf(mx1, red_m[w * kHeads + gq + 8]);
      }
      const float m0 = fmaxf(m_run[0], mx0), m1 = fmaxf(m_run[1], mx1);
      s[0] = exp2f(s[0] - m0);
      s[1] = exp2f(s[1] - m0);
      s[2] = exp2f(s[2] - m1);
      s[3] = exp2f(s[3] - m1);
      const float sum0 = quad_sum(s[0] + s[1]), sum1 = quad_sum(s[2] + s[3]);
      if (qd == 0) {
        red_l[warp * kHeads + gq] = sum0;
        red_l[warp * kHeads + gq + 8] = sum1;
      }
      *reinterpret_cast<uint32_t*>(p_sm + gq * LDP + r_t) = pack_bf16(s[0], s[1]);
      *reinterpret_cast<uint32_t*>(p_sm + (gq + 8) * LDP + r_t) =
          pack_bf16(s[2], s[3]);
      if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();
      __syncthreads();  // P, the sums and V of tile t visible to all
      float tl0 = 0.f, tl1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        tl0 += red_l[w * kHeads + gq];
        tl1 += red_l[w * kHeads + gq + 8];
      }
      const float a0 = exp2f(m_run[0] - m0), a1 = exp2f(m_run[1] - m1);
      l_run[0] = l_run[0] * a0 + tl0;
      l_run[1] = l_run[1] * a1 + tl1;
      m_run[0] = m0;
      m_run[1] = m1;

      // P.V: this warp's kColsPerWarp columns, k steps of 16 tile rows.
#pragma unroll
      for (int j = 0; j < kColsPerWarp / 8; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
      const int c_w = kColsPerWarp * warp;
#pragma unroll
      for (int kr = 0; kr < kTile / 16; ++kr) {
        uint32_t pa[4];
        ldsm_x4(pa, p_sm + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDP +
                        16 * kr + 8 * (lane >> 4));
        const bf16* vrow =
            vs + (16 * kr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + c_w +
            8 * (lane >> 4);
#pragma unroll
        for (int j = 0; j < kColsPerWarp / 8; j += 2) {
          if (c_w + 8 * j < d) {
            uint32_t bv[4];   // n tiles j and j + 1
            ldsm_x4_t(bv, vrow + 8 * j);
            mma_bf16(acc[j], pa, bv[0], bv[1]);
            mma_bf16(acc[j + 1], pa, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // this stage, P and the exchanges are free again
    }

    // The partial: heads below G, columns below d.
    float* pa = part_acc + static_cast<size_t>(pidx) * GS * D;
#pragma unroll
    for (int j = 0; j < kColsPerWarp / 8; ++j) {
      const int col = kColsPerWarp * warp + 8 * j + 2 * qd;
      if (col >= d) continue;
      if (gq < G)
        *reinterpret_cast<float2*>(pa + gq * D + col) =
            make_float2(acc[j][0], acc[j][1]);
      if (gq + 8 < G)
        *reinterpret_cast<float2*>(pa + (gq + 8) * D + col) =
            make_float2(acc[j][2], acc[j][3]);
    }
    if (warp == 0 && qd == 0) {
      if (gq < G) {
        part_ml[(pidx * GS + gq) * 2] = m_run[0];
        part_ml[(pidx * GS + gq) * 2 + 1] = l_run[0];
      }
      if (gq + 8 < G) {
        part_ml[(pidx * GS + gq + 8) * 2] = m_run[1];
        part_ml[(pidx * GS + gq + 8) * 2 + 1] = l_run[1];
      }
    }
  }

  // The combine: the last block of the unit to count itself.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counter + unit;
    const int prev = atomicAdd(cnt, 1);
    is_last = prev == splits - 1;
    if (is_last) *cnt = 0;  // every split has counted: reset for the next
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const int base = unit * splits;
  const int nvalid = (len + split_rows - 1) / split_rows;
  float* w_sm = reinterpret_cast<float*>(smem_raw);   // [split][kHeads]
  {
    // kTph threads a head, each over splits sub, sub + kTph, ...
    const int g = tid / kTph, sub = tid % kTph;
    float ms[kSpt], ls[kSpt];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
      const int sp = sub + kTph * i;
      const bool ok = g < G && sp < nvalid;
      const float* ml = part_ml + ((base + sp) * GS + g) * 2;
      ms[i] = ok ? __ldcg(ml) : kNegInf;
      ls[i] = ok ? __ldcg(ml + 1) : 0.f;
      mx = fmaxf(mx, ms[i]);
    }
    mx = head_max(mx);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
      ms[i] = sub + kTph * i < nvalid ? exp2f(ms[i] - mx) : 0.f;
      l += ls[i] * ms[i];
    }
    l = head_sum(l);
#pragma unroll
    for (int i = 0; i < kSpt; ++i) {
      const int sp = sub + kTph * i;
      if (g < G && sp < nvalid)
        w_sm[sp * kHeads + g] = ms[i] / (l == 0.f ? 1.f : l);
    }
    if (lse != nullptr && sub == 0 && g < G)
      lse[static_cast<size_t>(b) * hq + h0 + g] =
          l == 0.f ? __int_as_float(0xff800000) : (mx + log2f(l)) * kLn2;
  }
  __syncthreads();
  // The output: item i is head i / (d / 4), four columns; a thread's items
  // (at most kItems) are summed together, so each split's kItems 16-byte
  // loads are in flight at once.
  const int c4 = d / 4, n_items = G * c4;
  int off[kItems], head[kItems];
  float4 sum[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    head[j] = i < n_items ? i / c4 : 0;
    off[j] = head[j] * D + 4 * (i - head[j] * c4);
    sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* acc0 = part_acc + static_cast<size_t>(base) * GS * D;
#pragma unroll 2
  for (int sp = 0; sp < nvalid; ++sp) {
    const float* src = acc0 + static_cast<size_t>(sp) * GS * D;
    float4 a[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (tid + j * kThreads < n_items)
        a[j] = __ldcg(reinterpret_cast<const float4*>(src + off[j]));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (tid + j * kThreads < n_items) {
        const float w = w_sm[sp * kHeads + head[j]];
        sum[j].x += a[j].x * w;
        sum[j].y += a[j].y * w;
        sum[j].z += a[j].z * w;
        sum[j].w += a[j].w * w;
      }
    }
  }
  bf16* ob = o + (static_cast<size_t>(b) * hq + h0) * d;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    if (i < n_items) {
      uint2 packed;
      packed.x = pack_bf16(sum[j].x, sum[j].y);
      packed.y = pack_bf16(sum[j].z, sum[j].w);
      *reinterpret_cast<uint2*>(ob + static_cast<size_t>(head[j]) * d +
                                (off[j] - head[j] * D)) = packed;
    }
  }
}

}  // namespace

// With G = hq / hkv, gs = ceil(G / 16) slices of GS = min(G, 16) q heads:
// part_ml (b, hkv, gs, splits, GS, 2) and part_acc (b, hkv, gs, splits, GS,
// 256) fp32 scratch, part_acc 16-byte aligned, splits = ceil(skv /
// split_rows); counter b * hkv * gs int32, zero on entry and left zero.
// split_rows must be decode_mma_split_rows(skv, b * hkv * gs); d must hold
// decode_mma_route. Any failure is returned.
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, float* lse, float* part_ml, float* part_acc, int* counter,
           int b, int skv, int hq, int hkv, int d, int split_rows,
           float scale, cudaStream_t stream) {
  const int g = hq / hkv, gs = (g + kHeads - 1) / kHeads;
  if (g < 1 || !decode_mma_route(d) ||
      split_rows != decode_mma_split_rows(skv, b * hkv * gs) ||
      reinterpret_cast<uintptr_t>(part_acc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (skv + split_rows - 1) / split_rows;
  if (splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(split_rows > kTile ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(2)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, hkv * gs, b);
  decode_mma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), length, static_cast<bf16*>(o), lse,
      part_ml, part_acc, counter, skv, hq, hkv, d, splits, split_rows,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_tc
}  // namespace repro
