// Decode attention: one query token per (batch, q head) against a KV cache,
// q (b, hq, d), k/v (b, skv, hkv, d), length (b,) int32 -> o (b, hq, d).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (_dec_kernel), which walks kv blocks of 256 in order with the valid
// length brought in by scalar prefetch, skips blocks at or past it and
// masks the positions past it.
//
// Bound on the H100: memory bytes. Every K and V element below length[b]
// is read once for two multiply-adds per query head that shares it, so
// the work is a fraction of a flop per byte; at 4 slots and a few hundred
// rows each the cache of one layer is ~2 MB, so the card is short of
// blocks in flight before it is short of bandwidth.
//
// Design: split-KV flash-decode, one launch.
// * Grid (splits, hkv, b): block (s, h, b) owns cache rows
//   [s * split_rows, (s + 1) * split_rows) of kv head h for the G = hq / hkv
//   q heads that share it, so each K/V row is read once for all of them.
//   `splits` follows from skv, the cache's capacity, never from the values
//   in `length`: the host reads nothing back and a CUDA graph can hold the
//   launch. Each block reads its own length[b] (the TPU kernel's scalar
//   prefetch), clamps it to [0, skv] and never reads a row at or past it; a
//   block whose split starts there only counts itself for the combine.
// * Within a split, tiles of 64 rows come in by cp.async, 16 bytes a
//   thread, into padded shared-memory rows (conflict-free 16-byte reads),
//   two tiles in flight when a split has more than one. The scores of a
//   whole tile for all G heads are formed first (one thread per row and
//   head group), then one max, one exp2 pass and one rescale per head and
//   tile (a warp per head), then P.V with each thread owning 16 bytes of d.
// * Any head dim d >= 1 (the Pallas kernel takes any). Up to 256 the
//   kernel is instantiated at D = 16, 32, 64, 128, 160 and 256 (d 160 is
//   20 chunks in bf16, 40 in fp32) and a call runs at the least D >= d,
//   its shared-memory rows D wide. A d below D fills the first ceil(d /
//   VE) 16-byte chunks of each row: by cp.async where d is whole chunks
//   (a multiple of 8 in bf16, of 4 in fp32), else element by element with
//   zeros past d (single-element loads: the global rows are not 16-byte
//   aligned); the scores read those chunks alone, and the P.V threads of
//   the chunks past them idle. fp32 at D 256 keeps one tile in flight
//   (two would take 266 KB). bf16 at D 256 where d is whole 16-byte chunks
//   (decode_mma_route: d 168-256, gemma-2b's 256) does not reach this
//   kernel: repro_decode_attention sends it to decode_attention_tc.cu's
//   tensor-core kernel, its own source so that it compiles in parallel
//   with this one. Any group G = hq / hkv >= 1: one
//   instantiation serves each bucket of groups (GM = 1, 2, 4, 8, 16, the
//   least GM >= G), sizing shared memory and registers for GM; a group
//   equal to its bucket runs an instantiation where G is that constant,
//   the others (3, 5-7, 9-15) one that reads G at run time. A group above
//   16 (falcon-7b's 71) runs the run-time GM 16 in ceil(G / 16) slices of
//   q heads, a block each (grid (splits, hkv x slices, b)): every slice
//   reads the kv head's rows again, so they are read ceil(G / 16) times.
//   The P.V ownership (Layout) puts every (q head, 16 bytes of d, cache
//   row) under exactly one thread for every G <= GM, with guarded loops
//   where the thread groups and G do not divide each other (G 5 or 7, d
//   160); the threads left over idle. tests/test_torch_kernels.py reads
//   the same arithmetic.
// * Combine in the same launch: each block writes its fp32 partial
//   (m, l, acc[G][D], unnormalised) to scratch, fences, and counts itself
//   on an int32 counter of its (b, kv head, slice); the block that counts last
//   combines the partials of the ceil(length / split_rows) splits that
//   hold rows, writes o and sets the counter back to 0, so
//   the next launch (or graph replay) finds it zeroed. l == 0 (length 0)
//   gives zeros, as in the JAX kernel. Any skv is taken (the JAX kernel
//   asserts skv % 256 == 0).
// * Above 256, decode_wide_kernel: the output's columns in column tiles of
//   at most 256 (wide_tile_width), one block a (split, kv head, slice of
//   16 q heads, column tile), the same splits. Each block scores its rows
//   over the whole d, q and K streamed through shared memory in 64-column
//   pieces in the same order in every tile (so its m, l and the combine's
//   weights are bitwise equal across tiles), then P.V over its tile's
//   columns of V, thread t owning columns t and t + 128 for every head.
//   Each (b, kv head, slice, column tile) has its own partials and
//   counter; column tile 0 writes the lse. Scores over streamed pieces
//   first and P.V a tile of columns at a time after: the column tiles
//   keep a block's shared memory (91 KB) and registers (32 fp32
//   accumulators a thread) fixed at any d, where one block over all of
//   d would need G x d accumulators (36 KB at the MLA decode's 16 x 576,
//   more past it). The cost is the scores once per tile (three at 576).
// * Partial mode: given a non-null `lse` (b, hq) fp32, the combining block
//   also writes each head's natural log-sum-exp of its scaled scores,
//   (max + log2(sum)) * ln 2, and -inf where length is 0; o is the same
//   as without it. Slices of a sequence-sharded cache combine by these.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // cache rows per tile (one row per two threads)
constexpr int kMaxGM = 16; // q heads a block: larger groups take slices
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&out)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void load16<float>(const float* p, float (&out)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      float (&out)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shapes of the kernel for head dim D and groups of at most GM q heads a kv
// head (GM = 1, 2, 4, 8 or 16; the group g = hq / hkv <= GM, GM itself in the
// exact instantiations). P.V: thread t takes 16 bytes of d (chunk t % CH) in
// thread group t / CH; HG = kThreads / CH groups, the kThreads % CH threads
// past them idle (CH = 20 at d 160 in bf16, 40 in fp32). Group grp takes head
// grp % g over row slice grp / g of R = max(1, HG / g) slices, and heads grp +
// HG, grp + 2 HG, ... below g when g > HG: so each (head, 16 bytes of d, cache
// row) falls to exactly one thread for every g <= GM, and groups at or past
// min(HG, R g) idle.
template <typename T, int D, int GM>
struct Layout {
  static constexpr int VE = 16 / static_cast<int>(sizeof(T));  // elems / 16 B
  static constexpr int CH = D / VE;             // 16-byte chunks per row
  static constexpr int LDS = D + VE;            // smem row, 16 B of padding
  static constexpr int HG = kThreads / CH;      // thread groups in P.V
  static constexpr int HPT = (GM + HG - 1) / HG;  // at most, heads a thread
  static constexpr int SPT = (GM + 1) / 2;      // score heads per thread
  static_assert(D % VE == 0 && HG >= 1, "head dim");
  static constexpr size_t kStageBytes =
      sizeof(T) * static_cast<size_t>(2 * kTile * LDS);   // K and V tiles
  static constexpr size_t kFixedBytes =
      sizeof(float) * static_cast<size_t>(GM * D + GM * kTile +
                                          kThreads * VE + 3 * GM);
  // Tiles in flight when a split has more than one: two, but one where
  // two do not fit (fp32 at D 256: 2 x 133 KB).
  static constexpr int kStages =
      2 * kStageBytes + kFixedBytes <= kMaxSmem ? 2 : 1;
  static size_t smem(int stages) {
    return stages * kStageBytes + kFixedBytes;
  }
};

// Cache rows [r0, min(r0 + kTile, row_end)) of K and V into one stage
// (K rows, then V rows, each kTile x LDS) as two cp.async commit groups, so
// the scores can start while V is still on its way. Rows at or past
// row_end are never read, and their shared-memory rows never used. A head
// dim d below D fills the row's first cd = ceil(d / VE) chunks: by
// cp.async where d is whole chunks, else element by element (the global
// rows are not 16-byte aligned) with zeros past d; chunks at or past cd
// are never read.
template <typename T, int D, bool kPad>
__device__ __forceinline__ void load_tile(T* stage, const T* kb, const T* vb,
                                          int r0, int row_end,
                                          size_t row_stride, int d) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T)), CH = D / VE;
  constexpr int LDS = D + VE;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    T* dst = stage + part * kTile * LDS;
    const T* src = part ? vb : kb;
    if (!kPad) {
      for (int c = threadIdx.x; c < kTile * CH; c += kThreads) {
        const int r = c / CH, cc = c % CH;
        if (r0 + r < row_end)
          cp_async16(dst + r * LDS + cc * VE,
                     src + (r0 + r) * row_stride + cc * VE);
      }
    } else {
      const int cd = (d + VE - 1) / VE;
      for (int c = threadIdx.x; c < kTile * cd; c += kThreads) {
        const int r = c / cd, cc = c % cd;
        if (r0 + r >= row_end) continue;
        const T* s = src + (r0 + r) * row_stride + cc * VE;
        if (cd * VE == d) {
          cp_async16(dst + r * LDS + cc * VE, s);
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e)
            dst[r * LDS + cc * VE + e] =
                cc * VE + e < d ? s[e] : from_f32<T>(0.f);
        }
      }
    }
    cp_async_commit();
  }
}

// dot[i] += K row r . q of head gh + 2 i, over the row's first nch chunks.
template <typename T, int D, int SPT>
__device__ __forceinline__ void score_row(float (&dot)[SPT], const T* krow,
                                          const float* q_sm, int gh, int G,
                                          int nch) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
#pragma unroll 4
  for (int c = 0; c < nch; ++c) {
    float kf[VE];
    load16<T>(krow + c * VE, kf);
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int g = gh + 2 * i;
      if (g < G) {
        const float* qg = q_sm + g * D + c * VE;
#pragma unroll
        for (int e = 0; e < VE; ++e) dot[i] += kf[e] * qg[e];
      }
    }
  }
}

// The combine of a unit's partials, in the launch: each block of the unit
// (decode_split_kernel's (b, kv head, slice); decode_wide_kernel's also a
// column tile) counts itself on counter[unit] after its partial is out;
// the last of the `splits` sets the counter back to 0, so the next launch
// (or graph replay) finds it zeroed, and combines the splits below
// ceil(len / split_rows), the ones that hold rows. Head g of the unit's G
// (GS a split's stride in heads) has its accumulator `stride` floats after
// head g - 1's; its `cols` output columns go to o[o_base + g * d + c],
// and with `lse` (this unit's first head's) each head's log-sum-exp. w_sm:
// smem for splits x G weights; is_last: the block's shared flag.
template <typename T>
__device__ __forceinline__ void combine_partials(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    int* __restrict__ counter, T* __restrict__ o, float* __restrict__ lse,
    float* w_sm, int& is_last, int unit, int splits, int len, int split_rows,
    int G, int GS, int stride, int cols, size_t o_base, int d) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  for (int g = warp; g < G; g += kThreads / 32) {
    // nvalid <= splits <= 32 (wrapper), so one split per lane.
    const float* ml = part_ml + ((base + lane) * GS + g) * 2;
    const float ms = lane < nvalid ? __ldcg(ml) : kNegInf;
    const float ls = lane < nvalid ? __ldcg(ml + 1) : 0.f;
    const float mx = warp_max(ms);
    const float w = lane < nvalid ? exp2f(ms - mx) : 0.f;
    const float l = warp_sum(ls * w);
    if (lane < nvalid) w_sm[lane * G + g] = w / (l == 0.f ? 1.f : l);
    if (lse != nullptr && lane == 0)
      lse[g] = l == 0.f ? __int_as_float(0xff800000) : (mx + log2f(l)) * kLn2;
  }
  __syncthreads();
  for (int i = tid; i < G * cols; i += kThreads) {
    const int g = i / cols, c = i - g * cols;
    const float* pa = part_acc + static_cast<size_t>(base) * GS * stride +
                      g * stride + c;
    float sum = 0.f;
#pragma unroll 4
    for (int s = 0; s < nvalid; ++s)
      sum += __ldcg(pa + static_cast<size_t>(s) * GS * stride) *
             w_sm[s * G + g];
    o[o_base + static_cast<size_t>(g) * d + c] = from_f32<T>(sum);
  }
}

// kPad: a head dim d below D, read at run time (the one instantiation a D
// has for it is the run-time bucket 16); else d is D.
template <typename T, int D, int GM, bool kExact, bool kPad>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    T* __restrict__ o, float* __restrict__ lse,
                    float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int* __restrict__ counter,
                    int skv, int hq, int hkv, int d_arg, int splits,
                    int split_rows, float scale_log2) {
  using L = Layout<T, D, GM>;
  constexpr int VE = L::VE, CH = L::CH, LDS = L::LDS, HG = L::HG;
  constexpr int HPT = L::HPT, SPT = L::SPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The kv head's q heads come in gs slices of at most GM (one unless the
  // group passes kMaxGM, which only the run-time bucket 16 takes); this
  // block serves slice `slice`, G heads from h0. G is GM itself where the
  // group is exactly the bucket (a constant the compiler folds), else read
  // at run time; GS is the slices' stride in the partials.
  const int d = kPad ? d_arg : D;
  const int g_all = kExact ? GM : hq / hkv;   // launch() checked it
  const int gs = kExact || GM < kMaxGM ? 1 : (g_all + GM - 1) / GM;
  const int kvh = blockIdx.y / gs, slice = blockIdx.y - kvh * gs;
  const int G = kExact ? GM : min(GM, g_all - slice * GM);
  const int GS = kExact ? GM : min(GM, g_all);
  const int h0 = kvh * g_all + slice * GM;
  const int cd = kPad ? (d + VE - 1) / VE : CH;    // chunks holding d
  const int stages = split_rows > kTile && L::kStages == 2 ? 2 : 1;
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [stages][K, V][kTile][LDS]
  float* q_sm = reinterpret_cast<float*>(tiles + stages * 2 * kTile * LDS);
  float* s_sm = q_sm + GM * D;        // [G][kTile] scores, then p
  float* red = s_sm + GM * kTile;     // [kThreads][VE] row-slice partials
  float* st_m = red + kThreads * VE;  // [G] running max (log2 units)
  float* st_l = st_m + GM;            // [G] running sum
  float* st_a = st_l + GM;            // [G] this tile's rescale
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(length[b], 0), skv);
  const int row0 = split * split_rows;
  const int unit = b * hkv * gs + blockIdx.y;         // (b, kv head, slice)
  const int pidx = unit * splits + split;             // this partial
  const size_t row_stride = static_cast<size_t>(hkv) * d;
  const T* kb = k + static_cast<size_t>(b) * skv * row_stride +
                static_cast<size_t>(kvh) * d;
  const T* vb = v + static_cast<size_t>(b) * skv * row_stride +
                static_cast<size_t>(kvh) * d;

  if (row0 < len) {
    const int row_end = min(len, row0 + split_rows);
    const int ntiles = (row_end - row0 + kTile - 1) / kTile;
    load_tile<T, D, kPad>(tiles, kb, vb, row0, row_end, row_stride, d);
    const T* qb = q + (static_cast<size_t>(b) * hq + h0) * d;
    for (int i = tid; i < G * D; i += kThreads) {
      if (kPad) {
        const int g = i / D, c = i - g * D;
        q_sm[i] = c < d ? to_f32(qb[g * d + c]) * scale_log2 : 0.f;
      } else {
        q_sm[i] = to_f32(qb[i]) * scale_log2;
      }
    }
    if (tid < G) {
      st_m[tid] = kNegInf;
      st_l[tid] = 0.f;
    }

    // P.V ownership (Layout): 16 bytes of d (chunk pc) for heads pg,
    // pg + HG, ... below G, over the rows of slice rs of R.
    const int pc = tid % CH, grp = tid / CH;
    const int R = G < HG ? HG / G : 1;
    const bool pv_active = grp < min(HG, R * G) && (!kPad || pc < cd);
    const int pg = grp % G, rs = grp / G;
    float acc[HPT][VE];
#pragma unroll
    for (int i = 0; i < HPT; ++i)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[i][e] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
      // Two stages (whenever ntiles > 1 where they fit): tile t + 1 loads
      // while t computes. One: tile t loads once t - 1 is done (its last
      // barrier).
      constexpr bool kTwo = L::kStages == 2;
      const int stage = kTwo ? t & 1 : 0;
      const bool ahead = kTwo && t + 1 < ntiles;
      if (!kTwo && t > 0)
        load_tile<T, D, kPad>(tiles, kb, vb, row0 + t * kTile, row_end,
                              row_stride, d);
      if (ahead)
        load_tile<T, D, kPad>(tiles + (stage ^ 1) * 2 * kTile * LDS, kb, vb,
                              row0 + (t + 1) * kTile, row_end, row_stride,
                              d);
      // Pending groups, oldest first: K(t), V(t) [, K(t + 1), V(t + 1)].
      if (ahead) cp_async_wait<3>(); else cp_async_wait<1>();
      __syncthreads();  // K of tile t (and q, the stats) visible to all
      const T* ks = tiles + (stage * 2) * kTile * LDS;
      const T* vs = ks + kTile * LDS;
      const int nr = min(kTile, row_end - (row0 + t * kTile));

      // Scores: thread (r, gh) takes row r for heads gh, gh + 2, ...
      {
        const int r = tid % kTile, gh = tid / kTile;
        float dot[SPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) dot[i] = 0.f;
        if (r < nr) score_row<T, D, SPT>(dot, ks + r * LDS, q_sm, gh, G, cd);
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const int g = gh + 2 * i;
          if (g < G) s_sm[g * kTile + r] = r < nr ? dot[i] : kNegInf;
        }
      }
      __syncthreads();

      // One max, one exp2 pass and one rescale per head and tile.
      for (int g = warp; g < G; g += kThreads / 32) {
        const float x0 = s_sm[g * kTile + lane];
        const float x1 = s_sm[g * kTile + lane + 32];
        const float m_old = st_m[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
        s_sm[g * kTile + lane] = p0;
        s_sm[g * kTile + lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          st_a[g] = alpha;
          st_l[g] = st_l[g] * alpha + sum;
          st_m[g] = m_new;
        }
      }
      if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();
      __syncthreads();  // V of tile t and p visible to all

      if (pv_active) {
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          if (pg + HG * i < G) {
            const float alpha = st_a[pg + HG * i];
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[i][e] *= alpha;
          }
        }
        for (int r = rs; r < nr; r += R) {
          float vf[VE];
          load16<T>(vs + r * LDS + pc * VE, vf);
#pragma unroll
          for (int i = 0; i < HPT; ++i) {
            if (pg + HG * i < G) {
              const float p = s_sm[(pg + HG * i) * kTile + r];
#pragma unroll
              for (int e = 0; e < VE; ++e) acc[i][e] += p * vf[e];
            }
          }
        }
      }
      __syncthreads();  // this stage's tiles and s_sm are free again
    }

    float* pa = part_acc + static_cast<size_t>(pidx) * GS * D;
    if (R == 1) {
      if (pv_active) {
#pragma unroll
        for (int i = 0; i < HPT; ++i)
          if (pg + HG * i < G)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              pa[(pg + HG * i) * D + pc * VE + e] = acc[i][e];
      }
    } else {
      // Thread grp * CH + pc holds slice grp / G of head grp % G; the
      // slices of a (head, chunk) are summed in order.
#pragma unroll
      for (int e = 0; e < VE; ++e) red[tid * VE + e] = acc[0][e];
      __syncthreads();
      for (int i = tid; i < G * D; i += kThreads) {
        const int g = i / D, dd = i % D;
        if (kPad && dd >= d) continue;
        float sum = 0.f;
        for (int s = 0; s < R; ++s)
          sum += red[((s * G + g) * CH + dd / VE) * VE + dd % VE];
        pa[i] = sum;
      }
    }
    if (tid < G) {
      part_ml[(pidx * GS + tid) * 2] = st_m[tid];
      part_ml[(pidx * GS + tid) * 2 + 1] = st_l[tid];
    }
  }

  combine_partials<T>(part_ml, part_acc, counter, o,
                      lse == nullptr ? nullptr
                                     : lse + static_cast<size_t>(b) * hq + h0,
                      reinterpret_cast<float*>(smem_raw), is_last, unit,
                      splits, len, split_rows, G, GS, D, kPad ? d : D,
                      (static_cast<size_t>(b) * hq + h0) * d, d);
}

template <typename T, int D, int GM, bool kExact, bool kPad = false>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, float* lse, float* part_ml, float* part_acc,
           int* counter, int b,
           int skv, int hq, int hkv, int d, int split_rows, float scale,
           cudaStream_t stream) {
  using L = Layout<T, D, GM>;
  const int splits = (skv + split_rows - 1) / split_rows;
  const int g = hq / hkv;
  if (splits > 32 || (kExact ? g != GM : g > GM && GM != kMaxGM) ||
      (kPad ? d > D : d != D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gs = (g + GM - 1) / GM;     // q-head slices of a kv head
  const int stages = split_rows > kTile && L::kStages == 2 ? 2 : 1;
  const size_t smem = L::smem(stages);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, D, GM, kExact, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, hkv * gs, b);
  decode_split_kernel<T, D, GM, kExact, kPad>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), lse, part_ml,
      part_acc, counter, skv, hq, hkv, d, splits, split_rows,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_DECODE_ARGS \
  q, k, v, length, o, lse, part_ml, part_acc, counter, b, skv, hq, hkv, d, \
      split_rows, scale, s

// The group g = hq / hkv takes the instantiation of the least GM >= g: the
// exact one (g a compile-time constant) where g == GM, else the one that
// reads g at run time; a group above 16 the run-time 16, in ceil(g / 16)
// slices of q heads. A head dim below D takes the padded run-time 16 at
// any group, and so does D 256 at every d this kernel serves there (fp32,
// and bf16 at a d that is not whole 16-byte chunks; bf16 at the others
// goes to decode_attention_tc.cu before this dispatch).
template <typename T, int D>
int dispatch_g(int g, const void* q, const void* k, const void* v,
               const int* length, void* o, float* lse, float* part_ml,
               float* part_acc,
               int* counter, int b, int skv, int hq, int hkv, int d,
               int split_rows, float scale, cudaStream_t s) {
  if (g < 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D == 256) {
    return launch<T, D, 16, false, true>(REPRO_DECODE_ARGS);
  } else {
    if (d != D) return launch<T, D, 16, false, true>(REPRO_DECODE_ARGS);
    switch (g) {
      case 1: return launch<T, D, 1, true>(REPRO_DECODE_ARGS);
      case 2: return launch<T, D, 2, true>(REPRO_DECODE_ARGS);
      case 4: return launch<T, D, 4, true>(REPRO_DECODE_ARGS);
      case 8: return launch<T, D, 8, true>(REPRO_DECODE_ARGS);
      case 16: return launch<T, D, 16, true>(REPRO_DECODE_ARGS);
    }
    if (g <= 4) return launch<T, D, 4, false>(REPRO_DECODE_ARGS);
    if (g <= 8) return launch<T, D, 8, false>(REPRO_DECODE_ARGS);
    if (g <= 16) return launch<T, D, 16, false>(REPRO_DECODE_ARGS);
    return launch<T, D, 16, false>(REPRO_DECODE_ARGS);   // slices of 16
  }
}

// Head dim d at the least instantiated D at or above it (16, 32, 64, 128,
// 160, 256); past 256 nothing is instantiated.
template <typename T>
int dispatch_d(int d, int g, const void* q, const void* k, const void* v,
               const int* length, void* o, float* lse, float* part_ml,
               float* part_acc,
               int* counter, int b, int skv, int hq, int hkv, int split_rows,
               float scale, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 16: return dispatch_g<T, 16>(g, REPRO_DECODE_ARGS);
    case 32: return dispatch_g<T, 32>(g, REPRO_DECODE_ARGS);
    case 64: return dispatch_g<T, 64>(g, REPRO_DECODE_ARGS);
    case 128: return dispatch_g<T, 128>(g, REPRO_DECODE_ARGS);
    case 160: return dispatch_g<T, 160>(g, REPRO_DECODE_ARGS);
    case 256: return dispatch_g<T, 256>(g, REPRO_DECODE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_DECODE_ARGS

// ---------------------------------------------------------------------------
// Head dims above 256: column tiles.
// ---------------------------------------------------------------------------
namespace wide {

constexpr int kPiece = 64;                    // columns of d a piece
constexpr int kLP = kPiece + 1;               // row stride of a K piece
constexpr int kLV = kWideTileCols + 1;        // row stride of a V tile
constexpr int kCPT = kWideTileCols / kThreads;  // output columns a thread
constexpr int kSPT = kMaxGM / 2;              // score heads a thread

constexpr size_t smem_bytes() {
  return sizeof(float) * (kMaxGM * kPiece + kTile * kLP + kTile * kLV +
                          kMaxGM * kTile + 3 * kMaxGM);
}

// Grid (splits, hkv x slices x column tiles, b): block (s, (h, slice,
// ct), b) takes the cache rows of split s of kv head h for its slice's G
// <= 16 q heads and writes output columns [c0, c0 + cw) of column tile ct
// (wide_tile_width). Per tile of kTile rows: the scores over the whole d,
// q and K streamed through smem in kPiece-column pieces, in the same order
// in every column tile (so m, l and the weights of the combine are bitwise
// equal across tiles); the online softmax as decode_split_kernel's; then
// P.V over the tile's columns of V, thread t owning columns t and t +
// kThreads for every head. Partials and the combine as there, a counter
// each (b, kv head, slice, column tile); tile 0 writes the lse.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ length,
                   T* __restrict__ o, float* __restrict__ lse,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int* __restrict__ counter, int skv, int hq, int hkv, int d,
                   int splits, int split_rows, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qp = reinterpret_cast<float*>(smem_raw);  // [kMaxGM][kPiece]
  float* kp = qp + kMaxGM * kPiece;                // [kTile][kLP]
  float* vs = kp + kTile * kLP;                    // [kTile][kLV]
  float* s_sm = vs + kTile * kLV;                  // [G][kTile]
  float* st_m = s_sm + kMaxGM * kTile;
  float* st_l = st_m + kMaxGM;
  float* st_a = st_l + kMaxGM;
  __shared__ int is_last;

  const int n_ct = wide_col_tiles(d), tw = wide_tile_width(d);
  const int g_all = hq / hkv;
  const int gs = (g_all + kMaxGM - 1) / kMaxGM;
  const int ct = blockIdx.y % n_ct, hs = blockIdx.y / n_ct;
  const int kvh = hs / gs, slice = hs - kvh * gs;
  const int G = min(kMaxGM, g_all - slice * kMaxGM);
  const int GS = min(kMaxGM, g_all);
  const int h0 = kvh * g_all + slice * kMaxGM;
  const int c0 = ct * tw, cw = min(tw, d - c0);
  const int split = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(length[b], 0), skv);
  const int row0 = split * split_rows;
  const int unit = b * gridDim.y + blockIdx.y;  // (b, kv head, slice, tile)
  const int pidx = unit * splits + split;
  const size_t row_stride = static_cast<size_t>(hkv) * d;
  const T* kb = k + static_cast<size_t>(b) * skv * row_stride +
                static_cast<size_t>(kvh) * d;
  const T* vb = v + static_cast<size_t>(b) * skv * row_stride +
                static_cast<size_t>(kvh) * d;
  const T* qb = q + (static_cast<size_t>(b) * hq + h0) * d;

  if (row0 < len) {
    const int row_end = min(len, row0 + split_rows);
    if (tid < G) {
      st_m[tid] = kNegInf;
      st_l[tid] = 0.f;
    }
    float acc[kMaxGM][kCPT];
#pragma unroll
    for (int g = 0; g < kMaxGM; ++g)
#pragma unroll
      for (int j = 0; j < kCPT; ++j) acc[g][j] = 0.f;

    for (int t0 = row0; t0 < row_end; t0 += kTile) {
      const int nr = min(kTile, row_end - t0);
      // Scores: thread (r, gh) takes row r for heads gh, gh + 2, ...
      const int r = tid % kTile, gh = tid / kTile;
      float dot[kSPT];
#pragma unroll
      for (int i = 0; i < kSPT; ++i) dot[i] = 0.f;
      for (int p0 = 0; p0 < d; p0 += kPiece) {
        __syncthreads();  // the last piece, and the last tile's V and p
        const int pw = min(kPiece, d - p0);
        for (int i = tid; i < G * kPiece; i += kThreads) {
          const int g = i / kPiece, c = i % kPiece;
          qp[i] = c < pw ? to_f32(qb[static_cast<size_t>(g) * d + p0 + c]) *
                               scale_log2
                         : 0.f;
        }
        for (int i = tid; i < kTile * kPiece; i += kThreads) {
          const int rr = i / kPiece, c = i % kPiece;
          kp[rr * kLP + c] =
              rr < nr && c < pw
                  ? to_f32(kb[static_cast<size_t>(t0 + rr) * row_stride +
                              p0 + c])
                  : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < kPiece; ++c) {
          const float kv = kp[r * kLP + c];
#pragma unroll
          for (int i = 0; i < kSPT; ++i)
            if (gh + 2 * i < G) dot[i] += kv * qp[(gh + 2 * i) * kPiece + c];
        }
      }
#pragma unroll
      for (int i = 0; i < kSPT; ++i) {
        const int g = gh + 2 * i;
        if (g < G) s_sm[g * kTile + r] = r < nr ? dot[i] : kNegInf;
      }
      for (int i = tid; i < kTile * kWideTileCols; i += kThreads) {
        const int rr = i / kWideTileCols, c = i % kWideTileCols;
        vs[rr * kLV + c] =
            rr < nr && c < cw
                ? to_f32(vb[static_cast<size_t>(t0 + rr) * row_stride + c0 +
                            c])
                : 0.f;
      }
      __syncthreads();  // the scores and V visible to all

      // One max, one exp2 pass and one rescale per head and tile.
      for (int g = warp; g < G; g += kThreads / 32) {
        const float x0 = s_sm[g * kTile + lane];
        const float x1 = s_sm[g * kTile + lane + 32];
        const float m_old = st_m[g];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
        s_sm[g * kTile + lane] = p0;
        s_sm[g * kTile + lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          st_a[g] = alpha;
          st_l[g] = st_l[g] * alpha + sum;
          st_m[g] = m_new;
        }
      }
      __syncthreads();  // p and the rescales visible to all

#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int col = tid + kThreads * j;
        if (col >= cw) continue;
#pragma unroll
        for (int g = 0; g < kMaxGM; ++g)
          if (g < G) acc[g][j] *= st_a[g];
        for (int rr = 0; rr < nr; ++rr) {
          const float vv = vs[rr * kLV + col];
#pragma unroll
          for (int g = 0; g < kMaxGM; ++g)
            if (g < G) acc[g][j] += s_sm[g * kTile + rr] * vv;
        }
      }
    }

    float* pa = part_acc + static_cast<size_t>(pidx) * GS * kWideTileCols;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int col = tid + kThreads * j;
      if (col >= cw) continue;
#pragma unroll
      for (int g = 0; g < kMaxGM; ++g)
        if (g < G) pa[g * kWideTileCols + col] = acc[g][j];
    }
    if (tid < G) {
      part_ml[(pidx * GS + tid) * 2] = st_m[tid];
      part_ml[(pidx * GS + tid) * 2 + 1] = st_l[tid];
    }
  }

  combine_partials<T>(part_ml, part_acc, counter, o,
                      lse == nullptr || ct != 0
                          ? nullptr
                          : lse + static_cast<size_t>(b) * hq + h0,
                      reinterpret_cast<float*>(smem_raw), is_last, unit,
                      splits, len, split_rows, G, GS, kWideTileCols, cw,
                      (static_cast<size_t>(b) * hq + h0) * d + c0, d);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, float* lse, float* part_ml, float* part_acc, int* counter,
           int b, int skv, int hq, int hkv, int d, int split_rows,
           float scale, cudaStream_t stream) {
  const int splits = (skv + split_rows - 1) / split_rows;
  if (splits > 32 || d <= 256) return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv, gs = (g + kMaxGM - 1) / kMaxGM;
  cudaError_t err = cudaFuncSetAttribute(
      decode_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, hkv * gs * wide_col_tiles(d), b);
  decode_wide_kernel<T><<<grid, kThreads, smem_bytes(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), lse, part_ml,
      part_acc, counter, skv, hq, hkv, d, splits, split_rows,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

}  // namespace

// bf16 at the padded head dim 256 where d is whole 16-byte chunks
// (decode_mma_route): the tensor-core kernel of decode_attention_tc.cu.
namespace decode_tc {
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, float* lse, float* part_ml, float* part_acc, int* counter,
           int b, int skv, int hq, int hkv, int d, int split_rows,
           float scale, cudaStream_t stream);
}  // namespace decode_tc
}  // namespace repro

// With G = hq / hkv, gs = ceil(G / 16) slices of GS = min(G, 16) q heads
// and D the padded head dim: part_ml (b, hkv, gs, splits, GS, 2) fp32 and
// part_acc (b, hkv, gs, splits, GS, D) fp32 scratch, splits = ceil(skv /
// split_rows), written only for the splits below ceil(length /
// split_rows); counter: b * hkv * gs int32, zero on entry and left zero
// on exit. Above d 256 (decode_wide_kernel) each of the nct =
// wide_col_tiles(d) column tiles is a unit of its own: part_ml (b, hkv,
// gs, nct, splits, GS, 2), part_acc (b, hkv, gs, nct, splits, GS, 256),
// counter b * hkv * gs * nct. split_rows is a multiple of 64 and gives at
// most 32 splits (the combine takes one split per lane). bf16 where
// decode_mma_route holds (d 168-256, a multiple of 8) runs
// decode_attention_tc.cu's decode_mma_kernel, with the same scratch at D 256
// (part_acc 16-byte aligned) and counter, and split_rows
// decode_mma_split_rows(skv, b * hkv * gs), whole tiles of 32 rows. d below
// 1 returns cudaErrorInvalidValue. lse: null, or (b, hq) fp32 (partial
// mode).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* length,
                                      void* o, void* lse, void* part_ml,
                                      void* part_acc,
                                      void* counter, int b, int skv, int hq,
                                      int hkv, int d, int split_rows,
                                      float scale, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 || split_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16 && decode_mma_route(d))
    return decode_tc::launch(q, k, v, static_cast<const int*>(length), o,
                             static_cast<float*>(lse),
                             static_cast<float*>(part_ml),
                             static_cast<float*>(part_acc),
                             static_cast<int*>(counter), b, skv, hq, hkv, d,
                             split_rows, scale, s);
  if (split_rows % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(length);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counter);
  float* ls = static_cast<float*>(lse);
  const int g = hq / hkv;
  if (d > 256) {
    if (dtype == kF32)
      return wide::launch<float>(q, k, v, len, o, ls, ml, acc, cnt, b, skv,
                                 hq, hkv, d, split_rows, scale, s);
    if (dtype == kBF16)
      return wide::launch<__nv_bfloat16>(q, k, v, len, o, ls, ml, acc, cnt, b,
                                         skv, hq, hkv, d, split_rows, scale,
                                         s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kF32)
    return dispatch_d<float>(d, g, q, k, v, len, o, ls, ml, acc, cnt, b, skv,
                             hq, hkv, split_rows, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, g, q, k, v, len, o, ls, ml, acc, cnt,
                                     b, skv, hq, hkv, split_rows, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
