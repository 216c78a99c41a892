// Flash attention above a head dim of 256 in bf16 on the tensor cores:
// the forward and the backward's two kernels of csrc/flash_attention.cu's
// routes "wgmma_wide", where tc_wide_route(d) holds (d a multiple of 8, so
// the TMA maps' rows are whole 16-byte chunks, up to kTcWideMaxDim), and
// "wgmma_wide_staged", where tc_wide_staged_route(d) holds (d not a
// multiple of 8, up to kTcWideMaxDim): there flash_attention.cu's
// flash_stage_rows_kernel first copies the inputs into rows of
// staged_ld(d) elements, the maps read the copies (row stride staged_ld(d),
// inner extent d), and the kStaged instantiations store each output column
// on its own at the real d (the rest is the same code).
//
// Replaces, for those shapes, the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel), which
// takes any head dim; its backward is the port's own (FlashAttention-2's,
// as below 256). fp32 at every d above 256, and bf16 above kTcWideMaxDim,
// stay on the CUDA-core column tiles of flash_attention_simt_wide.cu.
//
// Bound on the H100: bytes. At b 8, s 256, d 512 the forward moves 67 MB
// (0.020 ms at 3.35 TB/s) for 4.3 GFLOP (0.004 ms at 989 TFLOP/s).
//
// Design. No block can keep O (or dK, dV, dQ) for all of d in registers, so
// as in namespace wide each block owns a column tile of the output: tiles
// of N = 192 or 256 columns (a template parameter), the last cut at d, by
// common.cuh's plans (tc_wide_fwd_tile_width for the forward,
// tc_wide_tile_width for the backward). Each block recomputes S
// (and in the backward dP) over the whole d, on the tensor cores, from the
// same boxes in the same order in every column tile, so S, m, l and P are
// bitwise equal across tiles; it accumulates only its own N columns, as
// N / 64 accumulators of 64 x 64 (one m64n64k16 wgmma a box and k step,
// 4 N / 8 fp32 registers a thread in all).
//
// Every operand is a box of 64 rows x 64 bf16 columns (8 KB), brought in
// by TMA with 128-byte swizzle; the tensor maps' inner extent is the real d,
// so a box's columns past d come in as zeros (and a box wholly past d is
// fetched at the last box's coordinates: it only feeds accumulator columns
// that are never stored). A block holds its fixed tile (Q in the forward,
// K and V in the dK/dV kernel, Q and dO in the dQ kernel) resident, and
// streams every other box through a ring of `ring` 8 KB slots (up to
// kMaxRing, as shared memory allows) in the order the products read them.
// One producer warp (one elected thread) issues the loads: it waits for a
// slot's `empty` mbarrier, announces its bytes on the slot's `full`
// mbarrier and issues the TMA copy. The consumer warpgroup waits for
// `full`, issues the box's wgmmas as one commit group, and once the next
// box's group is issued and the previous one has completed (wgmma
// wait_group 1) each warp arrives on the previous slot's `empty`. So loads
// run up to a ring ahead of the products, no barrier of the whole block is
// taken after the start, and no TMA copy is issued between a wgmma commit
// and its wait.
//
// Forward (flash_fwd_wgmma_wide_kernel), a block a (q tile of 64 rows, q
// head, batch, column tile), longest q tiles first: for each kv tile up to
// the diagonal, S = Q K^T over ceil(d / 64) boxes of K, the online softmax
// in registers as flash_fwd_wgmma_kernel's, P rounded to bf16 as the
// register A operand of O += P V[:, tile] over N / 64 boxes of V. Column
// tile 0 writes the log-sum-exp.
//
// Backward: delta = rowsum(dO * O) by flash_bwd_preprocess_rows_kernel (in
// flash_attention.cu; on the staged route the copy writes it), then two
// kernels, split as below 256 so that no block adds into another's output
// (no atomics; bitwise repeatable):
// * flash_bwd_dkdv_wgmma_wide_kernel, a block a (kv tile, kv head, batch,
//   column tile, role): role 0 keeps dV, role 1 dK (below 256, D 160 and
//   256 split them between two warpgroups of one block; here they are two
//   blocks, so each has one consumer warpgroup and 255 registers a thread).
//   K (and for dK, V) resident; for each q head of the group and q tile on
//   or below the diagonal, S^T = K Q^T (and for dK dP^T = V dO^T) over d,
//   P^T (and dS^T = P^T (dP^T - delta)) in registers, then dV += P^T
//   dO[:, tile] or dK += dS^T Q[:, tile]. lse and delta of the q tile's
//   rows (per column of S^T) go through shared memory, double-buffered,
//   one named barrier of the warpgroup a step.
// * flash_bwd_dq_wgmma_wide_kernel, a block a (q tile, q head, batch,
//   column tile): Q and dO resident; for each kv tile up to the diagonal S
//   = Q K^T and dP = dO V^T over d, dS = P (dP - delta), dQ += dS K[:, tile].
// 64-bit offsets throughout.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {
namespace tcw {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;                     // rows of a tile: wgmma M, S's N
constexpr int kBox = 64 * 64;              // elements of a box
constexpr uint32_t kBoxBytes = kBox * sizeof(bf16);   // 8 KB
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxRing = 8;                // ring slots, at most
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Position in the ring: slot and the parity of its current round.
struct Ring {
  int n, slot = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(int slots) : n(slots) {}
  __device__ void next() {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Shared memory: 1024 bytes for the alignment of the swizzled boxes, the
// resident boxes, the ring, its full and empty barriers and the resident
// tile's barrier, then `extra` bytes.
size_t smem_bytes(int resident, int ring, size_t extra) {
  return 1024 + static_cast<size_t>(resident + ring) * kBoxBytes +
         8 * static_cast<size_t>(2 * ring + 1) + extra;
}

// The deepest ring up to kMaxRing that fits beside the resident boxes,
// `blocks` blocks an SM (228 KB of shared memory an SM, 1 KB of it kept
// for each block) if they fit, else one; 0 if not even `least` slots fit.
// A consumer holds the slots of one commit group while it waits for the
// next: `least` is two groups' slots (2 in the forward, 4 in the
// backward's S and dP loops, which take two boxes a group).
int ring_slots(int resident, size_t extra, int least, int blocks) {
  for (int bl = blocks; bl >= 1; --bl) {
    const size_t cap = std::min<size_t>(kMaxSmem, (233472 - 1024 * bl) / bl);
    for (int r = kMaxRing; r >= least; --r)
      if (smem_bytes(resident, r, extra) <= cap) return r;
  }
  return 0;
}

struct Smem {
  bf16* res;        // resident boxes
  bf16* ring;       // [ring] slots
  uint64_t* full;   // [ring]
  uint64_t* empty;  // [ring]
  uint64_t* resbar; // the resident boxes arrived
  unsigned char* extra;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int resident,
                                      int ring) {
  const uint32_t a = smem_u32(raw);
  Smem s;
  s.res = reinterpret_cast<bf16*>(raw + ((1024 - (a & 1023)) & 1023));
  s.ring = s.res + static_cast<size_t>(resident) * kBox;
  s.full = reinterpret_cast<uint64_t*>(s.ring + static_cast<size_t>(ring) *
                                                    kBox);
  s.empty = s.full + ring;
  s.resbar = s.empty + ring;
  s.extra = reinterpret_cast<unsigned char*>(s.resbar + 1);
  return s;
}

// Thread 0: the barriers (a full barrier takes the producer's arrival and
// the bytes; an empty one an arrival of each consumer warp).
__device__ __forceinline__ void init_barriers(const Smem& s, int ring) {
  if (threadIdx.x == 0) {
    mbar_init(s.resbar, 1);
    for (int i = 0; i < ring; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Producer: the next ring slot for one box at (col, head, row, batch).
__device__ __forceinline__ void put(const Smem& s, Ring& r,
                                    const CUtensorMap* map, int col, int h,
                                    int row, int bb) {
  mbar_wait(&s.empty[r.slot], r.phase ^ 1);
  mbar_expect_tx(&s.full[r.slot], kBoxBytes);
  tma_load_4d(s.ring + static_cast<size_t>(r.slot) * kBox, map,
              &s.full[r.slot], col, h, row, bb);
  r.next();
}

// Consumer: wait for the ring's next box; returns it.
__device__ __forceinline__ const bf16* take(const Smem& s, const Ring& r) {
  mbar_wait(&s.full[r.slot], r.phase);
  return s.ring + static_cast<size_t>(r.slot) * kBox;
}

// Consumer warp: the slot is no longer read (after its wgmmas completed).
__device__ __forceinline__ void release(const Smem& s, int slot) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&s.empty[slot]);
}

// acc (64 x 64) += A . B^T over one box (64 columns of the product's
// depth): A and B 64-row boxes, K-major, as TMA writes them.
__device__ __forceinline__ void mma_box_abt(float (&acc)[32], const bf16* a,
                                            const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // 16 columns, 32 bytes, a k step
    wgmma_m64n64k16_ss(acc, desc_sw128(a, 16, 1024) + 2 * kk,
                       desc_sw128(b, 16, 1024) + 2 * kk);
}

// acc (64 x 64) += A . B: A (64 x 64) in registers, the bf16 pairs of an
// accumulator; B a box of 64 rows (the depth) x 64 columns, read MN-major;
// k steps of 16 rows are 2048 bytes apart.
__device__ __forceinline__ void mma_box_rb(float (&acc)[32],
                                           const uint32_t (&a)[4][4],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs_tb(acc, a[kk], desc_sw128(b + kk * 16 * 64,
                                                 kBoxBytes, 1024));
}

// The column of box i of column tile c0 (a whole box past d is fetched at
// the last box's: its accumulator columns are never stored).
__device__ __forceinline__ int tile_col(int c0, int i, int nb) {
  return min(c0 + 64 * i, 64 * (nb - 1));
}

// Consumer: acc[i] (64 x 64, box i of the tile) += A . (the ring's next NV
// boxes), each box its own commit group, each slot released once the next
// group is issued and its own completed.
template <int NV>
__device__ __forceinline__ void mma_tile(const Smem& s, Ring& r,
                                         float (&acc)[NV][32],
                                         const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) fence_regs(acc[i]);
  wgmma_fence();
  int prev = -1;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bf16* box = take(s, r);
    mma_box_rb(acc[i], a, box);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) release(s, prev);
    prev = r.slot;
    r.next();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NV; ++i) fence_regs(acc[i]);
  release(s, prev);
}

// This thread's two rows (row_a, row_a + 8) of a tile's accumulators, times
// `mul`, as bf16 into columns c0 + 64 i + ... below d of a (b, rows, heads,
// d) tensor at (bb, h). d is a multiple of 8, or with kStaged any d: each
// column is masked, a pair stored as 4 bytes where d is even (so the pair
// is whole and 4-byte aligned), else element by element (a row starts on
// an odd element, and the pair at d - 1 would write into the next head).
template <int NV, bool kStaged>
__device__ __forceinline__ void store_tile(bf16* out, const float (&acc)[NV][32],
                                           float mul_a, float mul_b, int bb,
                                           int row_a, int rows, int heads,
                                           int h, int d, int c0, int col_t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= rows) continue;
    const float mul = half ? mul_b : mul_a;
    bf16* orow = out + ((static_cast<size_t>(bb) * rows + row) * heads + h) *
                           static_cast<size_t>(d);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = c0 + 64 * i + 8 * jj + col_t;
        if constexpr (kStaged) {
          const float x0 = acc[i][4 * jj + 2 * half] * mul;
          const float x1 = acc[i][4 * jj + 2 * half + 1] * mul;
          if (d % 2 == 0) {
            if (col < d)
              *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
          } else {
            if (col < d) orow[col] = __float2bfloat16(x0);
            if (col + 1 < d) orow[col + 1] = __float2bfloat16(x1);
          }
        } else if (col < d) {
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[i][4 * jj + 2 * half] * mul,
                        acc[i][4 * jj + 2 * half + 1] * mul);
        }
      }
  }
}

// Forward blocks an SM: two at N 192 (the ring cut so that two fit shared
// memory beside Q, which they do up to kTcWideFwd192MaxDim, the plan's
// bound for N 192), one at 256, whose 128 accumulators would spill under
// two blocks' 204 registers a thread. Two blocks overlap one's loads with
// the other's products, so tiles of 192 at d 392-704 (three at d 512,
// against two of 256) win though they recompute S once more; where two
// blocks do not fit, the wider tiles win (PERF.md §6 has the times).
template <int N>
constexpr int kFwdBlocks = N == 192 ? 2 : 1;

template <int N, bool kStaged>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<N>)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            int b, int sq, int skv, int hq, int hkv, int d,
                            int n_qtiles, int ring, float scale_log2,
                            int causal) {
  constexpr int NV = N / 64;      // boxes of the column tile
  const int nb = (d + 63) / 64;   // boxes of a row
  const int n_ct = tc_wide_fwd_col_tiles(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, nb, ring);

  // Longest q tiles first; a q tile's column tiles side by side.
  const int per = n_ct * hq * b;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int ct = rem % n_ct;
  const int h = rem / n_ct % hq;
  const int bb = rem / n_ct / hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kB, c0 = ct * N;
  const int kv_end = causal ? min(skv, q0 + kB) : skv;
  const int n_kv = (kv_end + kB - 1) / kB;
  const int tid = threadIdx.x;

  init_barriers(sm, ring);
  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(sm.resbar, nb * kBoxBytes);
      for (int c = 0; c < nb; ++c)
        tma_load_4d(sm.res + static_cast<size_t>(c) * kBox, &tq, sm.resbar,
                    64 * c, h, q0, bb);
      Ring r(ring);
      for (int j = 0; j < n_kv; ++j) {
        for (int c = 0; c < nb; ++c) put(sm, r, &tk, 64 * c, kvh, j * kB, bb);
        for (int i = 0; i < NV; ++i)
          put(sm, r, &tv, tile_col(c0, i, nb), kvh, j * kB, bb);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8
  const int col_t = 2 * (lane & 3);
  float acc[NV][32];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  Ring r(ring);

  mbar_wait(sm.resbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    // S = Q . K^T (64 x 64) over d, a box of K at a time.
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_regs(s);
    wgmma_fence();
    int prev = -1;
    for (int c = 0; c < nb; ++c) {
      const bf16* kbox = take(sm, r);
      mma_box_abt(s, sm.res + static_cast<size_t>(c) * kBox, kbox);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(sm, prev);
      prev = r.slot;
      r.next();
    }
    wgmma_wait<0>();
    fence_regs(s);
    release(sm, prev);

    // Online softmax on the accumulator, as flash_fwd_wgmma_kernel's.
    const int k0 = j * kB;
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
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        acc[i][4 * jj] *= alpha_a;
        acc[i][4 * jj + 1] *= alpha_a;
        acc[i][4 * jj + 2] *= alpha_b;
        acc[i][4 * jj + 3] *= alpha_b;
      }

    // O[:, tile] += P . V[:, tile], P in bf16 from registers.
    uint32_t p[4][4];
    pack_a(p, s);
    mma_tile<NV>(sm, r, acc, p);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (lse != nullptr && ct == 0 && (lane & 3) == 0) {
    // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2.
    float* lrow = lse + (static_cast<size_t>(bb) * hq + h) * sq;
    if (row_a < sq)
      lrow[row_a] = (m_a + (l_a == 0.f ? 0.f : log2f(l_a))) * kLn2;
    if (row_a + 8 < sq)
      lrow[row_a + 8] = (m_b + (l_b == 0.f ? 0.f : log2f(l_b))) * kLn2;
  }
  store_tile<NV, kStaged>(o, acc, 1.f / (l_a == 0.f ? 1.f : l_a),
                          1.f / (l_b == 0.f ? 1.f : l_b), bb, row_a, sq, hq,
                          h, d, c0, col_t);
}

// dK or dV of a (kv tile, kv head, batch, column tile): role 0 dV, role 1
// dK. Per step (q head of the group, q tile), the ring brings Q's boxes (and
// for dK dO's, interleaved) over d, then the column tile's boxes of dO (dV)
// or Q (dK).
template <int N, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 int b, int sq, int skv, int hq, int hkv,
                                 int d, int ring, float scale,
                                 float scale_log2, int causal) {
  constexpr int NV = N / 64;
  const int nb = (d + 63) / 64;
  const int n_ct = tc_wide_col_tiles(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, 2 * nb, ring);
  const bf16* Ks = sm.res;
  const bf16* Vs = sm.res + static_cast<size_t>(nb) * kBox;
  float* Ls = reinterpret_cast<float*>(sm.extra);  // [2][kB]: lse, log2 units
  float* Dl = Ls + 2 * kB;                         // [2][kB]: delta

  // Longest first: when causal, kv tile 0 walks every q tile.
  const int per = 2 * n_ct * hkv * b;
  const int kt = static_cast<int>(blockIdx.x) / per;
  int rem = static_cast<int>(blockIdx.x) % per;
  const bool does_dk = rem & 1;
  rem >>= 1;
  const int ct = rem % n_ct;
  const int kvh = rem / n_ct % hkv;
  const int bb = rem / n_ct / hkv;
  const int k0 = kt * kB, c0 = ct * N;
  const int g = hq / hkv;
  const int qt0 = causal ? kt : 0;  // q tiles above the diagonal: none
  const int nq = max((sq + kB - 1) / kB - qt0, 0);
  const int n_it = g * nq;          // (q head of the group, q tile) steps
  const int tid = threadIdx.x;

  init_barriers(sm, ring);
  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(sm.resbar, (does_dk ? 2 : 1) * nb * kBoxBytes);
      for (int c = 0; c < nb; ++c) {
        tma_load_4d(sm.res + static_cast<size_t>(c) * kBox, &tk, sm.resbar,
                    64 * c, kvh, k0, bb);
        if (does_dk)
          tma_load_4d(sm.res + static_cast<size_t>(nb + c) * kBox, &tv,
                      sm.resbar, 64 * c, kvh, k0, bb);
      }
      Ring r(ring);
      for (int it = 0; it < n_it; ++it) {
        const int h = kvh * g + it / nq, q0 = (qt0 + it % nq) * kB;
        for (int c = 0; c < nb; ++c) {
          put(sm, r, &tq, 64 * c, h, q0, bb);
          if (does_dk) put(sm, r, &tdo, 64 * c, h, q0, bb);
        }
        for (int i = 0; i < NV; ++i)
          put(sm, r, does_dk ? &tq : &tdo, tile_col(c0, i, nb), h, q0, bb);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r_a = warp * 16 + (lane >> 2);  // tile row (kv) of the even pair
  const int kv_a = k0 + r_a, kv_b = kv_a + 8;
  const int col_t = 2 * (lane & 3);
  // lse (log2 units) and delta of row `tid` of step it's q tile.
  auto row_vals = [=](int it, float& l2, float& dl) {
    const int h = kvh * g + it / nq, qi = (qt0 + it % nq) * kB + tid;
    l2 = dl = 0.f;
    if (qi < sq) {
      const size_t off = (static_cast<size_t>(bb) * hq + h) * sq + qi;
      l2 = lse[off] * kLog2e;
      dl = delta[off];
    }
  };
  float next_l = 0.f, next_d = 0.f;
  if (tid < kB && n_it > 0) row_vals(0, next_l, next_d);

  float acc[NV][32];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  Ring r(ring);

  mbar_wait(sm.resbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qt0 + it % nq) * kB;
    const float* lrow = Ls + (it & 1) * kB;
    const float* drow = Dl + (it & 1) * kB;
    if (tid < kB) {
      Ls[(it & 1) * kB + tid] = next_l;
      Dl[(it & 1) * kB + tid] = next_d;
    }
    // Every writer has stored this step's lse and delta, and every reader
    // of this half is past the step before last.
    named_bar_sync(1, kConsumers);
    if (tid < kB && it + 1 < n_it) row_vals(it + 1, next_l, next_d);

    // S^T = K Q^T and, for dK, dP^T = V dO^T (kv rows x q columns) over d.
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    int prev = -1, prev2 = -1;
    for (int c = 0; c < nb; ++c) {
      const size_t off = static_cast<size_t>(c) * kBox;
      mma_box_abt(s, Ks + off, take(sm, r));
      const int slot = r.slot;
      r.next();
      int slot2 = -1;
      if (does_dk) {
        mma_box_abt(dp, Vs + off, take(sm, r));
        slot2 = r.slot;
        r.next();
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(sm, prev);
      if (prev2 >= 0) release(sm, prev2);
      prev = slot;
      prev2 = slot2;
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    release(sm, prev);
    if (prev2 >= 0) release(sm, prev2);

    // P^T = exp(S^T scale - lse) in place; zero where kv > q (causal), kv
    // >= skv or q >= sq: row r's valid columns are lo_r <= col < hi.
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
    uint32_t frag[4][4];
    if (does_dk) {
      // dS^T = P^T (dP^T - delta), delta per column.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = drow[8 * jj + col_t + c];
          dp[4 * jj + c] = s[4 * jj + c] * (dp[4 * jj + c] - dl);
          dp[4 * jj + 2 + c] = s[4 * jj + 2 + c] * (dp[4 * jj + 2 + c] - dl);
        }
      }
      pack_a(frag, dp);
    } else {
      pack_a(frag, s);
    }
    // dV[:, tile] += P^T dO[:, tile], or dK[:, tile] += dS^T Q[:, tile].
    mma_tile<NV>(sm, r, acc, frag);
  }

  if (does_dk)
    store_tile<NV, kStaged>(dk, acc, scale, scale, bb, kv_a, skv, hkv, kvh,
                            d, c0, col_t);
  else
    store_tile<NV, kStaged>(dv, acc, 1.f, 1.f, bb, kv_a, skv, hkv, kvh, d,
                            c0, col_t);
}

// dQ of a (q tile, q head, batch, column tile): Q and dO resident; per kv
// tile up to the diagonal the ring brings K's and V's boxes over d,
// interleaved, then the column tile's boxes of K.
template <int N, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dq, int b, int sq, int skv,
                               int hq, int hkv, int d, int n_qtiles,
                               int ring, float scale, float scale_log2,
                               int causal) {
  constexpr int NV = N / 64;
  const int nb = (d + 63) / 64;
  const int n_ct = tc_wide_col_tiles(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, 2 * nb, ring);
  const bf16* Qs = sm.res;
  const bf16* dOs = sm.res + static_cast<size_t>(nb) * kBox;

  const int per = n_ct * hq * b;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int ct = rem % n_ct;
  const int h = rem / n_ct % hq;
  const int bb = rem / n_ct / hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kB, c0 = ct * N;
  const int kv_end = causal ? min(skv, q0 + kB) : skv;
  const int n_kv = (kv_end + kB - 1) / kB;
  const int tid = threadIdx.x;

  init_barriers(sm, ring);
  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(sm.resbar, 2 * nb * kBoxBytes);
      for (int c = 0; c < nb; ++c) {
        tma_load_4d(sm.res + static_cast<size_t>(c) * kBox, &tq, sm.resbar,
                    64 * c, h, q0, bb);
        tma_load_4d(sm.res + static_cast<size_t>(nb + c) * kBox, &tdo,
                    sm.resbar, 64 * c, h, q0, bb);
      }
      Ring r(ring);
      for (int j = 0; j < n_kv; ++j) {
        for (int c = 0; c < nb; ++c) {
          put(sm, r, &tk, 64 * c, kvh, j * kB, bb);
          put(sm, r, &tv, 64 * c, kvh, j * kB, bb);
        }
        for (int i = 0; i < NV; ++i)
          put(sm, r, &tk, tile_col(c0, i, nb), kvh, j * kB, bb);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8
  const int row_b = row_a + 8;
  const int col_t = 2 * (lane & 3);
  const size_t lbase = (static_cast<size_t>(bb) * hq + h) * sq;
  const float l_a = row_a < sq ? lse[lbase + row_a] * kLog2e : 0.f;
  const float l_b = row_b < sq ? lse[lbase + row_b] * kLog2e : 0.f;
  const float d_a = row_a < sq ? delta[lbase + row_a] : 0.f;
  const float d_b = row_b < sq ? delta[lbase + row_b] : 0.f;

  float acc[NV][32];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  Ring r(ring);

  mbar_wait(sm.resbar, 0);
  for (int j = 0; j < n_kv; ++j) {
    // S = Q K^T and dP = dO V^T (q rows x kv columns) over d.
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    int prev = -1, prev2 = -1;
    for (int c = 0; c < nb; ++c) {
      const size_t off = static_cast<size_t>(c) * kBox;
      mma_box_abt(s, Qs + off, take(sm, r));
      const int slot = r.slot;
      r.next();
      mma_box_abt(dp, dOs + off, take(sm, r));
      const int slot2 = r.slot;
      r.next();
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) {
        release(sm, prev);
        release(sm, prev2);
      }
      prev = slot;
      prev2 = slot2;
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    release(sm, prev);
    release(sm, prev2);

    // P = exp(S scale - lse), zero where kv > q (causal), kv >= skv or
    // q >= sq; dS = P (dP - delta).
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
        const float pa =
            col < hi_a ? exp2f(s[4 * jj + c] * scale_log2 - l_a) : 0.f;
        const float pb =
            col < hi_b ? exp2f(s[4 * jj + 2 + c] * scale_log2 - l_b) : 0.f;
        dp[4 * jj + c] = pa * (dp[4 * jj + c] - d_a);
        dp[4 * jj + 2 + c] = pb * (dp[4 * jj + 2 + c] - d_b);
      }
    }
    // dQ[:, tile] += dS K[:, tile], dS rounded to bf16 as the A operand.
    uint32_t ds_frag[4][4];
    pack_a(ds_frag, dp);
    mma_tile<NV>(sm, r, acc, ds_frag);
  }

  store_tile<NV, kStaged>(dq, acc, scale, scale, bb, row_a, sq, hq, h, d,
                          c0, col_t);
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int N, bool kStaged = false>
int fwd_as(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, float* lse, int b, int sq,
           int skv, int hq, int hkv, int d, float scale, int causal,
           cudaStream_t stream) {
  const int nb = (d + 63) / 64;
  const int ring = ring_slots(nb, 0, 2, kFwdBlocks<N>);
  if (ring == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(nb, ring, 0);
  cudaError_t err = set_smem(flash_fwd_wgmma_wide_kernel<N, kStaged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (sq + kB - 1) / kB;
  flash_fwd_wgmma_wide_kernel<N, kStaged>
      <<<n_qtiles * hq * b * tc_wide_fwd_col_tiles(d), kThreads, smem,
         stream>>>(
          tq, tk, tv, static_cast<bf16*>(o), lse, b, sq, skv, hq, hkv, d,
          n_qtiles, ring, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int N, bool kStaged = false>
int bwd_as(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const CUtensorMap& tdo, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, int b, int sq,
           int skv, int hq, int hkv, int d, float scale, int causal,
           cudaStream_t stream) {
  const int nb = (d + 63) / 64;
  const size_t lsd = 2 * 2 * kB * sizeof(float);  // the dK/dV lse, delta
  const int ring_kv = ring_slots(2 * nb, lsd, 4, 1);
  const int ring_q = ring_slots(2 * nb, 0, 4, 1);
  if (ring_kv == 0 || ring_q == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t s_kv = smem_bytes(2 * nb, ring_kv, lsd);
  const size_t s_q = smem_bytes(2 * nb, ring_q, 0);
  cudaError_t err =
      set_smem(flash_bwd_dkdv_wgmma_wide_kernel<N, kStaged>, s_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem(flash_bwd_dq_wgmma_wide_kernel<N, kStaged>, s_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  const int n_ct = tc_wide_col_tiles(d);
  const int n_kt = (skv + kB - 1) / kB, n_qt = (sq + kB - 1) / kB;
  flash_bwd_dkdv_wgmma_wide_kernel<N, kStaged>
      <<<n_kt * hkv * b * n_ct * 2, kThreads, s_kv, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), b, sq, skv, hq, hkv, d, ring_kv, scale,
          scale_log2, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_wide_kernel<N, kStaged>
      <<<n_qt * hq * b * n_ct, kThreads, s_q, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), b, sq, skv,
          hq, hkv, d, n_qt, ring_q, scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcw
}  // namespace

namespace wgmma_wide {

// The forward where tc_wide_route(d) holds, on the caller's rows (ld 0); or
// where tc_wide_staged_route(d) holds, on copies whose rows are ld =
// staged_ld(d) elements apart (flash_stage_rows_kernel's), in the kStaged
// instantiations, which store O column by column at the real d. The tensor
// maps are encoded on every call (they hold the tensors' pointers, and a
// CUDA graph records them by value), at the real d. Any failure is
// returned: there is no other route.
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream, int ld) {
  CUtensorMap tq, tk, tv;
  if (!(ld == 0 ? tc_wide_route(d)
                : tc_wide_staged_route(d) && ld == staged_ld(d)) ||
      !make_map(&tq, q, b, sq, hq, d, ld) ||
      !make_map(&tk, k, b, skv, hkv, d, ld) ||
      !make_map(&tv, v, b, skv, hkv, d, ld))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ld != 0) {
    switch (tc_wide_fwd_tile_width(d)) {
      case 192: return tcw::fwd_as<192, true>(tq, tk, tv, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
      case 256: return tcw::fwd_as<256, true>(tq, tk, tv, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (tc_wide_fwd_tile_width(d)) {
    case 192: return tcw::fwd_as<192>(tq, tk, tv, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 256: return tcw::fwd_as<256>(tq, tk, tv, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's dK/dV and dQ kernels, delta already written; q, k, v and
// dout the caller's rows (ld 0) or their staged copies, as the forward's.
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream, int ld) {
  CUtensorMap tq, tk, tv, tdo;
  if (!(ld == 0 ? tc_wide_route(d)
                : tc_wide_staged_route(d) && ld == staged_ld(d)) ||
      !make_map(&tq, q, b, sq, hq, d, ld) ||
      !make_map(&tk, k, b, skv, hkv, d, ld) ||
      !make_map(&tv, v, b, skv, hkv, d, ld) ||
      !make_map(&tdo, dout, b, sq, hq, d, ld))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ld != 0) {
    switch (tc_wide_tile_width(d)) {
      case 192: return tcw::bwd_as<192, true>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, stream);
      case 256: return tcw::bwd_as<256, true>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (tc_wide_tile_width(d)) {
    case 192: return tcw::bwd_as<192>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 256: return tcw::bwd_as<256>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, b, sq, skv, hq, hkv, d, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wgmma_wide
}  // namespace repro
