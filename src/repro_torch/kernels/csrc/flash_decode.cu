// K2, K3, K4 — streaming flash-decode attention (one new token), for
// Hopper (sm_90a).
//
// Replace the TPU kernels `_flash_decode_kernel` (K2, dense, finalized),
// `_flash_decode_partial_kernel` (K3, dense, raw (m, l, o) partial per
// chunk of blocks) and `_flash_decode_paged_kernel` (K4, paged gather),
// launched by `flash_decode_pallas`, `flash_decode_partial_pallas` and
// `flash_decode_paged_pallas` (src/repro/kernels/flash_decode.py).  All
// three share one online-softmax step, mirroring `_online_softmax_step`:
// for each block of `bkv` KV rows,
//   s     = dot(q, k^T) * sm_scale + bias        (G, bkv)
//   m_new = max(m, max_j s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l     = l * alpha + sum_j p
//   acc   = acc * alpha + p @ v
// and at the end o = acc / max(l, 1e-30) (K2, K4) or the raw triple (K3).
// The mask value is -1e30, never -inf: a fully masked block gives p = 1 on
// every row until a valid block's alpha = 0 wipes them.
//
// Order (pinned once, also in flash_decode.py's docstring).
// * Inside a schedule block, every sum is the pass-through pairwise tree
//   of `core/trees.py`: each score over d, `sum_j p` and each (g, c) cell
//   of `p @ v` over the block's rows.  The pass-through tree of n leaves
//   is the right fold of the aligned power-of-two subtrees of n's binary
//   decomposition, largest first (T8 + (T4 + x12) for 13 leaves).  Here
//   a subtree of 2^L leaves sits in slot L of a register array; a push is
//   a binary-counter increment (merge `slot[L] + v` while bit L of the
//   count is set), and the close folds the set slots from the smallest
//   up.  Every slot index is a compile-time constant (the loops over L
//   are unrolled and only their conditions read the count), so the
//   stacks stay in registers.  A score is 8-column tree8 chunks pushed at
//   level 3 (leftover columns at level 0); a cell of `p @ v` is a fully
//   unrolled 32-row subtree per staged tile, pushed at level 5 (the rows
//   of a short last tile at level 0).  `sum_j p` is a warp's shuffle tree
//   over aligned row segments, padded with +0 to a power of two; p is
//   never -0, so the padding changes no bit.
// * K2 and K4 cut each request's stream into splits of `per` blocks
//   (per = max(1, SPLIT_ROWS / bkv), fixed by the wrapper).  Inside a
//   split the blocks fold in order from the initial registers (K3's
//   body).  A split whose bias entries are all exactly -1e30 is dead when
//   its request has a live split: it reads no K or V and is left out of
//   the merge.  A request with no live split computes every split.  The
//   computed partials of a request merge in order in the pass-through
//   tree of `flash_partial_combine`, then o / max(l, 1e-30).
// Products, adds, the max, expf and the division are elementwise IEEE
// operations, built with --fmad=false and without fast-math: no
// contraction, no flush to zero, no tensor cores.
//
// Design.  Three CUDA kernels for K2 and K4, one for K3:
// 1. `live_kernel` (K2, K4): one CUDA block per (split, request) reads the
//    split's bias entries and writes live[b][c] (the bias is 2 MB at the
//    full width of chip_smoke.py, against 2-4 GB of K and V).
// 2. `split_kernel`: one CUDA block of 128 threads (256 for d > 128) per
//    (kv head x group of query rows, request, split) - 4,096 at
//    chip_smoke.py's full width, where one CUDA block per (kv head,
//    request) gave 128 on 132 SMs.  G is cut into equal groups of at
//    most GMAX rows; the group size is a template parameter, so the trees
//    carry no runtime test per query row.  A dead split's block exits
//    after reading its request's flags.  A live one walks its schedule
//    blocks: the K tiles (scores), the softmax, the V tiles (p @ v).  K
//    and V rows stream through a ring of STAGES tiles of TILE rows in
//    shared memory, each filled by cp.async while the tile before it is
//    summed; every thread copies one fixed 16-byte piece of rows NT /
//    (d / 4) apart (every fourth row at d = 128).  Scores: lanes l and l + 16 of a warp own the two children of
//    the d-tree's root for one K row (a warp pair covers 32 rows) and
//    join them with one shuffle; each thread builds the trees of up to
//    ceil(G / (NT / 64)) query rows, so a k element loaded from shared
//    memory serves all of them.  p @ v: a thread owns a column of V and
//    every query row of its group.  The p @ v slots are declared inside
//    the V loop, so they never hold registers while the score trees run:
//    128 registers, four CUDA blocks an SM (`__launch_bounds__`; two ring
//    slots, 50 KB of shared memory each at d = 128, block 512).  It
//    writes the raw (m, l, o) of its split (K3: the outputs; K2, K4:
//    scratch the wrapper allocates).
// 3. `merge_kernel` (K2, K4): one CUDA block per (query head, request),
//    a thread per column, merges the computed partials in the pinned tree
//    and finalizes.
// The paged kernel differs only in the address of a tile: logical block
// j of request b is physical page table[b, j] (clamped into the pool).
// `tools/decode_phases.py` times each phase; PERF.md keeps the numbers.
//
// Bound.  Bytes: K and V of the live splits' rows, read once; the
// operations (4 * H * d per live row) are far below the f32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;          // K/V rows of one staged tile
constexpr int STAGES = 2;         // tiles in the cp.async ring
constexpr int GMAX = 8;           // query rows of one CUDA block
constexpr int DMAX = 256;         // largest head dim
constexpr int LV_D = 5;           // score slots: levels 3..7 (a child, 128)
constexpr int LV_T = 8;           // tile slots: levels 5..12 (4,096 rows)
constexpr int LV_C = 16;          // merge slots: up to 2^16 - 1 partials
constexpr int MAX_BLOCK = 1 << 12;
constexpr int LIVE_THREADS = 256;
constexpr float NEG = -1e30f;

struct Args {
  const float* q;      // (B, H, d)
  const float* k;      // dense (B, S, K, d) or pages (P, ps, K, d)
  const float* v;
  const float* bias;   // (B, S)  (paged: S = nb * ps)
  const int* table;    // (B, nb) page per logical block (paged only)
  const int* live;     // (B, C) split flags, or nullptr: every split (K3)
  float* o;            // (C, B, H, d) raw partial o
  float* m_out;        // (C, B, H)
  float* l_out;
  float* out;          // (B, H, d) finalized (K2, K4)
  int B, H, K, G, d;
  int S;               // rows of a request; dense rows >= S read as zero
  int bkv;             // rows per schedule block (paged: page size)
  int nb;              // schedule blocks per request
  int per;             // blocks per split
  int C;               // splits per request
  int pages;           // P (paged)
  int vec4;            // 16-byte copies (d % 4 == 0, aligned pointers)
  float sm_scale;
};

// Push v, the n-th subtree of 2^base leaves (n counted before the push),
// into slots indexed from level `base`.  No early exit: the unrolled loop
// keeps every slot index a constant, so the slots stay in registers.
template <int NL>
__device__ __forceinline__ void push(float (&slot)[NL], float v,
                                     unsigned n) {
  bool carry = true;
#pragma unroll
  for (int L = 0; L < NL; ++L) {
    if (carry) {
      if ((n >> L) & 1u) {
        v = slot[L] + v;
      } else {
        slot[L] = v;
        carry = false;
      }
    }
  }
}

// Fold the set slots of a count n from the smallest up into (v, have).
template <int NL>
__device__ __forceinline__ void close_slots(const float (&slot)[NL],
                                            unsigned n, float& v,
                                            bool& have) {
#pragma unroll
  for (int L = 0; L < NL; ++L) {
    if ((n >> L) & 1u) {
      v = have ? slot[L] + v : slot[L];
      have = true;
    }
  }
}

__device__ __forceinline__ float tree8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = smem_addr(dst);
  const int n = valid ? 4 : 0;     // 0: write a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// NG pass-through trees over columns [c0, c0 + n) of q_j[c] * kk[c], for
// the query rows g + j * gstep (rows of qs, stride dq; rows past the group
// are zeros); columns from c0 in 16-byte aligned 8-column pieces, each
// piece of kk loaded once for all NG trees.
template <int NG>
__device__ __forceinline__ void dot_trees(const float* qs, int dq, int g,
                                          int gstep, const float* kk,
                                          int c0, int n, float (&out)[NG]) {
  float slot[NG][LV_D] = {};
  const int nc = n >> 3, rem = n & 7;
  const float* qb = qs + g * dq + c0;
  kk += c0;
#pragma unroll
  for (int i = 0; i < DMAX / 16; ++i) {        // n <= DMAX / 2
    if (i < nc) {
      const float4 b0 = *reinterpret_cast<const float4*>(kk + 8 * i);
      const float4 b1 = *reinterpret_cast<const float4*>(kk + 8 * i + 4);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float* qq = qb + j * gstep * dq + 8 * i;
        const float4 a0 = *reinterpret_cast<const float4*>(qq);
        const float4 a1 = *reinterpret_cast<const float4*>(qq + 4);
        const float x[8] = {a0.x * b0.x, a0.y * b0.y, a0.z * b0.z,
                            a0.w * b0.w, a1.x * b1.x, a1.y * b1.y,
                            a1.z * b1.z, a1.w * b1.w};
        push(slot[j], tree8(x), static_cast<unsigned>(i));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const float* qq = qb + j * gstep * dq + 8 * nc;
    float ls[3] = {};
#pragma unroll
    for (int e = 0; e < 7; ++e)
      if (e < rem) push(ls, qq[e] * kk[8 * nc + e], e);
    float v = 0.f;
    bool have = false;
    close_slots(ls, rem, v, have);
    close_slots(slot[j], nc, v, have);
    out[j] = v;
  }
}

// The scores of one staged K tile.  The d-tree's root joins its two
// children: columns [0, half) (half the largest power of two below d) and
// [half, d).  Lane l of warp w owns row (w % 2) * 16 + l % 16 and child
// l / 16; warp pair w / 2 owns query rows w / 2, w / 2 + NT / 64, ...
// The two children meet with one shuffle, left + right.
template <int GC, int NT>
__device__ __forceinline__ void tile_scores(const Args& a, int b,
                                            long long pos0, int r0, int nrow,
                                            const float* tile, int ld,
                                            const float* qs, int dq,
                                            float* ss, int lds) {
  constexpr int NSETS = NT / 64;
  constexpr int NG = (GC + NSETS - 1) / NSETS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int set = w >> 1, child = lane >> 4;
  const int r = (w & 1) * 16 + (lane & 15);
  if (set >= GC) return;                       // whole warps
  int half = 1;
  while (2 * half < a.d) half *= 2;
  const int c0 = child ? half : 0;
  const int n = child ? a.d - half : min(half, a.d);
  const long long pos = pos0 + r0 + r;       // the bias load first: its
  const float bj = pos < a.S && r < nrow      // latency hides under the trees
                       ? a.bias[static_cast<long long>(b) * a.S + pos] : NEG;
  float s[NG];
  dot_trees<NG>(qs, dq, set, NSETS, tile + r * ld, c0, n, s);
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const float right = __shfl_xor_sync(0xffffffffu, s[j], 16);
    const int g = set + j * NSETS;
    if (child == 0 && r < nrow && (GC % NSETS == 0 || g < GC)) {
      const float tot = a.d > half ? s[j] + right : s[j];
      ss[g * lds + r0 + r] = tot * a.sm_scale + bj;
    }
  }
}

// m_new, alpha, p and l of one schedule block: one warp per query row.
template <int GC, int NT>
__device__ __forceinline__ void block_softmax(int bkv, float* ss, int lds,
                                              float* mrow, float* lrow,
                                              float* alpha) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int p2 = 1;
  while (p2 < bkv) p2 <<= 1;
  const int seg = p2 >= 32 ? p2 / 32 : 1;
  for (int g = warp; g < GC; g += NW) {
    float* sg = ss + g * lds;
    float mx = -INFINITY;
    for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, sg[j]);
    for (int off = 16; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = mrow[g];
    const float m_new = fmaxf(m_prev, mx);
    const float al = expf(m_prev - m_new);
    for (int j = lane; j < bkv; j += 32) sg[j] = expf(sg[j] - m_new);
    __syncwarp();
    float part = 0.f;
    bool have = false;
    const int r0 = lane * seg;
    if (r0 < p2 && seg >= 8) {                  // tree8 chunks at level 3
      float slot[LV_T] = {};
      for (int ch = 0; ch < seg / 8; ++ch) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int row = r0 + 8 * ch + u;
          x[u] = row < bkv ? sg[row] : 0.f;
        }
        push(slot, tree8(x), static_cast<unsigned>(ch));
      }
      close_slots(slot, static_cast<unsigned>(seg / 8), part, have);
    } else if (r0 < p2) {                       // leaves at level 0
      float slot[3] = {};
      for (int j = 0; j < seg; ++j)
        push(slot, r0 + j < bkv ? sg[r0 + j] : 0.f, static_cast<unsigned>(j));
      close_slots(slot, static_cast<unsigned>(seg), part, have);
    }
    for (int off = 1; off < 32; off <<= 1)
      part = part + __shfl_down_sync(0xffffffffu, part, off);
    if (lane == 0) {
      lrow[g] = lrow[g] * al + part;
      mrow[g] = m_new;
      alpha[g] = al;
    }
  }
}

// p @ v of one full staged V tile (TILE rows) for column c: per query row
// a 32-leaf subtree, pushed at level 5 as the t-th tile of the block.
template <int GC>
__device__ __forceinline__ void tile_pv_full(int c, const float* tile,
                                             int ld, const float* ss, int lds,
                                             int r0, unsigned t,
                                             float (&tslot)[GC][LV_T]) {
  float sub[GC][3];
#pragma unroll
  for (int q8 = 0; q8 < TILE / 8; ++q8) {
    float vv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) vv[u] = tile[(q8 * 8 + u) * ld + c];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float* pp = ss + g * lds + r0 + q8 * 8;
      const float4 p0 = *reinterpret_cast<const float4*>(pp);
      const float4 p1 = *reinterpret_cast<const float4*>(pp + 4);
      const float x[8] = {p0.x * vv[0], p0.y * vv[1], p0.z * vv[2],
                          p0.w * vv[3], p1.x * vv[4], p1.y * vv[5],
                          p1.z * vv[6], p1.w * vv[7]};
      push(sub[g], tree8(x), static_cast<unsigned>(q8));
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) push(tslot[g], sub[g][2], t);
}

__global__ void __launch_bounds__(LIVE_THREADS) live_kernel(Args a) {
  const int c = blockIdx.x, b = blockIdx.y;
  const long long span = static_cast<long long>(a.per) * a.bkv;
  const long long lo = c * span;
  const long long hi = min(lo + span, static_cast<long long>(a.S));
  const float* bias = a.bias + static_cast<long long>(b) * a.S;
  int any = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += LIVE_THREADS)
    any |= bias[i] != NEG;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0)
    const_cast<int*>(a.live)[static_cast<long long>(b) * a.C + c] = any;
}

template <int GC, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
    split_kernel(Args a, int ngrp) {
  extern __shared__ __align__(16) float smem[];
  const int G = a.G, d = a.d, bkv = a.bkv;
  const int kh = blockIdx.x / ngrp, grp = blockIdx.x % ngrp;
  const int g0 = grp * GC;
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;

  if (a.live != nullptr) {           // K2, K4: skip a dead split
    const int* lv = a.live + static_cast<long long>(b) * a.C;
    int any = 0;
    for (int i = tid; i < a.C; i += NT) any |= lv[i];
    any = __syncthreads_or(any);
    if (any && !lv[split]) return;
  }

  const int dq = (d + 3) & ~3, ld = dq + 4, lds = (bkv + 3) & ~3;
  float* ring = smem;                          // STAGES * TILE * ld
  float* qs = ring + STAGES * TILE * ld;       // GMAX * dq query rows
  float* ss = qs + GMAX * dq;                  // GC * lds scores, then p
  float* mrow = ss + GC * lds;                 // GMAX running max
  float* lrow = mrow + GMAX;                   // GMAX running denominator
  float* alpha = lrow + GMAX;                  // GMAX rescale of the block

  const long long h0 = static_cast<long long>(b) * a.H + kh * G + g0;
  for (int e = tid; e < GMAX * dq; e += NT) {
    const int g = e / dq, col = e - g * dq;
    qs[e] = g < GC && col < d ? a.q[(h0 + g) * d + col] : 0.f;
  }
  if (tid < GMAX) {
    mrow[tid] = NEG;
    lrow[tid] = 0.f;
  }

  // the tile stream of the split: per block nt K tiles, then nt V tiles
  const int blk0 = split * a.per;
  const int nblk = min(a.per, a.nb - blk0);
  const int nt = (bkv + TILE - 1) / TILE;
  const int units = nblk * 2 * nt;             // tiles of the split
  const long long rstride = static_cast<long long>(a.K) * d;
  // Tile u's rows: their first float (rows of a tile lie in one block,
  // one page, K * d floats apart), how many, and how many lie below S.
  auto rows_of = [&](int u, const float*& src, int& nrow, int& nvalid) {
    const int blk = blk0 + u / (2 * nt), w = u % (2 * nt);
    const int r0 = (w % nt) * TILE;
    nrow = min(TILE, bkv - r0);
    nvalid = nrow;
    long long first;
    if (a.table != nullptr) {
      int page = a.table[static_cast<long long>(b) * a.nb + blk];
      page = min(max(page, 0), a.pages - 1);
      first = ((static_cast<long long>(page) * bkv + r0) * a.K + kh) * d;
    } else {
      const long long pos0 = static_cast<long long>(blk) * bkv + r0;
      first = ((static_cast<long long>(b) * a.S + pos0) * a.K + kh) * d;
      nvalid = static_cast<int>(
          max(0LL, min(static_cast<long long>(nrow), a.S - pos0)));
    }
    src = (w < nt ? a.k : a.v) + first;
  };
  // Stage tile u into its ring slot with cp.async: 16-byte pieces where
  // d % 4 == 0 (else 4-byte ones); rows past S are filled with zeros.
  // Thread tid copies piece pc0 of rows pr0, pr0 + pdr, ... when the
  // pieces of a row divide NT, else it walks the pieces NT apart.
  const int unit = a.vec4 ? 4 : 1, pieces = d / unit;
  const int pr0 = tid / pieces, pc0 = tid - pr0 * pieces;
  const int pdr = NT / pieces;
  const bool even = pdr * pieces == NT;
  auto issue = [&](int u) {
    if (u < units) {
      const float* src;
      int nrow, nvalid;
      rows_of(u, src, nrow, nvalid);
      float* tile = ring + (u % STAGES) * TILE * ld;
      if (even && a.vec4) {                     // pointers stepped, no products
        const float* from = src + pr0 * rstride + pc0 * 4;
        float* to = tile + pr0 * ld + pc0 * 4;
        for (int r = pr0; r < nrow; r += pdr) {
          cp_async16(to, r < nvalid ? from : a.k, r < nvalid);
          from += pdr * rstride;
          to += pdr * ld;
        }
      } else {
        for (int e = tid; e < nrow * pieces; e += NT) {
          const int r = e / pieces, col = (e - r * pieces) * unit;
          const bool ok = r < nvalid;
          const float* from = ok ? src + r * rstride + col : a.k;
          if (a.vec4)
            cp_async16(tile + r * ld + col, from, ok);
          else
            cp_async4(tile + r * ld + col, from, ok);
        }
      }
    }
    cp_commit();
  };

  const int c = tid;                           // this thread's column of o
  float acc[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) acc[g] = 0.f;

  // One schedule block at a time: its K tiles, the softmax, its V tiles.
  // The tree slots of p @ v live inside the V loop only, so the score
  // trees and the p @ v trees never hold registers at the same time.
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) issue(u);
  int u = 0;
  for (int blk = blk0; blk < blk0 + nblk; ++blk) {
    for (int t = 0; t < nt; ++t, ++u) {         // K tiles: scores
      cp_wait();
      __syncthreads();
      issue(u + STAGES - 1);
      const int r0 = t * TILE;
      tile_scores<GC, NT>(a, b, static_cast<long long>(blk) * bkv, r0,
                          min(TILE, bkv - r0),
                          ring + (u % STAGES) * TILE * ld, ld, qs, dq, ss,
                          lds);
    }
    __syncthreads();
    block_softmax<GC, NT>(bkv, ss, lds, mrow, lrow, alpha);
    __syncthreads();
    float tslot[GC][LV_T] = {};
    for (int t = 0; t < nt; ++t, ++u) {         // V tiles: p @ v
      cp_wait();
      __syncthreads();
      issue(u + STAGES - 1);
      const int r0 = t * TILE, nrow = min(TILE, bkv - r0);
      const float* tile = ring + (u % STAGES) * TILE * ld;
      if (c < d && nrow == TILE)
        tile_pv_full<GC>(c, tile, ld, ss, lds, r0, t, tslot);
      if (c < d && t == nt - 1) {               // close the block's trees
        const unsigned full = bkv / TILE;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float v = 0.f;
          bool have = false;
          if (nrow < TILE) {                    // a short last tile
            float ls[5] = {};
            for (int j = 0; j < nrow; ++j)
              push(ls, ss[g * lds + r0 + j] * tile[j * ld + c],
                   static_cast<unsigned>(j));
            close_slots(ls, static_cast<unsigned>(nrow), v, have);
          }
          close_slots(tslot[g], full, v, have);
          acc[g] = acc[g] * alpha[g] + v;
        }
      }
    }
  }
  cp_wait();

  const long long out0 = static_cast<long long>(split) * a.B * a.H + h0;
  if (c < d) {
#pragma unroll
    for (int g = 0; g < GC; ++g) a.o[(out0 + g) * d + c] = acc[g];
  }
  if (tid < GC) {
    a.m_out[out0 + tid] = mrow[tid];
    a.l_out[out0 + tid] = lrow[tid];
  }
}

struct Part {
  float m, l, o;
};

// flash_partial_combine(x, y): x the earlier partial.
__device__ __forceinline__ Part combine(const Part& x, const Part& y) {
  const float m = fmaxf(x.m, y.m);
  const float a1 = expf(x.m - m), a2 = expf(y.m - m);
  return {m, x.l * a1 + y.l * a2, x.o * a1 + y.o * a2};
}

__global__ void merge_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int* lv = a.live + static_cast<long long>(b) * a.C;
  int any = 0;
  for (int i = threadIdx.x; i < a.C; i += blockDim.x) any |= lv[i];
  any = __syncthreads_or(any);
  Part slot[LV_C];
  unsigned n = 0;
  for (int s = 0; s < a.C; ++s) {
    if (any && !lv[s]) continue;
    const long long i = (static_cast<long long>(s) * a.B + b) * a.H + h;
    Part v{a.m_out[i], a.l_out[i], c < a.d ? a.o[i * a.d + c] : 0.f};
    bool carry = true;                  // push, as `push` above
#pragma unroll
    for (int L = 0; L < LV_C; ++L) {
      if (carry) {
        if ((n >> L) & 1u) {
          v = combine(slot[L], v);
        } else {
          slot[L] = v;
          carry = false;
        }
      }
    }
    ++n;
  }
  Part v{0.f, 0.f, 0.f};
  bool have = false;
#pragma unroll
  for (int L = 0; L < LV_C; ++L) {
    if ((n >> L) & 1u) {
      v = have ? combine(slot[L], v) : slot[L];
      have = true;
    }
  }
  if (c < a.d)
    a.out[(static_cast<long long>(b) * a.H + h) * a.d + c] =
        v.o / fmaxf(v.l, 1e-30f);
}

// Query rows of one CUDA block: G split into the fewest equal groups of
// at most GMAX rows.
int group_rows(int G) {
  int n = (G + GMAX - 1) / GMAX;
  while (G % n) ++n;
  return G / n;
}

// Bytes of dynamic shared memory; flash_decode.py's `smem_bytes` mirrors it.
size_t smem_bytes(int gc, int d, int bkv) {
  const size_t dq = (d + 3) & ~3, lds = (bkv + 3) & ~3;
  return 4 * (STAGES * TILE * (dq + 4) + GMAX * dq + gc * lds + 3 * GMAX);
}

template <int GC, int NT>
int launch_split(const Args& a, cudaStream_t stream) {
  auto kern = split_kernel<GC, NT>;
  const size_t smem = smem_bytes(GC, a.d, a.bkv);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int ngrp = a.G / GC;
  dim3 grid(a.K * ngrp, a.B, a.C);
  kern<<<grid, NT, smem, stream>>>(a, ngrp);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_split_gc(const Args& a, cudaStream_t stream) {
  switch (group_rows(a.G)) {
    case 1: return launch_split<1, NT>(a, stream);
    case 2: return launch_split<2, NT>(a, stream);
    case 3: return launch_split<3, NT>(a, stream);
    case 4: return launch_split<4, NT>(a, stream);
    case 5: return launch_split<5, NT>(a, stream);
    case 6: return launch_split<6, NT>(a, stream);
    case 7: return launch_split<7, NT>(a, stream);
    default: return launch_split<8, NT>(a, stream);
  }
}

}  // namespace

// mode: 0 dense finalized (K2), 1 dense raw partial (K3), 2 paged (K4).
// K3 writes its partials to (o, m_out, l_out); K2 and K4 write them to
// that scratch, with the split flags in `live` (B, C), and the finalized
// result to `out`.  Returns cudaGetLastError() after the last launch (0 =
// launched), or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int flash_decode_launch(
    int mode, const void* q, const void* k, const void* v, const void* bias,
    const void* table, void* live, void* o, void* m_out, void* l_out,
    void* out, int B, int H, int K, int d, int S, int bkv, int nb, int per,
    int pages, int vec4, float sm_scale, void* stream) {
  if (K <= 0 || H % K != 0 || d <= 0 || d > DMAX || bkv <= 0 || nb <= 0 ||
      per <= 0 || bkv > MAX_BLOCK || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = (nb + per - 1) / per;
  const bool merged = mode != 1;
  if (C >= (1 << LV_C) || C > 65535 || (merged && (!live || !out)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(bias),
         mode == 2 ? static_cast<const int*>(table) : nullptr,
         merged ? static_cast<const int*>(live) : nullptr,
         static_cast<float*>(o), static_cast<float*>(m_out),
         static_cast<float*>(l_out), static_cast<float*>(out),
         B, H, K, H / K, d, S, bkv, nb, per, C, pages, vec4, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (merged) {
    live_kernel<<<dim3(C, B), LIVE_THREADS, 0, s>>>(a);
    const int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
  }
  const int e = d <= 128 ? launch_split_gc<128>(a, s)
                         : launch_split_gc<256>(a, s);
  if (e != 0 || !merged) return e;
  merge_kernel<<<dim3(H, B), (d + 31) / 32 * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
