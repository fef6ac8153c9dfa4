// K1 — the JugglePAC block schedule with the accuracy-policy carry, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_segsum_policy_kernel`, launched by
// `segsum_policy_pallas` (src/repro/kernels/jugglepac_segsum.py).  Same
// function: a (N, W) domain stream with (N,) int32 labels, cut into
// schedule blocks of B rows; each block's (S, W) contribution folds into
// the tier's carry strictly in block order.  Rows past N (the ragged last
// block) read as sentinel rows.
//
// Design.  On the TPU the grid runs in order on one core and the carry
// sits in VMEM across grid steps.  Here CUDA blocks run in parallel and in
// no order, so the ordered fold is a loop inside each CUDA block: a CUDA
// block owns one (label tile x column tile) of the carry — one
// (segment, raw column) cell per thread, in registers — and walks every
// schedule block of the stream in order.  The label tiles are the grid's
// y dimension (`seg_tile_for` in ops.py sizes them); the column tiles its
// x dimension.
//
// Bound.  The least the card can do is read the stream once:
// N * (W + 1) * 4 bytes over the memory rate.  A label tile that read the
// whole stream would read it once per tile.  Instead, 32 warps check 32
// schedule blocks' labels at a time and a CUDA block loads the values of
// only the schedule blocks that hold one of its labels; the others fold
// an all-zero contribution (an identity the float tiers still apply, so
// the op sequence is the plain version's).  With back-to-back sets the
// values are read about once in all, and each CUDA block re-reads only
// the labels, N * 4 bytes.
//
// Numerics, per tier (exactly `Policy.update` in policy.py):
//   fast         acc += contrib
//   compensated  two_sum(acc, contrib); comp += e
//   exact        acc += contrib                      (int32, wrapping)
//   exact2       limb_split(q part) -> wrap_add into hi, lo; wrap_add of
//                the 7 residual digit planes; ovf += every wrap flag
//   procrastinate wrap_add of the 6 bins; ovf += every wrap flag
// Integer contributions are int32 sums, which any order gives to the bit:
// the dot form adds each cell's rows in a loop, the lane form scatters
// with int32 atomics into shared memory.  Float contributions follow the
// pinned order of policy.py: per lane, a pairwise tree over the lane's
// rows zero-padded to a power of two, where a row of another label is a
// +0 leaf; lanes folded in lane order.  Built with --fmad=false and
// without fast-math: no contraction, no flush-to-zero, no float atomics.
//
// The float tiers' tree.  A subtree whose rows all carry label s, or no
// label of the tile (sentinels, padding, rows past N, other tiles' labels:
// "wild" rows, +0 leaves for every label of the tile), sums for s to
// exactly the unmasked tree of its rows with the wild values set to +0,
// and for any other label to +0.  So a touched schedule block builds ONE
// unmasked tree per column in shared memory, in chunks of up to
// TREE_ROWS = 512 padded rows, and beside it one int per node: its pure
// label, WILD or MIXED.  Each thread stages 16 consecutive rows of its
// column, issuing all 32 loads (labels, values) before using any, and
// sums tree levels 1-4 in registers; the levels above take one barrier
// each.  Each thread then descends from the chunk's root for its own
// label, into MIXED nodes only, left child first, merging a finished
// right child with its left sibling on a register stack — the masked
// tree's bits, with one node visited for a chunk of one set and about
// 2 log2(C) at a set boundary, instead of C leaves.  Chunks are aligned
// subtrees of the lane's tree, so the binary-counter stack (`push_leaf`,
// `close_tree`) joins the chunk sums into the lane's sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FAST = 0;
constexpr int COMPENSATED = 1;
constexpr int EXACT = 2;
constexpr int EXACT2 = 3;
constexpr int PROCRASTINATE = 4;

// The float tiers' tree: a chunk of at most TREE_ROWS padded rows, so at
// most TREE_DEPTH left siblings wait on the descent's register stack.
constexpr int TREE_ROWS = 512;
constexpr int TREE_DEPTH = 9;
// A node's label when no row below it carries a label of the tile, and
// when rows of two or more of the tile's labels lie below it.
constexpr int WILD = -1;
constexpr int MIXED = -2;
// Consecutive rows of one column a thread stages and sums in registers:
// tree levels 0..GROUP_LOG of the chunk, written without a barrier.
constexpr int GROUP_ROWS = 16;
constexpr int GROUP_LOG = 4;
static_assert(GROUP_ROWS == 1 << GROUP_LOG, "a group is a subtree");

template <int TIER> struct Tier;
template <> struct Tier<FAST> {
  static constexpr int PARTS = 1; static constexpr bool INT = false;
  using In = float;
};
template <> struct Tier<COMPENSATED> {
  static constexpr int PARTS = 1; static constexpr bool INT = false;
  using In = float;
};
template <> struct Tier<EXACT> {
  static constexpr int PARTS = 1; static constexpr bool INT = true;
  using In = int;
};
template <> struct Tier<EXACT2> {    // [q | 7 residual digit planes]
  static constexpr int PARTS = 8; static constexpr bool INT = true;
  using In = float;
};
template <> struct Tier<PROCRASTINATE> {   // 6 exponent-bin planes
  static constexpr int PARTS = 6; static constexpr bool INT = true;
  using In = int;
};

struct Args {
  const void* values;   // (n_rows, PARTS * d), row-major
  const int* ids;       // (n_rows,) labels, absolute
  void* out0; void* out1; void* out2; void* out3;
  long long n_rows;
  int block_rows;       // B
  int num_segments;     // labels [seg_offset, seg_offset + num_segments)
  int seg_offset;
  int d;                // raw width: the carry's column count
  int lanes;            // float lane count (1 = dot form)
  int seg_tile;         // labels per CUDA block
  int col_tile;         // raw columns per CUDA block
  int chunk_rows;       // rows staged in shared memory at a time (float
                        // tiers: the tree chunk, a power of two)
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// intac.wrap_add: the sum and, into `flags`, its two's-complement wrap.
__device__ __forceinline__ int wrap_add(int a, int b, int& flags) {
  int s = wadd(a, b);
  flags = wadd(flags, ((a ^ s) & (b ^ s)) < 0 ? 1 : 0);
  return s;
}

// One leaf into the pairwise tree: after leaf i, merge ctz(i + 1) times,
// older (left) subtree first — the tree `x[0::2] + x[1::2]` builds.
__device__ __forceinline__ void push_leaf(float v, float* stk, int& sp,
                                          unsigned& cnt) {
  unsigned c = ++cnt;
  while ((c & 1u) == 0u) {
    v = stk[--sp] + v;
    c >>= 1;
  }
  stk[sp++] = v;
}

__device__ __forceinline__ float close_tree(float* stk, int& sp,
                                            unsigned& cnt) {
  unsigned p2 = 1u;
  while (p2 < cnt) p2 <<= 1;
  while (cnt < p2) push_leaf(0.f, stk, sp, cnt);
  return stk[0];
}

__device__ __forceinline__ void two_sum_update(float& acc, float& comp,
                                               float c) {
  float s = acc + c;
  float bp = s - acc;
  float e = (acc - (s - bp)) + (c - bp);
  acc = s;
  comp = comp + e;
}

// First node of tree level h in a chunk of C leaves: level 0 holds the C
// leaves, level h the C >> h sums of level h - 1's pairs.
__device__ __forceinline__ int level_start(int C, int h) {
  return 2 * C - ((2 * C) >> h);
}

__device__ __forceinline__ int pure_label(int a, int b) {
  return a == b ? a : a == WILD ? b : b == WILD ? a : MIXED;
}

// A group's M nodes of one tree level, from registers to the chunk's
// tree: the first m of them (fewer where the chunk is smaller than a
// group).  Constant indices only, so v and lab stay in registers.
template <int M>
__device__ __forceinline__ void put_level(const float* v, const int* lab,
                                          float* tval, int* tlab, int first,
                                          int m, int ct, int tx) {
#pragma unroll
  for (int u = 0; u < M; ++u) {
    if (u < m) {
      tval[(first + u) * ct + tx] = v[u];
      if (tx == 0) tlab[first + u] = lab[u];
    }
  }
}

// The next level up of a group's register tree: M sums of pairs.
template <int M>
__device__ __forceinline__ void pair_up(float* v, int* lab) {
#pragma unroll
  for (int u = 0; u < M; ++u) {
    v[u] = v[2 * u] + v[2 * u + 1];
    lab[u] = pure_label(lab[2 * u], lab[2 * u + 1]);
  }
}

// The descent's stack of finished left siblings, top at r[0].  Only
// constant indices, so it stays in registers.
struct Pending {
  float r[TREE_DEPTH];
  __device__ __forceinline__ void push(float v) {
#pragma unroll
    for (int k = TREE_DEPTH - 1; k > 0; --k) r[k] = r[k - 1];
    r[0] = v;
  }
  __device__ __forceinline__ float pop() {
    const float v = r[0];
#pragma unroll
    for (int k = 0; k < TREE_DEPTH - 1; ++k) r[k] = r[k + 1];
    return v;
  }
};

// The chunk's masked tree sum for label s in column col: a node pure for
// s gives its unmasked value, a node pure for another label (or wild)
// gives +0, a MIXED node the sum of its children, left first.  Walks the
// MIXED nodes depth first; a finished right child merges with its left
// sibling, which waits on the stack.
__device__ float descend(const int* tlab, const float* tval, int C,
                         int log_c, int ct, int s, int col) {
  Pending stk;
  int h = log_c, i = 0;
  for (;;) {
    const int node = level_start(C, h) + i;
    const int lab = tlab[node];
    if (lab == MIXED) {           // only above level 0
      --h;
      i <<= 1;
      continue;
    }
    float v = lab == s ? tval[node * ct + col] : 0.f;
    while (i & 1) {
      v = stk.pop() + v;
      i >>= 1;
      ++h;
    }
    if (h == log_c) return v;
    stk.push(v);
    ++i;
  }
}

template <typename In>
__device__ __forceinline__ int load_bits(const In* p);
template <>
__device__ __forceinline__ int load_bits<float>(const float* p) {
  return __float_as_int(*p);
}
template <>
__device__ __forceinline__ int load_bits<int>(const int* p) { return *p; }

// One touched schedule block's float contribution (rows [r0, r0 + B)) to
// the carry cell (ty, tx); +0 for a thread outside the tile.  Every thread
// of the CUDA block calls it: it synchronizes.  `present[s] == gen` marks
// the labels of the chunk being summed; each chunk takes the next `gen`.
__device__ float float_block(const Args& a, long long r0, int base,
                             int tile_segs, int cols, int d0, bool active,
                             int ty, int tx, int* present, int& gen,
                             int* tlab, float* tval) {
  const int B = a.block_rows, ct = a.col_tile;
  const int col_threads = blockDim.x / ct;    // threads per column
  const bool builds = ty < col_threads;       // stages and builds the tree
  const long long n = a.n_rows, d = a.d;
  const float* vals = static_cast<const float*>(a.values);
  float stk[33];                   // chunk sums: at most 32 levels
  float total = 0.f;
  for (int k = 0; k < a.lanes; ++k) {
    // lane k: rows [lo, lo + len) padded to L, cut into chunks of C
    const int lo = static_cast<int>((static_cast<long long>(k) * B) / a.lanes);
    const int len = static_cast<int>(
        (static_cast<long long>(k + 1) * B) / a.lanes) - lo;
    int L = 1;
    while (L < len) L <<= 1;
    const int C = min(L, a.chunk_rows);
    const int log_c = 31 - __clz(C);
    const int G = min(C, GROUP_ROWS), log_g = min(log_c, GROUP_LOG);
    const long long row0 = r0 + lo;
    int sp = 0;
    unsigned cnt = 0u;
    for (int c0 = 0; c0 < len; c0 += C) {
      ++gen;
      // Levels 0..log_g: thread (tx, ty) takes G consecutive rows of
      // column tx.  A row with no label of the tile is WILD with value
      // +0 (its loaded value is dropped); so are padding and rows past N.
      for (int grp = ty; builds && grp < C / G; grp += col_threads) {
        const int j0 = c0 + grp * G;
        float v[GROUP_ROWS];
        int lab[GROUP_ROWS];
#pragma unroll
        for (int u = 0; u < GROUP_ROWS; ++u) {    // every load before any use
          const long long g = row0 + j0 + u;
          lab[u] = base - 1;                        // no label of the tile
          v[u] = 0.f;
          if (u < G && j0 + u < len && g < n) {
            lab[u] = a.ids[g];
            if (tx < cols) v[u] = vals[g * d + d0 + tx];
          }
        }
#pragma unroll
        for (int u = 0; u < GROUP_ROWS; ++u) {
          const int loc = lab[u] - base;
          const bool mine =
              static_cast<unsigned>(loc) < static_cast<unsigned>(tile_segs);
          lab[u] = mine ? loc : WILD;
          v[u] = mine ? v[u] : 0.f;
          if (tx == 0 && mine) present[loc] = gen;
        }
        // GROUP_LOG = 4 levels, each pairing the one below, left first
        const int first = grp * G;
        put_level<16>(v, lab, tval, tlab, first, G, ct, tx);
        if (log_g >= 1) {
          pair_up<8>(v, lab);
          put_level<8>(v, lab, tval, tlab, level_start(C, 1) + first / 2,
                       G >> 1, ct, tx);
        }
        if (log_g >= 2) {
          pair_up<4>(v, lab);
          put_level<4>(v, lab, tval, tlab, level_start(C, 2) + first / 4,
                       G >> 2, ct, tx);
        }
        if (log_g >= 3) {
          pair_up<2>(v, lab);
          put_level<2>(v, lab, tval, tlab, level_start(C, 3) + first / 8,
                       G >> 3, ct, tx);
        }
        if (log_g >= 4) {
          pair_up<1>(v, lab);
          put_level<1>(v, lab, tval, tlab, level_start(C, 4) + first / 16,
                       1, ct, tx);
        }
      }
      __syncthreads();
      // levels log_g + 1 .. log_c in shared memory, one barrier each
      for (int h = log_g + 1; h <= log_c; ++h) {
        const int nodes = C >> h;
        const int src = level_start(C, h - 1), dst = level_start(C, h);
        for (int i = ty; builds && i < nodes; i += col_threads) {
          const int x = (src + 2 * i) * ct + tx;
          tval[(dst + i) * ct + tx] = tval[x] + tval[x + ct];
          if (tx == 0)
            tlab[dst + i] =
                pure_label(tlab[src + 2 * i], tlab[src + 2 * i + 1]);
        }
        __syncthreads();
      }
      float part = 0.f;
      if (active && present[ty] == gen)
        part = descend(tlab, tval, C, log_c, ct, ty, tx);
      push_leaf(part, stk, sp, cnt);
      __syncthreads();
    }
    const float part = close_tree(stk, sp, cnt);
    total = k == 0 ? part : total + part;
  }
  return total;
}

template <int TIER, bool LANES>
__global__ void segsum_policy_kernel(Args a) {
  using T = Tier<TIER>;
  constexpr int P = T::PARTS;
  constexpr bool INT = T::INT;
  using In = typename T::In;
  extern __shared__ int smem[];
  const int ct = a.col_tile, st = a.seg_tile, cr = a.chunk_rows;
  int* flags = smem;                     // 32 schedule-block hit flags
  int* present = flags + 32;             // st: label present in the block
                                         // (float tiers: in the chunk)
  // integer tiers
  int* sid = present + st;               // cr: tile-local labels
  int* sval = sid + cr;                  // cr * P * ct staged values
  int* scratch = sval + cr * P * ct;     // st * P * ct int32 lane sums
  // float tiers: a chunk's tree of 2 cr - 1 nodes
  int* tlab = present + st;              // each node's pure label
  float* tval = reinterpret_cast<float*>(tlab + 2 * cr - 1);  // x ct

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tx = tid % ct, ty = tid / ct;
  const int d0 = blockIdx.x * ct, seg0 = blockIdx.y * st;
  const int tile_segs = min(st, a.num_segments - seg0);
  const int cols = min(ct, a.d - d0);
  const bool active = ty < tile_segs && tx < cols;
  const int B = a.block_rows;
  const long long n = a.n_rows;
  const long long nb = (n + B - 1) / B;
  const long long W = static_cast<long long>(P) * a.d;
  const int base = a.seg_offset + seg0;
  const In* vals = static_cast<const In*>(a.values);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

  // the carry cell (segment seg0 + ty, column d0 + tx)
  float facc = 0.f, fcomp = 0.f;
  int iacc = 0, hi = 0, lo = 0, ovf = 0;
  int bins[P > 1 ? P : 1];
#pragma unroll
  for (int k = 0; k < (P > 1 ? P : 1); ++k) bins[k] = 0;

  int gen = 0;                           // float tiers: the chunk count
  if (!INT)
    for (int s = tid; s < st; s += nthr) present[s] = 0;

  auto float_update = [&](float c) {
    if (TIER == FAST) {
      facc = facc + c;
    } else {
      two_sum_update(facc, fcomp, c);
    }
  };

  for (long long b0 = 0; b0 < nb; b0 += 32) {
    // which of the next 32 schedule blocks hold a label of this tile
    for (int j = warp; j < 32; j += nwarps) {
      const long long blk = b0 + j;
      int hit = 0;
      if (blk < nb) {
        const long long r1 = min(blk * B + B, n);
        for (long long r = blk * B + lane; r < r1; r += 32) {
          const int loc = a.ids[r] - base;
          hit |= static_cast<unsigned>(loc) < static_cast<unsigned>(tile_segs);
        }
      }
      hit = __any_sync(0xffffffffu, hit);
      if (lane == 0) flags[j] = hit;
    }
    __syncthreads();

    for (int j = 0; j < 32 && b0 + j < nb; ++j) {
      if (!flags[j]) {
        if (!INT && active) float_update(0.f);   // the plain fold of +0
        continue;
      }
      const long long r0 = (b0 + j) * B;
      if constexpr (!INT) {
        const float c = float_block(a, r0, base, tile_segs, cols, d0, active,
                                    ty, tx, present, gen, tlab, tval);
        if (active) float_update(c);
      } else {
        for (int s = tid; s < st; s += nthr) present[s] = 0;
        if (LANES) {
          for (int e = tid; e < st * P * ct; e += nthr) scratch[e] = 0;
        }
        __syncthreads();
        for (int r = tid; r < B; r += nthr) {
          if (r0 + r < n) {
            const int loc = a.ids[r0 + r] - base;
            if (static_cast<unsigned>(loc) < static_cast<unsigned>(tile_segs))
              present[loc] = 1;
          }
        }
        __syncthreads();
        const bool mine = active && present[ty];

        int ctr[P];
#pragma unroll
        for (int p = 0; p < P; ++p) ctr[p] = 0;

        for (int c0 = 0; c0 < B; c0 += cr) {
          const int rows = min(cr, B - c0);
          for (int r = tid; r < rows; r += nthr) {
            const long long g = r0 + c0 + r;
            sid[r] = g < n ? a.ids[g] - base : -1;
          }
          for (int e = tid; e < rows * P * ct; e += nthr) {
            const int c = e % ct, p = (e / ct) % P, r = e / (ct * P);
            const long long g = r0 + c0 + r;
            sval[e] = (g < n && c < cols)
                          ? load_bits<In>(vals + g * W + p * a.d + d0 + c)
                          : 0;
          }
          __syncthreads();
          if (LANES) {
            for (int e = tid; e < rows * P * ct; e += nthr) {
              const int loc = sid[e / (ct * P)];
              int v = sval[e];
              if (TIER == EXACT2) v = __float2int_rn(__int_as_float(v));
              if (v != 0 &&
                  static_cast<unsigned>(loc) < static_cast<unsigned>(tile_segs))
                atomicAdd(&scratch[loc * P * ct + e % (P * ct)], v);
            }
          } else if (mine) {
            for (int r = 0; r < rows; ++r) {
              if (sid[r] == ty) {
#pragma unroll
                for (int p = 0; p < P; ++p) {
                  int v = sval[(r * P + p) * ct + tx];
                  if (TIER == EXACT2) v = __float2int_rn(__int_as_float(v));
                  ctr[p] = wadd(ctr[p], v);
                }
              }
            }
          }
          __syncthreads();
        }

        if (mine) {
          if (LANES) {
#pragma unroll
            for (int p = 0; p < P; ++p)
              ctr[p] = scratch[(ty * P + p) * ct + tx];
          }
          if (TIER == EXACT) {
            iacc = wadd(iacc, ctr[0]);
          } else if (TIER == EXACT2) {
            int wb = 0;
            hi = wrap_add(hi, ctr[0] >> 15, wb);
            lo = wrap_add(lo, ctr[0] & 0x7fff, wb);
#pragma unroll
            for (int k = 1; k < P; ++k) bins[k] = wrap_add(bins[k], ctr[k], wb);
            ovf = wadd(ovf, wb);
          } else {
            int wb = 0;
#pragma unroll
            for (int k = 0; k < P; ++k) bins[k] = wrap_add(bins[k], ctr[k], wb);
            ovf = wadd(ovf, wb);
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();
  }

  if (!active) return;
  const long long s = seg0 + ty;
  const long long col = d0 + tx;
  const long long d = a.d;
  if (TIER == FAST) {
    static_cast<float*>(a.out0)[s * d + col] = facc;
  } else if (TIER == COMPENSATED) {
    static_cast<float*>(a.out0)[s * d + col] = facc;
    static_cast<float*>(a.out1)[s * d + col] = fcomp;
  } else if (TIER == EXACT) {
    static_cast<int*>(a.out0)[s * d + col] = iacc;
  } else if (TIER == EXACT2) {
    static_cast<int*>(a.out0)[s * d + col] = hi;
    static_cast<int*>(a.out1)[s * d + col] = lo;
#pragma unroll
    for (int k = 1; k < P; ++k)
      static_cast<int*>(a.out2)[s * (P - 1) * d + (k - 1) * d + col] = bins[k];
    static_cast<int*>(a.out3)[s * d + col] = ovf;
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k)
      static_cast<int*>(a.out0)[s * P * d + k * d + col] = bins[k];
    static_cast<int*>(a.out1)[s * d + col] = ovf;
  }
}

// Bytes of dynamic shared memory; ops.py's `segsum_smem_bytes` mirrors it.
size_t smem_bytes(const Args& a, int parts, bool int_lanes, bool float_tree) {
  if (float_tree)
    return (32 + a.seg_tile +
            (2 * static_cast<size_t>(a.chunk_rows) - 1) * (1 + a.col_tile)) * 4;
  size_t words = 32 + a.seg_tile + a.chunk_rows +
                 static_cast<size_t>(a.chunk_rows) * parts * a.col_tile;
  if (int_lanes) words += static_cast<size_t>(a.seg_tile) * parts * a.col_tile;
  return words * 4;
}

template <int TIER, bool LANES>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = segsum_policy_kernel<TIER, LANES>;
  constexpr bool float_tree = !Tier<TIER>::INT;
  // a float tier's tree chunk: a power of two of at most TREE_ROWS rows
  if (float_tree && (a.chunk_rows < 1 || a.chunk_rows > TREE_ROWS ||
                     (a.chunk_rows & (a.chunk_rows - 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a, Tier<TIER>::PARTS,
                                 Tier<TIER>::INT && LANES, float_tree);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((a.d + a.col_tile - 1) / a.col_tile,
            (a.num_segments + a.seg_tile - 1) / a.seg_tile);
  const int threads = ((a.col_tile * a.seg_tile + 31) / 32) * 32;
  kern<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int TIER>
int launch_form(const Args& a, int lanes_form, cudaStream_t stream) {
  return lanes_form ? launch<TIER, true>(a, stream)
                    : launch<TIER, false>(a, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for an unknown tier.
extern "C" int segsum_policy_launch(
    int tier, int lanes_form, const void* values, const void* ids,
    void* out0, void* out1, void* out2, void* out3, long long n_rows,
    int block_rows, int num_segments, int seg_offset, int d, int lanes,
    int seg_tile, int col_tile, int chunk_rows, void* stream) {
  Args a{values, static_cast<const int*>(ids), out0, out1, out2, out3,
         n_rows, block_rows, num_segments, seg_offset, d, lanes,
         seg_tile, col_tile, chunk_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case FAST: return launch_form<FAST>(a, lanes_form, s);
    case COMPENSATED: return launch_form<COMPENSATED>(a, lanes_form, s);
    case EXACT: return launch_form<EXACT>(a, lanes_form, s);
    case EXACT2: return launch_form<EXACT2>(a, lanes_form, s);
    case PROCRASTINATE: return launch_form<PROCRASTINATE>(a, lanes_form, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
