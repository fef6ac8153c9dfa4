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
// whole stream would read it once per tile.  Instead a pre-pass kernel
// (`block_ranges_kernel`, one warp per schedule block, launched just
// before K1 on the same stream) reads the labels once and writes each
// schedule block's least and greatest label of [seg_offset,
// seg_offset + num_segments), or (INT_MAX, INT_MIN) where it holds none.
// A CUDA block reads these pairs (8 bytes a schedule block, a window of
// one per thread at a time, the next window's loads in flight) and loads
// the rows of only the schedule blocks whose range meets its label tile.
// With back-to-back sets the values are read about once in all.
//
// Numerics, per tier (exactly `Policy.update` in policy.py):
//   fast         acc += contrib
//   compensated  two_sum(acc, contrib); comp += e
//   exact        acc += contrib                      (int32, wrapping)
//   exact2       limb_split(q part) -> wrap_add into hi, lo; wrap_add of
//                the 7 residual digit planes; ovf += every wrap flag
//   procrastinate wrap_add of the 6 bins; ovf += every wrap flag
// A schedule block whose range misses the tile holds none of its labels:
// its contribution is all zero.  The integer tiers skip it, since
// wrap_add(x, 0) is x with no wrap flag.  The float tiers must still fold
// that +0 (it turns a -0.0 carry into +0.0, as the plain version's fold
// does), but folding +0 is idempotent: after one fold no part of the
// carry is -0.0 (two_sum's error term of a finite sum and +0 is +0), x + +0
// is x for every other x, and a NaN stays the card's one canonical NaN.  So a run of skipped blocks folds
// one +0, just before the next touched block, or at the end.
// Float contributions follow the pinned order of policy.py: per lane, a
// pairwise tree over the lane's rows zero-padded to a power of two, where
// a row of another label is a +0 leaf; lanes folded in lane order.  Built
// with --fmad=false and without fast-math: no contraction, no
// flush-to-zero, no float atomics.
//
// The integer tiers' contribution is an int32 wrapping sum, which any
// order and any split of the rows gives to the bit; so the dot and lane
// forms are one code path.  While a touched schedule block is summed,
// threads own rows, not carry cells: a thread takes a run of consecutive
// rows of VEC columns of one plane (VEC = 4, one 16-byte load a row, where
// the width allows), issues the loads of GROUP_ROWS rows (labels and
// values) before using any, sums in registers while consecutive rows carry
// one label of the tile, and flushes the run with one int32 shared atomic
// per column where the label changes and at the end.  After one barrier
// each carry-cell thread reads its own cell of the (label x plane x
// column) scratch, zeroes it, and folds it, zero included.  The scratch is
// double-buffered, so a touched block costs one barrier.
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
//
// A schedule block whose range meets the tile may still hold none of its
// labels (its least label below the tile, its greatest above).  Then
// every row is wild, every node WILD, no label is present in any chunk,
// and every chunk pushes the literal +0.f: the binary-counter stack and
// the lane fold add +0 to +0 only, so `float_block` returns +0.f and the
// carry folds +0.f exactly as for a block the range test skipped.
//
// The one-label schedule (`segsum_wide_launch`, num_segments == 1: every
// unsegmented reduce, and every K1 launch of a train step).  The label
// schedule above collapses there: one label a tile, 16 columns and 32
// threads a CUDA block, a pre-pass that is not needed.  With one label
// every row is the label's or a +0 leaf (0 for the integer tiers), so no
// label tile, no descent into MIXED nodes and no range pre-pass is
// needed, and the work splits in two phases:
//   1. the ordered fold, column-wide (`wide_fold_kernel`): a thread owns
//      VEC = 4 consecutive raw columns of every plane (one 16-byte load a
//      row a plane, where d and the base are aligned; VEC = 1 otherwise),
//      a CUDA block of 256 threads 1,024 columns, and walks the schedule
//      blocks' contributions in block order, the loads of several blocks
//      issued before it folds any, with `Policy.update` as above; a float
//      tier folds every block, +0 included.  At B == 1 a block's
//      contribution is its row (the value where the label is the launch's,
//      0 or +0 elsewhere), so the launch is this one kernel reading the
//      stream once.
//   2. where B > 1, block contributions in parallel, just before phase 1
//      (`wide_contrib_kernel`): one CUDA block per (schedule block, 32 VEC
//      columns of the flat P * d row), 8 warps sharing the block's rows,
//      into an (nb, P * d) tensor the caller allocates.  Integer tiers:
//      each warp sums runs of 16 rows, then the warps' sums add, an int32
//      wrapping sum, which any split of the rows gives to the bit.  Float
//      tiers: per lane, chunks of up to TREE_ROWS padded rows; each warp
//      takes groups of 16 consecutive rows (aligned subtrees), sums them
//      level by level in registers, and the levels above the groups sum
//      in shared memory, left child first: the pinned pairwise tree, node
//      for node.  Chunks join on the binary-counter stack and lanes fold
//      in lane order, as in `float_block`.
// So the bits are the plain version's: each block's contribution is the
// same tree (float) or the same wrapping sum (integer), and phase 1 is the
// same left fold per carry cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  const int2* ranges;   // (nb,) each schedule block's label range
  void* out0; void* out1; void* out2; void* out3;
  long long n_rows;
  int block_rows;       // B
  int num_segments;     // labels [seg_offset, seg_offset + num_segments)
  int seg_offset;
  int d;                // raw width: the carry's column count
  int lanes;            // float lane count (1 = dot form)
  int seg_tile;         // labels per CUDA block
  int col_tile;         // raw columns per CUDA block
  int chunk_rows;       // float tiers: the tree chunk, a power of two
};

// The range of a schedule block with no label of [seg_offset,
// seg_offset + num_segments): it meets no label tile.
constexpr int NO_LO = 0x7fffffff;
constexpr int NO_HI = -0x7fffffff - 1;
// The pre-pass: one warp per schedule block.
constexpr int RANGE_THREADS = 256;

// lab in [lo, lo + count), without signed overflow
__device__ __forceinline__ bool in_span(int lab, int lo, int count) {
  return static_cast<unsigned>(lab) - static_cast<unsigned>(lo) <
         static_cast<unsigned>(count);
}

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

// The integer tiers' loads: VEC consecutive columns of one row, as one
// 16-byte load where VEC is 4.
template <int VEC, typename In>
__device__ __forceinline__ void load_vec(const In* p, In (&v)[VEC]) {
  if constexpr (VEC == 4) {
    using V4 = typename std::conditional<std::is_same<In, float>::value,
                                         float4, int4>::type;
    const V4 q = *reinterpret_cast<const V4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(VEC == 1, "one or four columns a load");
    v[0] = *p;
  }
}

// A domain element as the int32 the contribution sums: exact2's domain is
// f32 holding integers.
template <int TIER, typename In>
__device__ __forceinline__ int as_int(In x) {
  if constexpr (TIER == EXACT2) {
    return __float2int_rn(x);
  } else {
    return x;
  }
}

// How a touched schedule block's rows are shared among the threads while
// the integer tiers sum it: work item i is (run i / pieces, piece
// i % pieces), a piece being VEC columns of one plane (plane-major,
// `per_plane` pieces a plane) and a run `run_rows` consecutive rows.
struct IntSplit {
  int per_plane;
  int pieces;
  int items;
  int run_rows;
};

// One touched schedule block's integer contribution (rows [r0, r0 + B))
// to the label tile [base, base + tile_segs), added into the
// (st x P x ct) int32 scratch `sc`.  A thread sums its rows in registers
// while they carry one label of the tile and flushes the run where the
// label changes and at the end; rows of no label of the tile (sentinels,
// padding, rows past N, other tiles' labels) add nothing.
template <int TIER, int VEC>
__device__ __forceinline__ void int_block(const Args& a, long long r0,
                                          int base, int tile_segs, int cols,
                                          int d0, const IntSplit& sp,
                                          int* sc) {
  using T = Tier<TIER>;
  constexpr int P = T::PARTS;
  using In = typename T::In;
  const In* vals = static_cast<const In*>(a.values);
  const long long n = a.n_rows, W = static_cast<long long>(P) * a.d;
  const int ct = a.col_tile, B = a.block_rows;
  const int stride = P * ct;              // scratch words per label
  // a label that is not in the tile, for the rows that load none
  const int none = static_cast<int>(static_cast<unsigned>(base) - 1u);
  for (int it = threadIdx.x; it < sp.items; it += blockDim.x) {
    const int run = it / sp.pieces, piece = it - run * sp.pieces;
    const int p = piece / sp.per_plane;
    const int c = (piece - p * sp.per_plane) * VEC;
    const bool col_ok = c < cols;         // a piece lies in or past cols
    // plane p of the row: 64-bit, since P * d may pass 2^31 (exact2 at a
    // stacked gradient leaf's width)
    const In* src = vals + static_cast<long long>(p) * a.d + d0 + c;
    int* cell = sc + p * ct + c;          // + label * stride
    const int j1 = min(B, (run + 1) * sp.run_rows);
    int cur = -1;                         // the run's tile-local label
    int acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0;
    auto flush = [&]() {
      if (cur >= 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (acc[k] != 0) atomicAdd(cell + cur * stride + k, acc[k]);
      }
    };
    for (int j0 = run * sp.run_rows; j0 < j1; j0 += GROUP_ROWS) {
      int lab[GROUP_ROWS];
      In v[GROUP_ROWS][VEC];
#pragma unroll
      for (int u = 0; u < GROUP_ROWS; ++u) {    // every load before any use
        const long long g = r0 + j0 + u;
        lab[u] = none;
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[u][k] = In(0);
        if (j0 + u < j1 && g < n) {
          lab[u] = a.ids[g];
          if (col_ok) load_vec<VEC>(src + g * W, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < GROUP_ROWS; ++u) {
        const int loc = static_cast<int>(static_cast<unsigned>(lab[u]) -
                                         static_cast<unsigned>(base));
        if (static_cast<unsigned>(loc) >= static_cast<unsigned>(tile_segs))
          continue;
        if (loc != cur) {
          flush();
          cur = loc;
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = wadd(acc[k], as_int<TIER>(v[u][k]));
      }
    }
    flush();
  }
}

template <int TIER, int VEC>
__global__ void segsum_policy_kernel(Args a) {
  using T = Tier<TIER>;
  constexpr int P = T::PARTS;
  constexpr bool INT = T::INT;
  extern __shared__ int smem[];
  const int ct = a.col_tile, st = a.seg_tile, cr = a.chunk_rows;
  int* hits = smem;                      // 32 words: a window's touched
                                         // schedule blocks, a bit each
  // float tiers: label present in the chunk, and a chunk's tree of
  // 2 cr - 1 nodes
  int* present = hits + 32;
  int* tlab = present + st;              // each node's pure label
  float* tval = reinterpret_cast<float*>(tlab + 2 * cr - 1);  // x ct
  // integer tiers: two (st x P x ct) int32 scratch buffers
  int* scratch = hits + 32;
  const int cells = st * P * ct;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tx = tid % ct, ty = tid / ct;
  const int d0 = blockIdx.x * ct, seg0 = blockIdx.y * st;
  const int tile_segs = min(st, a.num_segments - seg0);
  const int cols = min(ct, a.d - d0);
  const bool active = ty < tile_segs && tx < cols;
  const int B = a.block_rows;
  const long long nb = (a.n_rows + B - 1) / B;
  const int base = a.seg_offset + seg0;
  const int last = base + tile_segs - 1;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

  // the carry cell (segment seg0 + ty, column d0 + tx)
  float facc = 0.f, fcomp = 0.f;
  int iacc = 0, hi = 0, lo = 0, ovf = 0;
  int bins[P > 1 ? P : 1];
#pragma unroll
  for (int k = 0; k < (P > 1 ? P : 1); ++k) bins[k] = 0;

  int gen = 0;                           // float tiers: the chunk count
  IntSplit sp{0, 0, 0, 0};
  if constexpr (INT) {
    for (int e = tid; e < 2 * cells; e += nthr) scratch[e] = 0;
    sp.per_plane = (ct + VEC - 1) / VEC;
    sp.pieces = P * sp.per_plane;
    const int runs = max(1, nthr / sp.pieces);
    sp.items = runs * sp.pieces;
    sp.run_rows = (B + runs - 1) / runs;
  } else {
    for (int s = tid; s < st; s += nthr) present[s] = 0;
  }
  int buf = 0;                           // integer tiers: scratch in use
  long long folded = 0;                  // float tiers: blocks folded so far

  auto float_update = [&](float c) {
    if (TIER == FAST) {
      facc = facc + c;
    } else {
      two_sum_update(facc, fcomp, c);
    }
  };

  // windows of nthr schedule blocks: thread t tests block b0 + t
  // (a thread past the last schedule block tests an empty range)
  int2 ahead = tid < nb ? a.ranges[tid] : make_int2(NO_LO, NO_HI);
  for (long long b0 = 0; b0 < nb; b0 += nthr) {
    const int2 r = ahead;
    const long long up = b0 + nthr + tid;
    ahead = up < nb ? a.ranges[up] : make_int2(NO_LO, NO_HI);
    const unsigned m = __ballot_sync(0xffffffffu, r.x <= last && r.y >= base);
    if (lane == 0) hits[warp] = m;
    __syncthreads();

    for (int w = 0; w < nwarps; ++w) {
      unsigned bits = hits[w];
      while (bits) {
        const long long blk = b0 + 32 * w + __ffs(bits) - 1;
        bits &= bits - 1;
        if constexpr (INT) {
          int* sc = scratch + buf * cells;
          int_block<TIER, VEC>(a, blk * B, base, tile_segs, cols, d0, sp,
                               sc);
          __syncthreads();
          if (active) {
            int ctr[P];
#pragma unroll
            for (int p = 0; p < P; ++p) {
              int* cell = sc + (ty * P + p) * ct + tx;
              ctr[p] = *cell;
              *cell = 0;
            }
            if (TIER == EXACT) {
              iacc = wadd(iacc, ctr[0]);
            } else if (TIER == EXACT2) {
              int wb = 0;
              hi = wrap_add(hi, ctr[0] >> 15, wb);
              lo = wrap_add(lo, ctr[0] & 0x7fff, wb);
#pragma unroll
              for (int k = 1; k < P; ++k)
                bins[k] = wrap_add(bins[k], ctr[k], wb);
              ovf = wadd(ovf, wb);
            } else {
              int wb = 0;
#pragma unroll
              for (int k = 0; k < P; ++k)
                bins[k] = wrap_add(bins[k], ctr[k], wb);
              ovf = wadd(ovf, wb);
            }
          }
          buf ^= 1;
        } else {
          if (active && blk > folded) float_update(0.f);  // skipped blocks
          const float c = float_block(a, blk * B, base, tile_segs, cols, d0,
                                      active, ty, tx, present, gen, tlab,
                                      tval);
          if (active) float_update(c);
          folded = blk + 1;
        }
      }
    }
    __syncthreads();
  }
  if (!INT && active && nb > folded) float_update(0.f);

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

// Each schedule block's least and greatest label of [off, off + count)
// into ranges[blk], (NO_LO, NO_HI) where it holds none; rows past n are
// sentinels.
__global__ void block_ranges_kernel(const int* ids, int2* ranges,
                                    long long n, int B, long long nb,
                                    int count, int off) {
  const long long blk = static_cast<long long>(blockIdx.x) *
                            (RANGE_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blk >= nb) return;                 // the whole warp
  int lo = NO_LO, hi = NO_HI;
  const long long r1 = min(blk * B + B, n);
#pragma unroll 4
  for (long long r = blk * B + lane; r < r1; r += 32) {
    const int lab = ids[r];
    if (in_span(lab, off, count)) {
      lo = min(lo, lab);
      hi = max(hi, lab);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) ranges[blk] = make_int2(lo, hi);
}

int ranges_launch(const int* ids, int2* ranges, long long n, int B,
                  int count, int off, cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + B - 1) / B;
  if (nb == 0) return 0;
  constexpr int per = RANGE_THREADS / 32;
  block_ranges_kernel<<<static_cast<unsigned>((nb + per - 1) / per),
                        RANGE_THREADS, 0, stream>>>(ids, ranges, n, B, nb,
                                                    count, off);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory; ops.py's `segsum_smem_bytes` mirrors it.
size_t smem_bytes(const Args& a, int parts, bool float_tree) {
  if (float_tree)
    return (32 + a.seg_tile +
            (2 * static_cast<size_t>(a.chunk_rows) - 1) * (1 + a.col_tile)) * 4;
  return (32 + 2 * static_cast<size_t>(a.seg_tile) * parts * a.col_tile) * 4;
}

template <int TIER, int VEC>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = segsum_policy_kernel<TIER, VEC>;
  constexpr bool float_tree = !Tier<TIER>::INT;
  // a float tier's tree chunk: a power of two of at most TREE_ROWS rows
  if (float_tree && (a.chunk_rows < 1 || a.chunk_rows > TREE_ROWS ||
                     (a.chunk_rows & (a.chunk_rows - 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((a.col_tile * a.seg_tile + 31) / 32) * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(a, Tier<TIER>::PARTS, float_tree);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((a.d + a.col_tile - 1) / a.col_tile,
            (a.num_segments + a.seg_tile - 1) / a.seg_tile);
  kern<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The integer tiers load four columns at a time where every piece of four
// starts on 16 bytes: d, the column tile and the base address aligned.
template <int TIER>
int launch_tier(const Args& a, cudaStream_t stream) {
  if constexpr (Tier<TIER>::INT) {
    if (a.d % 4 == 0 && a.col_tile % 4 == 0 &&
        reinterpret_cast<uintptr_t>(a.values) % 16 == 0)
      return launch<TIER, 4>(a, stream);
  }
  return launch<TIER, 1>(a, stream);
}

// ---------------------------------------------------------------------------
// The one-label schedule (num_segments == 1)
// ---------------------------------------------------------------------------

struct WideArgs {
  const void* values;   // (n_rows, PARTS * d), row-major
  const int* ids;       // (n_rows,) labels, absolute
  void* contrib;        // (nb, PARTS * d) block contributions (B > 1)
  void* out0; void* out1; void* out2; void* out3;
  long long n_rows;
  int block_rows;       // B
  int label;            // the one label: seg_offset
  int d;                // raw width: the carry's column count
  int lanes;            // float lane count (1 = dot form)
};

// A contribution-kernel CUDA block: WIDE_WARPS warps, each warp 32 pieces
// of VEC columns side by side; a fold-kernel CUDA block: WIDE_THREADS
// threads of VEC columns each.
constexpr int WIDE_THREADS = 256;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
// A fold-kernel CUDA block where it reads the block contributions: few
// columns (a norm's 1,024) and a chain of nb / DEPTH load latencies, so
// small CUDA blocks spread the columns over more SMs.
constexpr int FOLD_THREADS = 64;
// Blocks whose contributions a fold thread loads before it folds any: a
// few rows of the stream (B == 1, VEC columns a thread, many threads), or
// many block contributions (B > 1, one column a thread, few threads: the
// fold is a chain of nb / DEPTH load latencies).
template <int P, bool RAW> struct FoldDepth {
  static constexpr int value = RAW ? (P == 1 ? 8 : 2) : (P == 1 ? 64 : 8);
};

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 4) {
    using V4 = typename std::conditional<std::is_same<T, float>::value,
                                         float4, int4>::type;
    V4 q;
    q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
    *reinterpret_cast<V4*>(p) = q;
  } else {
    p[0] = v[0];
  }
}

// A loaded element as the contribution the carry folds: an integer tier
// reading exact2's f32 domain rounds it to int32 (`as_int`); everything
// else is already of the carry's type.
template <int TIER, typename Src>
__device__ __forceinline__ auto wide_value(Src x) {
  if constexpr (Tier<TIER>::INT && std::is_same<Src, float>::value) {
    return __float2int_rn(x);
  } else {
    return x;
  }
}

// One level of a group's register tree, VEC columns at once: M sums of
// pairs, left first.
template <int M, int VEC>
__device__ __forceinline__ void pair_up_vec(float (&v)[GROUP_ROWS][VEC]) {
#pragma unroll
  for (int u = 0; u < M; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[u][k] = v[2 * u][k] + v[2 * u + 1][k];
}

// `push_leaf` and `close_tree` for VEC columns that share one count.
template <int VEC>
__device__ __forceinline__ void push_leaf_vec(float (&v)[VEC],
                                              float (*stk)[VEC], int& sp,
                                              unsigned& cnt) {
  unsigned c = ++cnt;
  while ((c & 1u) == 0u) {
    --sp;
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = stk[sp][k] + v[k];
    c >>= 1;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) stk[sp][k] = v[k];
  ++sp;
}

template <int VEC>
__device__ __forceinline__ void close_tree_vec(float (*stk)[VEC], int& sp,
                                               unsigned& cnt,
                                               float (&out)[VEC]) {
  unsigned p2 = 1u;
  while (p2 < cnt) p2 <<= 1;
  while (cnt < p2) {
    float z[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) z[k] = 0.f;
    push_leaf_vec<VEC>(z, stk, sp, cnt);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = stk[0][k];
}

// Phase 2 (B > 1): one schedule block's contribution to 32 * VEC columns
// of the flat (PARTS * d)-wide row, into contrib[blk].  Grid: one CUDA
// block per (schedule block, column tile), flat, schedule-block major.
// Rows past N and rows of another label are +0 leaves (0 for the integer
// tiers).
template <int TIER, int VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_contrib_kernel(WideArgs a) {
  using T = Tier<TIER>;
  using In = typename T::In;
  constexpr int CT = 32 * VEC;
  extern __shared__ int wsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long W = static_cast<long long>(T::PARTS) * a.d;
  const long long n = a.n_rows;
  const int B = a.block_rows;
  const long long tiles = (W + CT - 1) / CT;
  const long long blk = blockIdx.x / tiles;
  const long long c = (blockIdx.x - blk * tiles) * CT + lane * VEC;
  const bool col_ok = c < W;               // all VEC columns, or none
  const long long r0 = blk * B;
  const In* vals = static_cast<const In*>(a.values);
  // a label that is not the launch's, for the rows that load none
  const int none = static_cast<int>(static_cast<unsigned>(a.label) - 1u);
  if constexpr (T::INT) {
    // any split of the rows gives the int32 wrapping sum: warp w takes
    // the runs of GROUP_ROWS rows w, w + WIDE_WARPS, ...
    int acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0;
    for (int j0 = warp * GROUP_ROWS; j0 < B; j0 += WIDE_WARPS * GROUP_ROWS) {
      int lab[GROUP_ROWS];
      In v[GROUP_ROWS][VEC];
#pragma unroll
      for (int u = 0; u < GROUP_ROWS; ++u) {    // every load before any use
        const long long g = r0 + j0 + u;
        lab[u] = none;
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[u][k] = In(0);
        if (j0 + u < B && g < n) {
          lab[u] = a.ids[g];
          if (col_ok) load_vec<VEC>(vals + g * W + c, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < GROUP_ROWS; ++u)
        if (lab[u] == a.label)
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] = wadd(acc[k], wide_value<TIER>(v[u][k]));
    }
    int* part = wsm;                       // [WIDE_WARPS][CT]
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[warp * CT + lane * VEC + k] = acc[k];
    __syncthreads();
    if (warp == 0 && col_ok) {
      for (int w = 1; w < WIDE_WARPS; ++w)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = wadd(acc[k], part[w * CT + lane * VEC + k]);
      store_vec<VEC>(static_cast<int*>(a.contrib) + blk * W + c, acc);
    }
  } else {
    // the pinned tree: per lane, chunks of up to TREE_ROWS padded rows
    // (aligned subtrees); a chunk's groups of GROUP_ROWS rows sum in
    // registers, the groups' level above in shared memory, in place
    // (node i of level h at (i << h)); chunk sums join on the
    // binary-counter stack, lanes fold in lane order
    float* tree = reinterpret_cast<float*>(wsm);   // [groups][CT]
    float stk[33][VEC];                    // chunk sums (warp 0)
    float total[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) total[k] = 0.f;
    for (int ln = 0; ln < a.lanes; ++ln) {
      const int lo = static_cast<int>((static_cast<long long>(ln) * B) /
                                      a.lanes);
      const int len = static_cast<int>(
          (static_cast<long long>(ln + 1) * B) / a.lanes) - lo;
      int L = 1;
      while (L < len) L <<= 1;
      const int C = min(L, TREE_ROWS);
      const int log_c = 31 - __clz(C);
      const int G = min(C, GROUP_ROWS), log_g = min(log_c, GROUP_LOG);
      const int groups = C / G;
      int sp = 0;
      unsigned cnt = 0u;
      for (int c0 = 0; c0 < len; c0 += C) {
        for (int grp = warp; grp < groups; grp += WIDE_WARPS) {
          const int j0 = c0 + grp * G;
          float v[GROUP_ROWS][VEC];
          int lab[GROUP_ROWS];
#pragma unroll
          for (int u = 0; u < GROUP_ROWS; ++u) {  // every load before any use
            const long long g = r0 + lo + j0 + u;
            lab[u] = none;
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
            if (u < G && j0 + u < len && g < n) {
              lab[u] = a.ids[g];
              if (col_ok) load_vec<VEC>(vals + g * W + c, v[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < GROUP_ROWS; ++u)
            if (lab[u] != a.label)
#pragma unroll
              for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
          if (log_g >= 1) pair_up_vec<8, VEC>(v);
          if (log_g >= 2) pair_up_vec<4, VEC>(v);
          if (log_g >= 3) pair_up_vec<2, VEC>(v);
          if (log_g >= 4) pair_up_vec<1, VEC>(v);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            tree[grp * CT + lane * VEC + k] = v[0][k];
        }
        __syncthreads();
        for (int h = 1; (groups >> h) > 0; ++h) {
          const int half = 1 << (h - 1);
          for (int i = warp; i < (groups >> h); i += WIDE_WARPS) {
            float* x = tree + (i << h) * CT + lane * VEC;
#pragma unroll
            for (int k = 0; k < VEC; ++k) x[k] = x[k] + x[half * CT + k];
          }
          __syncthreads();
        }
        if (warp == 0) {
          float root[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) root[k] = tree[lane * VEC + k];
          push_leaf_vec<VEC>(root, stk, sp, cnt);
        }
        __syncthreads();
      }
      if (warp == 0) {
        float part[VEC];
        close_tree_vec<VEC>(stk, sp, cnt, part);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          total[k] = ln == 0 ? part[k] : total[k] + part[k];
      }
    }
    if (warp == 0 && col_ok)
      store_vec<VEC>(static_cast<float*>(a.contrib) + blk * W + c, total);
  }
}

// Phase 1: the ordered fold.  Thread t owns raw columns [VEC t, VEC t +
// VEC) of every plane and folds each schedule block's contribution into
// its carry cells in block order, with the loads of FoldDepth blocks
// issued before any fold.  RAW (B == 1): a block's contribution is its
// row, read from the stream, the value where the row's label is the
// launch's and 0 (+0) elsewhere; otherwise it is contrib[blk], read one
// column a thread (VEC == 1).
template <int TIER, int VEC, bool RAW>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_fold_kernel(WideArgs a) {
  using T = Tier<TIER>;
  constexpr int P = T::PARTS;
  constexpr bool INT = T::INT;
  constexpr int DEPTH = FoldDepth<P, RAW>::value;
  using Acc = typename std::conditional<INT, int, float>::type;
  using Src = typename std::conditional<RAW, typename T::In, Acc>::type;
  const long long d = a.d, W = static_cast<long long>(P) * d;
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= d) return;
  const long long nb = RAW ? a.n_rows
                           : (a.n_rows + a.block_rows - 1) / a.block_rows;
  const Src* src = static_cast<const Src*>(RAW ? a.values : a.contrib);

  float facc[VEC], fcomp[VEC];
  int iacc[VEC], hi[VEC], lo[VEC], ovf[VEC];
  int bins[P][VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    facc[k] = fcomp[k] = 0.f;
    iacc[k] = hi[k] = lo[k] = ovf[k] = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) bins[p][k] = 0;
  }

  for (long long b0 = 0; b0 < nb; b0 += DEPTH) {
    Src v[DEPTH][P][VEC];
    bool mine[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {        // every load before any fold
      const long long b = b0 + u;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[u][p][k] = Src(0);
      mine[u] = b < nb;
      if (b < nb) {
        if (RAW) mine[u] = a.ids[b] == a.label;
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_vec<VEC>(src + b * W + p * d + col, v[u][p]);
      }
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (b0 + u >= nb) break;
      Acc ctr[P][VEC];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          ctr[p][k] = mine[u] ? static_cast<Acc>(wide_value<TIER>(v[u][p][k]))
                              : Acc(0);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if constexpr (TIER == FAST) {
          facc[k] = facc[k] + ctr[0][k];
        } else if constexpr (TIER == COMPENSATED) {
          two_sum_update(facc[k], fcomp[k], ctr[0][k]);
        } else if constexpr (TIER == EXACT) {
          iacc[k] = wadd(iacc[k], ctr[0][k]);
        } else if constexpr (TIER == EXACT2) {
          int wb = 0;
          hi[k] = wrap_add(hi[k], ctr[0][k] >> 15, wb);
          lo[k] = wrap_add(lo[k], ctr[0][k] & 0x7fff, wb);
#pragma unroll
          for (int p = 1; p < P; ++p)
            bins[p][k] = wrap_add(bins[p][k], ctr[p][k], wb);
          ovf[k] = wadd(ovf[k], wb);
        } else {
          int wb = 0;
#pragma unroll
          for (int p = 0; p < P; ++p)
            bins[p][k] = wrap_add(bins[p][k], ctr[p][k], wb);
          ovf[k] = wadd(ovf[k], wb);
        }
      }
    }
  }

  // the carry, written once (one label: row 0 of each carry array)
  if constexpr (TIER == FAST) {
    store_vec<VEC>(static_cast<float*>(a.out0) + col, facc);
  } else if constexpr (TIER == COMPENSATED) {
    store_vec<VEC>(static_cast<float*>(a.out0) + col, facc);
    store_vec<VEC>(static_cast<float*>(a.out1) + col, fcomp);
  } else if constexpr (TIER == EXACT) {
    store_vec<VEC>(static_cast<int*>(a.out0) + col, iacc);
  } else if constexpr (TIER == EXACT2) {
    store_vec<VEC>(static_cast<int*>(a.out0) + col, hi);
    store_vec<VEC>(static_cast<int*>(a.out1) + col, lo);
#pragma unroll
    for (int p = 1; p < P; ++p)
      store_vec<VEC>(static_cast<int*>(a.out2) + (p - 1) * d + col, bins[p]);
    store_vec<VEC>(static_cast<int*>(a.out3) + col, ovf);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      store_vec<VEC>(static_cast<int*>(a.out0) + p * d + col, bins[p]);
    store_vec<VEC>(static_cast<int*>(a.out1) + col, ovf);
  }
}

// Bytes of dynamic shared memory of a contribution-kernel CUDA block;
// ops.py's `wide_smem_bytes` mirrors it: a chunk's group sums (float
// tiers) or the warps' partial sums (integer tiers), 32 * vec columns.
size_t wide_smem_bytes(bool float_tree, int vec) {
  const size_t rows = float_tree ? TREE_ROWS / GROUP_ROWS : WIDE_WARPS;
  return rows * 32 * static_cast<size_t>(vec) * 4;
}

template <int TIER, int VEC>
int wide_launch_vec(const WideArgs& a, cudaStream_t stream) {
  const long long d = a.d;
  if (a.block_rows == 1) {
    const unsigned fold_grid = static_cast<unsigned>(
        (d + WIDE_THREADS * VEC - 1) / (WIDE_THREADS * VEC));
    wide_fold_kernel<TIER, VEC, true><<<fold_grid, WIDE_THREADS, 0,
                                        stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const long long W = static_cast<long long>(Tier<TIER>::PARTS) * d;
  const long long nb = (a.n_rows + a.block_rows - 1) / a.block_rows;
  const long long tiles = (W + 32 * VEC - 1) / (32 * VEC);
  if (nb * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide_smem_bytes(!Tier<TIER>::INT, VEC);
  wide_contrib_kernel<TIER, VEC><<<static_cast<unsigned>(nb * tiles),
                                   WIDE_THREADS, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned fold_grid =
      static_cast<unsigned>((d + FOLD_THREADS - 1) / FOLD_THREADS);
  wide_fold_kernel<TIER, 1, false><<<fold_grid, FOLD_THREADS, 0,
                                     stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int TIER>
int wide_launch_tier(const WideArgs& a, int vec, cudaStream_t stream) {
  return vec == 4 ? wide_launch_vec<TIER, 4>(a, stream)
                  : wide_launch_vec<TIER, 1>(a, stream);
}

}  // namespace

// The pre-pass alone: each schedule block's label range into `ranges`
// ((nb, 2) int32).  Returns cudaGetLastError() after the launch.
extern "C" int block_ranges_launch(const void* ids, void* ranges,
                                   long long n_rows, int block_rows,
                                   int num_segments, int seg_offset,
                                   void* stream) {
  return ranges_launch(static_cast<const int*>(ids),
                       static_cast<int2*>(ranges), n_rows, block_rows,
                       num_segments, seg_offset,
                       static_cast<cudaStream_t>(stream));
}

// K1: the pre-pass into `ranges` ((nb, 2) int32 scratch), then the block
// schedule, on one stream.  Returns cudaGetLastError() after the
// launches (0 = launched), or cudaErrorInvalidValue for an unknown tier.
extern "C" int segsum_policy_launch(
    int tier, const void* values, const void* ids, void* ranges,
    void* out0, void* out1, void* out2, void* out3, long long n_rows,
    int block_rows, int num_segments, int seg_offset, int d, int lanes,
    int seg_tile, int col_tile, int chunk_rows, void* stream) {
  Args a{values, static_cast<const int*>(ids),
         static_cast<const int2*>(ranges), out0, out1, out2, out3,
         n_rows, block_rows, num_segments, seg_offset, d, lanes,
         seg_tile, col_tile, chunk_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tier < FAST || tier > PROCRASTINATE)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = ranges_launch(a.ids, static_cast<int2*>(ranges), n_rows,
                               block_rows, num_segments, seg_offset, s);
  if (rc != 0) return rc;
  switch (tier) {
    case FAST: return launch_tier<FAST>(a, s);
    case COMPENSATED: return launch_tier<COMPENSATED>(a, s);
    case EXACT: return launch_tier<EXACT>(a, s);
    case EXACT2: return launch_tier<EXACT2>(a, s);
    default: return launch_tier<PROCRASTINATE>(a, s);
  }
}

// K1 at one label: the label schedule's pre-pass and label tiles give way
// to the ordered fold, column-wide (`wide_fold_kernel`), which at B == 1
// reads the stream itself (one CUDA kernel) and otherwise reads the block
// contributions that `wide_contrib_kernel` writes into `contrib` ((nb,
// PARTS * d), of the carry's type) just before it, on the same stream.
// vec is 4 (16-byte loads: d a multiple of 4, values and contrib on 16
// bytes) or 1.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for arguments the schedule does not take.
extern "C" int segsum_wide_launch(
    int tier, const void* values, const void* ids, void* contrib,
    void* out0, void* out1, void* out2, void* out3, long long n_rows,
    int block_rows, int seg_offset, int d, int lanes, int vec,
    void* stream) {
  WideArgs a{values, static_cast<const int*>(ids), contrib, out0, out1,
             out2, out3, n_rows, block_rows, seg_offset, d, lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tier < FAST || tier > PROCRASTINATE || block_rows < 1 || lanes < 1 ||
      (vec != 1 && vec != 4) || (block_rows > 1 && contrib == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (d % 4 != 0 || reinterpret_cast<uintptr_t>(values) % 16 ||
                   reinterpret_cast<uintptr_t>(contrib) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tier) {
    case FAST: return wide_launch_tier<FAST>(a, vec, s);
    case COMPENSATED: return wide_launch_tier<COMPENSATED>(a, vec, s);
    case EXACT: return wide_launch_tier<EXACT>(a, vec, s);
    case EXACT2: return wide_launch_tier<EXACT2>(a, vec, s);
    default: return wide_launch_tier<PROCRASTINATE>(a, vec, s);
  }
}
