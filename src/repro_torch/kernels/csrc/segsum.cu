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
