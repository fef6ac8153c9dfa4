// The JugglePAC state machine as a batched scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the counterpart of the reference's
// `lax.scan` of one clock cycle, `_step` (src/repro/core/circuit_jax.py:67),
// vmapped over a batch of independent circuits.  In: values (B, T) f32,
// starts and valids (B, T) bytes (0 / 1).  Out, every cycle of every
// circuit: res_v f32, res_set int32, res_en and overflow bytes, bitwise
// the reference's (on cycles that emit nothing too: there register 0's
// stale value and owner, as `argmax` of an all-false mask is 0).
//
// The order inside a cycle is the reference's: the input issue from the
// old pending register; the label table on a start; the FIFO popped
// (a roll: slot 0 goes to slot 3) when the adder slot is free; the
// pipeline tick; the PIS store or pair (a pair pushes at min(n, 3), so
// past 4 it overwrites slot 3 while n keeps growing; overflow reads n
// after this cycle's pop); counters reset on the output, the timeout scan
// emits the lowest ready register; a saturating increment of the rest.
// The one add is `__fadd_rn`, built with --fmad=false: an unpaired
// element leaves as element + 0.0 (-0.0 becomes +0.0), NaN and Inf
// propagate as IEEE says.
//
// Design.  One thread per circuit, THREADS circuits a CUDA block, and a
// warp moves and steps its own 32 circuits (no block-wide barrier).  No
// per-circuit array lives in local memory: the arrays are in dynamic
// shared memory, sized from the launch's L and R, index-major and
// thread-minor (entry i of thread t at [i][t]), so a warp's 32 accesses
// fall on consecutive words whatever index each thread uses:
//   * pipe[L][THREADS], 8 bytes: the adder pipeline as a ring of L slots.
//     Cycle c reads slot c % L (the issue of cycle c - L) and writes this
//     cycle's issue there.  A slot holds the sum's bits and the label, or
//     IDLE for a cycle that issued nothing (the label and the value of an
//     idle slot are never read);
//   * reg[R][THREADS], 8 bytes: a PIS register's value and owning set;
//   * due[R][THREADS]: the cycle at which a register stored at cycle s
//     times out, s + L + 3 (mod 2^32);
//   * ring[L + 3][THREADS], a byte: the register stored at each of the
//     last L + 3 cycles, or NO_STORE.
// Registers hold the rest: the 4-slot FIFO (a circular buffer: a pop
// advances the head, which is the reference's roll), the FSM, the pending
// register, the current set and label, two bit masks of the R registers,
// `en` (occupied) and `ready` (occupied and timed out), and the circuit's
// flag bits.
//
// The reference's saturating counters are not kept.  A register is
// stored only when empty, its counter restarts at 0 then, and it leaves
// only by a pair or an emission, both of which empty it; so while it is
// occupied its counter is min(c - s, L + 3) and it is ready iff
// c - s >= L + 3.  No output reads a counter, so ready-ness is all that
// must be exact.  Cycle c reads the ring's entry for cycle c - L - 3:
// that register is newly ready iff it is still occupied, was not stored
// this cycle, and due == c (a later store would have moved due; the
// difference is below 2^32, so the wrapping compare is exact).  The
// timeout scan becomes the lowest bit of `ready`: O(1) a cycle for any R.
// The label table is not kept either: label l is owned by the last set
// s <= cur_set with s % R == l, which is cur_set - ((cur_label - l) mod
// R), or -1 below 0.
//
// I/O.  The (B, T) rows are T apart, so a warp reading one cycle of 32
// circuits would touch 32 lines, and the card's memory serves a row best
// in long pieces.  The warp moves one circuit's row at a time:
//   * values, res_v, res_set: CHUNK = 32 cycles, a lane each (128 B, a
//     line), staged through two shared tiles; a cycle's res_v overwrites
//     its value, and one pass stores a chunk's outputs and loads the next
//     chunk's values into the same slots;
//   * starts, valids, res_en, overflow: FLAGS = 128 cycles at a time (128
//     B a row), kept as bits in the owning thread's registers (a word a
//     chunk), which they reach by warp ballot and leave by shuffle.  Where
//     every row starts on a 4-byte boundary a lane moves a word (4 cycles)
//     and the next flag chunk's words are loaded a quarter of the rows at
//     a time while a chunk is stepped; else a lane moves a byte.
//
// Resources.  At the design point (L = 14, R = 4) a block takes 55,424 B
// of shared memory, and __launch_bounds__ caps a thread at 128 registers,
// so MIN_BLOCKS blocks (512 circuits) fit an SM: 65,536 circuits are
// resident at once on 132 SMs.  At L = R = 64 a block takes 205,184 B.
//
// Bound.  Bytes: 6 read and 10 written a (circuit, cycle), 16 B x B x T
// over the card's memory rate.  The step is some 170 instructions and a
// dozen shared accesses a circuit-cycle, with 4 warps a scheduler to hide
// its latency.  Each circuit is a sequential chain of T steps, so a launch
// with few circuits is bound by the chain's latency instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // circuits per CUDA block
constexpr int MIN_BLOCKS = 4;     // blocks an SM must hold at the design point
constexpr int CHUNK = 32;         // cycles staged per tile: a lane each
constexpr int BATCH = 4;          // rows of values a warp loads at once
constexpr int FW = 4;             // chunks a flag chunk spans
constexpr int FLAGS = FW * CHUNK; // cycles of the byte arrays moved at once
constexpr int FLAG_BATCH = 2;     // rows of flag bytes a warp loads at once
constexpr int WORD_ROWS = 32 / FW;  // rows of flag words loaded a chunk
constexpr int LMAX = 64;          // pipeline slots a circuit may have
constexpr int RMAX = 64;          // PIS registers a circuit may have
constexpr int FIFO = 4;
constexpr uint32_t IDLE = 0xffffffffu;  // a pipeline slot with no issue
constexpr uint32_t NO_STORE = 0xffu;    // a ring entry with no store
constexpr long long SMEM_MAX = 232448;  // a block's shared memory on Hopper

// Bytes of dynamic shared memory a block takes, in the order laid out:
// pipe, reg, due, value tile, set tile, ring.
long long smem_bytes(int L, int R) {
  return static_cast<long long>(THREADS) *
         (8LL * L + 8LL * R + 4LL * R + 8LL * CHUNK + L + 3);
}

__device__ __forceinline__ int lowest(uint32_t m) { return __ffs(m) - 1; }
__device__ __forceinline__ int lowest(unsigned long long m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

__device__ __forceinline__ float pick(const float (&a)[FIFO], uint32_t i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// Store res_v and res_set of the chunk at c_out (if c_out >= 0) of this
// warp's circuits and load their values of the chunk at c_in into the
// same tile slots, a row at a time, a cycle a lane.  Row r's cycle j sits
// at [r][j ^ (r % 32)] of a tile, so both this pass and the steps (a row
// a thread) are free of bank conflicts.
__device__ __forceinline__ void move_values(
    const float* __restrict__ values, float* __restrict__ res_v,
    int* __restrict__ res_set, float* tile_v, int* tile_s,
    long long first_row, int nrows, long long nt, long long c_out,
    long long c_in) {
  const int lane = threadIdx.x % 32, row0 = threadIdx.x - lane;
  const bool out = c_out >= 0 && c_out + lane < nt;
  const bool in = c_in + lane < nt;
  const long long base = first_row * nt + lane;
  for (int k0 = 0; k0 < nrows; k0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int k = k0 + j;
      const long long at = base + k * nt;
      const int ti = (row0 + k) * CHUNK + (lane ^ k);
      if (k < nrows && out) {
        res_v[at + c_out] = tile_v[ti];
        res_set[at + c_out] = tile_s[ti];
      }
      x[j] = k < nrows && in ? values[at + c_in] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int k = k0 + j;
      if (k < nrows) tile_v[(row0 + k) * CHUNK + (lane ^ k)] = x[j];
    }
  }
}

// The byte arrays a byte a lane: store res_en and overflow of the flag
// chunk at f_out (if f_out >= 0) from the bit words of each circuit's
// thread (`ew`, `ow`: a word a chunk, bit j = cycle j of it), and load
// the starts and valids of the flag chunk at f_in into its `sw`, `vw`.
// Row r's bits travel by warp ballot and shuffle to and from lane r % 32.
__device__ __forceinline__ void move_flag_bytes(
    const uint8_t* __restrict__ starts, const uint8_t* __restrict__ valids,
    uint8_t* __restrict__ res_en, uint8_t* __restrict__ ovf,
    uint32_t (&sw)[FW], uint32_t (&vw)[FW], const uint32_t (&ew)[FW],
    const uint32_t (&ow)[FW], long long first_row, int nrows, long long nt,
    long long f_out, long long f_in) {
  const int lane = threadIdx.x % 32;
  const long long base = first_row * nt + lane;
  for (int k0 = 0; k0 < nrows; k0 += FLAG_BATCH) {
    uint32_t fs[FLAG_BATCH][FW], fv[FLAG_BATCH][FW];
#pragma unroll
    for (int j = 0; j < FLAG_BATCH; ++j) {
      const int k = k0 + j;
      const long long at = base + k * nt;
#pragma unroll
      for (int w = 0; w < FW; ++w) {
        const long long c = 32 * w;
        const uint32_t e = __shfl_sync(0xffffffffu, ew[w], k & 31);
        const uint32_t o = __shfl_sync(0xffffffffu, ow[w], k & 31);
        if (k < nrows && f_out >= 0 && f_out + c + lane < nt) {
          res_en[at + f_out + c] = static_cast<uint8_t>((e >> lane) & 1);
          ovf[at + f_out + c] = static_cast<uint8_t>((o >> lane) & 1);
        }
        const bool ld = k < nrows && f_in + c + lane < nt;
        fs[j][w] = ld ? starts[at + f_in + c] : 0u;
        fv[j][w] = ld ? valids[at + f_in + c] : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < FLAG_BATCH; ++j) {
#pragma unroll
      for (int w = 0; w < FW; ++w) {
        const uint32_t sb = __ballot_sync(0xffffffffu, fs[j][w] != 0);
        const uint32_t vb = __ballot_sync(0xffffffffu, fv[j][w] != 0);
        if (lane == k0 + j) {
          sw[w] = sb;
          vw[w] = vb;
        }
      }
    }
  }
}

// The byte arrays a word a lane, where every row starts on a 4-byte
// boundary: lane l moves cycles 4l .. 4l + 3 of a flag chunk.  Loaded
// words pass through `ballot_words` into the owner's interleaved bits
// (bit l of word b = cycle 4l + b), which `untangle` turns into its
// per-chunk words.

// Load the starts and valids of rows k0 .. k0 + WORD_ROWS - 1 of the flag
// chunk at f_in, a word a lane (0 past the end or where `words` is false).
__device__ __forceinline__ void load_words(
    const uint8_t* __restrict__ starts, const uint8_t* __restrict__ valids,
    uint32_t (&ls)[WORD_ROWS], uint32_t (&lv)[WORD_ROWS], bool words,
    long long first_row, int k0, int nrows, long long nt, long long f_in) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < WORD_ROWS; ++j) {
    const bool ld = words && k0 + j < nrows && f_in + 4 * lane < nt;
    const long long at = (first_row + k0 + j) * nt + f_in + 4 * lane;
    ls[j] = ld ? *reinterpret_cast<const uint32_t*>(starts + at) : 0u;
    lv[j] = ld ? *reinterpret_cast<const uint32_t*>(valids + at) : 0u;
  }
}

// Ballot the loaded words of rows k0 .. k0 + WORD_ROWS - 1 into their
// owners' interleaved bits `si`, `vi`.
__device__ __forceinline__ void ballot_words(const uint32_t (&ls)[WORD_ROWS],
                                             const uint32_t (&lv)[WORD_ROWS],
                                             int k0, uint32_t (&si)[4],
                                             uint32_t (&vi)[4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < WORD_ROWS; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t sb =
          __ballot_sync(0xffffffffu, (ls[j] >> (8 * b)) & 0xffu);
      const uint32_t vb =
          __ballot_sync(0xffffffffu, (lv[j] >> (8 * b)) & 0xffu);
      if (lane == k0 + j) {
        si[b] = sb;
        vi[b] = vb;
      }
    }
  }
}

// bits 0..7 of x to bits 0, 4, .., 28
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// interleaved bits (bit l of x[b] = cycle 4l + b) -> a word a chunk
// (bit j of out[w] = cycle 32w + j)
__device__ __forceinline__ void untangle(const uint32_t (&x)[4],
                                         uint32_t (&out)[FW]) {
#pragma unroll
  for (int w = 0; w < FW; ++w) {
    uint32_t r = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) r |= spread4((x[b] >> (8 * w)) & 0xffu) << b;
    out[w] = r;
  }
}

// Store res_en and overflow of the flag chunk at f_out, a word a lane,
// from each owner's per-chunk words `ew`, `ow`.
__device__ __forceinline__ void store_words(
    uint8_t* __restrict__ res_en, uint8_t* __restrict__ ovf,
    const uint32_t (&ew)[FW], const uint32_t (&ow)[FW], long long first_row,
    int nrows, long long nt, long long f_out) {
  const int lane = threadIdx.x % 32;
  const bool out = f_out + 4 * lane < nt;
  const int sh = 4 * (lane % 8), g = lane / 8;
  for (int k = 0; k < nrows; ++k) {
    uint32_t e = 0, o = 0;
#pragma unroll
    for (int w = 0; w < FW; ++w) {
      const uint32_t ek = __shfl_sync(0xffffffffu, ew[w], k);
      const uint32_t ok = __shfl_sync(0xffffffffu, ow[w], k);
      e = g == w ? ek : e;
      o = g == w ? ok : o;
    }
    if (out) {
      const long long at = (first_row + k) * nt + f_out + 4 * lane;
      *reinterpret_cast<uint32_t*>(res_en + at) =
          (((e >> sh) & 0xfu) * 0x00204081u) & 0x01010101u;
      *reinterpret_cast<uint32_t*>(ovf + at) =
          (((o >> sh) & 0xfu) * 0x00204081u) & 0x01010101u;
    }
  }
}

// x[i] for a warp-uniform i < FW, kept in registers
__device__ __forceinline__ uint32_t word(const uint32_t (&x)[FW], int i) {
  uint32_t r = x[0];
#pragma unroll
  for (int w = 1; w < FW; ++w) r = i == w ? x[w] : r;
  return r;
}

template <typename Mask>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
jugglepac_fsm_kernel(const float* __restrict__ values,
                     const uint8_t* __restrict__ starts,
                     const uint8_t* __restrict__ valids,
                     float* __restrict__ res_v, int* __restrict__ res_set,
                     uint8_t* __restrict__ res_en, uint8_t* __restrict__ ovf,
                     long long nb, long long nt, int L, int R,
                     bool words) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* pipe = reinterpret_cast<uint2*>(smem);
  uint2* reg = pipe + L * THREADS;
  uint32_t* due = reinterpret_cast<uint32_t*>(reg + R * THREADS);
  float* tile_v = reinterpret_cast<float*>(due + R * THREADS);
  int* tile_s = reinterpret_cast<int*>(tile_v + THREADS * CHUNK);
  uint8_t* ring = reinterpret_cast<uint8_t*>(tile_s + THREADS * CHUNK);

  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * THREADS;
  const bool live = b0 + tid < nb;
  const int thresh = L + 3;

  // this thread's column of each array
  uint2* my_pipe = pipe + tid;
  uint2* my_reg = reg + tid;
  uint32_t* my_due = due + tid;
  uint8_t* my_ring = ring + tid;
  const int lane = tid % 32;
  float* my_v = tile_v + tid * CHUNK;
  int* my_s = tile_s + tid * CHUNK;
  for (int i = 0; i < L; ++i) my_pipe[i * THREADS] = make_uint2(0u, IDLE);
  for (int i = 0; i < R; ++i) my_reg[i * THREADS] = make_uint2(0u, IDLE);
  for (int i = 0; i < thresh; ++i) my_ring[i * THREADS] = NO_STORE;

  float fa[FIFO], fb[FIFO];
#pragma unroll
  for (int j = 0; j < FIFO; ++j) {
    fa[j] = 0.0f;
    fb[j] = 0.0f;
  }
  uint32_t fl = 0;                  // the FIFO's labels, a byte each
  uint32_t head = 0;                // the FIFO's slot 0
  int fn = 0;                       // its count (may pass FIFO)
  bool pending = false;             // the FSM: a first-of-pair is held
  float pend_v = 0.0f;
  uint32_t pend_l = 0;
  int cur_set = -1, cur_label = 0, next_label = 0;
  Mask en = 0, ready = 0;
  int slot = 0, rslot = 0;          // c % L and c % (L + 3)
  uint32_t cyc = 0;                 // c mod 2^32

  // a warp moves and steps its own 32 circuits: no block-wide barrier
  const long long first_row = b0 + tid - lane;
  const int nrows = static_cast<int>(max(0LL, min(32LL, nb - first_row)));
  uint32_t sw[FW], vw[FW], ew[FW], ow[FW];   // this circuit's flag bits
#pragma unroll
  for (int w = 0; w < FW; ++w) {
    sw[w] = vw[w] = ew[w] = ow[w] = 0;
  }
  move_values(values, res_v, res_set, tile_v, tile_s, first_row, nrows, nt,
              -1, 0);
  uint32_t si[4] = {0, 0, 0, 0}, vi[4] = {0, 0, 0, 0};  // next flag chunk
  if (words) {                      // the first flag chunk, row group by group
    for (int k0 = 0; k0 < 32; k0 += WORD_ROWS) {
      uint32_t ls[WORD_ROWS], lv[WORD_ROWS];
      load_words(starts, valids, ls, lv, true, first_row, k0, nrows, nt, 0);
      ballot_words(ls, lv, k0, si, vi);
    }
    untangle(si, sw);
    untangle(vi, vw);
  } else {
    move_flag_bytes(starts, valids, res_en, ovf, sw, vw, ew, ow, first_row,
                    nrows, nt, -1, 0);
  }
  __syncwarp();
  for (long long c0 = 0; c0 < nt; c0 += CHUNK) {
    const int n = static_cast<int>(min(static_cast<long long>(CHUNK),
                                       nt - c0));
    const int w = static_cast<int>((c0 / CHUNK) % FW);   // chunk in flags
    const long long f0 = c0 - w * CHUNK;                 // the flag chunk
    // the words of the next flag chunk for a group of rows, in flight
    // while the chunk is stepped
    uint32_t ls[WORD_ROWS], lv[WORD_ROWS];
    load_words(starts, valids, ls, lv, words, first_row, w * WORD_ROWS, nrows,
               nt, f0 + FLAGS);
    uint32_t emit_bits = 0, overflow_bits = 0;
    if (live) {
      const uint32_t start_bits = word(sw, w), valid_bits = word(vw, w);
      for (int cc = 0; cc < n; ++cc) {
        const int ti = cc ^ lane;
        const float v = my_v[ti];
        const bool valid = (valid_bits >> cc) & 1u;
        const bool start = (start_bits >> cc) & 1u;
        const bool is_start = valid && start;
        const bool is_cont = valid && !start;

        // FSM / input pairing (Algorithm 1), from the old pending register
        const bool flush = (is_start || !valid) && pending;
        const bool pair = is_cont && pending;
        const bool input_issue = flush || pair;
        float ia = pend_v;
        float ib = pair ? v : 0.0f;
        uint32_t il = pend_l;
        if (is_start) {
          cur_set += 1;
          cur_label = next_label;
          next_label = next_label + 1 == R ? 0 : next_label + 1;
        }
        const bool stash = is_start || (is_cont && !pending);
        if (stash) {
          pend_v = v;
          pend_l = static_cast<uint32_t>(cur_label);
        }
        pending = stash || (pending && !input_issue);

        // FIFO issue when the adder slot is free: pop = roll by -1
        const bool fifo_issue = !input_issue && fn > 0;
        if (fifo_issue) {
          ia = pick(fa, head);
          ib = pick(fb, head);
          il = (fl >> (8 * head)) & 0xffu;
          head = (head + 1) & (FIFO - 1);
          fn -= 1;
        }
        const bool issue_en = input_issue || fifo_issue;

        // adder pipeline tick: read the slot issued L cycles ago, refill it
        uint2* ps = my_pipe + slot * THREADS;
        const uint2 out = *ps;
        *ps = make_uint2(__float_as_uint(__fadd_rn(ia, ib)),
                         issue_en ? il : IDLE);
        slot = slot + 1 == L ? 0 : slot + 1;

        // the register stored L + 3 cycles ago, and its timeout cycle
        uint8_t* pr = my_ring + rslot * THREADS;
        const uint32_t ent = *pr;
        const uint32_t ent_due =
            ent < static_cast<uint32_t>(R) ? my_due[ent * THREADS] : 0u;
        rslot = rslot + 1 == thresh ? 0 : rslot + 1;

        // PIS insert (pair identification)
        bool overflow = false;
        uint32_t stored = NO_STORE;
        if (out.y != IDLE) {
          const uint32_t out_l = out.y;
          const Mask b = Mask(1) << out_l;
          if (en & b) {                 // pair -> FIFO push, clipped index
            const float a = __uint_as_float(my_reg[out_l * THREADS].x);
            const uint32_t p = (head + min(fn, FIFO - 1)) & (FIFO - 1);
#pragma unroll
            for (uint32_t j = 0; j < FIFO; ++j) {
              if (j == p) {
                fa[j] = a;
                fb[j] = __uint_as_float(out.x);
              }
            }
            fl = (fl & ~(0xffu << (8 * p))) | (out_l << (8 * p));
            overflow = fn >= FIFO;
            fn += 1;
            en &= ~b;                   // reg's value stays as it was
            ready &= ~b;
          } else {                      // store, owned by label out_l's set
            int d = cur_label - static_cast<int>(out_l);
            if (d < 0) d += R;
            const int owner = cur_set - d;
            my_reg[out_l * THREADS] =
                make_uint2(out.x, owner < 0 ? IDLE : owner);
            my_due[out_l * THREADS] = cyc + thresh;
            en |= b;
            stored = out_l;
          }
        }
        *pr = static_cast<uint8_t>(stored);

        // Algorithm 2: timeout, lowest ready register on the one port
        if (ent != stored && ent < static_cast<uint32_t>(R) &&
            ((en >> ent) & 1) && ent_due == cyc)
          ready |= Mask(1) << ent;
        const bool emit = ready != 0;
        const int e = emit ? lowest(ready) : 0;
        uint2* pe = my_reg + e * THREADS;
        const uint2 res = *pe;
        if (emit) {
          pe->y = IDLE;                 // the owner becomes -1
          const Mask b = Mask(1) << e;
          ready &= ~b;
          en &= ~b;
        }
        my_v[ti] = __uint_as_float(res.x);
        my_s[ti] = static_cast<int>(res.y);
        emit_bits |= static_cast<uint32_t>(emit) << cc;
        overflow_bits |= static_cast<uint32_t>(overflow) << cc;
        cyc += 1;
      }
    }
#pragma unroll
    for (int i = 0; i < FW; ++i) {
      ew[i] = i == w ? emit_bits : ew[i];
      ow[i] = i == w ? overflow_bits : ow[i];
    }
    __syncwarp();
    move_values(values, res_v, res_set, tile_v, tile_s, first_row, nrows,
                nt, c0, c0 + CHUNK);
    const bool flag_end = w == FW - 1 || c0 + CHUNK >= nt;
    if (words) {
      ballot_words(ls, lv, w * WORD_ROWS, si, vi);
      if (flag_end) {
        store_words(res_en, ovf, ew, ow, first_row, nrows, nt, f0);
        untangle(si, sw);
        untangle(vi, vw);
      }
    } else if (flag_end) {
      move_flag_bytes(starts, valids, res_en, ovf, sw, vw, ew, ow,
                      first_row, nrows, nt, f0, f0 + FLAGS);
    }
    __syncwarp();
  }
}

template <typename Mask>
cudaError_t configure(long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      jugglepac_fsm_kernel<Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(jugglepac_fsm_kernel<Mask>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int check_shape(int L, int R, long long smem) {
  if (L < 1 || L > LMAX || R < 1 || R > RMAX || smem != smem_bytes(L, R) ||
      smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Returns the error of the attribute calls or of the launch (0 =
// launched).  `smem` is the block's dynamic shared memory, which must be
// what the source lays out for (L, R) (the wrapper's `smem_bytes`).
extern "C" int jugglepac_fsm_launch(const void* values, const void* starts,
                                    const void* valids, void* res_v,
                                    void* res_set, void* res_en, void* ovf,
                                    long long nb, long long nt, int L, int R,
                                    long long smem, void* stream) {
  if (nb <= 0 || nt <= 0) return 0;
  if (int rc = check_shape(L, R, smem)) return rc;
  const long long blocks = (nb + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool words =
      nt % 4 == 0 && ((reinterpret_cast<uintptr_t>(starts) |
                       reinterpret_cast<uintptr_t>(valids) |
                       reinterpret_cast<uintptr_t>(res_en) |
                       reinterpret_cast<uintptr_t>(ovf)) & 3) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaError_t err;
  if (R <= 32) {
    if ((err = configure<uint32_t>(smem)) != cudaSuccess)
      return static_cast<int>(err);
    jugglepac_fsm_kernel<uint32_t><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(values),
        static_cast<const uint8_t*>(starts),
        static_cast<const uint8_t*>(valids), static_cast<float*>(res_v),
        static_cast<int*>(res_set), static_cast<uint8_t*>(res_en),
        static_cast<uint8_t*>(ovf), nb, nt, L, R, words);
  } else {
    if ((err = configure<unsigned long long>(smem)) != cudaSuccess)
      return static_cast<int>(err);
    jugglepac_fsm_kernel<unsigned long long><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(values),
        static_cast<const uint8_t*>(starts),
        static_cast<const uint8_t*>(valids), static_cast<float*>(res_v),
        static_cast<int*>(res_set), static_cast<uint8_t*>(res_en),
        static_cast<uint8_t*>(ovf), nb, nt, L, R, words);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of THREADS circuits one SM holds at (L, R), from the occupancy
// calculator, into *blocks.  Returns the CUDA error (0 = ok).
extern "C" int jugglepac_fsm_blocks_per_sm(int L, int R, long long smem,
                                           int* blocks) {
  if (int rc = check_shape(L, R, smem)) return rc;
  cudaError_t err;
  if (R <= 32) {
    if ((err = configure<uint32_t>(smem)) != cudaSuccess)
      return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, jugglepac_fsm_kernel<uint32_t>, THREADS, smem);
  } else {
    if ((err = configure<unsigned long long>(smem)) != cudaSuccess)
      return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, jugglepac_fsm_kernel<unsigned long long>, THREADS, smem);
  }
  return static_cast<int>(err);
}
