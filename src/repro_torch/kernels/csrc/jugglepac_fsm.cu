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
// Design.  One thread per circuit; its state stays in the thread:
//   * the adder pipeline as a ring of L slots: cycle c reads slot c % L
//     (the issue of cycle c - L, or the zeroed state), then writes this
//     cycle's issue there -- the reference's shift register, unmoved;
//   * the R PIS registers (value, occupancy, counter, owner) and the label
//     table, indexed by label: local arrays (L1-cached);
//   * the 4-slot FIFO, the FSM and the pending register in registers.
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
// I/O.  The (B, T) rows are T apart, so a warp reading one cycle of 32
// circuits would touch 32 lines.  A block of THREADS circuits stages
// CHUNK cycles at a time through shared memory: the tile is loaded and
// stored a row piece at a time (consecutive threads, consecutive
// cycles), and each thread steps its own row of the tile.
//
// Bound.  Bytes: 6 read and 10 written a (circuit, cycle), 16 B x B x T
// over the card's memory rate; the work is a few dozen integer and one
// f32 operation a cycle.  Each circuit is a sequential chain of T steps,
// so a launch with few circuits is bound by the chain's latency instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cycles staged per tile; tools/fsm_chunk.py builds other values with -D
#ifndef JPAC_CHUNK
#define JPAC_CHUNK 32
#endif

constexpr int THREADS = 64;     // circuits per CUDA block
constexpr int CHUNK = JPAC_CHUNK;
constexpr int LMAX = 64;        // pipeline slots a circuit may have
constexpr int RMAX = 64;        // PIS registers a circuit may have
constexpr int FIFO = 4;

__global__ void __launch_bounds__(THREADS)
jugglepac_fsm_kernel(const float* __restrict__ values,
                     const uint8_t* __restrict__ starts,
                     const uint8_t* __restrict__ valids,
                     float* __restrict__ res_v, int* __restrict__ res_set,
                     uint8_t* __restrict__ res_en, uint8_t* __restrict__ ovf,
                     long long nb, long long nt, int L, int R) {
  __shared__ float s_v[THREADS][CHUNK + 1];
  __shared__ uint8_t s_in[THREADS][CHUNK + 1];     // start | valid << 1
  __shared__ float s_rv[THREADS][CHUNK + 1];
  __shared__ int s_rs[THREADS][CHUNK + 1];
  __shared__ uint8_t s_re[THREADS][CHUNK + 1];
  __shared__ uint8_t s_of[THREADS][CHUNK + 1];

  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * THREADS;
  const bool live = b0 + tid < nb;
  const int thresh = L + 3;

  float pipe_v[LMAX];
  uint8_t pipe_l[LMAX];
  bool pipe_en[LMAX];
  float reg_v[RMAX];
  bool reg_en[RMAX];
  int reg_cnt[RMAX];
  int reg_set[RMAX];
  int label_set[RMAX];
  for (int i = 0; i < L; ++i) {
    pipe_v[i] = 0.0f;
    pipe_l[i] = 0;
    pipe_en[i] = false;
  }
  for (int i = 0; i < R; ++i) {
    reg_v[i] = 0.0f;
    reg_en[i] = false;
    reg_cnt[i] = 0;
    reg_set[i] = -1;
    label_set[i] = -1;
  }
  float fa[FIFO], fb[FIFO];
  int fl[FIFO];
#pragma unroll
  for (int j = 0; j < FIFO; ++j) {
    fa[j] = 0.0f;
    fb[j] = 0.0f;
    fl[j] = 0;
  }
  int fn = 0, fsm = 0, pend_l = 0, cur_set = -1, cur_label = 0;
  float pend_v = 0.0f;
  int slot = 0;                         // c % L

  for (long long c0 = 0; c0 < nt; c0 += CHUNK) {
    const int n = static_cast<int>(min(static_cast<long long>(CHUNK),
                                       nt - c0));
    for (int i = tid; i < THREADS * CHUNK; i += THREADS) {
      const int r = i / CHUNK, cc = i % CHUNK;
      const long long b = b0 + r;
      if (b < nb && cc < n) {
        const long long at = b * nt + c0 + cc;
        s_v[r][cc] = values[at];
        s_in[r][cc] = static_cast<uint8_t>((starts[at] != 0) |
                                           ((valids[at] != 0) << 1));
      }
    }
    __syncthreads();
    if (live) {
      for (int cc = 0; cc < n; ++cc) {
        const float v = s_v[tid][cc];
        const bool start = s_in[tid][cc] & 1;
        const bool valid = (s_in[tid][cc] >> 1) & 1;
        const bool is_start = valid && start;
        const bool is_cont = valid && !start;
        const bool have_pending = fsm == 1;

        // FSM / input pairing (Algorithm 1), from the old pending register
        const bool flush = (is_start || !valid) && have_pending;
        const bool pair = is_cont && have_pending;
        const bool input_issue = flush || pair;
        float ia = pend_v;
        float ib = pair ? v : 0.0f;
        int il = pend_l;

        const int new_set = is_start ? cur_set + 1 : cur_set;
        const int new_label = is_start ? (cur_set + 1) % R : cur_label;
        if (is_start) label_set[new_label] = new_set;
        const bool stash = is_start || (is_cont && !have_pending);
        if (stash) {
          pend_v = v;
          pend_l = new_label;
        }
        fsm = stash ? 1 : (input_issue ? 0 : fsm);
        cur_set = new_set;
        cur_label = new_label;

        // FIFO issue when the adder slot is free: pop = roll by -1
        const bool fifo_issue = !input_issue && fn > 0;
        if (fifo_issue) {
          ia = fa[0];
          ib = fb[0];
          il = fl[0];
          const float ta = fa[0], tb = fb[0];
          const int tl = fl[0];
#pragma unroll
          for (int j = 0; j < FIFO - 1; ++j) {
            fa[j] = fa[j + 1];
            fb[j] = fb[j + 1];
            fl[j] = fl[j + 1];
          }
          fa[FIFO - 1] = ta;
          fb[FIFO - 1] = tb;
          fl[FIFO - 1] = tl;
          fn -= 1;
        }
        const bool issue_en = input_issue || fifo_issue;

        // adder pipeline tick: read the slot issued L cycles ago, refill it
        const float out_v = pipe_v[slot];
        const int out_l = pipe_l[slot];
        const bool out_en = pipe_en[slot];
        pipe_v[slot] = issue_en ? __fadd_rn(ia, ib) : 0.0f;
        pipe_l[slot] = static_cast<uint8_t>(il);
        pipe_en[slot] = issue_en;
        slot = slot + 1 == L ? 0 : slot + 1;

        // PIS insert (pair identification)
        bool overflow = false;
        if (out_en) {
          if (reg_en[out_l]) {          // pair -> FIFO push, clipped index
            overflow = fn >= FIFO;
            const int p = min(fn, FIFO - 1);
            const float a = reg_v[out_l];
#pragma unroll
            for (int j = 0; j < FIFO; ++j) {
              if (j == p) {
                fa[j] = a;
                fb[j] = out_v;
                fl[j] = out_l;
              }
            }
            fn += 1;
            reg_en[out_l] = false;      // reg_v stays as it was
          } else {                      // store
            reg_v[out_l] = out_v;
            reg_en[out_l] = true;
            reg_set[out_l] = label_set[out_l];
          }
          reg_cnt[out_l] = 0;
        }

        // Algorithm 2: timeout scan, lowest ready register on the one port
        int emit = -1;
        float rv = 0.0f;
        int rs = 0;
        for (int i = 0; i < R; ++i) {
          if (!reg_en[i]) continue;
          if (emit < 0 && reg_cnt[i] >= thresh) {
            emit = i;
            rv = reg_v[i];
            rs = reg_set[i];
            reg_en[i] = false;
            reg_cnt[i] = 0;
            reg_set[i] = -1;
          } else {
            reg_cnt[i] = min(reg_cnt[i] + 1, thresh);
          }
        }
        if (emit < 0) {
          rv = reg_v[0];
          rs = reg_set[0];
        }
        s_rv[tid][cc] = rv;
        s_rs[tid][cc] = rs;
        s_re[tid][cc] = emit >= 0;
        s_of[tid][cc] = overflow;
      }
    }
    __syncthreads();
    for (int i = tid; i < THREADS * CHUNK; i += THREADS) {
      const int r = i / CHUNK, cc = i % CHUNK;
      const long long b = b0 + r;
      if (b < nb && cc < n) {
        const long long at = b * nt + c0 + cc;
        res_v[at] = s_rv[r][cc];
        res_set[at] = s_rs[r][cc];
        res_en[at] = s_re[r][cc];
        ovf[at] = s_of[r][cc];
      }
    }
    // the next tile's load overwrites s_v and s_in only after every
    // thread has stepped this one; the stores above finish before the
    // next tile's steps write s_rv (the barrier after the load)
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int jugglepac_fsm_launch(const void* values, const void* starts,
                                    const void* valids, void* res_v,
                                    void* res_set, void* res_en, void* ovf,
                                    long long nb, long long nt, int L, int R,
                                    void* stream) {
  if (nb <= 0 || nt <= 0) return 0;
  if (L < 1 || L > LMAX || R < 1 || R > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (nb + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  jugglepac_fsm_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const uint8_t*>(starts),
      static_cast<const uint8_t*>(valids), static_cast<float*>(res_v),
      static_cast<int*>(res_set), static_cast<uint8_t*>(res_en),
      static_cast<uint8_t*>(ovf), nb, nt, L, R);
  return static_cast<int>(cudaGetLastError());
}
