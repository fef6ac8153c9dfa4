// K2, K3, K4 — streaming flash-decode attention (one new token), for
// Hopper (sm_90a).
//
// Replace the TPU kernels `_flash_decode_kernel` (K2, dense, finalized),
// `_flash_decode_partial_kernel` (K3, dense, raw (m, l, o) partial per
// chunk of blocks) and `_flash_decode_paged_kernel` (K4, paged gather),
// launched by `flash_decode_pallas`, `flash_decode_partial_pallas` and
// `flash_decode_paged_pallas` (src/repro/kernels/flash_decode.py).  All
// three share one online-softmax step, `softmax_step` below, mirroring
// `_online_softmax_step`: for each block of `bkv` KV rows,
//   s     = dot(q, k^T) * sm_scale + bias        (G, bkv)
//   m_new = max(m, max_j s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l     = l * alpha + sum_j p
//   acc   = acc * alpha + p @ v
// and at the end o = acc / max(l, 1e-30) (K2, K4) or the raw triple (K3).
// The mask value is -1e30, never -inf: a fully masked block gives p = 1 on
// every row until a valid block's alpha = 0 wipes them.
//
// Order.  Every sum follows the port's pinned order, the pass-through
// pairwise tree of `core/trees.py` (the plain versions call
// `pairwise_tree_sum`): each score over d, `sum_j p` and each (g, c) cell
// of `p @ v` over the block's rows.  Here a tree is built with a
// binary-counter stack of subtrees: 8 consecutive leaves (aligned at a
// multiple of 8) are summed as one fixed 8-leaf tree in registers and
// pushed as a level-3 subtree, leftover leaves one at a time; the closing
// fold runs from the top of the stack down (T8 + (T4 + x12) for 13
// leaves), which is the pass-through tree.  `sum_j p` is a warp's shuffle
// tree over aligned row segments, padded with +0 to a power of two; p is
// never -0, so the padding changes no bit.  Products, adds, the max, expf
// and the division are elementwise IEEE operations, built with
// --fmad=false and without fast-math: no contraction, no flush to zero.
//
// Design.  One CUDA block per (kv-head, request) pair — the grid replaces
// the reference's vmap and its Python loop over requests — and, for K3,
// per chunk of `per` blocks (grid z).  Its G query rows (q.reshape(B, K,
// G, d): query head h reads kv head h / G) sit in shared memory.  One
// schedule block of 512 rows x d=128 f32 would be 256 KB, more than a
// block's 227 KB, so a step first computes the block's G x bkv scores
// (12 KB at G=6) while K streams through a tile of `chunk` rows, then the
// max, p and l, then V streams through the same tile into the (g, c)
// cells, each thread owning up to MAX_CELLS of them in registers.  The
// paged kernel differs only in the address of a row: logical block j of
// request b reads physical page table[b, j] (clamped into the pool).
//
// Bound.  Bytes: K and V are read once, 2 * B * S * K * d * 4 bytes; the
// operations (4 * B * H * S * d) are far below the f32 rate.  This first
// version keeps one CUDA block per pair and stages K/V synchronously, so
// it does not yet overlap loads with compute (see PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CELLS = 4;     // (g, c) cells per thread: G * d <= 2048
constexpr int DEPTH = 14;        // subtree stack: up to 2^13 leaves
constexpr float NEG = -1e30f;

struct Args {
  const float* q;      // (B, H, d)
  const float* k;      // dense (B, S, K, d) or pages (P, ps, K, d)
  const float* v;
  const float* bias;   // (B, S)  (paged: S = nb * ps)
  const int* table;    // (B, nb) page per logical block (paged only)
  float* o;            // (B, H, d) finalized, or (C, B, H, d) raw
  float* m_out;        // (C, B, H) raw partial (K3 only)
  float* l_out;
  int B, H, K, G, d;
  int S;               // rows of a request; dense rows >= S read as zero
  int bkv;             // rows per schedule block (paged: page size)
  int nb;              // schedule blocks per request
  int per;             // blocks per chunk (K3); nb otherwise
  int pages;           // P (paged)
  int chunk;           // rows of K/V staged in shared memory at a time
  int vec4;            // 16-byte loads (d % 4 == 0, aligned pointers)
  float sm_scale;
};

// A binary-counter stack of pairwise subtrees (see "Order" above).
struct Tree {
  float stk[DEPTH];
  int sp;
  unsigned cnt;
};

__device__ __forceinline__ void tree_reset(Tree& t) {
  t.sp = 0;
  t.cnt = 0u;
}

// Push a subtree of 2^lvl leaves; the count so far is a multiple of 2^lvl.
__device__ __forceinline__ void tree_push(Tree& t, float v, int lvl) {
  t.cnt += 1u << lvl;
  const int merges = __ffs(t.cnt) - 1 - lvl;
  for (int m = 0; m < merges; ++m) v = t.stk[--t.sp] + v;
  t.stk[t.sp++] = v;
}

__device__ __forceinline__ float tree_close(const Tree& t) {
  float v = t.stk[t.sp - 1];
  for (int i = t.sp - 2; i >= 0; --i) v = t.stk[i] + v;
  return v;
}

__device__ __forceinline__ float tree8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}

// First float of KV row `pos` of request b, kv head kh; nullptr past S.
template <bool PAGED>
__device__ __forceinline__ const float* kv_row(const Args& a,
                                               const float* base, int b,
                                               int kh, long long pos) {
  long long row;
  if (PAGED) {
    int page = a.table[static_cast<long long>(b) * a.nb + pos / a.bkv];
    page = min(max(page, 0), a.pages - 1);
    row = static_cast<long long>(page) * a.bkv + pos % a.bkv;
  } else {
    if (pos >= a.S) return nullptr;
    row = static_cast<long long>(b) * a.S + pos;
  }
  return base + (row * a.K + kh) * a.d;
}

// Rows [pos0, pos0 + rows) of K or V into tile (row stride d + 1 floats,
// so threads reading one column of consecutive rows hit distinct banks).
template <bool PAGED>
__device__ void stage(const Args& a, const float* base, int b, int kh,
                      long long pos0, int rows, float* tile) {
  const int d = a.d, ld = d + 1;
  if (a.vec4) {
    const int d4 = d / 4;
    for (int e = threadIdx.x; e < rows * d4; e += THREADS) {
      const int r = e / d4, c = (e - r * d4) * 4;
      const float* src = kv_row<PAGED>(a, base, b, kh, pos0 + r);
      float4 x = src ? *reinterpret_cast<const float4*>(src + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      float* dst = tile + r * ld + c;
      dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += THREADS) {
      const int r = e / d, c = e - r * d;
      const float* src = kv_row<PAGED>(a, base, b, kh, pos0 + r);
      tile[r * ld + c] = src ? src[c] : 0.f;
    }
  }
}

// One schedule block through the running (m, l, acc) registers.
template <bool PAGED>
__device__ void softmax_step(const Args& a, int b, int kh, int blk,
                             const float* qs, float* ss, float* tile,
                             float* mrow, float* lrow, float* alpha,
                             float* acc) {
  const int G = a.G, d = a.d, bkv = a.bkv, ld = d + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long pos0 = static_cast<long long>(blk) * bkv;
  const float* bias = a.bias + static_cast<long long>(b) * a.S;

  // scores: s = dot(q, k^T) * sm_scale + bias, one (g, row) per thread
  for (int r0 = 0; r0 < bkv; r0 += a.chunk) {
    const int rows = min(a.chunk, bkv - r0);
    stage<PAGED>(a, a.k, b, kh, pos0 + r0, rows, tile);
    __syncthreads();
    for (int e = tid; e < G * rows; e += THREADS) {
      const int g = e / rows, r = e - g * rows;
      const float* qq = qs + g * d;
      const float* kk = tile + r * ld;
      Tree t;
      tree_reset(t);
      int c = 0;
      for (; c + 8 <= d; c += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = qq[c + u] * kk[c + u];
        tree_push(t, tree8(x), 3);
      }
      for (; c < d; ++c) tree_push(t, qq[c] * kk[c], 0);
      const long long pos = pos0 + r0 + r;
      const float bj = pos < a.S ? bias[pos] : NEG;
      ss[g * bkv + r0 + r] = tree_close(t) * a.sm_scale + bj;
    }
    __syncthreads();
  }

  // m_new, alpha, p and l: one warp per query row
  int p2 = 1;
  while (p2 < bkv) p2 <<= 1;
  const int seg = p2 >= 32 ? p2 / 32 : 1;
  for (int g = warp; g < G; g += WARPS) {
    float* sg = ss + g * bkv;
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
    if (lane * seg < p2) {
      Tree t;
      tree_reset(t);
      for (int j = lane * seg; j < lane * seg + seg; ++j)
        tree_push(t, j < bkv ? sg[j] : 0.f, 0);
      part = tree_close(t);
    }
    for (int off = 1; off < 32; off <<= 1)
      part = part + __shfl_down_sync(0xffffffffu, part, off);
    if (lane == 0) {
      lrow[g] = lrow[g] * al + part;
      mrow[g] = m_new;
      alpha[g] = al;
    }
  }
  __syncthreads();

  // acc = acc * alpha + p @ v, one tree per (g, c) cell over the rows
  Tree tr[MAX_CELLS];
#pragma unroll
  for (int i = 0; i < MAX_CELLS; ++i) tree_reset(tr[i]);
  for (int r0 = 0; r0 < bkv; r0 += a.chunk) {
    const int rows = min(a.chunk, bkv - r0);
    stage<PAGED>(a, a.v, b, kh, pos0 + r0, rows, tile);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_CELLS; ++i) {
      const int cell = tid + i * THREADS;
      if (cell >= G * d) break;
      const int g = cell / d, c = cell - g * d;
      const float* pp = ss + g * bkv + r0;
      const float* vv = tile + c;
      int r = 0;
      for (; r + 8 <= rows; r += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = pp[r + u] * vv[(r + u) * ld];
        tree_push(tr[i], tree8(x), 3);
      }
      for (; r < rows; ++r) tree_push(tr[i], pp[r] * vv[r * ld], 0);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MAX_CELLS; ++i) {
    const int cell = tid + i * THREADS;
    if (cell >= G * d) break;
    acc[i] = acc[i] * alpha[cell / d] + tree_close(tr[i]);
  }
  __syncthreads();
}

template <bool PAGED, bool PARTIAL>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(Args a) {
  extern __shared__ float smem[];
  const int G = a.G, d = a.d;
  float* qs = smem;                        // G * d query rows
  float* ss = qs + G * d;                  // G * bkv scores, then p
  float* tile = ss + G * a.bkv;            // chunk * (d + 1) K or V rows
  float* mrow = tile + a.chunk * (d + 1);  // G running max
  float* lrow = mrow + G;                  // G running denominator
  float* alpha = lrow + G;                 // G rescale of the last step

  const int kh = blockIdx.x, b = blockIdx.y, chunk = blockIdx.z;
  const int tid = threadIdx.x;
  const long long h0 = static_cast<long long>(b) * a.H + kh * G;
  for (int e = tid; e < G * d; e += THREADS) qs[e] = a.q[h0 * d + e];
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = NEG;
    lrow[g] = 0.f;
  }
  float acc[MAX_CELLS];
#pragma unroll
  for (int i = 0; i < MAX_CELLS; ++i) acc[i] = 0.f;
  __syncthreads();

  const int blk0 = PARTIAL ? chunk * a.per : 0;
  const int blk1 = PARTIAL ? min(blk0 + a.per, a.nb) : a.nb;
  for (int blk = blk0; blk < blk1; ++blk)
    softmax_step<PAGED>(a, b, kh, blk, qs, ss, tile, mrow, lrow, alpha, acc);

  const long long out0 =
      PARTIAL ? (static_cast<long long>(chunk) * a.B * a.H + h0) : h0;
#pragma unroll
  for (int i = 0; i < MAX_CELLS; ++i) {
    const int cell = tid + i * THREADS;
    if (cell >= G * d) break;
    const int g = cell / d;
    a.o[out0 * d + cell] = PARTIAL ? acc[i] : acc[i] / fmaxf(lrow[g], 1e-30f);
  }
  if (PARTIAL) {
    for (int g = tid; g < G; g += THREADS) {
      a.m_out[out0 + g] = mrow[g];
      a.l_out[out0 + g] = lrow[g];
    }
  }
}

template <bool PAGED, bool PARTIAL>
int launch(const Args& a, size_t smem, int chunks, cudaStream_t stream) {
  auto kern = flash_decode_kernel<PAGED, PARTIAL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(a.K, a.B, chunks);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory; flash_decode.py's `smem_bytes` mirrors it.
size_t smem_bytes(int G, int d, int bkv, int chunk) {
  return 4 * (static_cast<size_t>(G) * d + static_cast<size_t>(G) * bkv +
              static_cast<size_t>(chunk) * (d + 1) + 3 * static_cast<size_t>(G));
}

}  // namespace

// mode: 0 dense finalized (K2), 1 dense raw partial (K3), 2 paged (K4).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_decode_launch(
    int mode, const void* q, const void* k, const void* v, const void* bias,
    const void* table, void* o, void* m_out, void* l_out, int B, int H,
    int K, int d, int S, int bkv, int nb, int per, int pages, int chunk,
    int vec4, float sm_scale, void* stream) {
  if (K <= 0 || H % K != 0 || d <= 0 || bkv <= 0 || nb <= 0 ||
      chunk <= 0 || chunk % 8 != 0 || bkv > (1 << (DEPTH - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  if (G * d > THREADS * MAX_CELLS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(bias),
         static_cast<const int*>(table), static_cast<float*>(o),
         static_cast<float*>(m_out), static_cast<float*>(l_out),
         B, H, K, G, d, S, bkv, nb, mode == 1 ? per : nb, pages, chunk,
         vec4, sm_scale};
  const size_t smem = smem_bytes(G, d, bkv, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<false, false>(a, smem, 1, s);
    case 1: return launch<false, true>(a, smem, (nb + per - 1) / per, s);
    case 2: return launch<true, false>(a, smem, 1, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
