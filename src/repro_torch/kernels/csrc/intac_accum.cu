// K5 — INTAC exact fixed-point column sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_intac_kernel`, launched by
// `intac_accum_pallas` (src/repro/kernels/intac_accum.py).  Same function:
// a (N, D) f32 stream and a scale -> (2, D) int32 limbs,
//   q  = rint(x * scale)          (round half to even, as jnp.round)
//   hi = floor(q * 2^-15),  lo = q - hi * 2^15     (both exact in f32)
//   out[0][c] = sum hi,     out[1][c] = sum lo     (int32, wrapping)
//
// Design.  On the TPU the grid walks row blocks in order and the (2, D)
// accumulator stays in VMEM.  Here each CUDA block owns 256 consecutive
// columns (one per thread, so a warp reads 128 contiguous bytes of a row)
// and one tile of `block_rows` rows; each thread sums its column's hi and
// lo over the tile in registers and adds them into the output with two
// int32 atomics.  Integer addition is associative, so neither the tile
// size nor the atomics' order changes a bit.  The caller zeroes `out`.
//
// Bound.  Bytes: the stream is read once, N * D * 4 bytes; the work is a
// handful of f32 and int32 operations per element, far below the f32
// rate.  Built with --fmad=false and without fast-math (the products here
// are exact anyway: scale and 2^-15 are powers of two).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
intac_accum_kernel(const float* __restrict__ x, float scale,
                   int* __restrict__ out, long long n, int d,
                   int block_rows) {
  const long long c = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (c >= d) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * block_rows;
  const long long r1 = min(r0 + block_rows, n);
  unsigned hi = 0u, lo = 0u;
#pragma unroll 8
  for (long long r = r0; r < r1; ++r) {
    const float q = rintf(x[r * d + c] * scale);
    const float h = floorf(q * (1.0f / 32768.0f));
    const float l = q - h * 32768.0f;
    hi += static_cast<unsigned>(static_cast<int>(h));
    lo += static_cast<unsigned>(static_cast<int>(l));
  }
  atomicAdd(out + c, static_cast<int>(hi));
  atomicAdd(out + d + c, static_cast<int>(lo));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int intac_accum_launch(const void* x, float scale, void* out,
                                  long long n, int d, int block_rows,
                                  void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long tiles = (n + block_rows - 1) / block_rows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((d + THREADS - 1) / THREADS, static_cast<unsigned>(tiles));
  intac_accum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), scale, static_cast<int*>(out), n, d,
      block_rows);
  return static_cast<int>(cudaGetLastError());
}
