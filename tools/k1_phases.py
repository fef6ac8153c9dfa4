#!/usr/bin/env python3
"""Where K1 spends its time, phase by phase, on the GPU.

    python3 tools/k1_phases.py            # needs a CUDA device and nvcc

Builds a copy of ``src/repro_torch/kernels/csrc/segsum.cu`` with a
``clock64()`` mark after each phase, into ``build/k1_phases/``, and
launches it at ``chip_smoke.py``'s main-path shape (N=4,000,000 x D=64
f32, 1,024 sets, seed 0): the ``fast`` tier at block sizes 512 and 4,096
(phases of a tree chunk), ``exact`` and ``exact2`` at 512 (phases of a
touched schedule block: loads, register runs and flushes; the flushes
alone; the barrier; the fold).  Every tier also reports the range walk
of each window of schedule blocks (the range test and ballot, and the
barrier waits around it).  Thread 0 of every CUDA block adds its cycles
to one counter per phase; the script prints each phase's cycles per
chunk, touched block or CUDA block, the marked kernel's time, and the
compiler's stack frame and registers of every K1 kernel (a float-tier
stack frame beyond the 33-float chunk stack means an array left
registers).  The marks serialize nothing, but they add instructions: the
kernel's own time is ``chip_smoke.py``'s.

Last, with the unmarked kernel, it times K1 exact, exact2 and
procrastinate at label tiles of 4, 8, 16 and 32 (64 to 512 threads a
CUDA block): the sweep behind ``ops.INT_THREADS``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FLOAT_PHASES = ("stage (thread 0)", "stage barrier wait", "shared levels",
                "descent and chunk stack", "trailing barrier")
WALK_PHASES = {5: "range test (thread 0)", 6: "range barrier waits"}
INT_PHASES = {7: "loads, runs, flushes", 8: "of which flushes",
              9: "sum barrier wait", 10: "fold"}
FLUSHES, TOUCHED, CHUNKS = 13, 14, 15      # counter slots
MARKS = [
    # (text in segsum.cu, the same text with marks), each found once
    ("namespace {\n", """namespace {
__device__ unsigned long long g_phase[16];
#define MARK(k) do { const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) atomicAdd(&g_phase[k], t_ - t_prev); \\
  t_prev = t_; } while (0)
"""),
    # the float tiers' tree chunk
    ("""    for (int c0 = 0; c0 < len; c0 += C) {
      ++gen;""", """    for (int c0 = 0; c0 < len; c0 += C) {
      unsigned long long t_prev = clock64();
      if (threadIdx.x == 0) atomicAdd(&g_phase[15], 1ull);
      ++gen;"""),
    ("""      }
      __syncthreads();
      // levels log_g + 1 .. log_c in shared memory, one barrier each""",
     """      }
      MARK(0);
      __syncthreads();
      MARK(1);
      // levels log_g + 1 .. log_c in shared memory, one barrier each"""),
    ("""      float part = 0.f;
      if (active && present[ty] == gen)""", """      MARK(2);
      float part = 0.f;
      if (active && present[ty] == gen)"""),
    ("""      push_leaf(part, stk, sp, cnt);
      __syncthreads();""", """      push_leaf(part, stk, sp, cnt);
      MARK(3);
      __syncthreads();
      MARK(4);"""),
    # the integer tiers' flush of a register run
    ("""    auto flush = [&]() {
      if (cur >= 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (acc[k] != 0) atomicAdd(cell + cur * stride + k, acc[k]);
      }
    };""", """    auto flush = [&]() {
      const unsigned long long t_f = clock64();
      if (cur >= 0) {
        if (threadIdx.x == 0) atomicAdd(&g_phase[13], 1ull);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (acc[k] != 0) atomicAdd(cell + cur * stride + k, acc[k]);
      }
      if (threadIdx.x == 0) atomicAdd(&g_phase[8], clock64() - t_f);
    };"""),
    # the walk over windows of schedule blocks
    ("""  for (long long b0 = 0; b0 < nb; b0 += nthr) {
""", """  for (long long b0 = 0; b0 < nb; b0 += nthr) {
    unsigned long long t_prev = clock64();
"""),
    ("""    if (lane == 0) hits[warp] = m;
    __syncthreads();
""", """    if (lane == 0) hits[warp] = m;
    MARK(5);
    __syncthreads();
    MARK(6);
"""),
    # the integer tiers' touched block
    ("""                               sc);
          __syncthreads();""", """                               sc);
          MARK(7);
          if (threadIdx.x == 0) atomicAdd(&g_phase[14], 1ull);
          __syncthreads();
          MARK(9);"""),
    ("""          buf ^= 1;
""", """          MARK(10);
          buf ^= 1;
"""),
    ("""    __syncthreads();
  }
  if (!INT""", """    t_prev = clock64();
    __syncthreads();
    MARK(6);
  }
  if (!INT"""),
]
READERS = """
extern "C" int phases_read(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));
}
extern "C" int phases_reset() {
  unsigned long long z[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, sizeof(z)));
}
"""
TIERS = {"fast": 0, "exact": 2, "exact2": 3, "procrastinate": 4}


def marked_source() -> str:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "segsum.cu").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"segsum.cu changed; no single {old!r}")
        src = src.replace(old, new)
    return src + READERS


def build():
    from repro_torch.kernels import _build
    out = ROOT / "build" / "k1_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "segsum_phases.cu").write_text(marked_source())
    lib_path = out / "libsegsum_phases.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(out / "segsum_phases.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    # K1 is segsum_policy_kernel<tier, vec>; the pre-pass has its own name
    for part in re.split(r"Compiling entry function", r.stdout + r.stderr):
        found = re.search(r"segsum_policy_kernelILi(\d)ELi(\d)E", part)
        if found:
            info = " ".join(l.split(":", 1)[-1].strip()
                            for l in part.splitlines()
                            if "stack frame" in l or "registers" in l)
            print(f"ptxas tier {found.group(1)} vec {found.group(2)}: "
                  f"{info}")
    lib = ctypes.CDLL(str(lib_path))
    lib.segsum_policy_launch.argtypes = \
        _build._SIGNATURES["segsum"]["segsum_policy_launch"]
    lib.segsum_policy_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.reduce import get_policy, mask_out_of_range
    lib = build()
    dev = torch.device("cuda")
    n, d, s = C.N_ROWS, C.WIDTH, C.SEGMENTS
    vals, ids = C.make_stream(n, d, s, 0, dev)
    ids = mask_out_of_range(ids, s)
    print(C.device_line(), flush=True)

    def launcher(fn, tier, dom, block, st):
        pol = get_policy(tier)
        w = dom.shape[1]
        carry = [torch.empty(c.shape, dtype=c.dtype, device=dev)
                 for c in pol.init(s, w, device="meta")]
        ptrs = [c.data_ptr() for c in carry] + [None] * (4 - len(carry))
        ranges = torch.empty((-(-n // block), 2), dtype=torch.int32,
                             device=dev)
        chunk = 0 if pol.integer else ops.tree_rows_for(block)

        def run():
            rc = fn(TIERS[tier], dom.data_ptr(), ids.data_ptr(),
                    ranges.data_ptr(), *ptrs, n, block, s, 0,
                    w // pol.parts, 1, st, ops.col_tile_for(w // pol.parts),
                    chunk, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return run

    domains = {}
    for tier, block in (("fast", 512), ("fast", 4096), ("exact", 512),
                        ("exact2", 512)):
        pol = get_policy(tier)
        if tier not in domains:
            domains[tier] = pol.prepare(vals, n)[0]
        dom = domains[tier]
        ct, st, grid = K.launch_shape(pol, s, dom.shape[1])
        run = launcher(lib.segsum_policy_launch, tier, dom, block, st)
        run()
        torch.cuda.synchronize()
        lib.phases_reset()
        ms = C.cuda_ms(run, 1, warmup=0)
        buf = (ctypes.c_ulonglong * 16)()
        if lib.phases_read(buf) != 0:
            raise RuntimeError("cannot read the phase counters")
        blocks = grid[0] * grid[1]
        # the schedule blocks whose range meets each label tile, over all
        # column tiles: what the walk should visit
        ranges = K.block_label_ranges_torch(ids, block, s)
        want = grid[0] * sum(
            int(((ranges[:, 0] < min(s, s0 + st)) & (ranges[:, 1] >= s0))
                .sum()) for s0 in range(0, s, st))
        if pol.integer:
            unit, count = "touched block", max(buf[TOUCHED], 1)
            rows = INT_PHASES
            print(f"{tier} B={block}: marked kernel {ms:.3f} ms, "
                  f"{buf[TOUCHED]} touched blocks (the ranges give {want}) "
                  f"and {buf[FLUSHES]} flushes of thread 0 over {blocks} "
                  f"CUDA blocks (label tile {st})")
        else:
            unit, count = "chunk", max(buf[CHUNKS], 1)
            rows = dict(enumerate(FLOAT_PHASES))
            print(f"{tier} B={block}: marked kernel {ms:.3f} ms, "
                  f"{buf[CHUNKS]} tree chunks (the ranges give "
                  f"{want * -(-block // ops.tree_rows_for(block))}) over "
                  f"{blocks} CUDA blocks")
        for k, name in rows.items():
            print(f"  {name:24s} {buf[k] / count:12.0f} cycles per {unit}; "
                  f"{buf[k] / blocks:14.0f} per CUDA block", flush=True)
        for k, name in WALK_PHASES.items():
            print(f"  {name:24s} {buf[k] / blocks:12.0f} cycles per CUDA "
                  "block", flush=True)
    del domains

    # the integer tiers' label tile, with the unmarked kernel
    plain = _build.load("segsum").segsum_policy_launch
    smi = C.device_line()
    for tier in ("exact", "exact2", "procrastinate"):
        dom = get_policy(tier).prepare(vals, n)[0]
        times = []
        for st in (4, 8, 16, 32):
            ms = C.cuda_ms(launcher(plain, tier, dom, 512, st), C.REPS)
            times.append(f"{st} labels ({16 * st} threads) {ms:.3f} ms")
        print(f"sweep {tier} B=512: " + ", ".join(times) + f" | {smi}",
              flush=True)
        del dom
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
