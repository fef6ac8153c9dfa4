#!/usr/bin/env python3
"""Where K1's float path spends its time, phase by phase, on the GPU.

    python3 tools/k1_phases.py            # needs a CUDA device and nvcc

Builds a copy of ``src/repro_torch/kernels/csrc/segsum.cu`` with a
``clock64()`` mark after each phase of a touched schedule block's tree
chunk and of the label scan, into ``build/k1_phases/``, and launches its
``fast`` tier once at ``chip_smoke.py``'s main-path shape (N=4,000,000 x
D=64 f32, 1,024 sets, seed 0) for block sizes 512 and 4,096.  Thread 0
of every CUDA block adds its cycles to one counter per phase; the script
prints each phase's cycles per chunk (or per CUDA block for the scan),
the marked kernel's time, and the compiler's stack frame and registers
of the float-tier kernels (a stack frame beyond the 33-float chunk
stack means an array left registers).  The marks serialize nothing, but
they add instructions: the kernel's own time is ``chip_smoke.py``'s.
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

PHASES = ("stage (thread 0)", "stage barrier wait", "shared levels",
          "descent and chunk stack", "trailing barrier", "scan (thread 0)",
          "scan barrier wait")
CHUNKS = 15                      # counter slot: chunks summed
MARKS = [
    # (text in segsum.cu, the same text with marks), each found once
    ("namespace {\n", """namespace {
__device__ unsigned long long g_phase[16];
#define MARK(k) do { const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) atomicAdd(&g_phase[k], t_ - t_prev); \\
  t_prev = t_; } while (0)
"""),
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
    ("""  for (long long b0 = 0; b0 < nb; b0 += 32) {
""", """  for (long long b0 = 0; b0 < nb; b0 += 32) {
    unsigned long long t_prev = clock64();
"""),
    ("""      if (lane == 0) flags[j] = hit;
    }
    __syncthreads();
""", """      if (lane == 0) flags[j] = hit;
    }
    MARK(5);
    __syncthreads();
    MARK(6);
"""),
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


def build():
    from repro_torch.kernels import _build
    src = (_build.CSRC / "segsum.cu").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"segsum.cu changed; no single {old!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "k1_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "segsum_phases.cu").write_text(src + READERS)
    lib_path = out / "libsegsum_phases.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(out / "segsum_phases.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    # the float tiers' kernels are segsum_policy_kernel<0 or 1, ...>
    report = re.split(r"Compiling entry function", r.stdout + r.stderr)
    for part in report:
        if re.search(r"segsum_policy_kernelILi[01]E", part):
            name = re.search(r"kernelILi(\d)ELb(\d)", part).groups()
            info = " ".join(l.split(":", 1)[-1].strip()
                            for l in part.splitlines()
                            if "stack frame" in l or "registers" in l)
            print(f"ptxas tier {name[0]} lanes {name[1]}: {info}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.segsum_policy_launch
    fn.argtypes = _build._SIGNATURES["segsum"][1]
    fn.restype = ctypes.c_int
    return lib, fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import ops
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.reduce import get_policy, mask_out_of_range, plan_program
    lib, fn = build()
    dev = torch.device("cuda")
    n, d, s = C.N_ROWS, C.WIDTH, C.SEGMENTS
    vals, ids = C.make_stream(n, d, s, 0, dev)
    ids = mask_out_of_range(ids, s)
    pol = get_policy("fast")
    print(C.device_line(), flush=True)
    for block in (512, 4096):
        prog = plan_program(pol, num_segments=s, domain_width=d,
                            block_size=block)
        ct, st, grid = K.launch_shape(pol, s, d, prog)
        carry = torch.empty((s, d), device=dev)

        def run():
            rc = fn(0, 0, vals.data_ptr(), ids.data_ptr(), carry.data_ptr(),
                    None, None, None, n, block, s, 0, d, 1, st, ct,
                    ops.tree_rows_for(block),
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        lib.phases_reset()
        ms = C.cuda_ms(run, 1, warmup=0)
        buf = (ctypes.c_ulonglong * 16)()
        if lib.phases_read(buf) != 0:
            raise RuntimeError("cannot read the phase counters")
        blocks = grid[0] * grid[1]
        chunks = max(buf[CHUNKS], 1)
        print(f"B={block}: marked kernel {ms:.3f} ms, {buf[CHUNKS]} tree "
              f"chunks over {blocks} CUDA blocks")
        for k, name in enumerate(PHASES):
            per, unit = (buf[k] / chunks, "chunk") if k < 5 \
                else (buf[k] / blocks, "CUDA block")
            print(f"  {name:24s} {per:12.0f} cycles per {unit}; "
                  f"{buf[k] / blocks:14.0f} per CUDA block", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
