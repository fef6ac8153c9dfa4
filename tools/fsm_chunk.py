#!/usr/bin/env python3
"""The JugglePAC kernel at other tile depths: is its L1 the limit?

    python3 tools/fsm_chunk.py [--seed 0] [--chunks 32,16,8]   # GPU

``csrc/jugglepac_fsm.cu`` stages ``CHUNK`` cycles of 64 circuits through
shared memory (32 as shipped: 31,680 B a block).  What a block takes in
shared memory an SM cannot give its L1, which caches the circuits' local
arrays.  This script builds the source once for each ``--chunks`` value
(``-DJPAC_CHUNK``, the port's nvcc flags, one nvcc each, all started
together), prints each build's ptxas report and the blocks an SM holds
by registers and shared memory, and runs each build on
``chip_smoke.py``'s real-size streams (65,536 circuits x 16,384 cycles,
L = 14, R = 4, sets of 64-512 values, from ``--seed`` + 23 as there):
held bitwise to the first build on all four outputs, timed (CUDA-event
medians of 5 after a warm-up, the builds in turns: first to last, then
last to first), beside the bound (16 B a circuit-cycle over 3.35 TB/s).
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

THREADS = 64                      # circuits a CUDA block, as in the source
SM_REGS, SM_SMEM, SM_BLOCKS, SM_THREADS = 65536, 233472, 32, 2048
REPS = 5


def build(chunks):
    """One library per tile depth -> {chunk: (ctypes library, ptxas)}."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "fsm_chunk"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "jugglepac_fsm.cu"
    jobs = {}
    for c in chunks:
        lib = out_dir / f"libjugglepac_fsm_c{c}.so"
        jobs[c] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DJPAC_CHUNK={c}",
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for c, (path, proc) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -DJPAC_CHUNK={c} failed:\n{report}")
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _build._SIGNATURES["jugglepac_fsm"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[c] = (lib, report)
    return libs


def blocks_per_sm(report):
    """(registers a thread, stack bytes, shared bytes a block, blocks an SM
    holds) from a ptxas report."""
    regs = int(re.search(r"Used (\d+) registers", report).group(1))
    stack = int(re.search(r"(\d+) bytes stack frame", report).group(1))
    m = re.search(r"(\d+) bytes smem", report)
    smem = int(m.group(1)) if m else 0
    by_regs = SM_REGS // (-(-regs // 8) * 8 * THREADS)
    by_smem = SM_SMEM // (smem + 1024) if smem else SM_BLOCKS
    return regs, stack, smem, min(by_regs, by_smem, SM_BLOCKS,
                                  SM_THREADS // THREADS)


def launch(lib, inputs, lat, regs):
    import torch
    values, starts, valids = inputs
    b, t = values.shape
    outs = (torch.empty_like(values),
            torch.empty((b, t), dtype=torch.int32, device=values.device),
            torch.empty((b, t), dtype=torch.bool, device=values.device),
            torch.empty((b, t), dtype=torch.bool, device=values.device))
    rc = lib.jugglepac_fsm_launch(
        values.data_ptr(), starts.data_ptr(), valids.data_ptr(),
        *(o.data_ptr() for o in outs), b, t, lat, regs,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return outs


def main(argv=None) -> int:
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", default="32,16,8")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.device_line()
    print(smi, flush=True)
    chunks = [int(c) for c in args.chunks.split(",")]
    libs = build(chunks)
    b, t, lat, regs = cs.CIRCUIT_B, cs.CIRCUIT_T, cs.CIRCUIT_L, cs.CIRCUIT_R
    inputs = cs.circuit_real_streams(args.seed + 23, b, t, lat, "cuda")[:3]
    first = launch(libs[chunks[0]][0], inputs, lat, regs)
    torch.cuda.synchronize()
    times = {c: [] for c in chunks}
    for order in (chunks, chunks[::-1]):
        for c in order:
            times[c].append(cs.cuda_ms(
                lambda: launch(libs[c][0], inputs, lat, regs), REPS))
    bound = 16 * b * t / cs.HBM_BYTES_PER_S * 1e3
    ok_all = True
    for c in chunks:
        lib, report = libs[c]
        outs = launch(lib, inputs, lat, regs)
        torch.cuda.synchronize()
        ok = cs.fsm_bitwise(outs, first)
        ok_all = ok_all and ok
        r, stack, smem, blocks = blocks_per_sm(report)
        ms = sorted(times[c])[0]
        print(f"CHUNK={c}: {r} registers, {stack} B stack, {smem} B shared a"
              f" block, {blocks} blocks ({blocks * THREADS} circuits) an "
              f"SM; kernel {times[c][0]:.3f} and {times[c][1]:.3f} ms "
              f"({b * t / ms * 1e3:.4g} circuit-cycles/s at the better), "
              f"{ms / bound:.1f} times the {bound:.3f} ms bound; outputs "
              f"{'bitwise' if ok else 'DIFFER from'} CHUNK={chunks[0]}'s | "
              f"{smi}", flush=True)
        del outs
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
