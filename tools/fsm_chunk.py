#!/usr/bin/env python3
"""The JugglePAC kernel against an earlier revision of its source (A/B).

    python3 tools/fsm_chunk.py --rev REV [--parts] [--seed 0]   # GPU
    python3 tools/fsm_chunk.py --rev REV --fetch-only           # anywhere

Builds ``csrc/jugglepac_fsm.cu`` with the port's nvcc flags (one nvcc a
build, all started together): as it is in the tree, and as it was at git
revision ``--rev``.  The old source is read with ``git show`` and kept
under ``build/fsm_ab/`` so that a machine without the repository's
history (a copy of the checkout, say) finds it there: run the script
once with ``--fetch-only`` where ``git`` works, then anywhere.  With
``--parts`` it also builds two parts of the tree's kernel: ``steps`` (the
circuits stepped, with no global traffic after the first chunk: each
chunk steps the previous chunk's outputs as values, and every flag chunk
after the first is all valid with a start at its first cycle) and ``io``
(the loads and stores alone, no step); their outputs are not compared.

For each build it prints the ptxas line of every kernel instance
(registers, stack frame, spills, shared memory) and the blocks an SM
holds at the design point: from the occupancy calculator where the
build exports ``jugglepac_fsm_blocks_per_sm``, else estimated from the
ptxas report.  Then it runs both builds on ``chip_smoke.py``'s
real-size streams (65,536 circuits x 16,384 cycles, L = 14, R = 4, sets
of 64-512 values, from ``--seed`` + 23 as there): held bitwise to each
other on all four outputs, timed (CUDA-event medians of 5 after a
warm-up, the builds in turns: first to last, then last to first),
beside the bound (16 B a circuit-cycle over 3.35 TB/s).  The card's
name and power limit come first.  Exit 1 if the outputs differ.
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

SOURCE = "src/repro_torch/kernels/csrc/jugglepac_fsm.cu"
OUT_DIR = ROOT / "build" / "fsm_ab"
SM_REGS, SM_SMEM, SM_BLOCKS, SM_THREADS = 65536, 233472, 32, 2048
REPS = 5


def fetch(rev: str) -> Path:
    """The source at ``rev``, read with ``git show`` (or the copy an
    earlier run kept under ``build/fsm_ab/``)."""
    path = OUT_DIR / f"jugglepac_fsm-{re.sub(r'[^\w.-]', '_', rev)}.cu"
    try:
        text = subprocess.run(["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT,
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        if path.exists():
            return path
        raise RuntimeError(f"cannot read {SOURCE} at {rev}: no git history "
                           f"here and no copy at {path}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def build(sources):
    """One library per source -> {name: (ctypes library, ptxas report,
    source text)}."""
    from repro_torch.kernels import _build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        lib = OUT_DIR / f"libjugglepac_fsm-{name}.so"
        jobs[name] = (lib, src, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, src, proc) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} source:\n{report}")
        lib = ctypes.CDLL(str(path))
        lib.jugglepac_fsm_launch.restype = ctypes.c_int
        libs[name] = (lib, report, Path(src).read_text())
    return libs


def ptxas_lines(report):
    """Per kernel instance in a ptxas report: its registers, stack frame,
    spills and static shared memory, one line each."""
    from repro_torch.kernels import _build
    return [f"{k['name']}: {k['registers']} registers, {k.get('stack')} B "
            f"stack, spills {k.get('spill_stores')}/{k.get('spill_loads')} "
            f"B, {k['smem']} B static smem"
            for k in _build.ptxas_kernels(report) if "jugglepac" in k["name"]]


def blocks_per_sm(lib, report, text, lat, regs, smem):
    """(blocks an SM holds, how it was found) for one build."""
    if hasattr(lib, "jugglepac_fsm_blocks_per_sm"):
        fn = lib.jugglepac_fsm_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        rc = fn(lat, regs, smem, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
        return out.value, "occupancy calculator"
    threads = int(re.search(r"constexpr int THREADS = (\d+)", text).group(1))
    r = int(re.search(r"Used (\d+) registers", report).group(1))
    m = re.search(r"(\d+) bytes smem", report)
    static = int(m.group(1)) if m else 0
    by_regs = SM_REGS // (-(-r // 8) * 8 * threads)
    by_smem = SM_SMEM // (static + 1024) if static else SM_BLOCKS
    return (min(by_regs, by_smem, SM_BLOCKS, SM_THREADS // threads),
            f"estimated from ptxas, {threads} threads a block")


def launcher(lib, inputs, lat, regs, smem):
    """A closure launching one build on ``inputs`` -> its four outputs.
    A build that exports the occupancy query takes the block's shared
    memory as an argument; an older one does not."""
    import torch
    values, starts, valids = inputs
    b, t = values.shape
    fn = lib.jugglepac_fsm_launch
    extra = []
    args = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
    if hasattr(lib, "jugglepac_fsm_blocks_per_sm"):
        args.append(ctypes.c_longlong)
        extra = [smem]
    fn.argtypes = args + [ctypes.c_void_p]

    def run():
        outs = (torch.empty_like(values),
                torch.empty((b, t), dtype=torch.int32, device=values.device),
                torch.empty((b, t), dtype=torch.bool, device=values.device),
                torch.empty((b, t), dtype=torch.bool, device=values.device))
        rc = fn(values.data_ptr(), starts.data_ptr(), valids.data_ptr(),
                *(o.data_ptr() for o in outs), b, t, lat, regs, *extra,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return outs
    return run


#: the tree's source cut to its parts: (old text, new text) edits
PARTS = {
    "steps": (
        ("""    load_words(starts, valids, ls, lv, words, first_row, w * WORD_ROWS, nrows,
               nt, f0 + FLAGS);""",
         """    for (int j = 0; j < WORD_ROWS; ++j) {
      ls[j] = lane == 0;
      lv[j] = 0x01010101u;
    }"""),
        ("""    move_values(values, res_v, res_set, tile_v, tile_s, first_row, nrows,
                nt, c0, c0 + CHUNK);""", ""),
        ("""        store_words(res_en, ovf, ew, ow, first_row, nrows, nt, f0);""",
         "")),
    "io": (("    if (live) {\n      const uint32_t start_bits",
            "    if (false) {\n      const uint32_t start_bits"),),
}


def part_sources(names):
    """Write the tree's source cut to each named part -> {name: path}."""
    text = (ROOT / SOURCE).read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in names:
        cut = text
        for old, new in PARTS[name]:
            if old not in cut:
                raise RuntimeError(f"part {name}: the source no longer "
                                   f"holds {old[:60]!r}")
            cut = cut.replace(old, new)
        path = OUT_DIR / f"jugglepac_fsm-{name}.cu"
        path.write_text(cut)
        out[name] = path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rev", required=True,
                    help="git revision of the source to compare against")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fetch-only", action="store_true",
                    help="keep the revision's source under build/fsm_ab/ "
                         "and stop")
    ap.add_argument("--parts", action="store_true",
                    help="also time the tree's kernel cut to its steps "
                         "and to its loads and stores")
    args = ap.parse_args(argv)
    old = fetch(args.rev)
    if args.fetch_only:
        print(old)
        return 0
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import jugglepac_fsm as fsm
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.device_line()
    print(smi, flush=True)
    sources = {"tree": ROOT / SOURCE, args.rev: old}
    parts = tuple(PARTS) if args.parts else ()
    sources.update(part_sources(parts))
    names = tuple(sources)
    libs = build(sources)
    b, t, lat, regs = cs.CIRCUIT_B, cs.CIRCUIT_T, cs.CIRCUIT_L, cs.CIRCUIT_R
    smem = fsm.smem_bytes(lat, regs)
    inputs = cs.circuit_real_streams(args.seed + 23, b, t, lat, "cuda")[:3]
    runs = {n: launcher(libs[n][0], inputs, lat, regs, smem) for n in names}
    first = runs[names[0]]()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append(cs.cuda_ms(runs[n], REPS))
    bound = 16 * b * t / cs.HBM_BYTES_PER_S * 1e3
    ok_all = True
    for n in names:
        lib, report, text = libs[n]
        for line in ptxas_lines(report):
            print(f"{n} ptxas: {line}", flush=True)
        blocks, how = blocks_per_sm(lib, report, text, lat, regs, smem)
        if n in parts:
            verdict = "a part: outputs not compared"
        else:
            outs = runs[n]()
            torch.cuda.synchronize()
            ok = cs.fsm_bitwise(outs, first)
            ok_all = ok_all and ok
            verdict = (f"outputs {'bitwise' if ok else 'DIFFER from'} "
                       f"{names[0]}'s")
            del outs
        ms = min(times[n])
        print(f"{n}: {blocks} blocks an SM ({how}); kernel "
              f"{times[n][0]:.3f} and {times[n][1]:.3f} ms "
              f"({b * t / ms * 1e3:.4g} circuit-cycles/s at the better), "
              f"{ms / bound:.2f} times the {bound:.3f} ms bound; {verdict} "
              f"| {smi}", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
