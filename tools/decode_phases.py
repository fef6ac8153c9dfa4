#!/usr/bin/env python3
"""Where K2 and K4 spend their time, phase by phase, on the GPU.

    python3 tools/decode_phases.py                  # needs a CUDA device
    python3 tools/decode_phases.py --old OLD.cu     # also an older design

Builds a copy of ``src/repro_torch/kernels/csrc/flash_decode.cu`` with a
``clock64()`` mark after each phase, into ``build/decode_phases/``, and
launches K2 and K4 at ``chip_smoke.py``'s full width (B=16 requests x
32,768 f32 KV rows, H=48, K=8, d=128, seed 0; K2 at block_kv=512, window
None and 4,096; K4 from a shuffled pool of 256-row pages).  Thread 0 of
every split-pass CUDA block adds its cycles to one counter per phase:
the wait for a staged tile (``cp.async`` wait and the barrier), issuing
the next tile's copies, the score trees, the softmax (with its two
barriers), the ``p @ v`` trees; the merge kernel's CUDA blocks add their
whole time.  The script prints each phase's cycles per tile and per live
CUDA block, the live CUDA blocks, and the marked kernel's time.  The
marks serialize nothing but add instructions: the kernels' own times are
``chip_smoke.py``'s.

``--old`` takes an older source of the kernels, the design with one CUDA
block per (kv head, request) and synchronous K-then-V staging (``git
show 05ba84d:src/repro_torch/kernels/csrc/flash_decode.cu``), and
measures its phases the same way: K staging, score trees, softmax, V staging, ``p @ v``
trees, each with its barrier.

With ``--variants`` it also builds the split pass with other ring depths
and register caps (``VARIANTS``) and times each, bitwise against the
plain versions.  Last, with the unmarked kernels, it sweeps ``SPLIT_ROWS`` over 1,024,
2,048, 4,096 and 8,192 (K2 window None and 4,096, K4), each value's
output checked bitwise against its own plain version, and prints the
compiler's registers, stack frame and spills of every decode kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = {0: "tile wait (cp.async, barrier)", 1: "issue next tile",
          2: "score trees", 3: "softmax (2 barriers)", 4: "p @ v trees"}
MERGE, LIVE_BLOCKS, TILES, MERGE_BLOCKS, BLOCK_TOTAL = 5, 6, 7, 8, 9
OLD_PHASES = {0: "K staging + barrier", 1: "score trees + barrier",
              2: "softmax + barrier", 3: "V staging + barrier",
              4: "p @ v trees + barrier"}
OLD_STEPS = 7

HEADER = ("namespace {\n", """namespace {
__device__ unsigned long long g_phase[16];
#define MARK(k) do { const unsigned long long t_ = clock64(); \\
  if (threadIdx.x == 0) atomicAdd(&g_phase[k], t_ - t_prev); \\
  t_prev = t_; } while (0)
""")
MARKS = [
    HEADER,
    ("""  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
""", """  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const unsigned long long t_block = clock64();
  unsigned long long t_prev = t_block;
"""),
    ("""  int u = 0;
""", """  int u = 0;
  if (tid == 0) atomicAdd(&g_phase[6], 1ull);
"""),
    ("""    for (int t = 0; t < nt; ++t, ++u) {         // K tiles: scores
      cp_wait();
      __syncthreads();
      issue(u + STAGES - 1);
""", """    for (int t = 0; t < nt; ++t, ++u) {         // K tiles: scores
      t_prev = clock64();
      if (tid == 0) atomicAdd(&g_phase[7], 1ull);
      cp_wait();
      __syncthreads();
      MARK(0);
      issue(u + STAGES - 1);
      MARK(1);
"""),
    ("""                          lds);
    }
    __syncthreads();
    block_softmax<GC, NT>(bkv, ss, lds, mrow, lrow, alpha);
    __syncthreads();
""", """                          lds);
      MARK(2);
    }
    __syncthreads();
    block_softmax<GC, NT>(bkv, ss, lds, mrow, lrow, alpha);
    __syncthreads();
    MARK(3);
"""),
    ("""    for (int t = 0; t < nt; ++t, ++u) {         // V tiles: p @ v
      cp_wait();
      __syncthreads();
      issue(u + STAGES - 1);
""", """    for (int t = 0; t < nt; ++t, ++u) {         // V tiles: p @ v
      t_prev = clock64();
      if (tid == 0) atomicAdd(&g_phase[7], 1ull);
      cp_wait();
      __syncthreads();
      MARK(0);
      issue(u + STAGES - 1);
      MARK(1);
"""),
    ("""          acc[g] = acc[g] * alpha[g] + v;
        }
      }
    }
  }
""", """          acc[g] = acc[g] * alpha[g] + v;
        }
      }
      MARK(4);
    }
  }
  if (tid == 0) atomicAdd(&g_phase[9], clock64() - t_block);
"""),
    ("""  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
""", """  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const unsigned long long t_m = clock64();
"""),
    ("""  if (c < a.d)
    a.out[""", """  if (threadIdx.x == 0) {
    atomicAdd(&g_phase[5], clock64() - t_m);
    atomicAdd(&g_phase[8], 1ull);
  }
  if (c < a.d)
    a.out["""),
]
OLD_MARKS = [
    HEADER,
    ("""  const long long pos0 = static_cast<long long>(blk) * bkv;
""", """  const long long pos0 = static_cast<long long>(blk) * bkv;
  unsigned long long t_prev = clock64();
  if (threadIdx.x == 0) atomicAdd(&g_phase[7], 1ull);
"""),
    ("""    stage<PAGED>(a, a.k, b, kh, pos0 + r0, rows, tile);
    __syncthreads();
""", """    stage<PAGED>(a, a.k, b, kh, pos0 + r0, rows, tile);
    __syncthreads();
    MARK(0);
"""),
    ("""      ss[g * bkv + r0 + r] = tree_close(t) * a.sm_scale + bj;
    }
    __syncthreads();
""", """      ss[g * bkv + r0 + r] = tree_close(t) * a.sm_scale + bj;
    }
    __syncthreads();
    MARK(1);
"""),
    ("""      alpha[g] = al;
    }
  }
  __syncthreads();
""", """      alpha[g] = al;
    }
  }
  __syncthreads();
  MARK(2);
"""),
    ("""    stage<PAGED>(a, a.v, b, kh, pos0 + r0, rows, tile);
    __syncthreads();
""", """    stage<PAGED>(a, a.v, b, kh, pos0 + r0, rows, tile);
    __syncthreads();
    MARK(3);
"""),
    ("""      for (; r < rows; ++r) tree_push(tr[i], pp[r] * vv[r * ld], 0);
    }
    __syncthreads();
""", """      for (; r < rows; ++r) tree_push(tr[i], pp[r] * vv[r * ld], 0);
    }
    __syncthreads();
    MARK(4);
"""),
]
#: other builds of the split pass, each a list of source edits
VARIANTS = {
    "as committed": [],
    "STAGES=3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "no register cap": [("__launch_bounds__(NT, 512 / NT)",
                         "__launch_bounds__(NT)")],
    "STAGES=3, at least 3 CUDA blocks an SM": [
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
        ("__launch_bounds__(NT, 512 / NT)", "__launch_bounds__(NT, 3)")],
}
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


def marked(src: str, marks) -> str:
    for old, new in marks:
        if src.count(old) != 1:
            raise RuntimeError(f"flash_decode.cu changed; no single {old!r}")
        src = src.replace(old, new)
    return src + READERS


def ptxas_lines(report: str):
    """(kernel, 'N registers, M bytes stack frame, ...') per entry."""
    out = []
    for part in re.split(r"Compiling entry function", report):
        name = re.search(r"'(_Z\w+)'", part)
        if not name:
            continue
        info = "; ".join(l.split(":", 1)[-1].strip()
                         for l in part.splitlines()
                         if "stack frame" in l or "registers" in l)
        out.append((name.group(1), info))
    return out


def build(name: str, src: str):
    from repro_torch.kernels import _build
    out = ROOT / "build" / "decode_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    lib_path = out / f"lib{name}.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(out / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    for kern, info in ptxas_lines(r.stdout + r.stderr):
        print(f"ptxas {name} {kern}: {info}", flush=True)
    return ctypes.CDLL(str(lib_path))


def read_phases(lib):
    buf = (ctypes.c_ulonglong * 16)()
    if lib.phases_read(buf) != 0:
        raise RuntimeError("cannot read the phase counters")
    return list(buf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="an older flash_decode.cu (one CUDA block per "
                         "(kv head, request), synchronous staging)")
    ap.add_argument("--variants", action="store_true",
                    help="also time the split pass built with other ring "
                         "depths and register caps (VARIANTS)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import _build, ops
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    smi = C.device_line()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    b, h, kh, s_len, d = C.BATCH, C.HEADS, C.KV_HEADS, C.KV_ROWS, C.HEAD_DIM
    sc, ps, nb = d ** -0.5, 256, C.KV_ROWS // 256
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kv_len = torch.randint(1, s_len + 1, (b,), generator=gen, device=dev)
    kv_len[3] = 0
    kp, vp, tables, k, v = C.shuffled_pool(kv_len, ps, nb, kh, d, gen, dev)
    biases = {w: ops.length_bias(kv_len, s_len, w, dev)
              for w in (None, C.WINDOW)}
    runs = {
        "K2 window=None": lambda: fd.flash_decode_cuda(
            q, k, v, biases[None], sm_scale=sc, block_kv=512),
        f"K2 window={C.WINDOW}": lambda: fd.flash_decode_cuda(
            q, k, v, biases[C.WINDOW], sm_scale=sc, block_kv=512),
        "K4 ps=256": lambda: fd.flash_decode_paged_cuda(
            q, kp, vp, biases[None], tables, sm_scale=sc),
    }

    if args.old is not None:          # the older design, K2 window None
        old = build("flash_decode_old",
                    marked(args.old.read_text(), OLD_MARKS))
        fn = old.flash_decode_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                ctypes.c_void_p])
        fn.restype = ctypes.c_int
        o = torch.empty_like(q)
        g = h // kh

        def run_old():
            rc = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    biases[None].data_ptr(), None, o.data_ptr(), None, None,
                    b, h, kh, d, s_len, 512, s_len // 512, s_len // 512, 0,
                    64, 1, sc, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"old launch failed: CUDA error {rc}")
        run_old()
        torch.cuda.synchronize()
        old.phases_reset()
        ms = C.cuda_ms(run_old, 1, warmup=0)
        ph = read_phases(old)
        steps = max(ph[OLD_STEPS], 1)
        print(f"old design K2 window=None (G={g}, 128 CUDA blocks): marked "
              f"kernel {ms:.3f} ms, {ph[OLD_STEPS]} schedule-block steps "
              f"of thread 0 | {smi}", flush=True)
        for i, name in OLD_PHASES.items():
            print(f"  {name:28s} {ph[i] / steps:12.0f} cycles per step; "
                  f"{ph[i] / (b * kh):14.0f} per CUDA block", flush=True)
        del o

    lib = build("flash_decode_phases",
                marked((_build.CSRC / "flash_decode.cu").read_text(), MARKS))
    fn = lib.flash_decode_launch
    fn.argtypes = _build._SIGNATURES["flash_decode"]["flash_decode_launch"]
    fn.restype = ctypes.c_int
    plain_lib = _build.load("flash_decode")
    _build._LIBS["flash_decode"] = lib           # the wrappers launch it
    try:
        for label, run in runs.items():
            run()
            torch.cuda.synchronize()
            lib.phases_reset()
            ms = C.cuda_ms(run, 1, warmup=0)
            ph = read_phases(lib)
            tiles, live = max(ph[TILES], 1), max(ph[LIVE_BLOCKS], 1)
            print(f"{label}: marked kernels {ms:.3f} ms, {ph[LIVE_BLOCKS]} "
                  f"live split-pass CUDA blocks, {ph[TILES]} tiles of "
                  f"{fd.TILE_ROWS} rows, {ph[MERGE_BLOCKS]} merge CUDA "
                  f"blocks | {smi}", flush=True)
            for i, name in PHASES.items():
                print(f"  {name:28s} {ph[i] / tiles:10.0f} cycles per tile;"
                      f" {ph[i] / live:12.0f} per live CUDA block",
                      flush=True)
            print(f"  {'whole split-pass block':28s} "
                  f"{ph[BLOCK_TOTAL] / live:10.0f} cycles per live CUDA "
                  f"block", flush=True)
            print(f"  {'merge':28s} {ph[MERGE] / max(ph[MERGE_BLOCKS], 1):10.0f}"
                  f" cycles per merge CUDA block", flush=True)
    finally:
        _build._LIBS["flash_decode"] = plain_lib

    if args.variants:                 # other builds of the same source
        src = (_build.CSRC / "flash_decode.cu").read_text()
        plain = {w: fd.flash_decode_torch(q, k, v, biases[w], sm_scale=sc,
                                          block_kv=512)
                 for w in (None, C.WINDOW)}
        plain_paged = fd.flash_decode_paged_torch(q, kp, vp, biases[None],
                                                  tables, sm_scale=sc)
        for idx, (name, edits) in enumerate(VARIANTS.items()):
            vsrc = src
            for old, new in edits:
                if vsrc.count(old) != 1:
                    raise RuntimeError(f"variant {name}: no single {old!r}")
                vsrc = vsrc.replace(old, new)
            lib = build(f"flash_decode_variant{idx}", vsrc)
            fn = lib.flash_decode_launch
            fn.argtypes = \
                _build._SIGNATURES["flash_decode"]["flash_decode_launch"]
            fn.restype = ctypes.c_int
            _build._LIBS["flash_decode"] = lib
            try:
                ok = (torch.equal(runs["K2 window=None"](), plain[None])
                      and torch.equal(runs[f"K2 window={C.WINDOW}"](),
                                      plain[C.WINDOW])
                      and torch.equal(runs["K4 ps=256"](), plain_paged))
                times = ", ".join(f"{label} {C.cuda_ms(run, C.REPS):.3f} ms"
                                  for label, run in runs.items())
            finally:
                _build._LIBS["flash_decode"] = plain_lib
            print(f"variant {name}: {'bitwise' if ok else 'DIFFER'}; "
                  f"{times} | {smi}", flush=True)
        del plain, plain_paged

    # the SPLIT_ROWS sweep, unmarked, each value bitwise its plain version
    for rows in (1024, 2048, 4096, 8192):
        times = []
        for label, kern, plain in (
                ("K2 window=None",
                 lambda: fd.flash_decode_cuda(q, k, v, biases[None],
                                              sm_scale=sc, block_kv=512,
                                              split_rows=rows),
                 lambda: fd.flash_decode_torch(q, k, v, biases[None],
                                               sm_scale=sc, block_kv=512,
                                               split_rows=rows)),
                (f"K2 window={C.WINDOW}",
                 lambda: fd.flash_decode_cuda(q, k, v, biases[C.WINDOW],
                                              sm_scale=sc, block_kv=512,
                                              split_rows=rows),
                 lambda: fd.flash_decode_torch(q, k, v, biases[C.WINDOW],
                                               sm_scale=sc, block_kv=512,
                                               split_rows=rows)),
                ("K4",
                 lambda: fd.flash_decode_paged_cuda(q, kp, vp, biases[None],
                                                    tables, sm_scale=sc,
                                                    split_rows=rows),
                 lambda: fd.flash_decode_paged_torch(q, kp, vp, biases[None],
                                                     tables, sm_scale=sc,
                                                     split_rows=rows))):
            ok = torch.equal(kern(), plain())
            if not ok:
                print(f"sweep SPLIT_ROWS={rows} {label}: kernel DIFFERS from "
                      "its plain version", flush=True)
                return 1
            times.append(f"{label} {C.cuda_ms(kern, C.REPS):.3f} ms")
        print(f"sweep SPLIT_ROWS={rows} (bitwise each): " + ", ".join(times)
              + f" | {smi}", flush=True)
    for kern, info in ptxas_lines(_build.BUILD_LOG.get(
            "flash_decode", {}).get("report", "")):
        print(f"ptxas flash_decode {kern}: {info}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
