"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` compiles on first use into a shared library with
a plain C interface, under ``build/repro_torch/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  The flags pin the
numerics the kernels promise: ``--fmad=false`` (no multiply-add
contraction) and no fast-math, so subnormals are kept and every float
add rounds as IEEE says.

    from repro_torch.kernels import _build
    _build.build_all()              # one nvcc per source, all in parallel
    lib = _build.load("segsum")
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("segsum", "flash_decode", "intac_accum", "jugglepac_fsm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: shared memory one CUDA block may use on Hopper (227 KB); every kernel's
#: launch shape is sized to it
SMEM_BYTES = 232448

#: per source: build seconds (0.0 when the library was already built)
#: and the compiler's resource report (registers, shared memory, spills)
BUILD_LOG: Dict[str, dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}

_C = ctypes.c_int
_P = ctypes.c_void_p
_F = ctypes.c_float
_L = ctypes.c_longlong
#: per source: its entry points and their argument types
_SIGNATURES = {
    "segsum": {
        "segsum_policy_launch": [_C, _P, _P, _P, _P, _P, _P, _P, _L,
                                 _C, _C, _C, _C, _C, _C, _C, _C, _P],
        "block_ranges_launch": [_P, _P, _L, _C, _C, _C, _P],
        "segsum_wide_launch": [_C, _P, _P, _P, _P, _P, _P, _P, _L, _C, _C,
                               _C, _C, _C, _P],
    },
    "flash_decode": {
        "flash_decode_launch": [_C, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _C, _C, _C, _C, _C, _C, _C, _C, _C, _C,
                                _F, _P],
    },
    "intac_accum": {
        "intac_accum_launch": [_P, _F, _P, _L, _C, _C, _P],
    },
    "jugglepac_fsm": {
        "jugglepac_fsm_launch": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _C,
                                 _C, _L, _P],
        "jugglepac_fsm_blocks_per_sm": [_C, _C, _L, _P],
    },
}


def ptxas_kernels(report: str) -> list:
    """Each kernel entry in a ptxas ``-v`` report: {"name" (mangled),
    "registers", "stack", "spill_stores", "spill_loads", "smem" (static
    shared bytes)}, in the report's order."""
    out, props = [], {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, props = m.group(1), {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props = {"stack": int(m.group(1)),
                     "spill_stores": int(m.group(2)),
                     "spill_loads": int(m.group(3))}
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            out.append({"name": name, "registers": int(m.group(1)),
                        **props, "smem": int(sm.group(1)) if sm else 0})
            name = None
    return out


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "repro_torch: nvcc (the CUDA compiler) was not found on PATH "
            "or at /usr/local/cuda/bin/nvcc; the CUDA kernels are built "
            "from source on first use")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{key[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "report": ""})
        return
    proc, tmp, out, t0 = job
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"repro_torch: nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{report}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "report": report}


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Build every named source, one ``nvcc`` each, all started at once."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)
    return {n: BUILD_LOG[n] for n in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with
    its entry points' argument types set (pointers as ``c_void_p``)."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
