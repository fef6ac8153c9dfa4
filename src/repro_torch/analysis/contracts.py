"""Layer 2 of the port's detlint: the determinism contract, run.

The reference traces every policy × backend × op with ``jax.make_jaxpr``
and holds the traces to the contract; the port has no trace to read
before it runs, so it runs the registered matrix on the reference's
canonical inputs (N = 128 rows, D = 2 columns, S = 4 labels, block sizes
32 and 64, values from ``np.random.RandomState(0)``) and holds what comes
out to the same contract:

DET101  the carry each policy × backend returns has the declared
        ``carry_dtypes`` and ``carry_len`` (a policy that declares int32
        limbs but carries float32 has left the exact tier without a word).
DET102  a ``merge_is_add`` policy returns only integer carry leaves, from
        every backend that ran it: a float sum across ranks is
        order-sensitive.  The fast tier's documented tolerance is listed
        in ``rules.TOLERATED_FLOAT_MERGE`` and surfaces as a *waived*
        finding, counted by the ratchet like any pragma.
DET103  the reference's fold barrier, as the CUDA compiler spells it:
        ``kernels/_build.py::NVCC_FLAGS`` holds ``--fmad=false`` (no
        multiply-add contraction), every source under ``kernels/csrc/``
        is built through ``_build`` with those flags and no nvcc call in
        the package passes others, and no fast-math, flush-to-zero or
        approximate division or square root flag appears.  Static.
DET104  the all-integer tiers dispatch the same set of aten ops, and give
        the same output dtype and shape, through ``reduce(...,
        backend="blocked")`` at both block sizes: the counterpart of the
        reference's primitive vocabulary of a jaxpr.  A block-size-
        dependent op sneaking into an exact tier breaks bitwise-across-
        block-sizes.
DET105  coverage: every op × policy × backend that claims support runs
        through ``reduce`` at all, and each integer tier's result is
        bitwise ``blocked``'s.  A row that cannot run where it is asked to
        (``cuda`` on the CPU, ``shard_map`` without ``group=``) is a named
        "not run" entry, never dropped.

    from repro_torch.analysis import run_contracts
    run_contracts(device="cpu")                              # 120 rows
    run_contracts(device="cuda", backends=("ref", "blocked", "cuda"))

Under ``group=`` every rank of the process group calls ``run_contracts``
alike; each rank passes its own contiguous share of the rows to the
``shard_map`` rows and the whole stream to the single-device ones.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import walker
from .rules import Finding, TOLERATED_FLOAT_MERGE, is_integer_dtype

#: canonical inputs: small enough to run in milliseconds, big enough for
#: several blocks at both canonical block sizes
_S, _D, _N = 4, 2, 128
_BLOCK_SIZES = (32, 64)

#: backends that run only on one kind of device
_DEVICE_ONLY = {"cuda": "cuda"}

#: nvcc flags that give up IEEE rounding or keep no subnormals
FORBIDDEN_NVCC_FLAGS = ("--use_fast_math", "-use_fast_math", "-ftz=true",
                        "--ftz=true", "--prec-div=false", "-prec-div=false",
                        "--prec-sqrt=false", "-prec-sqrt=false",
                        "--fmad=true", "-fmad=true")


@dataclasses.dataclass
class _Ctx:
    """Registries, canonical inputs and where to run, built once a run."""

    torch: object
    policies: Dict
    backends: Dict
    ops: Dict
    device: object
    group: object
    rank: int
    world: int
    vals: np.ndarray
    ids: np.ndarray

    @classmethod
    def build(cls, device, group, backends: Optional[Sequence[str]]):
        import torch
        from .. import resolve_device
        from ..distributed import comm
        from ..reduce.algebra import REDUCE_OPS
        from ..reduce.backends import BACKENDS
        from ..reduce.policy import POLICIES
        dev = resolve_device(device)
        if backends is not None:
            unknown = sorted(set(backends) - set(BACKENDS))
            if unknown:
                raise ValueError(f"unknown backend(s) {unknown}; "
                                 f"registered: {sorted(BACKENDS)}")
        rng = np.random.RandomState(0)
        vals = rng.randn(_N, _D).astype(np.float32)
        ids = (np.arange(_N) % _S).astype(np.int32)
        rank = 0 if group is None else comm.axis_index(group)
        world = 1 if group is None else comm.axis_size(group)
        return cls(torch=torch, policies=dict(POLICIES),
                   backends={k: v for k, v in BACKENDS.items()
                             if backends is None or k in backends},
                   ops=dict(REDUCE_OPS), device=dev, group=group,
                   rank=rank, world=world, vals=vals, ids=ids)

    def not_run(self, backend) -> Optional[str]:
        """Why ``backend`` cannot run here, or None."""
        need = _DEVICE_ONLY.get(backend.name)
        if need is not None and self.device.type != need:
            return f"runs on {need} tensors only; device is {self.device}"
        if getattr(backend, "distributed", False) and self.group is None:
            return "runs across a process group; no group= given"
        return None

    def rows(self, a: np.ndarray, backend) -> object:
        """``a`` on the device: this rank's contiguous share under a
        distributed backend, the whole stream otherwise."""
        if getattr(backend, "distributed", False):
            per = -(-_N // self.world)
            a = a[self.rank * per:(self.rank + 1) * per]
        return self.torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)

    def run_carry(self, policy, backend, *, block_size: int):
        """``policy.prepare`` then ``backend.run``: the raw carry."""
        v = self.rows(self.vals, backend)
        domain, _ = policy.prepare(v, _N)
        kw = {"group": self.group} if backend.distributed else {}
        return backend.run(domain, self.rows(self.ids, backend), _S,
                           policy=policy, block_size=block_size, **kw)

    def run_reduce(self, pname: str, bname: str, oname: str, *,
                   block_size: int):
        from ..reduce import api
        backend = self.backends[bname]
        op = self.ops[oname]
        kw = {}
        if getattr(op, "takes_weights", False):
            kw["weights"] = self.rows(np.ones((_N,), np.float32), backend)
        if getattr(op, "requires_coeffs", False):
            kw["coeffs"] = (0.0, 1.0)
        if backend.distributed:
            kw["group"] = self.group
        return api.reduce(self.rows(self.vals, backend),
                          segment_ids=self.rows(self.ids, backend),
                          num_segments=_S, op=oname, policy=pname,
                          backend=bname, block_size=block_size,
                          device=self.device, **kw)


def _not_run(rule: str, path: str, why: str) -> Finding:
    return Finding(rule=rule, path=path, line=0, message=why, not_run=True)


def _carry_dtype_findings(ctx: _Ctx) -> List[Finding]:
    """DET101 per policy × backend; DET102 once per policy, naming every
    backend whose carry held a float leaf."""
    out = []
    for pname, policy in sorted(ctx.policies.items()):
        declared = tuple(policy.carry_dtypes)
        float_in = []
        for bname, backend in sorted(ctx.backends.items()):
            if not backend.supports(policy):
                continue
            why = ctx.not_run(backend)
            if why:
                out.append(_not_run("DET101", f"{pname}/{bname}", why))
                continue
            try:
                carry = tuple(ctx.run_carry(policy, backend,
                                            block_size=_BLOCK_SIZES[0]))
            except Exception as e:
                out.append(Finding(
                    rule="DET101", path=f"{pname}/{bname}", line=0,
                    message=f"carry run failed: {type(e).__name__}: {e}"))
                continue
            got = tuple(c.dtype for c in carry)
            if len(got) != policy.carry_len or got != declared:
                out.append(Finding(
                    rule="DET101", path=f"{pname}/{bname}", line=0,
                    message=f"carry {[str(d) for d in got]} != declared "
                            f"carry_dtypes {[str(d) for d in declared]} "
                            f"(carry_len={policy.carry_len})"))
            if any(not is_integer_dtype(d) for d in got):
                float_in.append(bname)
        if float_in and getattr(policy, "merge_is_add", False):
            tol = TOLERATED_FLOAT_MERGE.get(pname)
            out.append(Finding(
                rule="DET102", path=pname, line=0,
                message=f"merge_is_add policy returns float carry leaves "
                        f"from {float_in} — a float sum across ranks is "
                        f"order-sensitive",
                waived=tol is not None, reason=tol or ""))
    return out


def _nvcc_calls(mod: walker.SourceModule):
    """Calls whose arguments hold a list that starts with ``find_nvcc()``
    (every nvcc command line in the port's Python), with that list."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.List) and node.elts and isinstance(
                node.elts[0], ast.Call) and (walker.dotted_name(
                    node.elts[0].func) or "").endswith("find_nvcc"):
            yield node


def _flag_findings(ctx: _Ctx) -> List[Finding]:
    """DET103: the compiler is told to keep every float op as written."""
    from ..kernels import _build
    out = []
    rel = "src/repro_torch/kernels/_build.py"
    flags = tuple(_build.NVCC_FLAGS)
    if "--fmad=false" not in flags:
        out.append(Finding(
            rule="DET103", path=rel, line=0,
            message=f"NVCC_FLAGS {flags} lack --fmad=false — nvcc "
                    f"contracts a*b+c into one fused multiply-add, which "
                    f"rounds once where the plain version rounds twice"))
    bad = [f for f in flags if f in FORBIDDEN_NVCC_FLAGS]
    if bad:
        out.append(Finding(
            rule="DET103", path=rel, line=0,
            message=f"NVCC_FLAGS hold {bad} — approximate or flushing "
                    f"float math"))
    kdir = Path(_build.__file__).resolve().parent
    built = set(_build.SOURCES)
    for src in sorted(_build.CSRC.glob("*.cu")):
        if src.stem not in built:
            out.append(Finding(
                rule="DET103", path=f"src/repro_torch/kernels/csrc/"
                                    f"{src.name}", line=0,
                message="a CUDA source that _build.SOURCES does not "
                        "list: nothing holds its flags"))
    for path in sorted(p for p in kdir.rglob("*")
                       if p.suffix in (".py", ".cu", ".cuh", ".h")):
        for i, line in enumerate(path.read_text().splitlines(), start=1):
            hit = [f for f in FORBIDDEN_NVCC_FLAGS if f in line]
            if hit:
                out.append(Finding(
                    rule="DET103", path=_rel(path), line=i,
                    message=f"{hit} — approximate or flushing float "
                            f"math"))
    # the package and the checkout's tools: every nvcc command line
    roots = [d for d in (kdir.parent, walker.repo_root() / "tools")
             if d.is_dir()]
    for path in walker.iter_source_files(roots):
        mod = walker.parse_module(path)
        for node in _nvcc_calls(mod):
            if not any(isinstance(e, ast.Starred) and (walker.dotted_name(
                    e.value) or "").endswith("NVCC_FLAGS")
                    for e in node.elts):
                out.append(Finding(
                    rule="DET103", path=mod.rel, line=node.lineno,
                    message="an nvcc command line without *NVCC_FLAGS — "
                            "a kernel built with other flags than the "
                            "ones its plain version is held to"))
    return out


def _rel(path: Path) -> str:
    try:
        return str(path.resolve().relative_to(walker.repo_root()))
    except ValueError:
        return str(path)


def dispatched_ops(fn) -> Tuple[frozenset, object]:
    """(the aten ops ``fn()`` dispatches, its result): the port's
    counterpart of a jaxpr's primitive vocabulary."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with _Record() as rec:
        result = fn()
    return frozenset(rec.names), result


def _invariance_findings(ctx: _Ctx) -> List[Finding]:
    """DET104: the all-integer tiers dispatch the same ops and give the
    same output dtype and shape at both block sizes."""
    out = []
    if "blocked" not in ctx.backends:
        return out
    for pname, policy in sorted(ctx.policies.items()):
        if not all(is_integer_dtype(d) for d in policy.carry_dtypes):
            continue       # only the claimed-invariant (integer) tiers
        runs = {}
        for bs in _BLOCK_SIZES:
            try:
                runs[bs] = dispatched_ops(lambda bs=bs: ctx.run_reduce(
                    pname, "blocked", "sum", block_size=bs))
            except Exception as e:
                out.append(Finding(
                    rule="DET104", path=f"{pname}/blocked", line=0,
                    message=f"invariance run (block_size={bs}) failed: "
                            f"{type(e).__name__}: {e}"))
        if len(runs) != len(_BLOCK_SIZES):
            continue
        (pa, ra), (pb, rb) = (runs[bs] for bs in _BLOCK_SIZES)
        if pa != pb:
            out.append(Finding(
                rule="DET104", path=f"{pname}/blocked", line=0,
                message=f"dispatched aten ops differ across block sizes "
                        f"{_BLOCK_SIZES}: {sorted(pa ^ pb)} not in both"))
        if ra.dtype != rb.dtype or tuple(ra.shape) != tuple(rb.shape):
            out.append(Finding(
                rule="DET104", path=f"{pname}/blocked", line=0,
                message=f"output differs across block sizes "
                        f"{_BLOCK_SIZES}: {ra.dtype}{tuple(ra.shape)} vs "
                        f"{rb.dtype}{tuple(rb.shape)}"))
    return out


def _bits(t) -> bytes:
    t = t.detach().contiguous().cpu()
    return t.numpy().tobytes() + str((t.dtype, tuple(t.shape))).encode()


def _coverage_findings(ctx: _Ctx) -> List[Finding]:
    """DET105: the whole registered matrix runs; the integer tiers agree
    bitwise with ``blocked`` on every backend that ran."""
    out = []
    combos = 0
    for oname in sorted(ctx.ops):
        for pname, policy in sorted(ctx.policies.items()):
            integer = all(is_integer_dtype(d) for d in policy.carry_dtypes)
            results = {}
            for bname, backend in sorted(ctx.backends.items()):
                if not backend.supports(policy):
                    continue
                combos += 1
                path = f"{pname}/{bname}/{oname}"
                why = ctx.not_run(backend)
                if why:
                    out.append(_not_run("DET105", path, why))
                    continue
                try:
                    results[bname] = ctx.run_reduce(
                        pname, bname, oname, block_size=_BLOCK_SIZES[0])
                except Exception as e:
                    out.append(Finding(
                        rule="DET105", path=path, line=0,
                        message=f"front-door run failed: "
                                f"{type(e).__name__}: {e}"))
            if not integer or "blocked" not in results:
                continue
            want = _bits(results["blocked"])
            for bname, r in sorted(results.items()):
                if _bits(r) != want:
                    out.append(Finding(
                        rule="DET105", path=f"{pname}/{bname}/{oname}",
                        line=0,
                        message="integer tier's result is not bitwise "
                                "blocked's on the same inputs"))
    if combos == 0:
        out.append(Finding(rule="DET105", path="<matrix>", line=0,
                           message="registry matrix is empty — nothing "
                                   "was checked"))
    return out


def matrix_size(backends: Optional[Sequence[str]] = None) -> int:
    """op × policy × backend combinations that claim support."""
    from ..reduce.algebra import REDUCE_OPS
    from ..reduce.backends import BACKENDS
    from ..reduce.policy import POLICIES
    return len(REDUCE_OPS) * sum(
        1 for p in POLICIES.values() for n, b in BACKENDS.items()
        if (backends is None or n in backends) and b.supports(p))


def run_contracts(*, checks: Optional[Sequence[str]] = None,
                  device="cpu", group=None,
                  backends: Optional[Sequence[str]] = None
                  ) -> List[Finding]:
    """Run the contract checks; returns findings (waived ones only where
    the tolerance table vouches for them, ``not_run`` ones for rows that
    cannot run on ``device`` or without ``group``).

    ``checks`` filters to a subset of {"carry", "flags", "invariance",
    "coverage"}; ``backends`` to a subset of the registered backends.
    """
    try:
        ctx = _Ctx.build(device, group, backends)
    except Exception as e:    # loud, unwaivable: checker can't even load
        return [Finding(rule="DET105", path="<registry>", line=0,
                        message=f"contract checker failed to load the "
                                f"registries: {type(e).__name__}: {e}")]
    steps = {
        "carry": _carry_dtype_findings,
        "flags": _flag_findings,
        "invariance": _invariance_findings,
        "coverage": _coverage_findings,
    }
    findings: List[Finding] = []
    for name, fn in steps.items():
        if checks and name not in checks:
            continue
        findings.extend(fn(ctx))
    findings.sort(key=lambda f: (f.rule, f.path))
    return findings
