"""Determinism-contract AST lint rules (layer 1 of the port's detlint).

The reference's rule IDs, each rewritten for the hazard as it exists in
PyTorch and CUDA, where the reference's was a hazard of JAX and XLA:

DET001  a raw ``torch.sum/mean/cumsum/nansum/nanmean``, a
        ``.sum()/.mean()/.cumsum()`` method, ``torch.distributed.
        all_reduce`` or the port's ``comm.psum`` in model, optimizer,
        train, serve, distributed, launch or data code instead of the
        ``repro_torch.reduce`` front door, where the policies, the degrade
        handling and the cross-rank merge live.  Host roots (``np``,
        ``numpy``, ``math``) are exempt.
DET002  a float fold whose order the toolchain picks, inside the fold
        paths (``reduce/``, ``core/``, ``kernels/``'s plain versions):
        ``torch.sum``, ``.sum()``, ``torch.matmul``/``@``/``einsum``/
        ``bmm``/``mm``, ``cumsum``, anything under ``torch.compile`` or
        ``torch.jit`` (Inductor and the fusers reassociate), and switching
        TF32 on (``allow_tf32``, ``set_float32_matmul_precision``).  The
        fold paths pin their order with elementwise IEEE adds; an integer
        sum is order-free and is waived with "int32 domain" as its reason.
DET003  an accumulating scatter: ``index_add_``, ``scatter_add_``,
        ``scatter_reduce_``, ``index_reduce_`` (and their out-of-place
        forms), ``index_put_``/``put_`` with ``accumulate=True``.  On CUDA
        these add with atomics, in no fixed order.
DET004  a draw from torch's global generator in ``serve/``:
        ``torch.rand/randn/randint/randperm/multinomial/bernoulli/normal``
        (and the in-place ``uniform_``/``normal_``/...) with no
        ``generator=``, or reseeding the global generator
        (``torch.manual_seed``).  Global draws depend on how many draws
        came before, i.e. on request arrival order; the serving contract
        is one ``torch.Generator`` per token, seeded from (seed, request,
        step).
DET005  registered policies, backends and ``ReduceOp``s missing or
        mis-signaturing a hook, checked against the live registries.
DET006  counting or indexing in float: float32 holds integers exactly
        only up to 2^24, so a float ones or full vector fed to a sum or a
        count, an ``all_reduce``/``psum`` of a float constant, or an
        ``arange`` index grid in a float dtype saturates silently.

Waive a finding with ``# detlint: ok[DET00x] reason`` on (or above) the
offending line; ``tools/detlint_torch.py --check-waivers`` ratchets the
per-rule waiver counts downward via ``tools/detlint_torch_baseline.json``.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
from typing import Iterable, List, Optional, Sequence, Set

from . import walker
from .walker import SourceModule, dotted_name

#: ``merge_is_add`` policies whose carry deliberately keeps float
#: leaves.  Entries here still count as waived findings in the ratchet
#: (rules DET005 here, DET102 in contracts) — the table is the pragma.
TOLERATED_FLOAT_MERGE = {
    "fast": ("documented-tolerance tier: psum of float partials is the "
             "policy's contract (docs/policies.md), not a determinism "
             "claim"),
}


@dataclasses.dataclass
class Finding:
    """One lint finding (waived or not).  ``not_run`` marks a contract
    row that could not run where it was asked to (a ``cuda`` row on the
    CPU, a ``shard_map`` row with no process group): it is reported,
    never dropped, and it is neither a fault nor a waiver."""

    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    reason: str = ""
    not_run: bool = False

    def __str__(self) -> str:
        tag = (" [not run]" if self.not_run
               else " [waived]" if self.waived else "")
        return f"{self.path}:{self.line}: {self.rule}{tag} {self.message}"


def _in_dirs(mod: SourceModule, names: Set[str]) -> bool:
    return bool(set(mod.path.parts) & names)


class LintRule:
    """Base class: subclasses set ``rule``/``title`` and implement
    ``check(mod) -> iterable of (node, message)``."""

    rule = "DET000"
    title = ""

    def applies(self, mod: SourceModule) -> bool:
        return True

    def check(self, mod: SourceModule) -> Iterable:
        raise NotImplementedError

    def run(self, mod: SourceModule) -> List[Finding]:
        if not self.applies(mod):
            return []
        out = []
        for node, message in self.check(mod):
            w = mod.waiver_for(self.rule, node)
            out.append(Finding(rule=self.rule, path=mod.rel,
                               line=getattr(node, "lineno", 0),
                               message=message, waived=w is not None,
                               reason=w.reason if w else ""))
        return out


def _calls(mod: SourceModule):
    """(node, dotted callee or None, tail name) of every call."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            tail = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else name or "")
            yield node, name, tail


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


#: roots whose ``.sum()``-style methods run on the host: deterministic
#: already, not the rules' business
_HOST_ROOTS = {"np", "numpy", "math"}


def _method_on_tensor(name: Optional[str], func: ast.AST,
                      methods: Set[str], *, skip_roots=()) -> bool:
    """``x.sum()`` and the like, on a root that is not the host's (nor
    one of ``skip_roots``, whose functions another branch matches)."""
    if not (isinstance(func, ast.Attribute) and func.attr in methods):
        return False
    root = None if name is None else name.split(".")[0]
    return root not in _HOST_ROOTS and root not in skip_roots


# ---------------------------------------------------------------------------
# DET001 — raw reductions outside the front door
# ---------------------------------------------------------------------------

#: layers that must route reductions through ``repro_torch.reduce`` — the
#: front-door implementation itself (reduce/, kernels/, core/) is where
#: the raw primitives legitimately live.
_FRONT_DOOR_DIRS = {"models", "optim", "train", "serve", "distributed",
                    "launch", "data"}

_RAW_REDUCERS = {
    "torch.sum", "torch.mean", "torch.cumsum", "torch.nansum",
    "torch.nanmean",
    "torch.distributed.all_reduce", "dist.all_reduce",
    "comm.psum",
}

_REDUCE_METHODS = {"sum", "mean", "cumsum"}


class RawReduction(LintRule):
    rule = "DET001"
    title = "raw reduction outside the repro_torch.reduce front door"

    def applies(self, mod: SourceModule) -> bool:
        return _in_dirs(mod, _FRONT_DOOR_DIRS)

    def check(self, mod: SourceModule):
        for node, name, _ in _calls(mod):
            if name in _RAW_REDUCERS:
                yield node, (f"raw `{name}` — route through the "
                             f"repro_torch.reduce front door (policy + "
                             f"degrade + cross-rank merge contract), or "
                             f"waive with the reason it must stay raw")
            elif _method_on_tensor(name, node.func, _REDUCE_METHODS,
                                   skip_roots=("torch",)):
                yield node, (f"method reduction `.{node.func.attr}()` — "
                             f"same contract as DET001 torch."
                             f"{node.func.attr}")


# ---------------------------------------------------------------------------
# DET002 — float folds in an order the toolchain picks
# ---------------------------------------------------------------------------

#: the layers whose folds pin their order: the front door's executors and
#: policies, the numerics under them, and the kernels' plain versions
_FOLD_DIRS = {"reduce", "core", "kernels"}

#: torch functions (and tensor methods) whose add order is the library's
_ORDERLESS_FOLDS = {"sum", "nansum", "mean", "nanmean", "cumsum", "matmul",
                    "mm", "bmm", "einsum", "tensordot", "dot", "mv",
                    "addmm", "baddbmm", "inner"}
_ORDERLESS_METHODS = {"sum", "nansum", "mean", "nanmean", "cumsum",
                      "matmul", "mm", "bmm", "dot", "mv"}
_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.jit.trace_module"}


def _tf32_on(node: ast.AST) -> bool:
    """``torch.set_float32_matmul_precision(p)`` with p not "highest"."""
    arg = node.args[0] if node.args else _kwarg(node, "precision")
    return not (isinstance(arg, ast.Constant) and arg.value == "highest")


class OrderlessFloatFold(LintRule):
    rule = "DET002"
    title = "fold in an order the toolchain picks, inside a fold path"

    def applies(self, mod: SourceModule) -> bool:
        return _in_dirs(mod, _FOLD_DIRS)

    def check(self, mod: SourceModule):
        for node, name, tail in _calls(mod):
            root = None if name is None else name.split(".")[0]
            if name in _COMPILERS or (name or "").startswith("torch.jit."):
                yield node, (f"`{name}` — the compiler fuses and may "
                             f"reassociate float adds; the fold paths run "
                             f"eagerly, in the order they spell out")
            elif root == "torch" and tail == "set_float32_matmul_precision" \
                    and _tf32_on(node):
                yield node, ("TF32 switched on — float32 products round "
                             "their inputs to 10 mantissa bits")
            elif (root == "torch" and tail in _ORDERLESS_FOLDS
                  and name.count(".") == 1) or _method_on_tensor(
                    name, node.func, _ORDERLESS_METHODS,
                    skip_roots=("torch",)):
                yield node, (f"`{name or '.' + tail}` — the library picks "
                             f"the add order (and on CUDA may split it "
                             f"differently per shape); fold paths add in "
                             f"a pinned order with elementwise IEEE adds, "
                             f"or waive an integer sum with \"int32 "
                             f"domain\"")
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                yield node, ("`@` — a matmul's add order is the "
                             "library's; fold paths add in a pinned order")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dotted_name(dec.func if isinstance(dec, ast.Call)
                                    else dec) or ""
                    if d in _COMPILERS or d.startswith("torch.jit."):
                        yield dec, (f"`@{d}` — the compiler fuses and may "
                                    f"reassociate float adds")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if (dotted_name(t) or "").endswith("allow_tf32") and \
                            not (isinstance(node.value, ast.Constant)
                                 and node.value.value is False):
                        yield node, ("TF32 switched on — float32 products "
                                     "round their inputs to 10 mantissa "
                                     "bits")


# ---------------------------------------------------------------------------
# DET003 — accumulating scatters (CUDA atomics, no fixed order)
# ---------------------------------------------------------------------------

_SCATTER_ADDS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce_", "scatter_reduce", "index_reduce_",
                 "index_reduce"}
_ACCUMULATING_PUTS = {"index_put_": 2, "index_put": 2, "put_": 2, "put": 2}


class AccumulatingScatter(LintRule):
    rule = "DET003"
    title = "accumulating scatter (no fixed add order on CUDA)"

    def check(self, mod: SourceModule):
        for node, name, tail in _calls(mod):
            if not isinstance(node.func, ast.Attribute):
                continue
            root = None if name is None else name.split(".")[0]
            if root in _HOST_ROOTS:
                continue
            if tail in _SCATTER_ADDS:
                yield node, (f"`.{tail}` — on CUDA an accumulating scatter "
                             f"adds with atomics in no fixed order; gather "
                             f"and fold in a pinned order, or waive with "
                             f"why the order cannot matter (an integer "
                             f"domain, one add per cell, a CPU-only "
                             f"oracle)")
            elif tail in _ACCUMULATING_PUTS:
                pos = _ACCUMULATING_PUTS[tail] + (1 if root == "torch"
                                                  else 0)
                acc = _kwarg(node, "accumulate")
                if acc is None and len(node.args) > pos:
                    acc = node.args[pos]
                if _is_true(acc):
                    yield node, (f"`.{tail}(accumulate=True)` — on CUDA "
                                 f"the accumulating put adds with atomics "
                                 f"in no fixed order")


# ---------------------------------------------------------------------------
# DET004 — draws from the global generator in serving code
# ---------------------------------------------------------------------------

_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
          "bernoulli", "normal", "poisson", "rand_like", "randn_like",
          "randint_like"}
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                  "random_", "geometric_", "cauchy_", "log_normal_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.seed",
                 "torch.random.manual_seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all"}


class GlobalGeneratorInServe(LintRule):
    rule = "DET004"
    title = "draw from the global generator in per-request code"

    def applies(self, mod: SourceModule) -> bool:
        return _in_dirs(mod, {"serve"})

    def check(self, mod: SourceModule):
        for node, name, tail in _calls(mod):
            root = None if name is None else name.split(".")[0]
            if name in _GLOBAL_SEEDS:
                yield node, (f"`{name}` reseeds the process-wide generator "
                             f"— every request's draws then depend on the "
                             f"others'; seed a torch.Generator per token "
                             f"from (seed, request, step)")
                continue
            draw = ((root == "torch" and tail in _DRAWS)
                    or _method_on_tensor(name, node.func, _INPLACE_DRAWS))
            if draw and _kwarg(node, "generator") is None:
                yield node, (f"`{name or '.' + tail}` draws from the global "
                             f"generator, whose state depends on request "
                             f"arrival order — pass generator= (one per "
                             f"token, seeded from (seed, request, step))")


# ---------------------------------------------------------------------------
# DET006 — float count/index arithmetic (exact only to 2^24)
# ---------------------------------------------------------------------------

#: float dtypes whose integer grid ends at or below 2^24.  The 64-bit ones
#: are left out: where the reference's ``jnp.float64`` is float32 unless
#: x64 is switched on, torch's float64 holds integers exactly to 2^53
_FLOAT_DTYPES = {"torch.float32", "torch.float", "torch.float16",
                 "torch.half", "torch.bfloat16", "np.float32",
                 "numpy.float32"}


def _is_float_dtype_expr(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    d = dotted_name(node)
    if d in _FLOAT_DTYPES:
        return True
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, str) and "float" in node.value


def _is_float_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, float)


def _is_float_ones(node: ast.AST) -> bool:
    """``torch.ones(n, dtype=torch.float32)``, ``torch.ones(n)`` (float by
    default), ``torch.full(s, 1.0)``, ``x.new_ones(s, dtype=float)`` — a
    count vector built in float."""
    if not isinstance(node, ast.Call):
        return False
    d = dotted_name(node.func) or ""
    tail = d.split(".")[-1] if d else getattr(node.func, "attr", "")
    if tail not in ("ones", "ones_like", "full", "full_like", "new_ones",
                    "new_full"):
        return False
    dtype = _kwarg(node, "dtype")
    if dtype is not None:
        return _is_float_dtype_expr(dtype)
    if d == "torch.ones":
        return True                      # the default dtype is float32
    if d == "torch.full" and len(node.args) > 1:
        return _is_float_const(node.args[1])
    return False


def _is_float_scalar(node: ast.AST) -> bool:
    """A float constant, a float-dtype cast of one (``np.float32(1)``) or
    a tensor of one (``torch.tensor(1.0)``)."""
    if _is_float_const(node):
        return True
    if not isinstance(node, ast.Call):
        return False
    if _is_float_dtype_expr(node.func):
        return True
    d = dotted_name(node.func) or ""
    if d in ("torch.tensor", "torch.as_tensor", "torch.scalar_tensor"):
        return (_is_float_dtype_expr(_kwarg(node, "dtype"))
                or (bool(node.args) and _is_float_const(node.args[0])))
    return _is_float_ones(node)


_COUNT_TAILS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
                "bincount"}


class FloatCountArithmetic(LintRule):
    rule = "DET006"
    title = "float count/index arithmetic (exact only to 2^24)"

    def check(self, mod: SourceModule):
        # names bound (anywhere in the module) to float-ones vectors
        float_ones_names: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and _is_float_ones(node.value):
                for t in node.targets:
                    float_ones_names |= {n.id for n in ast.walk(t)
                                         if isinstance(n, ast.Name)}

        for node, _, tail in _calls(mod):
            # (a) float ones-vector fed to a sum/count accumulator
            if "sum" in tail or "count" in tail or tail in _COUNT_TAILS:
                fed = list(node.args) + [kw.value for kw in node.keywords]
                if any(_is_float_ones(a) or (isinstance(a, ast.Name)
                                             and a.id in float_ones_names)
                       for a in fed):
                    yield node, ("counting in float: a float ones-vector "
                                 "accumulated by a sum saturates at 2^24 "
                                 "(f32 integer grid); count in int32/int64 "
                                 "and cast after")
            # (b) all_reduce/psum of a float constant — counting ranks in
            # float
            if tail in ("psum", "pmean", "all_reduce") and node.args \
                    and _is_float_scalar(node.args[0]):
                yield node, ("device-counting via all_reduce/psum of a "
                             "float constant — exact only to 2^24; reduce "
                             "an int and cast after")
            # (c) index grids materialized in float
            if tail in ("arange", "range"):
                if _is_float_dtype_expr(_kwarg(node, "dtype")) or any(
                        _is_float_const(a) for a in node.args):
                    yield node, ("index grid materialized in float — "
                                 "positions past 2^24 collide on the f32 "
                                 "integer grid; build indices in int and "
                                 "cast at the use site")


# ---------------------------------------------------------------------------
# DET005 — registry hook contract (reflection over the live registries)
# ---------------------------------------------------------------------------

_POLICY_HOOKS = {
    # hook -> (min positional args after self, required kwargs)
    "prepare_ctx": (2, ()),
    "to_domain": (2, ()),
    "prepare": (1, ()),
    "contrib": (2, ()),
    "contrib_lanes": (3, ("seg_offset", "lanes")),
    "init": (2, ()),
    "update": (2, ()),
    "merge": (2, ()),
    "merge_across": (2, ()),
    "carry_status": (1, ()),
    "finalize": (2, ()),
    "stage_costs": (1, ()),
    "domain_width": (1, ()),
}

#: every executor's ``run`` keywords; staged ones add ``program``,
#: distributed ones ``group`` (a process group, where the reference takes
#: ``mesh`` and ``axis_names``); the port has no interpret mode
_BACKEND_RUN_KWARGS = ("policy", "block_size")


def _sig_accepts(fn, *, min_pos: int = 0,
                 kwargs: Sequence[str] = ()) -> Optional[str]:
    """None when ``fn``'s signature can take ``min_pos`` positional args
    and every kwarg in ``kwargs``; else a human-readable deficit."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return "signature not introspectable"
    params = list(sig.parameters.values())
    has_var_pos = any(p.kind is p.VAR_POSITIONAL for p in params)
    has_var_kw = any(p.kind is p.VAR_KEYWORD for p in params)
    n_pos = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                for p in params)
    if n_pos < min_pos and not has_var_pos:
        return f"takes {n_pos} positional args, needs {min_pos}"
    names = {p.name for p in params}
    missing = [k for k in kwargs if k not in names and not has_var_kw]
    if missing:
        return f"missing keyword(s) {missing}"
    return None


def _def_site(obj):
    """(relpath, lineno) of a class/object definition, best-effort."""
    try:
        cls = obj if isinstance(obj, type) or inspect.isfunction(obj) \
            else type(obj)
        path = inspect.getsourcefile(cls)
        _, line = inspect.getsourcelines(cls)
        rel = str(walker.Path(path).resolve().relative_to(walker.repo_root()))
        return rel, line
    except (OSError, TypeError, ValueError):
        return "<registry>", 0


def is_integer_dtype(dt) -> bool:
    """True for a torch or numpy integer dtype (bool is not one)."""
    import torch
    if isinstance(dt, torch.dtype):
        return not (dt.is_floating_point or dt.is_complex
                    or dt == torch.bool)
    import numpy as np
    return np.issubdtype(np.dtype(dt), np.integer)


def check_registries() -> List[Finding]:
    """DET005: every registered policy/backend/op satisfies the hook
    contract its registry promises callers.  Runs against the *live*
    registries so a class registered from anywhere is held to the bar."""
    out: List[Finding] = []

    def finding(obj, msg, *, waived=False, reason=""):
        rel, line = _def_site(obj)
        out.append(Finding(rule="DET005", path=rel, line=line, message=msg,
                           waived=waived, reason=reason))

    try:
        from ..reduce.policy import POLICIES
        from ..reduce.backends import BACKENDS
        from ..reduce.algebra import REDUCE_OPS
    except Exception as e:    # loud, unwaivable: the checker itself broke
        out.append(Finding(rule="DET005", path="<registry>", line=0,
                           message=f"registry reflection failed to load: "
                                   f"{type(e).__name__}: {e}"))
        return out

    for name, p in sorted(POLICIES.items()):
        if getattr(p, "name", None) != name:
            finding(p, f"policy registered as {name!r} but .name is "
                       f"{getattr(p, 'name', None)!r}")
        for hook, (min_pos, kwargs) in _POLICY_HOOKS.items():
            fn = getattr(p, hook, None)
            if not callable(fn):
                finding(p, f"policy {name!r} missing required hook "
                           f"`{hook}`")
                continue
            deficit = _sig_accepts(fn, min_pos=min_pos, kwargs=kwargs)
            if deficit:
                finding(p, f"policy {name!r} hook `{hook}`: {deficit}")
        dts = getattr(p, "carry_dtypes", None)
        clen = getattr(p, "carry_len", None)
        if dts is None or clen is None or len(tuple(dts)) != clen:
            finding(p, f"policy {name!r}: len(carry_dtypes)="
                       f"{None if dts is None else len(tuple(dts))} != "
                       f"carry_len={clen}")
        elif getattr(p, "merge_is_add", False) and \
                not all(is_integer_dtype(d) for d in dts):
            tol = TOLERATED_FLOAT_MERGE.get(name)
            finding(p, f"policy {name!r}: merge_is_add with non-integer "
                       f"carry leaves {tuple(str(d) for d in dts)}"
                       f" — a float sum across ranks is order-sensitive",
                    waived=tol is not None, reason=tol or "")

    for name, b in sorted(BACKENDS.items()):
        if b.name != name:
            finding(b.run, f"backend registered as {name!r} but .name is "
                           f"{b.name!r}")
        kwargs = list(_BACKEND_RUN_KWARGS)
        if getattr(b, "staged", False):
            kwargs.append("program")
        if getattr(b, "distributed", False):
            kwargs.append("group")
        deficit = _sig_accepts(b.run, min_pos=3, kwargs=kwargs)
        if deficit:
            finding(b.run, f"backend {name!r} run(): {deficit}")

    for name, op in sorted(REDUCE_OPS.items()):
        if getattr(op, "name", None) != name:
            finding(op, f"op registered as {name!r} but .name is "
                       f"{getattr(op, 'name', None)!r}")
        for hook, spec in (("pre", (1, ("weights", "coeffs"))),
                           ("post", (2, ()))):
            fn = getattr(op, hook, None)
            if not callable(fn):
                finding(op, f"op {name!r} missing required hook `{hook}`")
                continue
            deficit = _sig_accepts(fn, min_pos=spec[0], kwargs=spec[1])
            if deficit:
                finding(op, f"op {name!r} hook `{hook}`: {deficit}")
        comps = getattr(op, "components", None)
        if not isinstance(comps, int) or comps < 1:
            finding(op, f"op {name!r}: components must be a positive int, "
                       f"got {comps!r}")
        for req, takes in (("requires_weights", "takes_weights"),
                           ("requires_coeffs", "takes_coeffs")):
            if getattr(op, req, False) and not getattr(op, takes, False):
                finding(op, f"op {name!r}: {req} without {takes}")

    # apply source-level pragmas to reflection findings too
    cache = {}
    for f in out:
        if f.waived or f.path == "<registry>":
            continue
        p = walker.repo_root() / f.path
        if p not in cache and p.exists():
            cache[p] = walker.parse_module(p)
        mod = cache.get(p)
        if mod is None:
            continue
        node = ast.Module(body=[], type_ignores=[])
        node.lineno = f.line
        node.end_lineno = f.line
        w = mod.waiver_for("DET005", node)
        if w is not None:
            f.waived, f.reason = True, w.reason
    return out


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

AST_RULES: List[LintRule] = [
    RawReduction(),
    OrderlessFloatFold(),
    AccumulatingScatter(),
    GlobalGeneratorInServe(),
    FloatCountArithmetic(),
]

ALL_RULE_IDS = tuple(sorted({r.rule for r in AST_RULES} | {"DET005"}))


def run_lint(files: Sequence, *, rules: Optional[Set[str]] = None,
             registry: bool = True) -> List[Finding]:
    """Lint ``files`` (paths) with every AST rule, plus the registry
    reflection rule (DET005) unless ``registry=False``.  ``rules``
    filters to a subset of rule ids."""
    findings: List[Finding] = []
    for path in files:
        mod = walker.parse_module(path)
        for rule in AST_RULES:
            if rules and rule.rule not in rules:
                continue
            findings.extend(rule.run(mod))
    if registry and (not rules or "DET005" in rules):
        findings.extend(check_registries())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
