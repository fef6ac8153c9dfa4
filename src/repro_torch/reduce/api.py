"""The front door: ``repro_torch.reduce(...)`` and ``ReduceSpec``.

    import repro_torch
    out = repro_torch.reduce(values)                       # (N, D) -> (D,)
    out = repro_torch.reduce(values, segment_ids=ids, num_segments=8)
    out = repro_torch.reduce(values, segment_ids=ids, num_segments=8,
                             op="mean", policy="exact2")

One call for every reduction: any op of the algebra, any accuracy
policy, any executor.  The steps are the reference's, eagerly: the op's
row-local ``pre``, ``Policy.prepare``, ``plan_program``, an executor,
``Policy.finalize`` and the op's ``post``.  It runs on the CUDA device
unless the caller passes ``device="cpu"``.

With ``group=`` (a process group of ``repro_torch.distributed.comm``;
the reference's ``mesh=`` and ``axis_names=``) every rank of the group
calls ``reduce`` with its own contiguous slice of the rows, rank 0
holding the first, and every rank gets the whole stream's result: the
``shard_map`` executor.  The row count and the quantization scale or
window anchor are shared across the ranks (a ``psum``, a ``pmax``)
before any rank maps its rows into the policy domain, so the integer
tiers give the one-process bits at any rank count.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..core import intac
from ..distributed import comm
from .algebra import get_op
from .backends import (get_backend, mask_out_of_range, run_with_carry_grad,
                       select_backend)
from .policy import get_policy
from .program import plan_program


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """Static description of a reduction (hashable).  ``backend=None``
    means auto-select: ``cuda`` on a CUDA device, ``blocked`` on the CPU."""

    op: str = "sum"
    policy: str = "fast"
    backend: Optional[str] = None
    block_size: int = 512
    coeffs: Optional[tuple] = None
    contrib: str = "auto"

    def __post_init__(self):
        op = get_op(self.op)
        if self.coeffs is not None:
            if not op.takes_coeffs:
                raise ValueError(f"op {self.op!r} takes no coeffs")
            object.__setattr__(self, "coeffs",
                               tuple(float(c) for c in self.coeffs))
        if self.contrib not in ("auto", "dot", "lanes"):
            raise ValueError(f"contrib must be 'auto', 'dot', or 'lanes', "
                             f"got {self.contrib!r}")
        get_policy(self.policy)
        if self.backend is not None:
            get_backend(self.backend)

    def replace(self, **kw) -> "ReduceSpec":
        return dataclasses.replace(self, **kw)


class ReduceStatus(NamedTuple):
    """Guard-rail flags of one reduction (0-d tensors):

    * ``nonfinite`` — a kept (in-range) row carried a NaN/Inf payload;
    * ``saturated`` — an int32 carry component wrapped;
    * ``degraded``  — ``on_overflow="degrade"`` re-planned the reduction;
    * ``kept_rows`` — int32 count of in-range rows.
    """

    nonfinite: torch.Tensor
    saturated: torch.Tensor
    degraded: torch.Tensor
    kept_rows: torch.Tensor


def _status_false(device) -> ReduceStatus:
    f = torch.tensor(False, device=device)
    return ReduceStatus(f, f.clone(), f.clone(),
                        torch.tensor(0, dtype=torch.int32, device=device))


def _counts(segment_ids, num_segments: int, device, group=None):
    """Exact int32 in-range row counts per segment, (S, 1), summed over
    ``group``'s ranks when given.  Sentinel rows park on a scratch row;
    int32 adds are order-free, so one ``index_add_`` is exact."""
    ids = mask_out_of_range(segment_ids, num_segments).to(torch.int64)
    safe = torch.where(ids >= 0, ids, torch.full_like(ids, num_segments))
    cnt = torch.zeros((num_segments + 1, 1), dtype=torch.int32,
                      device=device)
    cnt.index_add_(0, safe, torch.ones((ids.shape[0], 1), dtype=torch.int32,
                                       device=device))
    cnt = cnt[:num_segments]
    return cnt if group is None else comm.psum(cnt, group)


def _check_bounds(policy, n: int, block_size: int):
    if policy.max_block_size and block_size > policy.max_block_size:
        raise ValueError(
            f"policy {policy.name!r} admits blocks of at most "
            f"{policy.max_block_size} rows (its integer-headroom bound); "
            f"got block_size={block_size}")
    nb = -(-n // block_size)
    if policy.max_blocks and nb > policy.max_blocks:
        raise ValueError(
            f"policy {policy.name!r} admits at most {policy.max_blocks} "
            f"schedule blocks (its per-block carry headroom), but "
            f"{n} rows at block_size={block_size} need {nb}; "
            f"raise block_size or split the stream")


def _sum(values, segment_ids, *, spec: ReduceSpec, num_segments: int,
         with_status: bool, group=None):
    """The segmented sum of already op-transformed (N, W) rows, with
    optional status: the part of the pipeline every op shares.  Under
    ``group`` the rows are this rank's and the sum is the group's."""
    policy = get_policy(spec.policy)
    n, d = values.shape
    dev = values.device
    backend = get_backend(spec.backend)
    if not backend.supports(policy):
        raise ValueError(f"backend {backend.name!r} does not implement "
                         f"policy {policy.name!r} "
                         f"(capabilities: {sorted(backend.policies)})")
    n_local = n
    if group is not None:
        n = comm.psum_int(n_local, group, device=dev)
    _check_bounds(policy, n, spec.block_size)
    status = _status_false(dev) if with_status else None
    if n == 0:
        return torch.zeros((num_segments, d), dtype=torch.float32,
                           device=dev), status
    segment_ids = mask_out_of_range(segment_ids, num_segments)
    keep = segment_ids >= 0
    # dropped rows are zeroed before prepare: a huge sentinel payload
    # must not size the integer tiers' scale
    values = torch.where(keep[:, None], values,
                         torch.zeros((), dtype=values.dtype, device=dev))
    if with_status:
        bad = torch.logical_not(torch.all(torch.isfinite(values)))
        kept = keep.to(torch.int32).sum(dtype=torch.int32)
        if group is not None:
            bad = comm.psum(bad.to(torch.int32), group) > 0
            kept = comm.psum(kept, group)
        status = status._replace(nonfinite=bad, kept_rows=kept)
    run_kw = {}
    if backend.staged:
        # the contrib form is a (policy, shape) decision, planned once
        # above the executor
        run_kw["program"] = plan_program(
            policy, num_segments=num_segments,
            domain_width=policy.domain_width(d), block_size=spec.block_size,
            contrib=spec.contrib, op=spec.op)
    if backend.distributed:
        # the global statistic first (the max |value| of every rank's
        # kept rows, and the group's row count), then each rank maps its
        # own rows into the domain on that shared grid, inside the
        # executor: bitwise the whole stream's domain, row for row
        v32 = values.to(torch.float32)
        del values
        ctx = None
        if policy.needs_max_stat:
            m = (torch.max(torch.abs(v32)) if n_local else
                 torch.zeros((), dtype=torch.float32, device=dev))
            ctx = policy.prepare_ctx(comm.pmax(m, group), n)
        carry = backend.run(v32, segment_ids, num_segments, policy=policy,
                            block_size=spec.block_size, group=group,
                            to_domain=policy.to_domain, ctx=ctx, **run_kw)
        del v32
    else:
        domain, ctx = policy.prepare(values, n)
        del values
        run = backend.run
        if not backend.autograd:
            run = functools.partial(run_with_carry_grad, run)
        carry = run(domain, segment_ids, num_segments, policy=policy,
                    block_size=spec.block_size, **run_kw)
        del domain
    if with_status:
        sat = policy.carry_status(carry)
        if sat is not None:
            status = status._replace(saturated=sat)
    return policy.finalize(carry, ctx), status


def _chunk_limit(policy, block_size: int) -> int:
    """Largest block-aligned row count within every headroom bound."""
    limit = policy.max_terms
    if policy.max_blocks:
        cap = policy.max_blocks * block_size
        limit = cap if limit is None else min(limit, cap)
    return max(block_size, (limit // block_size) * block_size)


def _sum_degrade(values, segment_ids, *, spec: ReduceSpec,
                 num_segments: int):
    """``on_overflow="degrade"``: chunk over-bound streams (chunk sums
    folded with a two-sum accumulator) and escalate a saturated tier to
    ``policy.escalation``.  Returns (sums, status)."""
    policy = get_policy(spec.policy)
    n, d = values.shape
    nb = -(-n // spec.block_size)
    over = bool((policy.max_terms is not None and n > policy.max_terms)
                or (policy.max_blocks and nb > policy.max_blocks))
    if over:
        chunk = _chunk_limit(policy, spec.block_size)
        acc = torch.zeros((num_segments, d), dtype=torch.float32,
                          device=values.device)
        comp = torch.zeros_like(acc)
        status = _status_false(values.device)
        for i in range(0, n, chunk):
            part, st = _sum(values[i:i + chunk], segment_ids[i:i + chunk],
                            spec=spec, num_segments=num_segments,
                            with_status=True)
            acc, err = intac.two_sum(acc, part)
            comp = comp + err
            status = ReduceStatus(
                torch.logical_or(status.nonfinite, st.nonfinite),
                torch.logical_or(status.saturated, st.saturated),
                status.degraded, status.kept_rows + st.kept_rows)
        out = acc + comp
    else:
        out, status = _sum(values, segment_ids, spec=spec,
                           num_segments=num_segments, with_status=True)
    if bool(status.saturated):
        if policy.escalation is None:
            raise OverflowError(
                f"policy {policy.name!r} saturated an int32 carry and has "
                f"no stronger tier to escalate to; split the stream")
        out, status = _sum_degrade(
            values, segment_ids, spec=spec.replace(policy=policy.escalation),
            num_segments=num_segments)
        return out, status._replace(
            degraded=torch.tensor(True, device=values.device))
    return out, status._replace(degraded=torch.logical_or(
        status.degraded, torch.tensor(over, device=values.device)))


def reduce(values, *, segment_ids=None, num_segments: Optional[int] = None,
           op: str = "sum", policy: str = "fast",
           backend: Optional[str] = None, block_size: int = 512,
           contrib: str = "auto", weights=None, coeffs=None,
           spec: Optional[ReduceSpec] = None, with_status: bool = False,
           on_overflow: str = "raise", device=None, group=None):
    """Reduce a value stream, optionally partitioned into labeled sets.

    Args:
      values: (N,) or (N, D) tensor or array of any float dtype.
      segment_ids: optional (N,) int labels; rows labeled outside
        [0, num_segments) (``OUT_OF_RANGE_LABEL`` among them) are dropped
        from sums and counts.
      num_segments: label-space size; required with ``segment_ids``.
      op: "sum", "mean", "weighted_sum" (needs ``weights``), "sumsq",
        "moments" (adds a leading (mean, var) axis) or "poly" (needs
        ``coeffs``).
      policy: "fast", "compensated", "exact", "exact2" or "procrastinate".
      backend: "ref", "blocked", "cuda", "shard_map", or None to
        auto-select (``shard_map`` under a group of more than one rank,
        else ``cuda`` on a CUDA device and ``blocked`` on the CPU).
      block_size: rows per schedule block.
      contrib: gather form — "auto", "dot" or "lanes".
      weights / coeffs: per-row weights / static polynomial coefficients.
      spec: a prebuilt ``ReduceSpec``; overrides the per-call knobs.
      with_status: also return a ``ReduceStatus``.
      on_overflow: "raise" rejects streams beyond the policy's headroom
        bounds; "degrade" chunks them and escalates on saturation.
      device: where to run; None means "cuda" (raises without CUDA).
        Values that require grad differentiate on every single-device
        executor as on ``blocked`` (``cuda`` through
        ``backends.run_with_carry_grad``); the sharded executor on CUDA
        raises for them.
      group: a process group (``repro_torch.distributed.comm``) whose
        ranks each pass their own contiguous slice of the rows and each
        get the whole stream's result; only for the distributed backend
        (``shard_map``).  ``on_overflow="degrade"`` runs in one process
        only.

    Returns:
      f32 tensor: (num_segments, D) / (num_segments,) when segmented,
      (D,) / scalar otherwise; with ``with_status``, (result, status).

    >>> import torch
    >>> float(reduce(torch.arange(4.0), device="cpu"))
    6.0
    >>> out = reduce(torch.arange(6.0), device="cpu",
    ...              segment_ids=torch.tensor([0, 0, 1, 1, 1, 2]),
    ...              num_segments=3, policy="exact2")
    >>> [float(v) for v in out]
    [1.0, 9.0, 5.0]
    """
    if on_overflow not in ("raise", "degrade"):
        raise ValueError(f"on_overflow must be 'raise' or 'degrade', "
                         f"got {on_overflow!r}")
    dev = resolve_device(device)
    if spec is None:
        spec = ReduceSpec(op=op, policy=policy, backend=backend,
                          block_size=block_size, contrib=contrib,
                          coeffs=coeffs)
    elif coeffs is not None and spec.coeffs is None:
        spec = spec.replace(coeffs=coeffs)
    pol = get_policy(spec.policy)
    auto = spec.backend is None
    bk = (select_backend(pol, dev, group) if auto
          else get_backend(spec.backend))
    spec = spec if spec.backend == bk.name else spec.replace(backend=bk.name)
    if bk.distributed:
        if group is None:
            raise ValueError(f"backend {bk.name!r} runs across the ranks "
                             f"of a process group: pass group=")
        if on_overflow == "degrade":
            raise ValueError("on_overflow='degrade' re-plans one process's "
                             "stream; under group= keep on_overflow="
                             "'raise'")
    elif group is not None:
        if not auto:
            raise ValueError(f"backend {bk.name!r} is single-device; group= "
                             f"only applies to distributed backends (e.g. "
                             f"'shard_map')")
        # auto-selection declined a one-rank group: the local executor
        # over this rank's rows, which are the whole stream
        group = None
    if (bk.distributed and dev.type == "cuda"
            and getattr(values, "requires_grad", False)):
        # each rank folds with K1, and a gradient across the ranks' merge
        # is not written yet: it would stop here without a word
        raise NotImplementedError(
            "repro_torch.reduce: the sharded executor on CUDA (K1 in every "
            "rank) has no backward, and these values require grad; reduce "
            "a detached tensor — ROADMAP.md queue 1, item 9 (the sharded "
            "executor under autograd) brings it")

    values = torch.as_tensor(values, device=dev)
    if not values.is_floating_point():
        values = values.to(torch.float32)
    if values.ndim not in (1, 2):
        raise ValueError(f"values must be (N,) or (N, D), "
                         f"got shape {tuple(values.shape)}")
    squeeze_d = values.ndim == 1
    if squeeze_d:
        values = values[:, None]

    op_ = get_op(spec.op)
    if op_.requires_weights and weights is None:
        raise ValueError(f"op {spec.op!r} requires per-row weights=")
    if weights is not None and not op_.takes_weights:
        raise ValueError(f"op {spec.op!r} takes no weights")
    if op_.requires_coeffs and spec.coeffs is None:
        raise ValueError(f"op {spec.op!r} requires coeffs=")
    if weights is not None:
        weights = torch.as_tensor(weights, device=dev)
        if weights.ndim == 2 and weights.shape[-1] == 1:
            weights = weights[:, 0]
        if weights.ndim != 1 or weights.shape[0] != values.shape[0]:
            raise ValueError(
                f"weights must be (N,) or (N, 1) matching values' "
                f"N={values.shape[0]}, got shape {tuple(weights.shape)}")
    values = op_.pre(values, weights=weights, coeffs=spec.coeffs)

    segmented = segment_ids is not None
    if segmented:
        if num_segments is None:
            raise ValueError("num_segments (static int) is required with "
                             "segment_ids")
        segment_ids = torch.as_tensor(segment_ids, device=dev)
    else:
        if num_segments is not None:
            raise ValueError("num_segments was given without segment_ids; "
                             "pass both for a segmented reduction")
        num_segments = 1
        segment_ids = torch.zeros(values.shape[0], dtype=torch.int32,
                                  device=dev)
    num_segments = int(num_segments)

    if on_overflow == "degrade":
        out, status = _sum_degrade(values, segment_ids, spec=spec,
                                   num_segments=num_segments)
    else:
        out, status = _sum(values, segment_ids, spec=spec,
                           num_segments=num_segments,
                           with_status=with_status, group=group)
    if op_.needs_count:
        out = op_.post(out, _counts(segment_ids, num_segments, dev, group))
    else:
        out = op_.post(out, None)
    if not segmented:
        out = out[0]
    if squeeze_d:
        out = out[..., 0]
    return (out, status) if with_status else out
