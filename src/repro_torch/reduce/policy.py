"""Accuracy policies — the five tiers of ``repro_torch.reduce``.

The PyTorch counterpart of the reference's ``reduce/policy.py``.  A
policy says *in what domain* a block's rows are added; every tier shares
the same block schedule:

  * ``fast``          — f32 carry, one add per block.
  * ``compensated``   — f32 carry plus a two-sum compensation term.
  * ``exact``         — INTAC: quantize to one power-of-two scale sized so
    the whole stream fits int32, add in int32, dequantize once.
  * ``exact2``        — int32 (hi, lo) limbs plus the quantization
    residual as int32 digit bins: within 1 ulp of the f64 sum, bitwise
    independent of blocking.
  * ``procrastinate`` — exponent-indexed int32 digit bins.

The hooks are the reference's: ``prepare_ctx`` / ``to_domain`` /
``prepare``, the gather stage ``contrib`` (dot form) and
``contrib_lanes`` (lane form), ``init`` / ``update`` / ``carry_status``
/ ``finalize``, and the ``stage_costs`` hints ``plan_program`` reads.
The cross-rank hooks are the reference's too: ``merge`` combines two
partial carries, and ``merge_across`` combines the carries of a process
group's ranks (the ``shard_map`` executor's merge).  An integer carry
merges by one fused ``psum`` per carry (``fused_psum``); a float carry
(fast, compensated) is gathered and folded with ``merge`` strictly in
rank order, where the reference's fast tier takes a float psum: a float
sum across ranks has no pinned order.

The gather stage works on a batch of schedule blocks at once: ``ids``
(nb, B) int32 labels and ``vals`` (nb, B, W) domain rows give the
(nb, S, W) per-block contributions.  For the integer tiers any order of
int32 adds gives the same bits, so both forms are one scatter-add
(``index_add_``; never ``torch.matmul``, which has no int32 path on the
GPU).  For the float tiers the order is pinned here, once, and the CUDA
kernel repeats it exactly (``repro_torch.kernels.jugglepac_segsum``):

  * a block's rows split into ``lanes`` contiguous slices (the dot form is
    one lane), lane k spanning rows [k*B//lanes, (k+1)*B//lanes);
  * within a lane, each (segment, column) cell sums its leaves — the row's
    value where the row's label is the segment, +0.0 elsewhere — by a
    pairwise tree over the lane's rows zero-padded to a power of two:
    level by level, leaf 2i plus leaf 2i+1;
  * the lane sums fold in lane order: ((lane0 + lane1) + lane2) + ...

Only elementwise IEEE adds are used: no ``torch.sum``, no matmul, no
atomics, no fused multiply-add.  The reference's one-hot ``jnp.dot`` has
no defined order, so the float tiers agree with it to a tolerance, and
with every executor of this package to the bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import intac
from ..core.intac import fused_psum, two_sum  # noqa: F401  (re-export)
from ..distributed import comm

POLICIES: Dict[str, "Policy"] = {}

#: lanes the lane-form contrib splits a block into (the PhasedAccu phases)
LANES_DEFAULT = 4

#: elements of the (blocks, leaves, S, W) tensor the float gather builds
#: at once; larger batches are cut into groups of blocks
_TREE_ELEMS = 1 << 25

#: raw elements the digit-plane domains (exact2, procrastinate) convert
#: at once: every step is elementwise, so a wider stream is converted in
#: slices of raw columns, which bounds the f32 temporaries of the
#: exponent arithmetic (a dozen of them, each the size of a slice)
_DOMAIN_ELEMS = 1 << 26


def _column_slices(n: int, d: int):
    """Raw-column ranges [c0, c1) of at most ``_DOMAIN_ELEMS`` elements."""
    cols = max(1, _DOMAIN_ELEMS // max(1, n))
    for c0 in range(0, d, cols):
        yield c0, min(d, c0 + cols)


def register_policy(cls):
    """Class decorator: instantiate and add to the policy registry."""
    inst = cls()
    POLICIES[inst.name] = inst
    return cls


def get_policy(name: str) -> "Policy":
    """Look up a registered policy instance by name."""
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; registered: "
                         f"{sorted(POLICIES)}") from None


def lane_bounds(block_rows: int, lanes: int):
    """Row bounds of the contiguous lanes of one block."""
    nl = max(1, min(int(lanes), block_rows))
    return [(k * block_rows) // nl for k in range(nl + 1)]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pairwise_leaves(ids, vals, num_segments: int):
    """(nb, L) labels + (nb, L, W) rows -> (nb, S, W): the masked leaves
    summed by the pinned pairwise tree over L rows padded to a power of
    two."""
    labels = torch.arange(num_segments, dtype=torch.int32, device=ids.device)
    match = ids[:, :, None] == labels                         # (nb, L, S)
    zero = torch.zeros((), dtype=torch.float32, device=vals.device)
    x = torch.where(match[..., None], vals[:, :, None, :], zero)
    pad = _next_pow2(x.shape[1]) - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def float_contrib(ids, vals, num_segments: int, lanes: int = 1):
    """The float tiers' pinned gather: lanes of pairwise trees folded in
    lane order.  ``ids`` are block-local labels; rows outside
    [0, num_segments) contribute nothing."""
    nb, b, w = vals.shape
    vals = vals.to(torch.float32)
    ids = ids.to(torch.int32)
    bounds = lane_bounds(b, lanes)
    leaves = _next_pow2(max(hi - lo for lo, hi in zip(bounds, bounds[1:])))
    group = max(1, _TREE_ELEMS // max(1, leaves * num_segments * w))
    out = []
    for g in range(0, nb, group):
        total = None
        for lo, hi in zip(bounds, bounds[1:]):
            part = _pairwise_leaves(ids[g:g + group, lo:hi],
                                    vals[g:g + group, lo:hi], num_segments)
            total = part if total is None else total + part
        out.append(total)
    return out[0] if len(out) == 1 else torch.cat(out, 0)


def int_contrib(ids, vals, num_segments: int):
    """The integer tiers' gather: one int32 scatter-add per block (any
    order gives the same bits).  Rows outside [0, num_segments) park on
    a scratch row, as ``index_add_`` takes no negative index."""
    nb, b, w = vals.shape
    ids = ids.to(torch.int64)
    safe = torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))
    base = torch.arange(nb, device=ids.device)[:, None] * (num_segments + 1)
    out = torch.zeros((nb * (num_segments + 1), w), dtype=torch.int32,
                      device=vals.device)
    # detlint: ok[DET003] int32 domain: the integer tiers' gather, the same
    # bits in any order
    out.index_add_(0, (base + safe).reshape(-1),
                   vals.reshape(-1, w).to(torch.int32))
    return out.view(nb, num_segments + 1, w)[:, :num_segments]


class Policy:
    """Base accuracy policy.  Subclasses set ``name`` and override hooks."""

    name: str = "?"
    #: number of carry arrays threaded through the block schedule
    carry_len: int = 1
    #: dtype the executors accumulate in
    acc_dtype = torch.float32
    #: largest schedule block the headroom analysis covers (None = any)
    max_block_size: Optional[int] = None
    #: largest block count the per-block carry headroom covers
    max_blocks: Optional[int] = None
    #: largest total row count the carry headroom covers
    max_terms: Optional[int] = None
    #: the next-stronger tier ``on_overflow="degrade"`` escalates to
    escalation: Optional[str] = None
    #: True when ``prepare_ctx`` consumes the stream's max-|value|
    needs_max_stat: bool = False
    #: rough elementwise-op count of one ``update`` per carry element
    update_ops_per_elem: int = 1
    #: domain columns per raw column (the digit planes of exact2 and
    #: procrastinate); the carry of every tier is (S, parts * D) at most
    parts: int = 1
    #: True when ``merge`` is elementwise addition of every carry
    merge_is_add: bool = True

    @property
    def integer(self) -> bool:
        return self.acc_dtype == torch.int32

    @property
    def carry_dtypes(self) -> Tuple:
        return (self.acc_dtype,) * self.carry_len

    def domain_width(self, d: int) -> int:
        return self.parts * d

    def prepare_ctx(self, max_abs, num_terms: int):
        return None

    def to_domain(self, values: torch.Tensor, ctx):
        return values.to(torch.float32)

    def prepare(self, values: torch.Tensor, num_terms: int, *,
                shared_max=None):
        """(domain_values, ctx): ``prepare_ctx`` then ``to_domain``."""
        v = values.to(torch.float32)
        m = None
        if self.needs_max_stat:
            m = torch.max(torch.abs(v)) if shared_max is None else shared_max
        ctx = self.prepare_ctx(m, num_terms)
        return self.to_domain(v, ctx), ctx

    def contrib(self, ids, vals, num_segments: int):
        """Dot-form gather of a batch of blocks (see the module doc)."""
        if self.integer:
            return int_contrib(ids, vals, num_segments)
        return float_contrib(ids, vals, num_segments, lanes=1)

    def contrib_lanes(self, ids, vals, num_segments: int, *,
                      seg_offset: int = 0, lanes: int = LANES_DEFAULT):
        """Lane-form gather: bitwise the dot form for integer domains, a
        different (pinned) rounding order for float ones.  Labels are
        taken relative to ``seg_offset``, as in the reference's hook."""
        if seg_offset:
            ids = ids - seg_offset
        if self.integer:
            return int_contrib(ids, vals, num_segments)
        return float_contrib(ids, vals, num_segments, lanes=lanes)

    def stage_costs(self, block_size: int, domain_width: int,
                    num_segments: int, *, contrib: str = "dot") -> Dict:
        """Declared per-block byte/flop hints of the two stages."""
        b, w, s = block_size, domain_width, num_segments
        acc_bytes = 4
        in_bytes = b * w * 4 + b * 4
        if contrib == "lanes":
            gather = {"bytes": float(in_bytes + (s + 1) * w * acc_bytes),
                      "flops": float(b * w), "bound": "memory"}
        else:
            gather = {"bytes": float(in_bytes + s * w * acc_bytes),
                      "flops": float(2.0 * b * s * w), "bound": "memory"}
        update = {"bytes": float(2 * self.carry_len * s * w * acc_bytes),
                  "flops": float(self.update_ops_per_elem
                                 * self.carry_len * s * w),
                  "bound": "compute"}
        return {"contrib": gather, "update": update}

    def init(self, num_segments: int, d: int, device=None):
        """Zero carry; ``d`` is the domain width."""
        return tuple(torch.zeros((num_segments, d), dtype=dt, device=device)
                     for dt in self.carry_dtypes)

    def update(self, carry, contrib):
        return (carry[0] + contrib,)

    def merge(self, a, b):
        """Combine two partial carries: ``merge(run(blocks[:k]),
        run(blocks[k:]))`` is ``run(blocks)``, exactly for the integer
        tiers, to a tolerance for the float ones."""
        return tuple(x + y for x, y in zip(a, b))

    def merge_across(self, carry, group):
        """Merge the carries of ``group``'s ranks (every rank gets the
        merged carry): an integer carry that merges by addition takes one
        ``fused_psum`` (the same bits in any order); any other carry is
        gathered and folded with ``merge`` strictly in rank order."""
        if self.merge_is_add and self.integer:
            return fused_psum(carry, group)
        gathered = tuple(comm.all_gather(c, group) for c in carry)
        merged = tuple(g[0] for g in gathered)
        for k in range(1, gathered[0].shape[0]):
            merged = self.merge(merged, tuple(g[k] for g in gathered))
        return merged

    def carry_status(self, carry):
        return None

    def finalize(self, carry, ctx) -> torch.Tensor:
        return carry[0]


@register_policy
class FastPolicy(Policy):
    """f32 accumulation over the fixed block tree (the default)."""

    name = "fast"


@register_policy
class CompensatedPolicy(Policy):
    """Two-sum compensated cross-block accumulation."""

    name = "compensated"
    carry_len = 2
    merge_is_add = False            # the two-sum merge is order-sensitive
    update_ops_per_elem = 6

    def update(self, carry, contrib):
        acc, comp = carry
        s, e = two_sum(acc, contrib)
        return (s, comp + e)

    def merge(self, a, b):
        """Two-sum the partial sums; pool the compensations and the new
        rounding error."""
        s, e = two_sum(a[0], b[0])
        return (s, a[1] + b[1] + e)

    def finalize(self, carry, ctx) -> torch.Tensor:
        acc, comp = carry
        return acc + comp


@register_policy
class ExactPolicy(Policy):
    """INTAC fixed point: int32 accumulation, one dequantize per reduction."""

    name = "exact"
    acc_dtype = torch.int32
    needs_max_stat = True
    escalation = "exact2"

    def prepare_ctx(self, max_abs, num_terms: int):
        return intac.choose_scale(max_abs, max(num_terms, 1))

    def to_domain(self, values: torch.Tensor, ctx):
        return intac.quantize(values.to(torch.float32), ctx)

    def finalize(self, carry, ctx) -> torch.Tensor:
        return intac.dequantize(carry[0], ctx)


@register_policy
class Exact2Policy(Policy):
    """Three-limb all-integer carry-save: (hi, lo) limbs of the quantized
    block sums plus the exactly-captured residual as int32 digit bins."""

    name = "exact2"
    carry_len = 4
    acc_dtype = torch.int32
    QBITS = 21
    max_block_size = 1 << (30 - QBITS)
    max_blocks = 1 << (30 - intac.LIMB_SHIFT)
    MAX_TERMS = max_block_size * max_blocks
    max_terms = MAX_TERMS
    escalation = "procrastinate"
    needs_max_stat = True
    update_ops_per_elem = 4
    #: domain layout: [q | digit bin 0 | ... | digit bin RES_NUM_BINS-1]
    parts = 1 + intac.RES_NUM_BINS

    def prepare_ctx(self, max_abs, num_terms: int):
        if num_terms > self.MAX_TERMS:
            raise ValueError(
                f"exact2: {num_terms} rows exceed the two-limb headroom "
                f"bound ({self.MAX_TERMS}); split the stream")
        return intac.choose_scale(max_abs, 1, qbits=self.QBITS)

    def to_domain(self, values: torch.Tensor, ctx):
        """(N, 8D) f32: the quantized value, then the residual's digit
        planes, each column an integer below 2^21 (q) or 2^6 (digits).
        Every plane is an int32 cast in the reference, which passes no
        gradient: the domain leaves the autograd graph here, as the
        integer domains of ``exact`` and ``procrastinate`` do."""
        v = values.detach().to(torch.float32)
        n, d = v.shape
        scale = ctx
        out = torch.empty((n, self.parts * d), dtype=torch.float32,
                          device=v.device)
        for c0, c1 in _column_slices(n, d):
            vs = v[:, c0:c1]
            q = intac.quantize(vs, scale)
            out[:, c0:c1] = q
            res = vs - intac.dequantize(q, scale)     # exact (Sterbenz)
            del q
            for k, dig in enumerate(intac.bin_digits(
                    res * scale, 0, bits=intac.RES_BIN_BITS,
                    num=intac.RES_NUM_BINS)):
                # the reference's bin_split casts each digit to int32
                # (NaN -> 0, saturating).  Finite digits are integers
                # below 2^7, so that cast, stored back as f32, is this
                # one pass: NaN -> 0, +-Inf -> +-2^31 (the f32 value of
                # INT32_MAX / INT32_MIN)
                torch.nan_to_num(dig, nan=0.0, posinf=2.0 ** 31,
                                 neginf=-2.0 ** 31,
                                 out=out[:, (k + 1) * d + c0:(k + 1) * d + c1])
        return out

    def init(self, num_segments: int, d: int, device=None):
        dd = d // self.parts
        z = torch.zeros((num_segments, dd), dtype=torch.int32, device=device)
        rb = torch.zeros((num_segments, intac.RES_NUM_BINS * dd),
                         dtype=torch.int32, device=device)
        return (z, z.clone(), rb, z.clone())

    def update(self, carry, contrib):
        hi, lo, rbins, ovf = carry
        dd = hi.shape[1]
        chi, clo = intac.limb_split(contrib[:, :dd])
        nhi, w1 = intac.wrap_add(hi, chi)
        nlo, w2 = intac.wrap_add(lo, clo)
        nrb, w3 = intac.wrap_add(rbins, contrib[:, dd:])
        wb = w1.to(torch.int32) + w2.to(torch.int32)
        for k in range(intac.RES_NUM_BINS):
            wb = wb + w3[:, k * dd:(k + 1) * dd].to(torch.int32)
        return (nhi, nlo, nrb, ovf + wb)

    def carry_status(self, carry):
        return torch.any(carry[3] != 0)

    def finalize(self, carry, ctx) -> torch.Tensor:
        hi, lo, rbins, _ovf = carry
        s, wd = rbins.shape
        bins = rbins.reshape(s, intac.RES_NUM_BINS,
                             wd // intac.RES_NUM_BINS).permute(1, 0, 2)
        return intac.limbs_resolve3_binned(hi, lo, bins, ctx)


@register_policy
class ProcrastinatePolicy(Policy):
    """Exponent-indexed int32 digit bins (Liguori/Neal procrastination)."""

    name = "procrastinate"
    carry_len = 2
    acc_dtype = torch.int32
    max_terms = intac.BIN_MAX_TERMS
    needs_max_stat = True
    update_ops_per_elem = 3
    parts = intac.NUM_BINS

    def prepare_ctx(self, max_abs, num_terms: int):
        if num_terms > intac.BIN_MAX_TERMS:
            raise ValueError(
                f"procrastinate: {num_terms} rows exceed the per-bin "
                f"headroom bound ({intac.BIN_MAX_TERMS}); split the stream")
        return intac.bin_ref_exponent(max_abs)

    def to_domain(self, values: torch.Tensor, ctx):
        """(N, 6D) int32 digit planes, digit-major along the columns."""
        v = values.to(torch.float32)
        n, d = v.shape
        out = torch.empty((n, self.parts * d), dtype=torch.int32,
                          device=v.device)
        for c0, c1 in _column_slices(n, d):
            for k, dig in enumerate(intac.bin_digits(v[:, c0:c1], ctx)):
                out[:, k * d + c0:k * d + c1] = intac.to_i32(dig)
        return out

    def init(self, num_segments: int, d: int, device=None):
        return (torch.zeros((num_segments, d), dtype=torch.int32,
                            device=device),
                torch.zeros((num_segments, d // self.parts),
                            dtype=torch.int32, device=device))

    def update(self, carry, contrib):
        bins, ovf = carry
        nb, w = intac.wrap_add(bins, contrib)
        dd = ovf.shape[1]
        wb = torch.zeros_like(ovf)
        for k in range(intac.NUM_BINS):
            wb = wb + w[:, k * dd:(k + 1) * dd].to(torch.int32)
        return (nb, ovf + wb)

    def carry_status(self, carry):
        return torch.any(carry[1] != 0)

    def finalize(self, carry, ctx) -> torch.Tensor:
        c = carry[0]
        s, wd = c.shape
        bins = c.reshape(s, intac.NUM_BINS,
                         wd // intac.NUM_BINS).permute(1, 0, 2)
        return intac.bin_combine(bins, ctx)
