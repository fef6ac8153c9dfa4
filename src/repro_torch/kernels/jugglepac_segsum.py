"""K1: the JugglePAC segmented streaming sum with the policy carry.

The Hopper counterpart of the TPU kernel ``_segsum_policy_kernel``
(``segsum_policy_pallas``, ``src/repro/kernels/jugglepac_segsum.py``).
It takes a (N, W) stream already in the policy's domain and (N,) int32
labels, cut into schedule blocks of ``block_rows`` rows, and returns the
policy's carry tuple, not yet finalized: each block's (S, W)
contribution folds into the carry strictly in block order.

Two implementations of one function live here:

  * ``segsum_policy_cuda`` launches the CUDA kernel (``csrc/segsum.cu``)
    on CUDA tensors and counts its launches in ``LAUNCHES``;
  * ``segsum_policy_torch`` is its plain PyTorch version — the code path
    the ``blocked`` executor runs — built from the very gather
    (``program.block_contrib``) and fold (``Policy.update``) the ``ref``
    executor runs block by block.

K1 has two schedules, chosen by shape alone (``launch_plan``):

  * the label schedule, for more than one label: two CUDA kernels on one
    stream, a pre-pass that writes each schedule block's label range,
    which ``block_label_ranges_torch`` computes plainly
    (``block_label_ranges_cuda`` launches the pre-pass alone, for
    checks), and the block schedule, which loads only the schedule blocks
    whose range meets its label tile;
  * the one-label schedule (``wide_plan``), for ``num_segments == 1``:
    every unsegmented reduce and every K1 launch of a train step.  Its
    fold is column-wide: a thread owns ``ops.WIDE_VEC`` columns of every
    plane (one where it reads block contributions) and folds the
    schedule blocks' contributions into their carry cells in block
    order.  At ``block_rows == 1`` a block's contribution
    is its row, so the fold reads the stream itself: one CUDA kernel.
    Otherwise a contribution kernel runs first: one CUDA block per
    (schedule block, column tile) sums the block's rows — the pinned
    tree of the float tiers, as 16-row register subtrees joined level by
    level in shared memory; an int32 wrapping sum for the integer tiers
    — into an (nb, W) tensor the launcher allocates, which the fold
    reads.  Each contribution is the plain version's gather to the bit
    (the same tree, or a wrapping sum that any split of the rows gives),
    and the fold is ``Policy.update`` in block order, so the carry is too.

The backend registry (``repro_torch.reduce.backends``) picks between
them by device.  The kernel never falls back: a failed build or launch
raises.

The in-block order of the float tiers is pinned once, here and in
``repro_torch.reduce.policy``, and both implementations follow it: the
block's rows split into contiguous lanes (one lane for the dot form);
within a lane each (segment, column) cell sums its leaves — the row's
value where the row has that label, +0.0 elsewhere — by a pairwise tree
over the lane's rows zero-padded to a power of two (leaf 2i + leaf 2i+1,
level by level); the lane sums fold in lane order.  Only elementwise
IEEE adds: no float atomics, matmul, ``torch.sum``, TF32 or FMA.  So the
kernel and its plain version agree to the bit for every tier.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..reduce.policy import lane_bounds
from ..reduce.program import block_contrib
from . import ops

#: launches of the K1 kernel, counted by ``segsum_policy_cuda``
LAUNCHES = 0

_TIERS = {"fast": 0, "compensated": 1, "exact": 2, "exact2": 3,
          "procrastinate": 4}
_IN_DTYPES = {"fast": torch.float32, "compensated": torch.float32,
              "exact": torch.int32, "exact2": torch.float32,
              "procrastinate": torch.int32}

#: carry cells (S x W) a batch of gathered contributions may hold
_CONTRIB_ELEMS = 1 << 24

#: the range of a schedule block with none of the labels
NO_RANGE = (2 ** 31 - 1, -2 ** 31)


@functools.lru_cache(maxsize=256)
def _carry_spec(policy, num_segments: int, width: int):
    """The carry's (shape, dtype) per part, from the policy's init (the
    one source of them), cached: a launch's host time counts whenever
    the card waits for it."""
    return tuple((tuple(c.shape), c.dtype)
                 for c in policy.init(num_segments, width, device="meta"))


def block_label_ranges_torch(ids: torch.Tensor, block_rows: int,
                             num_segments: int,
                             seg_offset: int = 0) -> torch.Tensor:
    """The plain version of K1's pre-pass: ids (N,) -> (nb, 2) int32,
    each schedule block's least and greatest label of
    [seg_offset, seg_offset + num_segments), ``NO_RANGE`` where it holds
    none.  Rows past N (the ragged last block) are sentinels."""
    ids = ids.to(torch.int64).reshape(-1)
    n = ids.shape[0]
    nb = -(-n // block_rows)
    pad = nb * block_rows - n
    keep = (ids >= seg_offset) & (ids < seg_offset + num_segments)
    lo = torch.where(keep, ids, torch.full_like(ids, NO_RANGE[0]))
    hi = torch.where(keep, ids, torch.full_like(ids, NO_RANGE[1]))
    lo = torch.cat([lo, lo.new_full((pad,), NO_RANGE[0])])
    hi = torch.cat([hi, hi.new_full((pad,), NO_RANGE[1])])
    return torch.stack([lo.reshape(nb, block_rows).amin(1),
                        hi.reshape(nb, block_rows).amax(1)], 1) \
        .to(torch.int32)


def block_label_ranges_cuda(ids: torch.Tensor, block_rows: int,
                            num_segments: int,
                            seg_offset: int = 0) -> torch.Tensor:
    """K1's pre-pass alone, on a contiguous int32 CUDA tensor of labels:
    the same (nb, 2) int32 ranges as ``block_label_ranges_torch``."""
    from . import _build
    if not ids.is_cuda or ids.dtype != torch.int32 or ids.ndim != 1 \
            or not ids.is_contiguous():
        raise ValueError("block_label_ranges_cuda needs a contiguous (N,) "
                         f"int32 CUDA tensor; got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    nb = -(-ids.shape[0] // block_rows)
    ranges = torch.empty((nb, 2), dtype=torch.int32, device=ids.device)
    rc = _build.load("segsum").block_ranges_launch(
        ids.data_ptr(), ranges.data_ptr(), ids.shape[0], block_rows,
        num_segments, seg_offset,
        torch.cuda.current_stream(ids.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 pre-pass launch failed: CUDA error {rc}")
    return ranges


def _plane_cols(x: torch.Tensor, d: int, c0: int, c1: int) -> torch.Tensor:
    """Raw columns [c0, c1) of each d-wide plane of x (rows, k * d), the
    planes kept in order: a domain or a carry cut to those columns."""
    k = x.shape[1] // d
    if k == 1:
        return x[:, c0:c1]
    return torch.cat([x[:, j * d + c0:j * d + c1] for j in range(k)], 1)


def segsum_policy_torch(values: torch.Tensor, ids: torch.Tensor,
                        num_segments: int, *, policy, program=None,
                        block_rows: int = 512, seg_offset: int = 0):
    """The plain version: values (N, W) in the policy's domain with N a
    multiple of ``block_rows``, ids (N,) int32 -> the carry tuple.
    Gathers contributions in batches of blocks, then folds them one
    block at a time, in order.  Every tier sums each raw column on its
    own, so a stream whose one block's contribution would pass
    ``_CONTRIB_ELEMS`` cells runs in slices of raw columns (all planes
    of each), with the same bits and bounded memory."""
    n, w = values.shape
    if n % block_rows:
        raise ValueError(f"segsum_policy_torch: N={n} must be a multiple "
                         f"of block_rows={block_rows}; pad in the caller")
    d = w // policy.parts
    cols = max(1, _CONTRIB_ELEMS // max(1, num_segments * policy.parts))
    if d > cols:
        carry = policy.init(num_segments, w, device=values.device)
        for c0 in range(0, d, cols):
            c1 = min(d, c0 + cols)
            part = segsum_policy_torch(
                _plane_cols(values, d, c0, c1).contiguous(), ids,
                num_segments, policy=policy, program=program,
                block_rows=block_rows, seg_offset=seg_offset)
            for full, got in zip(carry, part):
                cw = c1 - c0
                for j in range(full.shape[1] // d):
                    full[:, j * d + c0:j * d + c1] = got[:, j * cw:
                                                         (j + 1) * cw]
        return carry
    nb = n // block_rows
    vb = values.reshape(nb, block_rows, w)
    ib = ids.to(torch.int32).reshape(nb, block_rows)
    carry = policy.init(num_segments, w, device=values.device)
    group = max(1, _CONTRIB_ELEMS // max(1, num_segments * w))
    for g in range(0, nb, group):
        contribs = block_contrib(vb[g:g + group], ib[g:g + group],
                                 num_segments, policy, program,
                                 seg_offset=seg_offset)
        for c in contribs:
            carry = policy.update(carry, c)
    return carry


def launch_shape(policy, num_segments: int, width: int):
    """(col_tile, seg_tile, grid) of one K1 launch."""
    d = width // policy.parts
    ct = ops.col_tile_for(d)
    st = ops.seg_tile_for(num_segments, d, policy.parts,
                          float_tree=not policy.integer)
    grid = (-(-d // ct), -(-num_segments // st))
    return ct, st, grid


class WidePlan(NamedTuple):
    """The CUDA kernels of one K1 launch under the one-label schedule."""

    #: raw columns a thread owns (4: 16-byte loads; 1)
    vec: int
    #: (schedule blocks, column tiles) of the contribution kernel, one
    #: CUDA block each; None where ``block_rows == 1``
    contrib_grid: Optional[Tuple[int, int]]
    #: the (nb, W) block contributions it writes, or None
    contrib_shape: Optional[Tuple[int, int]]
    #: CUDA blocks of the ordered fold (one column a thread where it
    #: reads the contributions)
    fold_grid: int
    #: dynamic shared memory of a contribution-kernel CUDA block
    smem: int

    @property
    def kernels(self) -> int:
        return 1 if self.contrib_grid is None else 2


def wide_plan(policy, width: int, n_rows: int, block_rows: int, *,
              aligned: bool = True) -> WidePlan:
    """The one-label schedule of an (n_rows, width) domain stream:
    ``ops.WIDE_VEC`` columns a thread where the raw width d is a multiple
    of it and the stream's base is ``aligned`` on 16 bytes, else one.
    Mirrors ``wide_launch_vec`` in ``csrc/segsum.cu``."""
    d = width // policy.parts
    vec = ops.WIDE_VEC if aligned and d % ops.WIDE_VEC == 0 else 1
    if block_rows == 1:
        return WidePlan(vec, None, None, -(-d // (ops.WIDE_THREADS * vec)),
                        0)
    nb = -(-n_rows // block_rows)
    tiles = -(-width // (32 * vec))
    return WidePlan(vec, (nb, tiles), (nb, width), -(-d // ops.FOLD_THREADS),
                    ops.wide_smem_bytes(policy.integer, vec))


def launch_plan(policy, num_segments: int, width: int, n_rows: int,
                block_rows: int, *, aligned: bool = True):
    """K1's schedule for a launch, by shape alone: ``wide_plan`` for one
    label, else the label schedule's ``launch_shape``."""
    if num_segments == 1:
        return wide_plan(policy, width, n_rows, block_rows, aligned=aligned)
    return launch_shape(policy, num_segments, width)


def segsum_policy_cuda(values: torch.Tensor, ids: torch.Tensor,
                       num_segments: int, *, policy, program=None,
                       block_rows: int = 512, seg_offset: int = 0):
    """Launch K1: values (N, W) in the policy's domain, ids (N,) int32,
    both contiguous CUDA tensors -> the carry tuple.  Any N: the rows
    past N of the last block read as sentinel rows.  ``launch_plan``
    picks the schedule from the shape; either way one call is one count
    in ``LAUNCHES``."""
    global LAUNCHES
    from . import _build
    name = policy.name
    if name not in _TIERS:
        raise ValueError(f"the CUDA kernel implements the tiers "
                         f"{sorted(_TIERS)}, not {name!r}")
    if not (values.is_cuda and ids.is_cuda):
        raise ValueError("segsum_policy_cuda needs CUDA tensors; got "
                         f"values on {values.device}, ids on {ids.device}")
    if values.dtype != _IN_DTYPES[name] or ids.dtype != torch.int32:
        raise TypeError(f"{name}: values must be {_IN_DTYPES[name]} and "
                        f"ids int32; got {values.dtype}, {ids.dtype}")
    if values.ndim != 2 or ids.shape != (values.shape[0],):
        raise ValueError(f"values must be (N, W) and ids (N,); got "
                         f"{tuple(values.shape)}, {tuple(ids.shape)}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("segsum_policy_cuda needs contiguous tensors")
    n, w = values.shape
    if w % policy.parts:
        raise ValueError(f"{name}: width {w} is not a multiple of its "
                         f"{policy.parts} domain planes")
    carry = tuple(torch.empty(shape, dtype=dtype, device=values.device)
                  for shape, dtype in _carry_spec(policy, num_segments, w))
    if n == 0 or num_segments == 0 or w == 0:
        return tuple(c.zero_() for c in carry)
    lanes_form = program is not None and program.contrib == "lanes"
    nl = len(lane_bounds(block_rows, program.lanes if lanes_form else 1)) - 1
    lib = _build.load("segsum")
    # the raw handle of PyTorch's current stream: a Stream object costs
    # microseconds of host time, which a short launch pays in full
    stream = torch._C._cuda_getCurrentRawStream(values.device.index)
    plan = launch_plan(policy, num_segments, w, n, block_rows,
                       aligned=values.data_ptr() % 16 == 0)
    ptrs = [c.data_ptr() for c in carry] + [None] * (4 - len(carry))
    if isinstance(plan, WidePlan):
        contrib = None
        if plan.contrib_shape is not None:
            contrib = torch.empty(plan.contrib_shape, dtype=carry[0].dtype,
                                  device=values.device)
        rc = lib.segsum_wide_launch(
            _TIERS[name], values.data_ptr(), ids.data_ptr(),
            None if contrib is None else contrib.data_ptr(), *ptrs, n,
            block_rows, seg_offset, w // policy.parts, nl, plan.vec, stream)
        if rc != 0:
            raise RuntimeError(f"K1 launch failed for {name}: CUDA error "
                               f"{rc}")
        LAUNCHES += 1
        return carry
    ct, st, _ = plan
    chunk = 0 if policy.integer else ops.tree_rows_for(block_rows, nl)
    ranges = torch.empty((-(-n // block_rows), 2), dtype=torch.int32,
                         device=values.device)
    rc = lib.segsum_policy_launch(
        _TIERS[name], values.data_ptr(), ids.data_ptr(), ranges.data_ptr(),
        *ptrs, n, block_rows, num_segments, seg_offset, w // policy.parts,
        nl, st, ct, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed for {name}: CUDA error {rc}")
    LAUNCHES += 1
    return carry
