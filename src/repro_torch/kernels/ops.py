"""Public wrappers around the kernels, and K1's tiling rule.

Each wrapper runs on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.resolve_device``): it moves its inputs
there, and on a CUDA device it launches its kernel, on the CPU it runs the
kernel's plain version.  Without CUDA, ``device=None`` raises.

  * ``segment_sum``         K1 with the ``fast`` tier;
  * ``intac_accum``         K5, exact fixed-point column sums;
  * ``flash_decode``        K2 (or K3 with ``partial_chunks``), GQA decode
    attention with length and sliding-window masks;
  * ``flash_decode_paged``  K4, the same over a paged KV pool;
  * ``length_bias``         the decode kernels' length/window mask.

``seg_tile_for`` is re-derived for Hopper.  The reference sized a label
tile so that all carries of the tile fit an 8 MiB VMEM budget, one tile
per kernel call.  On the H100 a CUDA block holds one carry cell per
thread, in registers, so the label tile of one CUDA block is bounded by
its thread count and by what its shared memory must hold beside: for the
float tiers a chunk's pairwise tree (``tree_rows_for``), with
``BLOCK_THREADS`` threads; for the integer tiers two int32 scratch
buffers of the tile's contribution, with ``INT_THREADS`` threads, fewer
so that several CUDA blocks share an SM — within the 227 KB (232,448
bytes) a Hopper block may use.  The label tiles are the grid's y
dimension, so one launch covers the whole label space.

A launch with one label takes K1's one-label schedule instead
(``jugglepac_segsum.wide_plan``): ``WIDE_THREADS`` threads a CUDA block,
``WIDE_VEC`` columns a thread where the width allows, and, where a
schedule block holds more than one row, a contribution kernel whose
shared memory ``wide_smem_bytes`` gives.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..core.intac import LIMB_SHIFT
from ._build import SMEM_BYTES
# Both kernel modules load here, before the package exports the wrappers
# of the same names (``repro_torch.kernels.intac_accum`` is this module's
# function, as in the reference package).
from .flash_decode import (NEG, flash_decode_cuda, flash_decode_paged_cuda,
                           flash_decode_paged_torch,
                           flash_decode_partial_cuda,
                           flash_decode_partial_torch, flash_decode_torch)
from .intac_accum import intac_accum_cuda, intac_accum_torch

#: threads of one CUDA block of the float tiers: one carry cell
#: (segment, column) each
BLOCK_THREADS = 512
#: threads of one CUDA block of the integer tiers: one carry cell each
#: while folding, a share of a schedule block's rows while summing it
INT_THREADS = 256
#: raw columns per CUDA block: 16 consecutive floats, 64-byte row pieces
COL_TILE = 16
#: padded rows of a float tier's tree chunk, at most (``TREE_ROWS`` in
#: ``csrc/segsum.cu``)
TREE_ROWS = 512
#: rows of a float tier's tree a thread sums in registers (``GROUP_ROWS``
#: in ``csrc/segsum.cu``)
GROUP_ROWS = 16
#: threads of a CUDA block of the one-label schedule's contribution
#: kernel, and of its fold where B = 1
WIDE_THREADS = 256
#: raw columns a thread of the one-label schedule owns: one 16-byte load
#: a row a plane, where the width and the base address allow
WIDE_VEC = 4
#: threads of a CUDA block of the one-label fold where it reads block
#: contributions (one column each)
FOLD_THREADS = 64


def col_tile_for(d: int) -> int:
    return max(1, min(int(d), COL_TILE))


def tree_rows_for(block_rows: int, lanes: int = 1) -> int:
    """Rows of a float tier's tree chunk: the longest lane of
    ``lane_bounds(block_rows, lanes)`` padded to a power of two, at most
    ``TREE_ROWS``."""
    nl = max(1, min(int(lanes), int(block_rows)))
    longest = -(-int(block_rows) // nl)
    return min(1 << max(0, (longest - 1).bit_length()), TREE_ROWS)


def segsum_smem_bytes(seg_tile: int, col_tile: int, parts: int,
                      tree_rows: int = 0) -> int:
    """Dynamic shared memory of one CUDA block of K1 (mirrors
    ``smem_bytes`` in ``csrc/segsum.cu``): 32 words of touched-block
    bits, then for the float tiers (``tree_rows`` > 0) the label-present
    flags and a chunk's tree of ``2 * tree_rows - 1`` nodes, one label
    and ``col_tile`` values each; for the integer tiers two int32
    scratch buffers of ``seg_tile x parts x col_tile`` cells."""
    if tree_rows:
        return 4 * (32 + seg_tile + (2 * tree_rows - 1) * (1 + col_tile))
    return 4 * (32 + 2 * seg_tile * parts * col_tile)


def wide_smem_bytes(integer: bool, vec: int) -> int:
    """Dynamic shared memory of one CUDA block of the one-label
    schedule's contribution kernel (mirrors ``wide_smem_bytes`` in
    ``csrc/segsum.cu``), for its 32 * ``vec`` columns: for the float tiers
    a tree chunk's group sums, ``TREE_ROWS / GROUP_ROWS`` rows; for the
    integer tiers one partial sum per warp."""
    rows = WIDE_THREADS // 32 if integer else TREE_ROWS // GROUP_ROWS
    return 4 * rows * 32 * vec


def seg_tile_for(num_segments: int, d: int, parts: int = 1, *,
                 float_tree: bool = False) -> int:
    """Labels per CUDA block: one per carry cell of the
    ``col_tile_for(d)`` columns for each of the block's threads
    (``BLOCK_THREADS`` for the float tiers, ``INT_THREADS`` for the
    integer ones), halved until the block's shared memory fits
    ``SMEM_BYTES`` (for the float tiers, with a tree chunk of
    ``TREE_ROWS``, the largest any block size gives)."""
    ct = col_tile_for(d)
    threads = BLOCK_THREADS if float_tree else INT_THREADS
    tree = TREE_ROWS if float_tree else 0
    tile = max(1, min(int(num_segments), threads // ct))
    while tile > 1 and segsum_smem_bytes(tile, ct, parts,
                                         tree) > SMEM_BYTES:
        tile //= 2
    return tile


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, block_rows: int = 512,
                device=None) -> torch.Tensor:
    """JugglePAC segmented sum with the ``fast`` tier: values (N, D) or
    (N,), ids (N,) -> (num_segments, D) f32.  Launches K1 on a CUDA
    device; runs its plain version on the CPU."""
    from ..reduce.backends import _pad_to_blocks, mask_out_of_range
    from ..reduce.policy import get_policy
    from .jugglepac_segsum import segsum_policy_cuda, segsum_policy_torch
    dev = resolve_device(device)
    values = torch.as_tensor(values, device=dev)
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    values = values.to(torch.float32)
    ids = mask_out_of_range(torch.as_tensor(segment_ids, device=dev),
                            num_segments)
    vb, ib, _ = _pad_to_blocks(values, ids, block_rows)
    impl = segsum_policy_cuda if dev.type == "cuda" else segsum_policy_torch
    out = impl(vb.reshape(-1, values.shape[1]).contiguous(),
               ib.reshape(-1).contiguous(), num_segments,
               policy=get_policy("fast"), block_rows=block_rows)[0]
    return out[:, 0] if squeeze else out


def intac_accum(values: torch.Tensor, scale, *, block_rows: int = 256,
                device=None) -> torch.Tensor:
    """Exact fixed-point accumulation: values (N, D), scale () -> int32
    limbs (2, D); resolve with ``ref.limbs_to_float``.  N <= 2^15 keeps
    each limb's sum inside int32 (with |x| * scale < 2^30)."""
    dev = resolve_device(device)
    values = torch.as_tensor(values, device=dev)
    n, _ = values.shape
    if n > (1 << LIMB_SHIFT):
        raise ValueError("intac_accum: N > 2^15 would risk limb overflow; "
                         "split the stream and limb_merge the results")
    values = values.to(torch.float32).contiguous()
    if dev.type == "cuda":
        return intac_accum_cuda(values, scale, block_rows=block_rows)
    return intac_accum_torch(values, scale)


def length_bias(kv_len, s_len: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """The decode kernels' (B, S) f32 additive mask: 0 where
    pos < kv_len (and, with a window, pos >= kv_len - window), -1e30
    elsewhere."""
    kv_len = torch.as_tensor(kv_len, device=device)[:, None]
    pos = torch.arange(s_len, device=kv_len.device)[None, :]
    valid = pos < kv_len
    if window is not None:
        valid &= pos >= kv_len - window
    return torch.where(valid, 0.0, NEG).to(torch.float32).contiguous()


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len, *, sm_scale: float, window: Optional[int] = None,
                 block_kv: int = 512, partial_chunks: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """Batched GQA decode attention for one new token.

    q (B, H, d); k, v (B, S, K, d) with H = K * G; kv_len (B,) valid
    lengths.  ``window``: sliding-window size (valid positions are
    ``pos >= kv_len - window``).  ``partial_chunks``: split the KV stream
    into chunks of ceil(nb / partial_chunks) blocks, each emitting a raw
    (m, l, o) partial (K3), merged by ``FlashAccumulator`` in the fixed
    ``merge_tree``.  Without it, K2 runs the split, skip and merge order
    of ``flash_decode.py``: the same result bitwise where no split of
    ``SPLIT_ROWS`` rows is masked whole and the chunks agree.  Returns
    (B, H, d) f32.
    """
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev).to(torch.float32).contiguous()
               for t in (q, k, v))
    bias = length_bias(kv_len, k.shape[1], window, dev)
    cuda = dev.type == "cuda"
    if partial_chunks is not None and partial_chunks > 1:
        from ..reduce.accumulator import FlashAccumulator, merge_tree
        nb = -(-k.shape[1] // block_kv)
        per = -(-nb // partial_chunks)
        run = flash_decode_partial_cuda if cuda \
            else flash_decode_partial_torch
        m, l, o = run(q, k, v, bias, sm_scale=sm_scale, block_kv=block_kv,
                      per=per)
        acc = FlashAccumulator()
        return acc.finalize(merge_tree(acc, [(m[c], l[c], o[c])
                                             for c in range(m.shape[0])]))
    run = flash_decode_cuda if cuda else flash_decode_torch
    return run(q, k, v, bias, sm_scale=sm_scale, block_kv=block_kv)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_tables, kv_len, *,
                       sm_scale: float, device=None) -> torch.Tensor:
    """Paged-gather GQA decode attention for one new token.

    q (B, H, d); k_pages, v_pages (P, ps, K, d) — the shared pool
    (``serve.PagedKVPool``); page_tables (B, nb) int32, ``FREE_PAGE``
    padded (padded entries read page 0 and are masked by the length
    bias); kv_len (B,) valid lengths.  Returns (B, H, d) f32, bitwise
    equal to ``flash_decode`` with ``block_kv=ps`` on the logically
    assembled cache.
    """
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(
            "flash_decode_paged: expected q (B, H, d) and k_pages/v_pages "
            f"(P, ps, K, d); got q {tuple(q.shape)}, k_pages "
            f"{tuple(k_pages.shape)}")
    page_tables = torch.as_tensor(page_tables)
    if page_tables.ndim != 2 or page_tables.shape[0] != q.shape[0]:
        raise ValueError(
            "flash_decode_paged: page_tables must be (B, nb) matching "
            f"q's batch {q.shape[0]}; got {tuple(page_tables.shape)}")
    dev = resolve_device(device)
    q, k_pages, v_pages = (
        torch.as_tensor(t, device=dev).to(torch.float32).contiguous()
        for t in (q, k_pages, v_pages))
    tables = page_tables.to(device=dev, dtype=torch.int32).contiguous()
    bias = length_bias(kv_len, tables.shape[1] * k_pages.shape[1],
                       device=dev)
    run = flash_decode_paged_cuda if dev.type == "cuda" \
        else flash_decode_paged_torch
    return run(q, k_pages, v_pages, bias, tables, sm_scale=sm_scale)
