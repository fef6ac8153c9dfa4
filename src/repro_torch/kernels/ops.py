"""Public wrappers around K1 and the tiling rule it launches with.

``seg_tile_for`` is re-derived for Hopper.  The reference sized a label
tile so that all carries of the tile fit an 8 MiB VMEM budget, one tile
per kernel call.  On the H100 a CUDA block holds one carry cell per
thread, in registers, so the label tile of one CUDA block is bounded by
its thread count (``BLOCK_THREADS``) and by what its shared memory must
hold beside: the staged rows of a chunk and, for the integer lane form,
an int32 scratch of the tile's contributions — within the 227 KB
(232,448 bytes) a Hopper block may use.  The label tiles are the grid's
y dimension, so one launch covers the whole label space.
"""

from __future__ import annotations

import torch

#: shared memory one CUDA block may use on Hopper (227 KB)
SMEM_BYTES = 232448
#: threads of one CUDA block: one carry cell (segment, column) each
BLOCK_THREADS = 512
#: raw columns per CUDA block: 16 consecutive floats, 64-byte row pieces
COL_TILE = 16
#: rows of a schedule block staged in shared memory at a time
CHUNK_ROWS = 64


def col_tile_for(d: int) -> int:
    return max(1, min(int(d), COL_TILE))


def segsum_smem_bytes(seg_tile: int, col_tile: int, parts: int,
                      int_lanes: bool, chunk_rows: int = CHUNK_ROWS) -> int:
    """Dynamic shared memory of one CUDA block of K1 (mirrors
    ``smem_bytes`` in ``csrc/segsum.cu``): hit flags, label-present
    flags, the staged labels and values of a chunk, and the int32 lane
    scratch."""
    words = 32 + seg_tile + chunk_rows + chunk_rows * parts * col_tile
    if int_lanes:
        words += seg_tile * parts * col_tile
    return 4 * words


def seg_tile_for(num_segments: int, d: int, parts: int = 1, *,
                 int_lanes: bool = True) -> int:
    """Labels per CUDA block: as many as the block has threads for, one
    per carry cell of the ``col_tile_for(d)`` columns, halved until the
    block's shared memory fits ``SMEM_BYTES``."""
    ct = col_tile_for(d)
    tile = max(1, min(int(num_segments), BLOCK_THREADS // ct))
    while tile > 1 and segsum_smem_bytes(tile, ct, parts,
                                         int_lanes) > SMEM_BYTES:
        tile //= 2
    return tile


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, block_rows: int = 512) -> torch.Tensor:
    """JugglePAC segmented sum with the ``fast`` tier: values (N, D) or
    (N,), ids (N,) -> (num_segments, D) f32.  Launches K1 on a CUDA
    tensor; runs its plain version on a CPU tensor."""
    from ..reduce.backends import _pad_to_blocks, mask_out_of_range
    from ..reduce.policy import get_policy
    from .jugglepac_segsum import segsum_policy_cuda, segsum_policy_torch
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    values = values.to(torch.float32)
    ids = mask_out_of_range(segment_ids.to(values.device), num_segments)
    vb, ib, _ = _pad_to_blocks(values, ids, block_rows)
    impl = segsum_policy_cuda if values.is_cuda else segsum_policy_torch
    out = impl(vb.reshape(-1, values.shape[1]).contiguous(),
               ib.reshape(-1).contiguous(), num_segments,
               policy=get_policy("fast"), block_rows=block_rows)[0]
    return out[:, 0] if squeeze else out
