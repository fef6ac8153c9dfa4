"""K2, K3, K4: streaming flash-decode attention for one new token.

The Hopper counterparts of the TPU kernels in
``src/repro/kernels/flash_decode.py``, batched over requests and kv heads
(one launch covers every pair):

  * K2 ``flash_decode_cuda``          dense KV, finalized o;
  * K3 ``flash_decode_partial_cuda``  dense KV, the raw (m, l, o) partial
    of each chunk of ``per`` blocks, for ``FlashAccumulator`` to merge;
  * K4 ``flash_decode_paged_cuda``    paged KV: logical block j of
    request b is physical page ``table[b, j]`` of a shared pool.

Beside each is its plain PyTorch version (``flash_decode_torch``,
``flash_decode_partial_torch``, ``flash_decode_paged_torch``), which the
wrappers in ``ops`` run on the CPU.  The kernels never fall back: a
failed build or launch raises.  ``LAUNCHES`` counts each wrapper's
launches (K2 and K4 are three CUDA kernels a launch: the liveness
pre-pass, the split pass and the merge).

Layout (the reference's, batched): q (B, H, d); k, v (B, S, K, d), or
pages (P, ps, K, d); bias (B, S) additive, 0 or -1e30; query head h reads
kv head h // G, G = H / K.  The mask is -1e30, never -inf: a fully masked
block gives p = 1 on every row until a valid block's alpha = 0 wipes
them, so a request with no valid key returns the mean of V, not NaN.

The order is pinned once, here.

* In a schedule block of ``block`` rows: each score is
  ``pairwise_tree_sum`` over d of the products q * k, then ``* sm_scale``,
  then ``+ bias``; ``sum(p)`` and each cell of ``p @ v`` are
  ``pairwise_tree_sum`` over the block's rows; the updates are
  ``l * alpha + sum(p)`` and ``acc * alpha + p @ v``, unfused.
* K2 and K4 cut each request's stream into splits of
  ``per = max(1, split_rows // block)`` blocks (``split_rows`` defaults to
  ``SPLIT_ROWS``; it never depends on B, the card or another request).
  Inside a split the blocks fold in order from the initial registers,
  exactly K3's body.  A split is dead when every bias entry in it is
  exactly -1e30 and its request has a live split: it reads no K or V and
  is left out of the merge.  A request with no live split computes every
  split.  Liveness is read from the bias alone.
* The computed partials of a request are merged in their order by the
  pass-through pairwise tree of ``combine_flash_partials_tree``, then
  finalized as ``o / max(l, 1e-30)``.

So a request's output depends on its own row of the bias and its own
keys only (bitwise independent of the batch); where no split is dead it
is bitwise ``flash_decode(partial_chunks=C)`` with ``C = ceil(nb / per)``
whenever that gives the same ``per``; and K4 is bitwise K2 at
``block_kv = ps`` on the assembled cache.  The kernels build the same
trees (``csrc/flash_decode.cu``), with elementwise IEEE operations only,
so each agrees with its plain version to the bit on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.segmented import combine_flash_partials_tree, flash_finalize
from ..core.trees import pairwise_tree_sum
from ._build import SMEM_BYTES

NEG = -1e30

#: launches of each kernel, counted by its ``*_cuda`` function
LAUNCHES = {"dense": 0, "partial": 0, "paged": 0}

#: KV rows of one split of K2 and K4 (``per = max(1, SPLIT_ROWS // block)``
#: schedule blocks); chosen by the sweep of ``tools/decode_phases.py``
#: (1,024, 2,048, 4,096, 8,192 on an H100: 1,024 the fastest)
SPLIT_ROWS = 1024
#: K/V rows of one staged tile, and tiles in the ``cp.async`` ring
TILE_ROWS, STAGES = 32, 2
#: query rows of one CUDA block (a kv head's G rows go in groups of GMAX)
GMAX = 8
#: largest head dim, largest schedule block, most splits of one request
MAX_D, MAX_BLOCK, MAX_SPLITS = 256, 1 << 12, 1 << 16

_MODES = {"dense": 0, "partial": 1, "paged": 2}


def group_rows(g: int) -> int:
    """Query rows of one split-pass CUDA block: G cut into the fewest
    equal groups of at most GMAX rows (mirrors ``group_rows`` in
    ``csrc/flash_decode.cu``)."""
    n = -(-g // GMAX)
    while g % n:
        n += 1
    return g // n


def smem_bytes(g: int, d: int, block: int) -> int:
    """Dynamic shared memory of one split-pass CUDA block (mirrors
    ``smem_bytes`` in ``csrc/flash_decode.cu``): the ring of K/V tiles
    (row stride d rounded up to 4, plus 4), GMAX q rows (zeros past the
    group), the group's scores (row stride ``block`` rounded up to 4), and
    m, l, alpha."""
    dq = -(-d // 4) * 4
    return 4 * (STAGES * TILE_ROWS * (dq + 4) + GMAX * dq
                + group_rows(g) * (-(-block // 4) * 4) + 3 * GMAX)


def split_shape(nb: int, block: int, split_rows: int = SPLIT_ROWS):
    """(per, C): schedule blocks of a split, and splits of a request."""
    per = max(1, split_rows // block)
    return per, -(-nb // per)


def _check_dense_shapes(name, q, k, v, bias):
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4 or bias.ndim != 2:
        raise ValueError(
            f"{name}: expected q (B, H, d), k/v (B, S, K, d), bias (B, S); "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must match")
    if q.shape[2] != k.shape[3]:
        raise ValueError(f"{name}: head dim mismatch: q has d={q.shape[2]} "
                         f"but k has d={k.shape[3]}")
    if q.shape[0] != k.shape[0] or q.shape[1] % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} needs k's batch "
                         f"{k.shape[0]} and a multiple of its "
                         f"{k.shape[2]} kv heads")
    if bias.shape != (k.shape[0], k.shape[1]) or k.shape[1] == 0:
        raise ValueError(f"{name}: bias must be (B, S)=({k.shape[0]}, "
                         f"{k.shape[1]}) with S > 0; got "
                         f"{tuple(bias.shape)}")


def _check_paged_shapes(name, q, k_pages, v_pages, bias, table):
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.ndim != 4:
        raise ValueError(
            f"{name}: expected q (B, H, d), k_pages/v_pages (P, ps, K, d); "
            f"got q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
            f"v_pages {tuple(v_pages.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: k_pages {tuple(k_pages.shape)} and "
                         f"v_pages {tuple(v_pages.shape)} must match")
    if q.shape[2] != k_pages.shape[3]:
        raise ValueError(f"{name}: head dim mismatch: q has d={q.shape[2]} "
                         f"but k_pages has d={k_pages.shape[3]}")
    if q.shape[1] % k_pages.shape[2]:
        raise ValueError(f"{name}: H={q.shape[1]} query heads are not a "
                         f"multiple of K={k_pages.shape[2]} kv heads")
    if table.ndim != 2 or table.shape[0] != q.shape[0] \
            or table.shape[1] == 0:
        raise ValueError(f"{name}: page_table must be a non-empty (B, nb) "
                         f"int tensor with B={q.shape[0]}; got shape "
                         f"{tuple(table.shape)}")
    want = (q.shape[0], table.shape[1] * k_pages.shape[1])
    if tuple(bias.shape) != want:
        raise ValueError(f"{name}: bias must be (B, nb*ps)={want}; got "
                         f"{tuple(bias.shape)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _step(qg, kb, vb, bb, m, l, acc, sm_scale):
    """One schedule block: qg (B, K, G, d); kb, vb (B, R, K, d); bb (B, R);
    m, l (B, K, G); acc (B, K, G, d)."""
    kb = kb.permute(0, 2, 1, 3)[:, :, None]              # (B, K, 1, R, d)
    vb = vb.permute(0, 2, 1, 3)[:, :, None]
    s = pairwise_tree_sum(qg[:, :, :, None, :] * kb, axis=-1)
    s = s * sm_scale + bb[:, None, None, :]              # (B, K, G, R)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + pairwise_tree_sum(p, axis=-1)
    acc = acc * alpha[..., None] + pairwise_tree_sum(p[..., None] * vb,
                                                     axis=3)
    return m_new, l, acc


def _run(q, kh, rows_of, bias, blocks, block, sm_scale):
    """The online softmax over ``blocks`` from the initial registers."""
    b, h, d = q.shape
    qg = q.to(torch.float32).reshape(b, kh, h // kh, d)
    m = torch.full(qg.shape[:3], NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for j in blocks:
        kb, vb = rows_of(j)
        bb = bias[:, j * block:(j + 1) * block]
        m, l, acc = _step(qg, kb.to(torch.float32), vb.to(torch.float32),
                          bb.to(torch.float32), m, l, acc, sm_scale)
    return m, l, acc


def _dense_rows(k, v, bias, block):
    """k, v and bias padded to a whole number of blocks (zero rows, -1e30
    bias), and the block reader."""
    pad = (-k.shape[1]) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        bias = F.pad(bias.to(torch.float32), (0, pad), value=NEG)
    return (lambda j: (k[:, j * block:(j + 1) * block],
                       v[:, j * block:(j + 1) * block]),
            bias, k.shape[1] // block)


def split_liveness(bias, block: int, nb: int, per: int) -> torch.Tensor:
    """(B, C) bool: the splits a request computes.  A split is live when a
    bias entry in it is not exactly -1e30 (rows past the bias, the padding
    of the last block, count as -1e30); a request with no live split
    computes every split."""
    b, s_len = bias.shape
    c = -(-nb // per)
    masked = bias.to(torch.float32) == torch.tensor(NEG, dtype=torch.float32)
    span = per * block
    masked = F.pad(masked, (0, c * span - s_len), value=True)
    live = ~masked.reshape(b, c, span).all(-1)
    return live | ~live.any(1, keepdim=True)


def _split_merge(q, kh, rows_of, bias, nb, block, per, sm_scale):
    """The split, skip and merge rule: each computed split's partial from
    the initial registers, merged per request in the pinned tree and
    finalized -> (B, H, d)."""
    b, h, d = q.shape
    comp = split_liveness(bias, block, nb, per)
    meta = q.device.type == "meta"
    parts = {}
    for c in range(comp.shape[1]):
        # liveness is data, which a meta tensor does not hold: on meta
        # (the dry-run, shapes alone) every split is computed
        if meta or bool(comp[:, c].any()):
            m, l, acc = _run(q, kh, rows_of, bias,
                             range(c * per, min(c * per + per, nb)), block,
                             sm_scale)
            parts[c] = (m.reshape(b, h), l.reshape(b, h), acc.reshape(b, h, d))
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if meta:
        # the per-request merge is elementwise: it changes no shape and
        # no product the dry-run counts
        return out
    for bi in range(b):
        cs = [c for c in range(comp.shape[1]) if bool(comp[bi, c])]
        m, l, o = (torch.stack([parts[c][i][bi] for c in cs])
                   for i in range(3))
        _, l, o = combine_flash_partials_tree(m, l, o)
        out[bi] = flash_finalize(l, o)
    return out


def flash_decode_torch(q, k, v, bias, *, sm_scale: float,
                       block_kv: int = 512,
                       split_rows: int = SPLIT_ROWS) -> torch.Tensor:
    """The plain version of K2: q (B, H, d), k/v (B, S, K, d), bias (B, S)
    -> (B, H, d) f32, in the split, skip and merge order.  Any S: it is
    padded to a block multiple with zero rows of -1e30 bias."""
    _check_dense_shapes("flash_decode_torch", q, k, v, bias)
    rows_of, bias, nb = _dense_rows(k, v, bias, block_kv)
    per, _ = split_shape(nb, block_kv, split_rows)
    return _split_merge(q, k.shape[2], rows_of, bias, nb, block_kv, per,
                        sm_scale)


def flash_decode_partial_torch(q, k, v, bias, *, sm_scale: float,
                               block_kv: int = 512, per: int = 1):
    """The plain version of K3: the raw partial of each chunk of ``per``
    blocks -> m (C, B, H), l (C, B, H), o (C, B, H, d), o unnormalized.
    Every chunk is computed, masked or not."""
    _check_dense_shapes("flash_decode_partial_torch", q, k, v, bias)
    rows_of, bias, nb = _dense_rows(k, v, bias, block_kv)
    parts = [_run(q, k.shape[2], rows_of, bias,
                  range(c, min(c + per, nb)), block_kv, sm_scale)
             for c in range(0, nb, per)]
    b, h, d = q.shape
    return (torch.stack([p[0].reshape(b, h) for p in parts]),
            torch.stack([p[1].reshape(b, h) for p in parts]),
            torch.stack([p[2].reshape(b, h, d) for p in parts]))


def flash_decode_paged_torch(q, k_pages, v_pages, bias, page_table, *,
                             sm_scale: float,
                             split_rows: int = SPLIT_ROWS) -> torch.Tensor:
    """The plain version of K4: q (B, H, d); k_pages/v_pages (P, ps, K, d);
    bias (B, nb * ps); page_table (B, nb) int, entries clamped into
    [0, P) -> (B, H, d) f32, in the split, skip and merge order of K2 at
    ``block_kv = ps``."""
    _check_paged_shapes("flash_decode_paged_torch", q, k_pages, v_pages,
                        bias, page_table)
    ps = k_pages.shape[1]
    tab = page_table.to(torch.int64).clamp(0, k_pages.shape[0] - 1)
    nb = tab.shape[1]
    per, _ = split_shape(nb, ps, split_rows)
    return _split_merge(q, k_pages.shape[2],
                        lambda j: (k_pages[tab[:, j]], v_pages[tab[:, j]]),
                        bias, nb, ps, per, sm_scale)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _launch(mode, q, k, v, bias, table, outs, *, s_len, block, nb, per,
            pages, sm_scale):
    """One call of ``flash_decode_launch``: the split pass over C =
    ceil(nb / per) splits writing (m, l, o) partials, and for K2 and K4
    the liveness pre-pass before it and the merge after it."""
    from . import _build
    tensors = [q, k, v, bias] + ([table] if table is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the flash-decode kernels need CUDA tensors; got "
                         + ", ".join(str(t.device) for t in tensors))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in (q, k, v, bias)):
        raise ValueError("the flash-decode kernels need contiguous float32 "
                         "q, k, v and bias")
    if table is not None and (table.dtype != torch.int32
                              or not table.is_contiguous()):
        raise ValueError("the page table must be a contiguous int32 tensor")
    b, h, d = q.shape
    kheads = k.shape[2]
    g = h // kheads
    c = -(-nb // per)
    if d > MAX_D:
        raise ValueError(f"the flash-decode kernels take d <= {MAX_D}; "
                         f"got d={d}")
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"the flash-decode kernels take 0 < block <= "
                         f"{MAX_BLOCK}; got {block}")
    if c > MAX_SPLITS:
        raise ValueError(f"the flash-decode kernels take at most "
                         f"{MAX_SPLITS} splits a request; got {c}")
    if smem_bytes(g, d, block) > SMEM_BYTES:
        raise ValueError(f"flash decode: G={g}, d={d}, block={block} "
                         f"needs more than {SMEM_BYTES} bytes of shared "
                         "memory per CUDA block")
    vec4 = d % 4 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    out, live = outs.get("out"), None
    if mode == "partial":
        m, l, o = outs["m"], outs["l"], outs["o"]
    else:                                   # scratch of the split pass
        m = torch.empty((c, b, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        o = torch.empty((c, b, h, d), dtype=torch.float32, device=q.device)
        live = torch.empty((b, c), dtype=torch.int32, device=q.device)
    lib = _build.load("flash_decode")
    rc = lib.flash_decode_launch(
        _MODES[mode], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), None if table is None else table.data_ptr(),
        None if live is None else live.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), None if out is None else out.data_ptr(),
        b, h, kheads, d, s_len, block, nb, per, pages, int(vec4),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash-decode kernel ({mode}) launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES[mode] += 1


def flash_decode_cuda(q, k, v, bias, *, sm_scale: float,
                      block_kv: int = 512,
                      split_rows: int = SPLIT_ROWS) -> torch.Tensor:
    """Launch K2: q (B, H, d), k/v (B, S, K, d), bias (B, S), all f32 and
    contiguous on a CUDA device -> (B, H, d) f32.  Any S: rows past S read
    as zero rows of -1e30 bias."""
    _check_dense_shapes("flash_decode_cuda", q, k, v, bias)
    nb = -(-k.shape[1] // block_kv)
    per, _ = split_shape(nb, block_kv, split_rows)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("dense", q, k, v, bias, None, {"out": out}, s_len=k.shape[1],
            block=block_kv, nb=nb, per=per, pages=0, sm_scale=sm_scale)
    return out


def flash_decode_partial_cuda(q, k, v, bias, *, sm_scale: float,
                              block_kv: int = 512, per: int = 1):
    """Launch K3: the raw partial of each chunk of ``per`` blocks -> m
    (C, B, H), l (C, B, H), o (C, B, H, d), C = ceil(nb / per)."""
    _check_dense_shapes("flash_decode_partial_cuda", q, k, v, bias)
    if per < 1:
        raise ValueError(f"per must be positive, got {per}")
    nb = -(-k.shape[1] // block_kv)
    c = -(-nb // per)
    b, h, d = q.shape
    m = torch.empty((c, b, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((c, b, h, d), dtype=torch.float32, device=q.device)
    _launch("partial", q, k, v, bias, None, {"m": m, "l": l, "o": o},
            s_len=k.shape[1], block=block_kv, nb=nb, per=per, pages=0,
            sm_scale=sm_scale)
    return m, l, o


def flash_decode_paged_cuda(q, k_pages, v_pages, bias, page_table, *,
                            sm_scale: float,
                            split_rows: int = SPLIT_ROWS) -> torch.Tensor:
    """Launch K4: q (B, H, d); k_pages/v_pages (P, ps, K, d); bias
    (B, nb * ps); page_table (B, nb) int32, entries clamped into [0, P) by
    the kernel -> (B, H, d) f32."""
    _check_paged_shapes("flash_decode_paged_cuda", q, k_pages, v_pages,
                        bias, page_table)
    nb, ps = page_table.shape[1], k_pages.shape[1]
    per, _ = split_shape(nb, ps, split_rows)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("paged", q, k_pages, v_pages, bias, page_table, {"out": out},
            s_len=nb * ps, block=ps, nb=nb, per=per,
            pages=k_pages.shape[0], sm_scale=sm_scale)
    return out
