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
failed build or launch raises.  ``LAUNCHES`` counts each kernel's
launches.

Layout (the reference's, batched): q (B, H, d); k, v (B, S, K, d), or
pages (P, ps, K, d); bias (B, S) additive, 0 or -1e30; query head h reads
kv head h // G, G = H / K.  The mask is -1e30, never -inf: a fully masked
block gives p = 1 on every row until a valid block's alpha = 0 wipes
them, so a request with no valid key returns the mean of V, not NaN.

The in-block order is pinned once, here: each score is
``pairwise_tree_sum`` over d of the products q * k, then ``* sm_scale``,
then ``+ bias``; ``sum(p)`` and each cell of ``p @ v`` are
``pairwise_tree_sum`` over the block's rows; the updates are
``l * alpha + sum(p)`` and ``acc * alpha + p @ v``, unfused.  The kernels
build the same trees (``csrc/flash_decode.cu``), with elementwise IEEE
operations only, so each agrees with its plain version to the bit on the
card (PERF.md records where ``expf`` and ``torch.exp`` could part).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.segmented import flash_finalize
from ..core.trees import pairwise_tree_sum
from ._build import SMEM_BYTES

NEG = -1e30

#: launches of each kernel, counted by its ``*_cuda`` function
LAUNCHES = {"dense": 0, "partial": 0, "paged": 0}

#: threads of one CUDA block, each owning up to MAX_CELLS (g, c) cells
THREADS, MAX_CELLS = 512, 4
#: most K/V rows staged in shared memory at a time (a multiple of 8)
CHUNK_ROWS = 64
#: most rows of one schedule block (the kernel's subtree stack depth)
MAX_BLOCK = 1 << 13

_MODES = {"dense": 0, "partial": 1, "paged": 2}


def smem_bytes(g: int, d: int, block: int, chunk: int) -> int:
    """Dynamic shared memory of one CUDA block (mirrors ``smem_bytes`` in
    ``csrc/flash_decode.cu``): q, the block's scores, the K/V tile, and
    m, l, alpha."""
    return 4 * (g * d + g * block + chunk * (d + 1) + 3 * g)


def chunk_rows_for(g: int, d: int, block: int) -> int:
    """K/V rows staged at a time: up to CHUNK_ROWS, a multiple of 8, so
    that the CUDA block's shared memory fits SMEM_BYTES."""
    chunk = CHUNK_ROWS
    while chunk > 8 and smem_bytes(g, d, block, chunk) > SMEM_BYTES:
        chunk -= 8
    if smem_bytes(g, d, block, chunk) > SMEM_BYTES:
        raise ValueError(f"flash decode: G={g}, d={d}, block={block} "
                         f"needs more than {SMEM_BYTES} bytes of shared "
                         "memory per CUDA block")
    return chunk


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


def flash_decode_torch(q, k, v, bias, *, sm_scale: float,
                       block_kv: int = 512) -> torch.Tensor:
    """The plain version of K2: q (B, H, d), k/v (B, S, K, d), bias (B, S)
    -> (B, H, d) f32.  Any S: it is padded to a block multiple with zero
    rows of -1e30 bias."""
    _check_dense_shapes("flash_decode_torch", q, k, v, bias)
    rows_of, bias, nb = _dense_rows(k, v, bias, block_kv)
    _, l, acc = _run(q, k.shape[2], rows_of, bias, range(nb), block_kv,
                     sm_scale)
    return flash_finalize(l, acc).reshape(q.shape)


def flash_decode_partial_torch(q, k, v, bias, *, sm_scale: float,
                               block_kv: int = 512, per: int = 1):
    """The plain version of K3: the raw partial of each chunk of ``per``
    blocks -> m (C, B, H), l (C, B, H), o (C, B, H, d), o unnormalized."""
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
                             sm_scale: float) -> torch.Tensor:
    """The plain version of K4: q (B, H, d); k_pages/v_pages (P, ps, K, d);
    bias (B, nb * ps); page_table (B, nb) int, entries clamped into
    [0, P) -> (B, H, d) f32."""
    _check_paged_shapes("flash_decode_paged_torch", q, k_pages, v_pages,
                        bias, page_table)
    ps = k_pages.shape[1]
    tab = page_table.to(torch.int64).clamp(0, k_pages.shape[0] - 1)
    _, l, acc = _run(q, k_pages.shape[2],
                     lambda j: (k_pages[tab[:, j]], v_pages[tab[:, j]]),
                     bias, range(tab.shape[1]), ps, sm_scale)
    return flash_finalize(l, acc).reshape(q.shape)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _launch(mode, q, k, v, bias, table, outs, *, s_len, block, nb, per,
            pages, sm_scale):
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
    if g * d > THREADS * MAX_CELLS:
        raise ValueError(f"the flash-decode kernels take G*d <= "
                         f"{THREADS * MAX_CELLS}; got G={g}, d={d}")
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"the flash-decode kernels take 0 < block <= "
                         f"{MAX_BLOCK}; got {block}")
    vec4 = d % 4 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    o, m, l = outs
    lib = _build.load("flash_decode")
    rc = lib.flash_decode_launch(
        _MODES[mode], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), None if table is None else table.data_ptr(),
        o.data_ptr(), None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(), b, h, kheads, d, s_len, block,
        nb, per, pages, chunk_rows_for(g, d, block), int(vec4),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash-decode kernel ({mode}) launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES[mode] += 1


def flash_decode_cuda(q, k, v, bias, *, sm_scale: float,
                      block_kv: int = 512) -> torch.Tensor:
    """Launch K2: q (B, H, d), k/v (B, S, K, d), bias (B, S), all f32 and
    contiguous on a CUDA device -> (B, H, d) f32.  Any S: rows past S read
    as zero rows of -1e30 bias."""
    _check_dense_shapes("flash_decode_cuda", q, k, v, bias)
    nb = -(-k.shape[1] // block_kv)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("dense", q, k, v, bias, None, (o, None, None), s_len=k.shape[1],
            block=block_kv, nb=nb, per=nb, pages=0, sm_scale=sm_scale)
    return o


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
    _launch("partial", q, k, v, bias, None, (o, m, l), s_len=k.shape[1],
            block=block_kv, nb=nb, per=per, pages=0, sm_scale=sm_scale)
    return m, l, o


def flash_decode_paged_cuda(q, k_pages, v_pages, bias, page_table, *,
                            sm_scale: float) -> torch.Tensor:
    """Launch K4: q (B, H, d); k_pages/v_pages (P, ps, K, d); bias
    (B, nb * ps); page_table (B, nb) int32, entries clamped into [0, P) by
    the kernel -> (B, H, d) f32."""
    _check_paged_shapes("flash_decode_paged_cuda", q, k_pages, v_pages,
                        bias, page_table)
    nb, ps = page_table.shape[1], k_pages.shape[1]
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("paged", q, k_pages, v_pages, bias, page_table, (o, None, None),
            s_len=nb * ps, block=ps, nb=nb, per=nb,
            pages=k_pages.shape[0], sm_scale=sm_scale)
    return o
