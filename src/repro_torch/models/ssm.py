"""The Mamba selective state-space block, with its O(1) decode state.

The PyTorch counterpart of the reference's ``repro.models.ssm`` (Mamba
only; mLSTM and sLSTM are not ported yet).  Mamba is a streaming
accumulator in the JugglePAC sense: a running state ``h`` (B, di,
d_state) is updated by a stream of inputs in a fixed order,

    h_t = exp(dt_t * -a) * h_{t-1} + (dt_t * x_t) * b_t,
    y_t = sum_n h_t[:, n] * c_t[n],

so a decode step carries ``MambaState(h, conv)`` (the last d_conv - 1
rows of the conv input) and never grows with the sequence.

Train and prefill run the whole prompt in chunks of ``cfg.scan_chunk``
rows, the state carried from one chunk to the next, as the reference's
``lax.scan`` does.  Inside a chunk the recurrence is an inclusive scan
of the affine maps (decay_t, drive_t) under the combine

    (l, r) -> (r0 * l0, r0 * l1 + r1),    l the earlier element,

then h = acum * h0 + bcum.  The reference's ``lax.associative_scan`` has
its own combination tree, which torch cannot reproduce; the port's order
is a doubling (Hillis-Steele) scan: log2(Q) elementwise steps k = 1, 2,
4, ..., at step k every row t >= k combining the row t - k on the left
with row t on the right (``_doubling_scan``).  Row t's tree depends on t
alone, never on the chunk's length, so a ragged last chunk is sliced
rather than padded: padding rows (dt = 0: decay 1, drive 0) would leave
every real row and the final state bitwise as they are.  The two trees
agree to a few float32 ulps times their depth (``tests/
test_torch_mamba.py``).

Dtypes follow the reference: ``in_proj``'s output in the model's dtype;
the causal depthwise conv in float32, its taps in order from 0.0
(``_depthwise_conv``, the same chain for prefill and for decode's
window); the gates' input cast down to the model's dtype; ``dt_proj``, the
scan, ``y`` and the gate product in float32, with no TF32 (``matmul_f32``
on float32 operands is a plain float32 ``torch.matmul``; the state
contractions are elementwise products summed over d_state); ``out_proj``'s
input in the model's dtype.  ``dt_bias``, ``a_log`` and ``d_skip`` are
float32 parameters whatever the model's dtype.

Decode (s == 1) writes the new state in place into the ``MambaState`` it
is given (the layer's view of the stacked caches, as attention writes its
cache rows); rows where ``active`` is False keep ``h`` and ``conv``
bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import MambaCfg, ModelConfig
from .layers import _param, dense, matmul_f32


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, di, d_state) float32
    conv: torch.Tensor     # (B, d_conv - 1, di): the last conv inputs


class Mamba(nn.Module):
    """The weights of one Mamba block, with the reference's leaf names and
    (d_in, d_out) layout (``mamba_init``): di = expand * d_model, dt_rank
    = ceil(d_model / 16)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.m = m = cfg.mamba or MambaCfg()
        d = cfg.d_model
        di = m.expand * d
        dt_rank = max(1, math.ceil(d / 16))
        f32 = torch.float32
        self.in_proj = _param((d, 2 * di), dtype, device)
        self.conv_w = _param((m.d_conv, di), dtype, device)
        self.conv_b = _param((di,), dtype, device)
        self.x_proj = _param((di, dt_rank + 2 * m.d_state), dtype, device)
        self.dt_proj = _param((dt_rank, di), dtype, device)
        self.dt_bias = _param((di,), f32, device)
        self.a_log = _param((di, m.d_state), f32, device)
        self.d_skip = _param((di,), f32, device)
        self.out_proj = _param((di, d), dtype, device)

    def forward(self, x, *, positions=None, mode: str = "train",
                cache: Optional[MambaState] = None,
                active: Optional[torch.Tensor] = None, rope=None):
        """``positions`` and ``rope`` are ignored (the signature is
        ``GQA``'s and ``MLA``'s)."""
        return mamba_apply(self, x, self.m, mode=mode, state=cache,
                           active=active, chunk=self.cfg.scan_chunk)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _depthwise_conv(xpad, conv_w, conv_b):
    """Causal depthwise conv in float32: xpad (B, S + K - 1, di) -> (B, S,
    di), the K taps added in order onto 0.0, then ``conv_b``."""
    k = conv_w.shape[0]
    s = xpad.shape[1] - (k - 1)
    w = conv_w.float()
    acc = 0.0
    for i in range(k):
        acc = acc + xpad[:, i:i + s].float() * w[i]
    return acc + conv_b.float()


def _mamba_gates(p: Mamba, xc, m: MambaCfg):
    """xc (B, L, di) in the model's dtype -> dt (B, L, di), b and c (B, L,
    d_state), float32."""
    dt_rank = p.dt_proj.shape[0]
    proj = dense(p.x_proj, xc).float()
    dt, b, c = torch.split(proj, [dt_rank, m.d_state, m.d_state], dim=-1)
    dt = _softplus(matmul_f32(dt, p.dt_proj) + p.dt_bias)
    return dt, b, c


def _doubling_scan(a, b):
    """Inclusive scan along axis 1 of the affine maps (a_t, b_t) under
    (l, r) -> (r0 * l0, r0 * l1 + r1): at step k = 1, 2, 4, ... < Q every
    row t >= k takes row t - k on its left.  -> (acum, bcum)."""
    q = a.shape[1]
    k = 1
    while k < q:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _mamba_scan_chunk(h0, xin, dt, b, c, a):
    """One chunk: h0 (B, di, n); xin, dt (B, Q, di); b, c (B, Q, n); a
    (di, n) -> (y (B, Q, di), the state after the chunk's last row)."""
    decay = torch.exp(dt[..., None] * (-a))                  # (B,Q,di,n)
    drive = (dt * xin)[..., None] * b[:, :, None, :]         # (B,Q,di,n)
    acum, bcum = _doubling_scan(decay, drive)
    h = acum * h0[:, None] + bcum
    y = (h * c[:, :, None, :]).sum(-1)
    return y, h[:, -1]


def mamba_scan(xc, dt, b, c, a, chunk: int):
    """The whole stream in chunks of ``chunk`` rows from a zero state, the
    state carried across: -> (y (B, S, di), final h (B, di, n))."""
    bsz, s, di = xc.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=xc.device)
    ys = []
    for start in range(0, s, chunk):
        rows = slice(start, start + chunk)
        y, h = _mamba_scan_chunk(h, xc[:, rows], dt[:, rows], b[:, rows],
                                 c[:, rows], a)
        ys.append(y)
    return torch.cat(ys, dim=1), h.clone()


def mamba_apply(p: Mamba, x, m: MambaCfg, *, mode: str = "train",
                state: Optional[MambaState] = None,
                active: Optional[torch.Tensor] = None, chunk: int = 512):
    """x (B, S, d) -> (y (B, S, d), state): None in train mode, the
    ``MambaState`` after the prompt in prefill, ``state`` itself (written
    in place) in decode."""
    bsz, s, _ = x.shape
    di = p.conv_b.shape[0]
    dconv = p.conv_w.shape[0]
    xi, z = dense(p.in_proj, x).split(di, dim=-1)            # (B,S,di)
    a = torch.exp(p.a_log)

    if mode in ("train", "prefill"):
        xpad = torch.cat([xi.new_zeros((bsz, dconv - 1, di)), xi], dim=1)
        xc = F.silu(_depthwise_conv(xpad, p.conv_w, p.conv_b))
        dt, b, c = _mamba_gates(p, xc.to(x.dtype), m)
        y, h_n = mamba_scan(xc, dt, b, c, a, chunk)
        y = y + xc * p.d_skip
        out = dense(p.out_proj, (y * F.silu(z.float())).to(x.dtype))
        new_state = None
        if mode == "prefill":
            new_state = MambaState(h=h_n, conv=xpad[:, -(dconv - 1):]
                                   .contiguous())
        return out, new_state

    if mode != "decode":
        raise ValueError(mode)
    if state is None:
        raise ValueError("mamba_apply: mode='decode' needs a MambaState")
    if s != 1:
        raise ValueError(f"mamba_apply: decode takes one token a row, got "
                         f"s={s} (prompts prefill whole)")
    window = torch.cat([state.conv, xi.to(state.conv.dtype)], dim=1)
    xc = F.silu(_depthwise_conv(window, p.conv_w, p.conv_b))  # (B,1,di)
    dt, b, c = _mamba_gates(p, xc.to(x.dtype), m)
    decay = torch.exp(dt[:, 0, :, None] * (-a))              # (B,di,n)
    drive = (dt[:, 0] * xc[:, 0])[..., None] * b[:, 0, None, :]
    h = decay * state.h + drive
    y = (h * c[:, 0, None, :]).sum(-1) + xc[:, 0] * p.d_skip
    out = dense(p.out_proj,
                (y[:, None] * F.silu(z.float())).to(x.dtype))
    conv = window[:, 1:]
    if active is not None:
        keep = active.reshape(-1, 1, 1)
        h = torch.where(keep, h, state.h)
        conv = torch.where(keep, conv, state.conv)
    state.h.copy_(h)
    state.conv.copy_(conv)
    return out, state


__all__ = ["MambaState", "Mamba", "mamba_apply", "mamba_scan"]
