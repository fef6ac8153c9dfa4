"""The recurrent blocks: Mamba, mLSTM and sLSTM, each with its O(1)
decode state.

The PyTorch counterpart of the reference's ``repro.models.ssm``.  Mamba
is a streaming accumulator in the JugglePAC sense: a running state ``h`` (B, di,
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
bitwise.  The xLSTM blocks below do the same with their own states.

mLSTM (xLSTM's matrix memory, ``MLSTM``) carries ``MLSTMState(c, n, m,
conv)`` per head: a (p, p) memory ``c``, a normalizer ``n`` and a log
stabilizer ``m``, updated by exponential input and forget gates,

    m_t = max(logf_t + m_{t-1}, logi_t),
    c_t = exp(logf_t + m_{t-1} - m_t) c_{t-1} + exp(logi_t - m_t) v_t k_t^T,
    h_t = c_t q_t / max(|n_t . q_t|, exp(-m_t))

(``mlstm_step``, decode's one step).  Train and prefill run the
reference's chunkwise stabilized parallel form (``_mlstm_chunk``) over
chunks of ``cfg.scan_chunk`` rows with (c, n, m) carried, from m = 0.
Its gate prefix sum F_t = logf_1 + ... + logf_t is the doubling scan's
order again (``_prefix_sum``: row t's sum depends on t alone, the same
elementwise adds on the CPU and on the card), where the reference has
XLA's ``cumsum``; its running max is ``torch.cummax``, exact.  A ragged
last chunk is sliced where the reference pads it (q, k, v with 0, logi
with -1e30, logf with 0): padding rows add 0 to F, so F, the running max
and every real row's weights are the sliced chunk's, and their weights
exp(-1e30 - ...) = 0 add nothing to the state; only the contractions'
lengths differ, by terms that are exact zeros.  The gates come from a
float32 ``w_if`` on the model's-dtype conv output and are rounded to the
model's dtype before they are widened (``dense``), as the reference
rounds them; ``v`` comes from the conv's input, not its output.

sLSTM (scalar memory with recurrent weights, ``SLSTM``) is sequential by
nature: train and prefill run ``slstm_cell`` token by token, as the
reference's ``lax.scan``, and decode runs it once.  Its state
``SLSTMState(c, n, h, m)`` starts with n at ones; h is held rounded to the
model's dtype (the reference keeps it in that dtype), so a float32 cache
holds exactly what the reference's holds and ``w_h`` reads the same
operand.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import MambaCfg, ModelConfig, XLSTMCfg
from .layers import NEG, _param, dense, matmul_f32, rmsnorm

#: the reference's default chunk of the mLSTM scan (the model passes
#: ``cfg.scan_chunk``)
CHUNK = 128


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


def _keep_inactive(state, new, active):
    """Write ``new`` (a state of ``state``'s type) into ``state`` in place,
    rows where ``active`` is False keeping their old values bitwise."""
    for old, val in zip(state, new):
        if active is not None:
            keep = active.reshape((-1,) + (1,) * (old.ndim - 1))
            val = torch.where(keep, val.to(old.dtype), old)
        old.copy_(val)
    return state


def _decode_check(name, state, s):
    if state is None:
        raise ValueError(f"{name}: mode='decode' needs a state")
    if s != 1:
        raise ValueError(f"{name}: decode takes one token a row, got "
                         f"s={s} (prompts prefill whole)")


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
    _decode_check("mamba_apply", state, s)
    window = torch.cat([state.conv, xi.to(state.conv.dtype)], dim=1)
    xc = F.silu(_depthwise_conv(window, p.conv_w, p.conv_b))  # (B,1,di)
    dt, b, c = _mamba_gates(p, xc.to(x.dtype), m)
    decay = torch.exp(dt[:, 0, :, None] * (-a))              # (B,di,n)
    drive = (dt[:, 0] * xc[:, 0])[..., None] * b[:, 0, None, :]
    h = decay * state.h + drive
    y = (h * c[:, 0, None, :]).sum(-1) + xc[:, 0] * p.d_skip
    out = dense(p.out_proj,
                (y[:, None] * F.silu(z.float())).to(x.dtype))
    return out, _keep_inactive(state, (h, window[:, 1:]), active)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory): chunkwise stabilized parallel form
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, p, p) float32: rows index v, columns k
    n: torch.Tensor     # (B, H, p) float32
    m: torch.Tensor     # (B, H) float32, the log stabilizer
    conv: torch.Tensor  # (B, kconv - 1, di): the last conv inputs


class MLSTM(nn.Module):
    """The weights of one mLSTM block, with the reference's leaf names and
    (d_in, d_out) layout (``mlstm_init``): di = proj_factor_m * d_model in
    ``num_heads`` heads; ``w_if``, ``b_i`` and ``b_f`` are float32."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.x = x = cfg.xlstm or XLSTMCfg()
        d = cfg.d_model
        di = int(x.proj_factor_m * d)
        f32 = torch.float32
        self.in_proj = _param((d, 2 * di), dtype, device)
        self.conv_w = _param((x.conv_kernel, di), dtype, device)
        self.conv_b = _param((di,), dtype, device)
        self.wq = _param((di, di), dtype, device)
        self.wk = _param((di, di), dtype, device)
        self.wv = _param((di, di), dtype, device)
        self.w_if = _param((di, 2 * x.num_heads), f32, device)
        self.b_i = _param((x.num_heads,), f32, device)
        self.b_f = _param((x.num_heads,), f32, device)
        self.out_norm = _param((di,), dtype, device)
        self.out_proj = _param((di, d), dtype, device)

    def forward(self, x, *, positions=None, mode: str = "train",
                cache: Optional[MLSTMState] = None,
                active: Optional[torch.Tensor] = None, rope=None):
        """``positions`` and ``rope`` are ignored (``GQA``'s signature)."""
        return mlstm_apply(self, x, self.x, mode=mode, state=cache,
                           active=active, chunk=self.cfg.scan_chunk)


def _prefix_sum(x):
    """Inclusive prefix sum along the last axis in the doubling order: at
    step k = 1, 2, 4, ... < Q every row t >= k adds row t - k on its
    left (``_doubling_scan``'s tree, decay 1)."""
    q = x.shape[-1]
    k = 1
    while k < q:
        x = torch.cat([x[..., :k], x[..., :-k] + x[..., k:]], dim=-1)
        k *= 2
    return x


def _mlstm_chunk(c0, n0, m0, q, k, v, logi, logf):
    """One chunk of every head: q, k, v (B, H, Q, p) in the model's dtype;
    logi, logf (B, H, Q) and the state c0 (B, H, p, p), n0 (B, H, p), m0
    (B, H) float32 -> (h (B, H, Q, p), c, n, m after the chunk).

    With F_t the gates' prefix sum, u_s = logi_s - F_s and w_t = max(m0,
    max_{s<=t} u_s), the weights are A_ts = exp(u_s - w_t) (F_t cancels)
    and the carried state's coefficient exp(m0 - w_t); the stabilizer
    after the chunk is F_Q + w_Q (the reference's derivation)."""
    p = q.shape[-1]
    q = q.float() * (p ** -0.5)               # 1/sqrt(p) lives on q
    k = k.float()
    v = v.float()
    f_cum = _prefix_sum(logf)
    u = logi - f_cum                                         # (B,H,Q)
    w = torch.maximum(m0[..., None], torch.cummax(u, dim=-1).values)
    qq = q.shape[2]
    # the masked (s > t) exponents go to -1e30 before exp, so that none
    # overflows into a gradient of 0 * inf
    mask = torch.ones((qq, qq), dtype=torch.bool, device=q.device).tril()
    aw = torch.exp(torch.where(mask, u[..., None, :] - w[..., None], NEG))
    scores = (q @ k.transpose(-1, -2)) * aw                  # (B,H,t,s)
    inter = torch.exp(m0[..., None] - w)                     # (B,H,Q)
    num = scores @ v + inter[..., None] * (q @ c0.transpose(-1, -2))
    den = scores.sum(-1) + inter * (q @ n0[..., None])[..., 0]
    den = torch.maximum(den.abs(), torch.exp(-(f_cum + w)))
    h = num / den[..., None]
    f_q, w_q = f_cum[..., -1], w[..., -1]                    # (B,H)
    m_new = f_q + w_q
    r = torch.exp(u + f_q[..., None] - m_new[..., None])     # (B,H,Q)
    decay = torch.exp(m0 + f_q - m_new)
    c_new = decay[..., None, None] * c0 + (v * r[..., None]).transpose(
        -1, -2) @ k
    n_new = decay[..., None] * n0 + (r[..., None, :] @ k)[..., 0, :]
    return h, c_new, n_new, m_new


def mlstm_init_state(bsz: int, nh: int, hd: int, device):
    """(c, n, m) before the first token: zeros, m = 0 as the reference
    starts it (not -inf)."""
    z = torch.zeros((bsz, nh), dtype=torch.float32, device=device)
    return z[..., None, None].expand(bsz, nh, hd, hd), \
        z[..., None].expand(bsz, nh, hd), z


def mlstm_core(q, k, v, logi, logf, state, chunk: int = CHUNK):
    """q, k, v (B, H, S, p): the stream in chunks of ``chunk`` rows from
    ``state`` = (c, n, m), carried across -> (h (B, H, S, p) float32,
    (c, n, m))."""
    c, n, m = state
    hs = []
    for start in range(0, q.shape[2], chunk):
        rows = slice(start, start + chunk)
        h, c, n, m = _mlstm_chunk(c, n, m, q[:, :, rows], k[:, :, rows],
                                  v[:, :, rows], logi[..., rows],
                                  logf[..., rows])
        hs.append(h)
    return torch.cat(hs, dim=2), (c, n, m)


def mlstm_step(q, k, v, logi, logf, state):
    """One token's recurrence: q, k, v (B, H, p); logi, logf (B, H) ->
    (h (B, H, p), (c, n, m)), in the state's dtype (float32 in the model;
    float64 gives a reference recurrence)."""
    c, n, m = state
    p = q.shape[-1]
    q = q.to(c.dtype) * (p ** -0.5)
    k = k.to(c.dtype)
    v = v.to(c.dtype)
    m_new = torch.maximum(logf + m, logi)
    a = torch.exp(logf + m - m_new)
    b = torch.exp(logi - m_new)
    c_new = a[..., None, None] * c \
        + b[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = a[..., None] * n + b[..., None] * k
    num = (c_new @ q[..., None])[..., 0]
    den = torch.maximum((n_new[..., None, :] @ q[..., None])[..., 0, 0]
                        .abs(), torch.exp(-m_new))
    return num / den[..., None], (c_new, n_new, m_new)


def mlstm_gates(p: MLSTM, xi, xc, nh: int):
    """The heads and gates of one block: ``in_proj``'s first half xi and
    its conv output xc, each (B, S, di) in the model's dtype -> q, k, v
    (B, H, S, p) in that dtype, logi and logf (B, H, S) float32."""
    bsz, s, di = xi.shape

    def heads(t):
        return t.reshape(bsz, s, nh, di // nh).transpose(1, 2)

    q, k, v = heads(dense(p.wq, xc)), heads(dense(p.wk, xc)), \
        heads(dense(p.wv, xi))
    gates = dense(p.w_if, xc).float()        # rounded to xc's dtype first
    logi = gates[..., :nh].transpose(1, 2) + p.b_i[:, None]
    logf = F.logsigmoid(gates[..., nh:].transpose(1, 2) + p.b_f[:, None])
    return q, k, v, logi, logf


def mlstm_apply(p: MLSTM, x, xc_cfg: XLSTMCfg, *, mode: str = "train",
                state: Optional[MLSTMState] = None,
                active: Optional[torch.Tensor] = None, chunk: int = CHUNK):
    """x (B, S, d) -> (y (B, S, d), state): None in train mode, the
    ``MLSTMState`` after the prompt in prefill (from m = 0), ``state``
    itself (written in place) in decode."""
    bsz, s, _ = x.shape
    di = p.conv_b.shape[0]
    nh = xc_cfg.num_heads
    kconv = p.conv_w.shape[0]
    xi, z = dense(p.in_proj, x).split(di, dim=-1)
    if mode in ("train", "prefill"):
        window = torch.cat([xi.new_zeros((bsz, kconv - 1, di)), xi], dim=1)
    elif mode == "decode":
        _decode_check("mlstm_apply", state, s)
        window = torch.cat([state.conv, xi.to(state.conv.dtype)], dim=1)
    else:
        raise ValueError(mode)
    # decode's window through prefill's chain of taps (the reference's
    # decode is an einsum over the taps: the same sum in another order)
    xc = F.silu(_depthwise_conv(window, p.conv_w, p.conv_b)).to(x.dtype)
    q, k, v, logi, logf = mlstm_gates(p, xi, xc, nh)

    if mode == "decode":
        h1, (c, n, m) = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   logi[..., 0], logf[..., 0],
                                   (state.c, state.n, state.m))
        h = h1.reshape(bsz, 1, di)
        new_state = _keep_inactive(state, (c, n, m, window[:, 1:]), active)
    else:
        h, (c, n, m) = mlstm_core(q, k, v, logi, logf, mlstm_init_state(
            bsz, nh, di // nh, x.device), chunk)
        h = h.transpose(1, 2).reshape(bsz, s, di)
        new_state = None
        if mode == "prefill":
            new_state = MLSTMState(c, n, m, window[:, -(kconv - 1):]
                                   .contiguous())
    h = rmsnorm(p.out_norm, h.to(x.dtype))
    out = dense(p.out_proj, (h.float() * F.silu(z.float())).to(x.dtype))
    return out, new_state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, recurrent connections)
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) float32
    n: torch.Tensor   # (B, d) float32, ones at the start
    h: torch.Tensor   # (B, d): values of the model's dtype
    m: torch.Tensor   # (B, d) float32


class SLSTM(nn.Module):
    """The weights of one sLSTM block (``slstm_init``): the input and
    recurrent projections to the 4 gates, a float32 ``bias``, and a GELU
    FFN of proj_factor_s * d_model."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.x = x = cfg.xlstm or XLSTMCfg()
        d = cfg.d_model
        dff = int(x.proj_factor_s * d)
        self.w_x = _param((d, 4 * d), dtype, device)
        self.w_h = _param((d, 4 * d), dtype, device)
        self.bias = _param((4 * d,), torch.float32, device)
        self.ff_wi = _param((d, dff), dtype, device)
        self.ff_wo = _param((dff, d), dtype, device)

    def forward(self, x, *, positions=None, mode: str = "train",
                cache: Optional[SLSTMState] = None,
                active: Optional[torch.Tensor] = None, rope=None):
        return slstm_apply(self, x, self.x, mode=mode, state=cache,
                           active=active)


def slstm_cell(p: SLSTM, xt, st: SLSTMState):
    """xt (B, 4d) float32, the token's input projection -> (h (B, d)
    float32, the next state, its h rounded to the model's dtype)."""
    g = (xt + dense(p.w_h, st.h.to(p.w_h.dtype)).float()) + p.bias
    zi, ii, ff, oo = g.chunk(4, dim=-1)
    logf = F.logsigmoid(ff)
    m_new = torch.maximum(logf + st.m, ii)
    a = torch.exp(logf + st.m - m_new)
    b = torch.exp(ii - m_new)
    c_new = a * st.c + b * torch.tanh(zi)
    n_new = torch.maximum(a * st.n + b, torch.exp(-m_new))
    h_new = torch.sigmoid(oo) * (c_new / n_new)
    return h_new, SLSTMState(c_new, n_new,
                             h_new.to(p.w_h.dtype).to(st.h.dtype), m_new)


def slstm_init_state(bsz: int, d: int, device) -> SLSTMState:
    """The state before the first token: c, h, m zeros, n ones."""
    z = torch.zeros((bsz, d), dtype=torch.float32, device=device)
    return SLSTMState(z, torch.ones_like(z), z, z)


def slstm_apply(p: SLSTM, x, xc_cfg: XLSTMCfg, *, mode: str = "train",
                state: Optional[SLSTMState] = None,
                active: Optional[torch.Tensor] = None):
    """x (B, S, d) -> (h + ffn(h) (B, S, d), state): train and prefill
    run the cell token by token from ``state`` (the initial state if
    None), prefill returning the state after the prompt; decode writes
    ``state`` in place."""
    bsz, s, d = x.shape
    xg = dense(p.w_x, x).float()                             # (B,S,4d)
    if mode in ("train", "prefill"):
        st = state if state is not None else \
            slstm_init_state(bsz, d, x.device)
        hs = []
        for t in range(s):
            ht, st = slstm_cell(p, xg[:, t], st)
            hs.append(ht)
        h = torch.stack(hs, dim=1).to(x.dtype)
        new_state = st if mode == "prefill" else None
    elif mode == "decode":
        _decode_check("slstm_apply", state, s)
        h1, st = slstm_cell(p, xg[:, 0], state)
        h = h1[:, None].to(x.dtype)
        new_state = _keep_inactive(state, st, active)
    else:
        raise ValueError(mode)
    ff = dense(p.ff_wo, F.gelu(dense(p.ff_wi, h).float(),
                               approximate="tanh").to(x.dtype))
    return h + ff, new_state


__all__ = ["MambaState", "Mamba", "mamba_apply", "mamba_scan",
           "MLSTMState", "MLSTM", "mlstm_apply", "mlstm_core", "mlstm_step",
           "mlstm_init_state", "slstm_init_state",
           "SLSTMState", "SLSTM", "slstm_apply", "slstm_cell"]
