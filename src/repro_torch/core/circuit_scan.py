"""JugglePAC as a batched scan over fixed-shape tensors.

The PyTorch counterpart of the reference's ``core/circuit_jax.py`` (a
``jax.lax.scan`` of one clock cycle, vmapped over parameter sweeps): the
same cycle-accurate circuit as ``core.circuit.JugglePAC``, with a batch
of independent circuits as the leading dimension in place of
``jax.vmap``.  One ``step`` == one clock cycle of every circuit.

On a CUDA device ``jugglepac_scan`` runs the whole scan in one launch of
the hand-written kernel ``kernels/jugglepac_fsm.py`` (one CUDA thread
per circuit); on the CPU (``device="cpu"``) it runs the kernel's plain
version, which calls ``step`` cycle by cycle.  Both are bitwise the
reference's scan on every cycle, overflowing FIFOs included.

State layout (L = adder latency, R = PIS registers, ``...`` = batch):
  pipe_v   (..., L)  values in flight in the adder pipeline
  pipe_l   (..., L)  labels accompanying them (the paper's shift register)
  pipe_en  (..., L)  the shift register's inEn bit
  reg_v    (..., R)  PIS register file (intermediate results, by label)
  reg_en   (..., R)  occupancy
  reg_cnt  (..., R)  Algorithm-2 timeout counters
  reg_set  (..., R)  which global set index owns the slot
  label_set(..., R)  which set index currently owns each label
  fifo_*   (..., 4)  the 4-slot ready-pair FIFO
  fsm state, pending input register, current set/label counters (...)

    from repro_torch.core import circuit_scan
    res_v, res_set, res_en, overflow = circuit_scan.jugglepac_scan(
        values, starts, valids, latency=14, num_registers=4, device="cpu")
    results, overflowed = circuit_scan.run_sets(sets, device="cpu")
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import resolve_device

FIFO_DEPTH = 4

_I32 = torch.int32


class PacState(NamedTuple):
    pipe_v: torch.Tensor
    pipe_l: torch.Tensor
    pipe_en: torch.Tensor
    reg_v: torch.Tensor
    reg_en: torch.Tensor
    reg_cnt: torch.Tensor
    reg_set: torch.Tensor
    label_set: torch.Tensor
    fifo_a: torch.Tensor
    fifo_b: torch.Tensor
    fifo_l: torch.Tensor
    fifo_n: torch.Tensor     # int32: occupancy (may pass FIFO_DEPTH)
    fsm: torch.Tensor        # int32: 0 / 1 (pending first-of-pair?)
    pend_v: torch.Tensor
    pend_l: torch.Tensor
    cur_set: torch.Tensor    # int32: index of current set (-1 before any)
    cur_label: torch.Tensor


def init_state(latency: int, num_registers: int, dtype=torch.float32, *,
               batch=None, device=None) -> PacState:
    """The zeroed state of ``batch`` circuits (None: one circuit, in the
    reference's unbatched shapes)."""
    L, R = latency, num_registers
    lead = () if batch is None else (batch,)

    def z(n, dt):
        return torch.zeros(lead + n, dtype=dt, device=device)

    def neg(n):
        return torch.full(lead + n, -1, dtype=_I32, device=device)

    return PacState(
        pipe_v=z((L,), dtype), pipe_l=z((L,), _I32),
        pipe_en=z((L,), torch.bool),
        reg_v=z((R,), dtype), reg_en=z((R,), torch.bool),
        reg_cnt=z((R,), _I32), reg_set=neg((R,)), label_set=neg((R,)),
        fifo_a=z((FIFO_DEPTH,), dtype), fifo_b=z((FIFO_DEPTH,), dtype),
        fifo_l=z((FIFO_DEPTH,), _I32), fifo_n=z((), _I32),
        fsm=z((), _I32), pend_v=z((), dtype), pend_l=z((), _I32),
        cur_set=neg(()), cur_label=z((), _I32))


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] with one index per circuit."""
    return torch.gather(x, -1, i.to(torch.int64)[..., None])[..., 0]


def step(latency: int, num_registers: int, state: PacState,
         inp) -> Tuple[PacState, Tuple]:
    """One clock cycle of every circuit; the reference's ``_step``.

    ``inp`` = (value, start bool, valid bool), each of the batch's shape.
    Returns the new state and (res_v, res_set, res_en, overflow)."""
    L, R = latency, num_registers
    v, start, valid = inp
    s = state
    dev = v.device
    lanes_r = torch.arange(R, device=dev)
    lanes_f = torch.arange(FIFO_DEPTH, device=dev)

    is_start = valid & start
    is_cont = valid & ~start
    idle = ~valid
    have_pending = s.fsm == 1

    # --- FSM / input pairing (Algorithm 1) -------------------------------
    flush = (is_start | idle) & have_pending          # dangling odd element
    pair = is_cont & have_pending                     # raw input pair
    input_issue = flush | pair

    zero = torch.zeros_like(v)
    issue_a = s.pend_v
    issue_b = torch.where(pair, v, zero)
    issue_l = s.pend_l

    # New-set bookkeeping (the label table takes this cycle's start).
    new_set = torch.where(is_start, s.cur_set + 1, s.cur_set)
    new_label = torch.where(is_start, (s.cur_set + 1) % R, s.cur_label)
    label_set = torch.where(
        is_start[..., None] & (lanes_r == new_label[..., None]),
        new_set[..., None], s.label_set)

    # Pending register update.
    stash = is_start | (is_cont & ~have_pending)
    pend_v = torch.where(stash, v, s.pend_v)
    pend_l = torch.where(stash, new_label, s.pend_l)
    fsm = torch.where(stash, 1, torch.where(input_issue, 0, s.fsm)).to(_I32)

    # --- FIFO issue when the adder slot is free (a pop rolls slot 0 to
    # the back, so a stale pair stays there) ------------------------------
    fifo_issue = ~input_issue & (s.fifo_n > 0)
    issue_a = torch.where(fifo_issue, s.fifo_a[..., 0], issue_a)
    issue_b = torch.where(fifo_issue, s.fifo_b[..., 0], issue_b)
    issue_l = torch.where(fifo_issue, s.fifo_l[..., 0], issue_l)
    issue_en = input_issue | fifo_issue

    pop = fifo_issue[..., None]
    fifo_a = torch.where(pop, torch.roll(s.fifo_a, -1, -1), s.fifo_a)
    fifo_b = torch.where(pop, torch.roll(s.fifo_b, -1, -1), s.fifo_b)
    fifo_l = torch.where(pop, torch.roll(s.fifo_l, -1, -1), s.fifo_l)
    fifo_n = s.fifo_n - fifo_issue.to(_I32)

    # --- adder pipeline tick (an idle slot carries +0.0; a flush adds
    # +0.0, so a pending -0.0 leaves as +0.0) ------------------------------
    out_v = s.pipe_v[..., L - 1]
    out_l = s.pipe_l[..., L - 1]
    out_en = s.pipe_en[..., L - 1]
    issued = torch.where(issue_en, issue_a + issue_b, zero)
    pipe_v = torch.cat([issued[..., None], s.pipe_v[..., :-1]], -1)
    pipe_l = torch.cat([issue_l[..., None], s.pipe_l[..., :-1]], -1)
    pipe_en = torch.cat([issue_en[..., None], s.pipe_en[..., :-1]], -1)

    # --- PIS insert (pair identification) ---------------------------------
    slot_occupied = _at(s.reg_en, out_l)
    make_pair = out_en & slot_occupied
    store = out_en & ~slot_occupied

    # pair -> FIFO push at the clipped index: past 4 it overwrites slot 3
    push = make_pair[..., None] & (
        lanes_f == fifo_n.clamp(0, FIFO_DEPTH - 1)[..., None])
    fifo_a = torch.where(push, _at(s.reg_v, out_l)[..., None], fifo_a)
    fifo_b = torch.where(push, out_v[..., None], fifo_b)
    fifo_l = torch.where(push, out_l[..., None], fifo_l)
    overflow = make_pair & (fifo_n >= FIFO_DEPTH)
    fifo_n = fifo_n + make_pair.to(_I32)

    # reg_v is never cleared: a pair or an emission clears reg_en alone
    hit = out_en[..., None] & (lanes_r == out_l[..., None])
    stored = hit & store[..., None]
    reg_v = torch.where(stored, out_v[..., None], s.reg_v)
    reg_en = torch.where(hit, store[..., None], s.reg_en)
    reg_cnt = torch.where(hit, 0, s.reg_cnt)
    reg_set = torch.where(stored, _at(label_set, out_l)[..., None], s.reg_set)

    # --- Algorithm 2: timeout scan (single output port) --------------------
    thresh = L + 3
    ready = reg_en & (reg_cnt >= thresh)
    res_en = ready.any(-1)
    emit_i = torch.argmax(ready.to(torch.uint8), -1)  # lowest ready, else 0
    res_v = _at(reg_v, emit_i)
    res_set = _at(reg_set, emit_i)

    emitted = res_en[..., None] & (lanes_r == emit_i[..., None])
    reg_en = reg_en & ~emitted
    reg_cnt = torch.where(emitted, 0, reg_cnt)
    reg_set = torch.where(emitted, -1, reg_set)
    # saturating increment for occupied, non-emitted registers
    reg_cnt = torch.where(reg_en, (reg_cnt + 1).clamp(max=thresh), reg_cnt)

    new_state = PacState(pipe_v, pipe_l, pipe_en, reg_v, reg_en, reg_cnt,
                         reg_set, label_set, fifo_a, fifo_b, fifo_l, fifo_n,
                         fsm, pend_v, pend_l, new_set, new_label)
    return new_state, (res_v, res_set, res_en, overflow)


def jugglepac_scan(values, starts, valids, *, latency: int = 14,
                   num_registers: int = 4, device=None):
    """Run the circuit for ``T`` cycles (pad with valid=False to drain).

    values, starts, valids: (T,) or (B, T), one circuit a row.  Returns
    per-cycle (result, set_index int32, result_valid, overflow) of the
    same shape.  ``device=None`` means the card: the kernel, float32
    values only, 1 <= latency, num_registers <= 64 (outside these it
    raises); ``device="cpu"`` runs the plain version."""
    from ..kernels import jugglepac_fsm as fsm
    dev = resolve_device(device)
    values = torch.as_tensor(values, device=dev)
    starts = torch.as_tensor(starts, device=dev).to(torch.bool)
    valids = torch.as_tensor(valids, device=dev).to(torch.bool)
    one = values.ndim == 1
    if one:
        values, starts, valids = values[None], starts[None], valids[None]
    if values.ndim != 2 or starts.shape != values.shape \
            or valids.shape != values.shape:
        raise ValueError("jugglepac_scan: values, starts and valids must "
                         "share one (T,) or (B, T) shape; got "
                         f"{tuple(values.shape)}, {tuple(starts.shape)}, "
                         f"{tuple(valids.shape)}")
    run = fsm.jugglepac_fsm_cuda if dev.type == "cuda" \
        else fsm.jugglepac_fsm_torch
    outs = run(values.contiguous(), starts.contiguous(), valids.contiguous(),
               latency=latency, num_registers=num_registers)
    return tuple(o[0] for o in outs) if one else outs


def run_sets(sets, *, latency: int = 14, num_registers: int = 4,
             drain: int | None = None, device=None):
    """Mirror of ``circuit.JugglePAC.run`` for the scan: ``sets`` fed
    back-to-back as float32, then ``drain`` idle cycles (default
    8L + 32 + the longest set).  Returns [(set_index, value, cycle)] in
    emission order and whether any cycle overflowed the FIFO."""
    if drain is None:
        drain = 8 * latency + 32 + max((len(s) for s in sets), default=0)
    vals, starts, valids = [], [], []
    for s in sets:
        for j, x in enumerate(s):
            vals.append(x)
            starts.append(j == 0)
            valids.append(True)
    vals += [0.0] * drain
    starts += [False] * drain
    valids += [False] * drain
    res_v, res_set, res_en, ovf = jugglepac_scan(
        torch.tensor(vals, dtype=torch.float32), torch.tensor(starts),
        torch.tensor(valids), latency=latency, num_registers=num_registers,
        device=device)
    res_v, res_set, res_en = (t.cpu() for t in (res_v, res_set, res_en))
    out = [(int(si), float(rv), int(cy))
           for cy, (rv, si, re) in enumerate(zip(res_v.tolist(),
                                                 res_set.tolist(),
                                                 res_en.tolist())) if re]
    return out, bool(ovf.any())
