"""Cycle-accurate simulators for the paper's two circuits.

This module is the *faithful reproduction* layer: it models JugglePAC
(Fig. 3 / Algorithm 1 / Algorithm 2) and INTAC (Fig. 4 / Fig. 5 / Eq. 1)
at clock-cycle granularity, so the paper's own claims can be validated:

  * JugglePAC: single pipelined adder, 2-state FSM, PIS register file with
    per-register timeout counters (L+3), 4-slot FIFO, in-order results,
    latency <= DS + c, minimum-set-size vs. number of PIS registers
    (paper Table II), and the Table I schedule for L=2.
  * INTAC: 3:2 carry-save compressor with feedback + resource-shared final
    adder with K full-adder cells; latency per Eq. (1).

The simulators are plain Python on purpose — they are the oracle the
PyTorch/CUDA production layer (core/segmented.py, kernels/) is tested
against, and an oracle should be as simple as possible.  The JugglePAC FSM
as a batched scan over fixed-shape tensors lives in core/circuit_scan.py
(plain PyTorch on the CPU, the hand-written kernel of
kernels/jugglepac_fsm.py on a CUDA device) and is tested against this one.
It needs neither torch nor numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Pipelined operator (the paper's "FP adder with latency L")
# ---------------------------------------------------------------------------


class PipelinedAdder:
    """A latency-L pipelined binary operator.

    Each cycle accepts at most one (a, b) issue; the result appears exactly
    L cycles later.  Models the paper's IP FP adder.  ``op`` is the combining
    operator — ``operator.add`` for accumulation, but any associative-ish
    multi-cycle operator works (the paper notes an FP multiplier works too).
    """

    def __init__(self, latency: int, op: Callable = lambda a, b: a + b):
        assert latency >= 1
        self.latency = latency
        self.op = op
        # Each stage holds None or (value, label) — value computed at issue
        # time; the pipeline models latency, not partial arithmetic.
        self._stages: List[Optional[Tuple[object, int]]] = [None] * latency

    def tick(self, issue: Optional[Tuple[object, object, int]]):
        """Advance one clock. ``issue`` is (a, b, label) or None.

        Returns (value, label) completing this cycle, or None.
        """
        done = self._stages[-1]
        self._stages = [None] + self._stages[:-1]
        if issue is not None:
            a, b, label = issue
            self._stages[0] = (self.op(a, b), label)
        return done

    @property
    def busy(self) -> bool:
        return any(s is not None for s in self._stages)


# ---------------------------------------------------------------------------
# JugglePAC
# ---------------------------------------------------------------------------


@dataclass
class JugglePACResult:
    value: object
    set_index: int          # global index of the data set this result belongs to
    cycle: int              # clock cycle the result was produced on
    first_input_cycle: int  # cycle the set's first element entered the circuit

    @property
    def latency(self) -> int:
        return self.cycle - self.first_input_cycle


class JugglePAC:
    """Cycle-accurate JugglePAC (paper §III-A, §IV-B).

    Architecture, per the paper:
      * top-level FSM with two states (Algorithm 1):
          state 1 — the current input is the 2nd of a raw pair: issue
                    (previous input, current input) to the adder;
          state 0 — the adder input slot is free: issue a ready pair from the
                    PIS FIFO, if any;
        on ``start`` (first element of a new set) a dangling previous input
        is paired with 0.
      * a shift register carrying (label, inEn) alongside the adder pipeline;
      * the PIS: ``num_registers`` registers addressed by label, per-register
        timeout counters, and a 4-slot FIFO of ready pairs (Algorithm 2).

    Labels are assigned per set as set_index % num_registers, matching the
    paper's "behaving as a BRAM where the address is the label".
    """

    FIFO_DEPTH = 4

    def __init__(self, adder_latency: int = 14, num_registers: int = 4,
                 op: Callable = lambda a, b: a + b, zero=0.0):
        self.L = adder_latency
        self.R = num_registers
        self.zero = zero
        self.adder = PipelinedAdder(adder_latency, op)
        # PIS register file: per label slot (value or None), wait counter,
        # and which set_index currently owns the slot.
        self.reg: List[Optional[object]] = [None] * num_registers
        self.counter = [0] * num_registers
        self.reg_owner = [-1] * num_registers
        self.fifo: List[Tuple[object, object, int]] = []  # (a, b, label)
        self.cycle = 0
        # FSM / input pairing state
        self.state = 0          # state==1 -> have a pending first-of-pair
        self.pending: Optional[object] = None
        self.pending_label = -1
        self.pending_set = -1
        # bookkeeping
        self.set_count = 0
        self.cur_label = -1
        self.cur_set = -1
        self.first_cycle_of_set: dict = {}
        self.label_to_set: dict = {}
        self.results: List[JugglePACResult] = []
        self.fifo_overflows = 0
        self.adder_issue_log: List[Tuple[int, object, object, int]] = []

    # -- internals ----------------------------------------------------------

    def _pis_insert(self, value, label: int):
        """Adder output (value,label) enters the PIS (pair identification)."""
        if self.reg[label] is None:
            self.reg[label] = value
            self.counter[label] = 0
            self.reg_owner[label] = self.label_to_set[label]
        else:
            if len(self.fifo) >= self.FIFO_DEPTH:
                # The paper sizes the FIFO at 4 and relies on the schedule to
                # never overflow; we count overflows (a correctness bug if >0)
                # rather than silently dropping.
                self.fifo_overflows += 1
            self.fifo.append((self.reg[label], value, label))
            self.reg[label] = None
            self.counter[label] = 0

    def _pis_timeout_scan(self):
        """Algorithm 2: counters tick; a value that has waited L+3 cycles
        without a partner is this set's final result.

        The output bus is a single port, so at most one result is emitted
        per cycle; a second register at threshold holds until the next cycle
        (counters saturate at the threshold).
        """
        emitted = False
        for i in range(self.R):
            if self.reg[i] is None:
                continue
            if self.counter[i] >= self.L + 3:
                if emitted:
                    continue  # bus busy: hold at threshold
                emitted = True
                set_idx = self.reg_owner[i]
                self.results.append(JugglePACResult(
                    value=self.reg[i], set_index=set_idx, cycle=self.cycle,
                    first_input_cycle=self.first_cycle_of_set[set_idx]))
                self.reg[i] = None
                self.counter[i] = 0
                self.reg_owner[i] = -1
            else:
                self.counter[i] += 1

    # -- public API ----------------------------------------------------------

    def step(self, value=None, start: bool = False):
        """Advance one clock cycle.

        value/start model the paper's input bus: ``value`` is the sample (or
        None for an idle cycle), ``start`` flags the first element of a set.
        """
        issue = None

        if value is not None and start:
            # New set begins. A dangling odd element of the previous set is
            # paired with 0 (Algorithm 1 "Adder <- previous input, 0").
            if self.state == 1 and self.pending is not None:
                issue = (self.pending, self.zero, self.pending_label)
            self.set_count += 1
            self.cur_set = self.set_count - 1
            self.cur_label = self.cur_set % self.R
            self.label_to_set[self.cur_label] = self.cur_set
            self.first_cycle_of_set[self.cur_set] = self.cycle
            self.pending = value
            self.pending_label = self.cur_label
            self.pending_set = self.cur_set
            self.state = 1
        elif value is not None:
            if self.state == 1:
                # state 1: second element of a raw pair -> issue it.
                issue = (self.pending, value, self.pending_label)
                self.pending = None
                self.state = 0
            else:
                # state 0: stash as first-of-pair; adder slot is free.
                self.pending = value
                self.pending_label = self.cur_label
                self.pending_set = self.cur_set
                self.state = 1
        elif self.state == 1 and self.pending is not None:
            # Idle cycle with a dangling first-of-pair: the set has ended
            # (sets are back-to-back within themselves, per Fig. 1), so the
            # odd leftover is paired with 0 — the same action Algorithm 1
            # takes on the next ``start``, just triggered by the gap.
            issue = (self.pending, self.zero, self.pending_label)
            self.pending = None
            self.state = 0

        if issue is None and self.fifo:
            # Free adder slot -> issue a ready PIS pair (Algorithm 1 state 0).
            issue = self.fifo.pop(0)

        if issue is not None:
            self.adder_issue_log.append(
                (self.cycle, issue[0], issue[1], issue[2]))
        out = self.adder.tick(issue)
        if out is not None:
            self._pis_insert(out[0], out[1])
        self._pis_timeout_scan()
        self.cycle += 1

    def run(self, sets: Sequence[Sequence], gaps: Optional[Sequence[int]] = None,
            drain: Optional[int] = None) -> List[JugglePACResult]:
        """Feed ``sets`` back-to-back (or with per-set leading ``gaps``) and
        run until the circuit drains.  Returns results in emission order."""
        gaps = list(gaps) if gaps is not None else [0] * len(sets)
        for s, gap in zip(sets, gaps):
            for _ in range(gap):
                self.step()
            for j, v in enumerate(s):
                self.step(v, start=(j == 0))
        if drain is None:
            drain = 4 * self.L + 16 + max((len(s) for s in sets), default=0)
        target = len(sets)
        guard = 0
        while len(self.results) < target and guard < drain + 10000:
            self.step()
            guard += 1
        return self.results

    # Convenience: is the circuit fully drained?
    @property
    def idle(self) -> bool:
        return (not self.adder.busy and not self.fifo
                and all(r is None for r in self.reg)
                and self.pending is None)


def jugglepac_min_set_size(adder_latency: int, num_registers: int,
                           probe_max: int = 200, trials_per_n: int = 3,
                           num_sets: int = 12) -> int:
    """Empirically determine the minimum set length (paper Table II).

    Smallest n such that ``num_sets`` back-to-back sets of length n (and a
    few jittered variants >= n) all produce correct, in-order results with
    no FIFO overflow.  The paper reports 94/29/18 for R=2/4/8 at L=14.
    """
    def ok(n: int) -> bool:
        for t in range(trials_per_n):
            sizes = [n + ((7 * i + t) % 3) for i in range(num_sets)]
            sets = [[float(i * 1000 + j) for j in range(sz)]
                    for i, sz in enumerate(sizes)]
            pac = JugglePAC(adder_latency, num_registers)
            res = pac.run(sets)
            if pac.fifo_overflows or len(res) != len(sets):
                return False
            for r, (i, s) in zip(res, enumerate(sets)):
                if r.set_index != i or abs(r.value - sum(s)) > 1e-6 * abs(sum(s)):
                    return False
        return True

    lo, hi = 2, probe_max
    if not ok(hi):
        return probe_max + 1
    # first find some failing floor, then binary search the boundary
    while lo < hi:
        mid = (lo + hi) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


# ---------------------------------------------------------------------------
# INTAC
# ---------------------------------------------------------------------------


@dataclass
class INTACResult:
    value: int
    cycle: int


class INTAC:
    """Cycle-accurate INTAC (paper §III-B, Fig. 4/5, Eq. 1).

    * An N:2 carry-save compressor with feedback accumulates ``inputs_per_cycle``
      new operands per cycle into a redundant (sum, carry) pair with a 1-FA
      critical path (modeled bitwise).
    * When the set ends, the (sum, carry) pair is handed to the resource-shared
      final adder: ``fa_cells`` full-adder cells resolve K bits per cycle from
      the LSB up, operands shifting right by K each cycle (Fig. 5).
    * Latency (cycles from last input to result) follows Eq. (1).

    Bit widths: inputs are ``in_bits`` wide, the accumulator/result ``out_bits``.
    """

    def __init__(self, in_bits: int = 64, out_bits: int = 128,
                 inputs_per_cycle: int = 1, fa_cells: int = 1):
        self.in_bits = in_bits
        self.out_bits = out_bits
        self.N = inputs_per_cycle
        self.K = fa_cells
        self.mask = (1 << out_bits) - 1
        self.reset()

    def reset(self):
        self.s = 0      # carry-save "sum" word
        self.c = 0      # carry-save "carry" word
        self.cycle = 0

    def _csa(self, a: int, b: int, d: int) -> Tuple[int, int]:
        """One row of full adders (3:2 compressor), bit-parallel."""
        s = (a ^ b ^ d) & self.mask
        c = (((a & b) | (a & d) | (b & d)) << 1) & self.mask
        return s, c

    def feed(self, values: Sequence[int]):
        """One clock: compress up to ``inputs_per_cycle`` new values into
        the (s, c) feedback pair via an N:2 compressor tree."""
        assert len(values) <= self.N
        for v in values:
            self.s, self.c = self._csa(self.s, self.c, v & self.mask)
        self.cycle += 1

    def finalize(self) -> INTACResult:
        """Resource-shared final addition: K FA cells per cycle, LSB-first,
        operands in shift registers (Fig. 5)."""
        s, c, carry, out = self.s, self.c, 0, 0
        cycles = 0
        for pos in range(0, self.out_bits, self.K):
            a = s & ((1 << self.K) - 1)
            b = c & ((1 << self.K) - 1)
            total = a + b + carry
            out |= (total & ((1 << self.K) - 1)) << pos
            carry = total >> self.K
            s >>= self.K
            c >>= self.K
            cycles += 1
        self.cycle += cycles + 1          # +1: output register (Fig. 5)
        res = INTACResult(value=out & self.mask, cycle=self.cycle)
        self.s = self.c = 0
        return res

    def accumulate(self, values: Sequence[int]) -> INTACResult:
        """Accumulate a full set and return the resolved result."""
        self.reset()
        for i in range(0, len(values), self.N):
            self.feed(values[i:i + self.N])
        return self.finalize()

    @staticmethod
    def latency_eq1(num_inputs: int, inputs_per_cycle: int, out_bits: int,
                    fa_cells: int, reduced_bits: int = 0) -> int:
        """Paper Eq. (1): Latency = ceil(I/N) + ceil((M-R)/FAs) + 1.

        (The paper's LaTeX transposes N and I; the meaning — set length
        divided by inputs-per-cycle — is unambiguous from Table V.)
        """
        return (math.ceil(num_inputs / inputs_per_cycle)
                + math.ceil((out_bits - reduced_bits) / fa_cells) + 1)

    def min_set_size(self) -> int:
        """Paper §IV-C: minimum set length = ceil((M*inputs)/FAs)."""
        return math.ceil(self.out_bits * self.N / self.K)
