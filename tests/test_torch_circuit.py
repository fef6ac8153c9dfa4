"""The port's faithful layer against the reference, on the CPU.

``repro_torch.core.circuit`` (the cycle-accurate JugglePAC and INTAC
simulators, plain Python) must give results identical to
``repro.core.circuit`` on the same inputs; ``repro_torch.core.
circuit_scan`` (the FSM as a batched scan; on the CPU its plain version,
``step`` cycle by cycle) must be bitwise ``circuit_jax.jugglepac_scan``
on every cycle and every output, ``res_v`` compared as int32 bit views
(NaN included), overflowing FIFOs included.  The kernel itself runs only
on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it
against this plain version.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import circuit as ref_circuit  # noqa: E402
from repro.core import circuit_jax  # noqa: E402
from repro_torch.core import circuit, circuit_scan  # noqa: E402

TABLE1 = [[1, 2, 3, 4, 5], [10, 20, 30, 40],
          [100, 200, 300, 400, 500, 600, 700, 800, 900]]


def _results(res):
    return [(r.value, r.set_index, r.cycle, r.first_input_cycle, r.latency)
            for r in res]


def _run_both(sets, gaps=None, **kw):
    a = ref_circuit.JugglePAC(**kw)
    b = circuit.JugglePAC(**kw)
    ra, rb = a.run(sets, gaps), b.run(sets, gaps)
    return a, b, ra, rb


def _assert_same_run(a, b, ra, rb):
    assert _results(rb) == _results(ra)
    assert b.adder_issue_log == a.adder_issue_log
    assert b.fifo_overflows == a.fifo_overflows
    assert b.cycle == a.cycle and b.idle == a.idle


def test_table1_run_identical():
    a, b, ra, rb = _run_both(TABLE1, adder_latency=2, num_registers=4)
    _assert_same_run(a, b, ra, rb)
    assert [r.set_index for r in rb] == [0, 1, 2]
    assert [r.value for r in rb] == [sum(s) for s in TABLE1]


@pytest.mark.parametrize("latency", [2, 5, 14, 20])
def test_seeded_runs_identical(latency):
    """At R in {2, 4, 8}: back-to-back sets, sets with idle gaps, and
    sets far below the minimum set size (results mixed, FIFO
    overflowing)."""
    rng = random.Random(100 + latency)
    for regs in (2, 4, 8):
        sizes = [rng.randrange(20, 90) for _ in range(6)]
        sets = [[float(rng.randrange(1, 50)) for _ in range(n)]
                for n in sizes]
        gaps = [rng.randrange(0, 2 * latency) for _ in sets]
        small = [[float(rng.randrange(1, 9))
                  for _ in range(rng.randrange(1, 6))] for _ in range(16)]
        for s, g in ((sets, None), (sets, gaps), (small, None)):
            _assert_same_run(*_run_both(s, g, adder_latency=latency,
                                        num_registers=regs))


def test_multiplication_operator_identical():
    """Paper §III-A: any multi-cycle operator; here a product onto 1.0."""
    sets = [[1.5, 2.0, 3.0] + [1.0] * 40, [2.0] * 35, [0.5, 3.0] * 9]
    kw = dict(adder_latency=6, num_registers=4, op=lambda a, b: a * b,
              zero=1.0)
    a, b, ra, rb = _run_both(sets, **kw)
    _assert_same_run(a, b, ra, rb)
    assert rb[0].value == 9.0 and rb[1].value == 2.0 ** 35


def test_min_set_size_identical():
    """Table II's search at L = 14 (the paper: 94, 29, 18 for R = 2, 4, 8)
    and at two other latencies."""
    for lat, regs in [(14, 2), (14, 4), (14, 8), (14, 16), (5, 4), (20, 2)]:
        assert circuit.jugglepac_min_set_size(lat, regs) == \
            ref_circuit.jugglepac_min_set_size(lat, regs)
    assert circuit.jugglepac_min_set_size(14, 4, probe_max=10) == 11


def test_intac_identical():
    rng = random.Random(7)
    for n_in, fas, count in [(1, 1, 64), (1, 16, 100), (2, 2, 64),
                             (2, 4, 17), (4, 16, 200)]:
        vals = [rng.randrange(0, 2 ** 64) for _ in range(count)]
        a = ref_circuit.INTAC(64, 128, n_in, fas).accumulate(vals)
        b = circuit.INTAC(64, 128, n_in, fas).accumulate(vals)
        assert (b.value, b.cycle) == (a.value, a.cycle)
        assert b.value == sum(vals) % (1 << 128)
        assert circuit.INTAC.latency_eq1(count, n_in, 128, fas) == \
            ref_circuit.INTAC.latency_eq1(count, n_in, 128, fas)
        assert circuit.INTAC.latency_eq1(count, n_in, 128, fas, 8) == \
            ref_circuit.INTAC.latency_eq1(count, n_in, 128, fas, 8)
        assert circuit.INTAC(64, 128, n_in, fas).min_set_size() == \
            ref_circuit.INTAC(64, 128, n_in, fas).min_set_size()
    a, b = ref_circuit.INTAC(32, 40, 3, 5), circuit.INTAC(32, 40, 3, 5)
    vals = [rng.randrange(0, 2 ** 32) for _ in range(50)]
    assert (b.accumulate(vals).value, b.cycle) == \
        (a.accumulate(vals).value, a.cycle)


def _stream(sets, gaps=(), drain=64):
    v, st, va = [], [], []
    for i, s in enumerate(sets):
        g = gaps[i] if i < len(gaps) else 0
        v += [0.0] * g
        st += [False] * g
        va += [False] * g
        for j, x in enumerate(s):
            v.append(x)
            st.append(j == 0)
            va.append(True)
    v += [0.0] * drain
    st += [False] * drain
    va += [False] * drain
    return (np.array(v, np.float32), np.array(st, bool), np.array(va, bool))


def _mixed_stream(seed, n_sets, lo, hi, t_drain):
    """Sets of lengths in [lo, hi), idle gaps inside and between sets,
    starts on invalid cycles (ignored), -0.0, +-Inf and NaN values."""
    rng = np.random.RandomState(seed)
    sets = [rng.randint(-40, 40, rng.randint(lo, hi)).astype(np.float32)
            for _ in range(n_sets)]
    v, st, va = _stream(sets, rng.randint(0, 6, n_sets), t_drain)
    hole = (rng.rand(v.size) < 0.04) & va & ~st      # a gap inside a set
    va &= ~hole
    st |= ~va & (rng.rand(v.size) < 0.2)             # starts while invalid
    k = rng.rand(v.size)
    v[k < 0.05] = -0.0
    v[(k >= 0.05) & (k < 0.06)] = np.inf
    v[(k >= 0.06) & (k < 0.07)] = -np.inf
    v[(k >= 0.07) & (k < 0.08)] = np.nan
    return v, st, va


def _assert_bitwise(ref_outs, outs):
    ref_outs = [np.asarray(x) for x in ref_outs]
    outs = [x.numpy() for x in outs]
    assert outs[0].dtype == np.float32 and outs[1].dtype == np.int32
    assert np.array_equal(outs[0].view(np.int32), ref_outs[0].view(np.int32))
    for a, b in zip(outs[1:], ref_outs[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


CASES = {
    # (latency, registers, stream)
    "L1-R1-mixed": (1, 1, lambda: _mixed_stream(1, 30, 1, 30, 40)),
    "L2-R4-mixed": (2, 4, lambda: _mixed_stream(2, 30, 1, 40, 60)),
    # 20 sets of 5 at R = 2: the FIFO overflows and fifo_n passes 4
    "L14-R2-overflow": (14, 2, lambda: _stream([[1.0] * 5] * 20, (),
                                                200)),
    "L32-R16-mixed": (32, 16, lambda: _mixed_stream(4, 24, 1, 60, 320)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_scan_bitwise_reference(case):
    lat, regs, make = CASES[case]
    v, st, va = make()
    ref = circuit_jax.jugglepac_scan(jnp.asarray(v), jnp.asarray(st),
                                     jnp.asarray(va), latency=lat,
                                     num_registers=regs)
    outs = circuit_scan.jugglepac_scan(v, st, va, latency=lat,
                                       num_registers=regs, device="cpu")
    _assert_bitwise(ref, outs)
    res_v, _, res_en, ovf = (x.numpy() for x in outs)
    if case.endswith("overflow"):
        assert ovf.sum() > 1
    else:
        assert res_en.sum() > 0 and np.isnan(res_v).any()


def test_step_state_bitwise_reference():
    """Every state field after every cycle, one circuit in the
    reference's unbatched shapes; the FIFO overflows (fifo_n past 4, a
    pop leaving a stale pair in slot 3) and reg_v keeps stale values."""
    lat, regs = 3, 2
    v, st, va = _stream([[1.0, -0.0, 2.0]] * 12 + [[5.0] * 9] * 2,
                        (0, 3, 0, 1), 60)
    rs = circuit_jax.init_state(lat, regs)
    ts = circuit_scan.init_state(lat, regs)
    ref_step = jax.jit(lambda s, x: circuit_jax._step(lat, regs, s, x))
    seen_n = 0
    for c in range(v.size):
        rs, rout = ref_step(rs, (jnp.float32(v[c]), jnp.bool_(st[c]),
                                 jnp.bool_(va[c])))
        ts, tout = circuit_scan.step(lat, regs, ts, (
            torch.tensor(v[c]), torch.tensor(st[c]), torch.tensor(va[c])))
        for name, a, b in zip(rs._fields, rs, ts):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape, name
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            assert np.array_equal(a, b), (c, name)
        _assert_bitwise([np.asarray(x)[None] for x in rout],
                        [x[None] for x in tout])
        seen_n = max(seen_n, int(ts.fifo_n))
    assert seen_n > circuit_scan.FIFO_DEPTH


def test_batched_scan_bitwise_vmap():
    """(B, T) against ``jax.vmap`` of the reference: three circuits with
    different streams, one of them overflowing."""
    lat, regs = 14, 2
    streams = [_mixed_stream(5, 20, 1, 50, 150),
               _mixed_stream(6, 20, 1, 50, 150),
               _stream([[2.0] * 5] * 20, (), 200)]
    t = max(s[0].size for s in streams)
    pad = [tuple(np.pad(x, (0, t - x.size)) for x in s) for s in streams]
    v, st, va = (np.stack([p[i] for p in pad]) for i in range(3))
    ref = jax.vmap(lambda a, b, c: circuit_jax.jugglepac_scan(
        a, b, c, latency=lat, num_registers=regs))(
            jnp.asarray(v), jnp.asarray(st), jnp.asarray(va))
    outs = circuit_scan.jugglepac_scan(torch.tensor(v), torch.tensor(st),
                                       torch.tensor(va), latency=lat,
                                       num_registers=regs, device="cpu")
    assert all(o.shape == (3, t) for o in outs)
    _assert_bitwise(ref, outs)
    assert outs[3][2].any() and not outs[3][0].any()


def test_run_sets_matches_both_references():
    """``run_sets`` against ``circuit_jax.run_sets`` (identical lists) and
    the Python ``JugglePAC.run`` (set, value and cycle, on integer values
    whose sums are exact in float32)."""
    rng = random.Random(3)
    for lat, regs, sizes in [(14, 4, [40, 33, 50, 29, 64, 41]),
                             (5, 2, [30, 70, 45]), (2, 4, [5, 4, 9]),
                             (14, 2, [5] * 20)]:
        sets = [[float(rng.randrange(1, 50)) for _ in range(n)]
                for n in sizes]
        got, ovf = circuit_scan.run_sets(sets, latency=lat,
                                         num_registers=regs, device="cpu")
        want, want_ovf = circuit_jax.run_sets(sets, latency=lat,
                                              num_registers=regs)
        assert got == want and ovf == want_ovf
        pac = circuit.JugglePAC(lat, regs)
        py = [(r.set_index, r.value, r.cycle) for r in pac.run(sets)]
        if not ovf:
            assert got == py and pac.fifo_overflows == 0
        else:
            assert pac.fifo_overflows > 0
    got, _ = circuit_scan.run_sets([[1.0, 2.0], [3.0]], latency=2,
                                   num_registers=2, drain=3, device="cpu")
    assert got == circuit_jax.run_sets([[1.0, 2.0], [3.0]], latency=2,
                                       num_registers=2, drain=3)[0]


def test_kernel_shared_memory_fits_a_block_and_grows_with_l_and_r():
    """The kernel's shared memory a block (``smem_bytes``, which the
    wrapper passes to the launch) stays under Hopper's 232,448 B for every
    1 <= L, R <= 64 and grows with each of L and R; at the paper's design
    point (L = 14, R = 4) four blocks fit an SM's 233,472 B (1 KB of it
    reserved a block), so 65,536 circuits fit 132 SMs at once."""
    from repro_torch.kernels import _build, jugglepac_fsm
    size = np.array([[jugglepac_fsm.smem_bytes(lat, regs)
                      for regs in range(1, 65)] for lat in range(1, 65)])
    assert _build.SMEM_BYTES == 232448
    assert size.max() < _build.SMEM_BYTES
    assert (np.diff(size, axis=0) > 0).all()
    assert (np.diff(size, axis=1) > 0).all()
    assert 4 * (size[13, 3] + 1024) <= 233472
    assert 4 * 132 * jugglepac_fsm.THREADS >= 65536


def test_scan_without_device_raises_when_cuda_is_absent():
    """``device=None`` means the card; ``device="cpu"`` runs the plain
    version.  The kernel's wrapper refuses what it lacks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch.kernels import jugglepac_fsm
    v = torch.ones(8)
    b = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        circuit_scan.jugglepac_scan(v, b, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        circuit_scan.run_sets([[1.0, 2.0]])
    outs = circuit_scan.jugglepac_scan(v, b, b, device="cpu")
    assert [o.shape for o in outs] == [(8,)] * 4
    assert circuit_scan.run_sets([[1.0, 2.0]], latency=2,
                                 device="cpu")[0] == [(0, 3.0, 8)]
    v2, b2 = v[None], b[None]
    for kw in ({"latency": 65}, {"num_registers": 65}):
        with pytest.raises(ValueError, match="<= 64"):
            jugglepac_fsm.jugglepac_fsm_cuda(v2, b2, b2, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        jugglepac_fsm.jugglepac_fsm_cuda(v2, b2, b2)
    assert jugglepac_fsm.LAUNCHES == 0
