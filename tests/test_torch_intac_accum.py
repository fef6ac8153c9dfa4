"""K5 — INTAC exact fixed-point column sums — held against the TPU kernel.

Integer limbs, so bitwise: the port's ``ops.intac_accum(device="cpu")``
(the kernel's plain version) against ``repro.kernels.ops.intac_accum``
(Pallas in interpret mode) and the oracle ``intac_accum_ref`` of both
packages.  The CUDA kernel is held to the plain version bitwise in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as J  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402


@pytest.mark.parametrize("n,d,scale", [
    (256, 64, 2.0 ** 18), (700, 32, 2.0 ** 12), (128, 128, 2.0 ** 20)])
def test_intac_accum_bitwise_reference(n, d, scale):
    vals = np.random.RandomState(n).randn(n, d).astype(np.float32)
    want = np.asarray(J.intac_accum(jnp.asarray(vals), jnp.float32(scale)))
    got = T.intac_accum(torch.tensor(vals), scale, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, d)
    assert np.array_equal(got.numpy(), want)
    oracle = TR.intac_accum_ref(torch.tensor(vals), scale).numpy()
    assert np.array_equal(oracle, want)
    assert np.array_equal(
        oracle, np.asarray(JR.intac_accum_ref(jnp.asarray(vals),
                                              jnp.float32(scale))))
    back = TR.limbs_to_float(got, scale).numpy()
    assert np.array_equal(
        back, np.asarray(JR.limbs_to_float(jnp.asarray(want), scale)))
    np.testing.assert_allclose(back, vals.sum(0), atol=4.0 / scale * n)


def test_intac_accum_block_invariance():
    vals = torch.tensor(
        np.random.RandomState(2).randn(512, 16).astype(np.float32))
    a = T.intac_accum(vals, 2.0 ** 16, block_rows=64, device="cpu")
    b = T.intac_accum(vals, 2.0 ** 16, block_rows=256, device="cpu")
    assert torch.equal(a, b)


def test_intac_overflow_guard():
    with pytest.raises(ValueError, match="2\\^15"):
        T.intac_accum(torch.zeros((1 << 15) + 1, 8), 1.0, device="cpu")


def test_half_way_values_round_to_even():
    """x * scale = k + 0.5 exactly: jnp.round and torch.round (and the
    kernel's rintf) round half to even, so 2.5 -> 2 and 3.5 -> 4, where
    round-half-away would give 3 and 4."""
    vals = np.asarray([[2.5 / 16, 3.5 / 16, -2.5 / 16, 0.5 / 16]],
                      np.float32)
    got = T.intac_accum(torch.tensor(vals), 16.0, device="cpu")
    want = np.asarray(J.intac_accum(jnp.asarray(vals), jnp.float32(16.0)))
    assert np.array_equal(got.numpy(), want)
    q = got[0].long() * 32768 + got[1].long()
    assert q.tolist() == [2, 4, -2, 0]
