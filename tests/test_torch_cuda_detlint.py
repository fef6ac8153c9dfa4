"""GPU-only tests of the port's determinism lint: the contract matrix on
the card and the one fault it leaves open.

``run_contracts(device="cuda")`` over the single-device backends runs
the 90 op x policy x backend rows, K1 in the 30 ``cuda`` rows, with no
unwaived finding and no row "not run"; each integer tier's ``cuda``
result is bitwise ``ref``'s and ``blocked``'s.  F6 (ROADMAP queue 3):
``core.segmented.segment_mean`` on float rows adds through
``index_add_``, whose CUDA atomics have no fixed order, so two runs on
the same inputs can differ; the front door on the same rows does not.
Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_cuda_detlint.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.analysis import contracts as C  # noqa: E402
from repro_torch.core import segmented as TS  # noqa: E402
from repro_torch.kernels import jugglepac_segsum as K  # noqa: E402

BACKENDS = ("ref", "blocked", "cuda")
INT_TIERS = ("exact", "exact2", "procrastinate")
OPS = ("mean", "moments", "poly", "sum", "sumsq", "weighted_sum")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False (K1 has no CPU mode; "
                    "tests/test_torch_detlint_contracts.py runs the matrix's "
                    "ref and blocked rows on the CPU, and chip_smoke.py's "
                    "phase 24 runs this matrix on the GPU)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().contiguous().cpu()
    view = {4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.view(view) if t.is_floating_point() else t


@pytest.mark.cuda
def test_cuda_contract_matrix_clean_with_every_row_run(cuda):
    K.LAUNCHES = 0
    found = C.run_contracts(device=cuda, backends=BACKENDS)
    launches = K.LAUNCHES
    assert not [f for f in found if f.not_run], \
        "\n".join(str(f) for f in found if f.not_run)
    assert not [f for f in found if not f.waived], \
        "\n".join(map(str, found))
    assert [(f.rule, f.path) for f in found] == [("DET102", "fast")]
    assert "cuda" in found[0].message       # K1's own float carry
    assert C.matrix_size(BACKENDS) == 90
    # 5 carries (DET101) and 30 front-door rows (DET105) on the cuda row
    assert launches >= 30


@pytest.mark.cuda
@pytest.mark.parametrize("tier", INT_TIERS)
def test_cuda_integer_tiers_bitwise_ref_and_blocked(cuda, tier):
    ctx = C._Ctx.build(cuda, None, BACKENDS)
    for op in OPS:
        for bs in C._BLOCK_SIZES:
            K.LAUNCHES = 0
            got = ctx.run_reduce(tier, "cuda", op, block_size=bs)
            assert K.LAUNCHES >= 1, (op, bs)
            for other in ("ref", "blocked"):
                want = ctx.run_reduce(tier, other, op, block_size=bs)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(_bits(got), _bits(want)), (op, bs, other)


@pytest.mark.cuda
def test_cuda_segment_mean_float_rows_differ_run_to_run_f6(cuda):
    """F6, pinned: the oracle-backed ``segment_mean`` repeats its bits only
    by chance on the card; ``reduce(op="mean")`` on the same rows always
    does."""
    rng = np.random.RandomState(0)
    n = 1 << 20
    vals = (rng.standard_normal((n, 4))
            * np.exp2(rng.randint(-12, 13, (n, 1)))).astype(np.float32)
    v = torch.from_numpy(vals).to(cuda)
    ids = torch.from_numpy((np.arange(n) % 2).astype(np.int32)).to(cuda)
    runs = {_bits(TS.segment_mean(v, ids, 2)).numpy().tobytes()
            for _ in range(16)}
    torch.cuda.synchronize()
    assert len(runs) > 1, "segment_mean repeated its bits 16 times: F6 " \
        "may be gone (update ROADMAP queue 3 and the pragma)"
    front = {_bits(repro_torch.reduce(v, segment_ids=ids, num_segments=2,
                                      op="mean", policy="fast",
                                      device=cuda)).numpy().tobytes()
             for _ in range(4)}
    assert len(front) == 1
