"""GPU-only tests of the port: K1 against its plain version on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False.  The file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import jugglepac_segsum as K  # noqa: E402
from repro_torch.reduce import get_policy, plan_program  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
S = 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False (the kernel has no CPU mode; chip_smoke.py runs "
                    "the same comparison on the GPU)")
    return torch.device("cuda")


def _stream(seed, n, d, s):
    rng = np.random.RandomState(seed)
    vals = (rng.randn(n, d) * 2.0 ** rng.randint(-6, 6, (n, 1))) \
        .astype(np.float32)
    ids = rng.randint(-1, s, n).astype(np.int32)
    return vals, ids


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_kernel_bitwise_plain_version(policy, cuda):
    """Every tier x {dot, lanes} x block sizes {64, 128, 512}, on a ragged
    stream (4,000 rows: the kernel reads the missing rows of the last
    block as sentinel rows; the plain version is given them padded)."""
    vals, ids = _stream(11, 4000, 16, S)
    pol = get_policy(policy)
    dom, _ = pol.prepare(torch.tensor(vals, device=cuda), len(ids))
    tids = torch.tensor(ids, device=cuda)
    for contrib in ("dot", "lanes"):
        for block in (64, 128, 512):
            prog = plan_program(pol, num_segments=S,
                                domain_width=dom.shape[1], block_size=block,
                                contrib=contrib)
            pad = (-len(ids)) % block
            pdom = torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))])
            pids = torch.cat([tids, tids.new_full((pad,), -1)])
            plain = K.segsum_policy_torch(pdom, pids, S, policy=pol,
                                          program=prog, block_rows=block)
            kern = K.segsum_policy_cuda(dom, tids, S, policy=pol,
                                        program=prog, block_rows=block)
            torch.cuda.synchronize()
            for a, b in zip(plain, kern):
                assert torch.equal(a, b), (policy, contrib, block)


@pytest.mark.cuda
def test_reduce_runs_on_the_card_by_default(cuda):
    """``device=None`` means the card: the result lives there, K1 ran, and
    it equals the plain ``blocked`` executor's bits for every tier."""
    vals, ids = _stream(12, 3000, 8, 40)
    for policy in POLICIES:
        before = K.LAUNCHES
        out = repro_torch.reduce(torch.tensor(vals),
                                 segment_ids=torch.tensor(ids),
                                 num_segments=40, policy=policy)
        assert out.is_cuda and K.LAUNCHES == before + 1
        plain = repro_torch.reduce(torch.tensor(vals, device=cuda),
                                   segment_ids=torch.tensor(ids,
                                                            device=cuda),
                                   num_segments=40, policy=policy,
                                   backend="blocked")
        assert torch.equal(out, plain), policy
