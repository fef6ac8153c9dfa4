"""GPU-only tests of K1 under autograd: ``reduce(..., backend="cuda")``
and ``rmsnorm(policy=)`` on values that require grad, against the
``blocked`` executor on the same card.

The ``cuda`` executor differentiates through
``backends.run_with_carry_grad``: K1 in the forward, a gather of the
carry's gradient by label in the backward.  Its output and gradient are
bitwise those of autograd through ``blocked``, at every tier, at one
label (K1's column-wide fold) and at many.  Every test carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is False.
The file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_cuda_autograd.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import jugglepac_segsum as K  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
S = 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False (K1 has no CPU mode; tests/test_torch_autograd.py "
                    "holds the same gradient around the blocked executor, "
                    "and chip_smoke.py's phase 23 runs this comparison on "
                    "the GPU)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().contiguous()
    view = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(view)


def _grad_run(x, backend, policy, cot, **kw):
    """(output, dL/dx, K1 launches forward, backward)."""
    v = x.clone().requires_grad_(True)
    K.LAUNCHES = 0
    out = repro_torch.reduce(v, policy=policy, backend=backend,
                             device=x.device, **kw)
    fwd = K.LAUNCHES
    if out.requires_grad:
        g, = torch.autograd.grad(out, v, cot)
    else:
        g = torch.zeros_like(v)
    torch.cuda.synchronize()
    return out.detach(), g, fwd, K.LAUNCHES - fwd


@pytest.mark.cuda
@pytest.mark.parametrize("labelled", (True, False), ids=("many", "one"))
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_reduce_grad_bitwise_blocked(policy, labelled, cuda):
    """``reduce(op="sumsq")`` of 5,000 x 24 values that require grad, with
    sentinel and out-of-range rows at 48 labels or unsegmented: K1's output
    and dL/dx bitwise ``blocked``'s, K1 launched once in the forward and
    never in the backward; the integer tiers' results outside the graph."""
    rng = np.random.default_rng(7)
    x = torch.tensor((rng.standard_normal((5000, 24))
                      * np.exp2(rng.integers(-6, 6, (5000, 1))))
                     .astype(np.float32), device=cuda)
    kw = {}
    shape = (24,)
    if labelled:
        kw = {"segment_ids": torch.tensor(
                  rng.integers(-1, S + 1, 5000).astype(np.int32),
                  device=cuda),
              "num_segments": S}
        shape = (S, 24)
    cot = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                       device=cuda)
    got = _grad_run(x, "cuda", policy, cot, op="sumsq", **kw)
    want = _grad_run(x, "blocked", policy, cot, op="sumsq", **kw)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert got[2:] == (1, 0) and want[2:] == (0, 0)
    if policy in ("fast", "compensated"):
        assert bool(got[1].abs().sum() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_rmsnorm_grad_bitwise_blocked(policy, cuda):
    """``rmsnorm(g, x, policy=)`` on (4, 64, 512) bf16 tokens (one label:
    K1's column-wide fold over the 512 features): output, dL/dx and dL/dg
    bitwise between ``backend="cuda"`` and ``backend="blocked"``."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x0 = torch.randn(4, 64, 512, generator=gen, device=cuda).bfloat16()
    g0 = (1 + 0.1 * torch.randn(512, generator=gen, device=cuda)).bfloat16()
    cot = torch.randn(4, 64, 512, generator=gen, device=cuda).bfloat16()
    res = []
    for backend in ("cuda", "blocked"):
        g = g0.clone().requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        y = TL.rmsnorm(g, x, 1e-5, policy=policy, backend=backend)
        res.append((y,) + torch.autograd.grad(y, (x, g), cot))
    for a, b in zip(*res):
        assert torch.equal(_bits(a), _bits(b))
