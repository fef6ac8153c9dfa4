"""The port's ``reduce`` and ``rmsnorm(policy=)`` under autograd against
``jax.grad`` of the reference, on the CPU.

The reference defines no custom gradient for ``reduce``: its gradient is
what ``jax.grad`` derives through the ``ref`` and ``blocked`` executors.
For ``fast`` and ``compensated`` each kept row receives its set's
incoming gradient (IEEE adds pass it exactly; TwoSum's residual passes
0), a dropped row 0; the integer tiers (``exact``, ``exact2``,
``procrastinate``) pass 0, as an int32 cast does.  The port's ``ref``
and ``blocked`` executors derive the same through autograd, and the
``cuda`` executor (K1) gives it through ``backends.run_with_carry_grad``,
which these tests wrap around ``blocked`` on the CPU.

Tolerances: the integer tiers' gradients (zeros) and ``exact2``'s
forward bitwise; the float tiers' gradients within 1e-6 relative (the
packages differ only in how ``sumsq``'s 2 x g and the norm's rsqrt are
rounded).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch import reduce as treduce  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.reduce import backends as TB  # noqa: E402

CPU = "cpu"
TIERS = ("fast", "compensated", "exact", "exact2", "procrastinate")
FLOAT_TIERS = ("fast", "compensated")
#: gradients of the float tiers, relative to the reference's
GRAD_RTOL = 1e-6
#: rows, columns, labels and schedule rows of the test streams
N, W, S, BLOCK = 300, 5, 7, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, labelled: bool):
    """(values (N, W), ids (N,) or None, num_segments or None, cotangent):
    a labelled stream holds sentinel rows (labels -1 and S, out of range),
    a one-label stream is unsegmented."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, W))
         * np.exp2(rng.uniform(-4, 4, (N, W)))).astype(np.float32)
    if not labelled:
        return x, None, None, rng.standard_normal(W).astype(np.float32)
    ids = rng.integers(-1, S + 1, N).astype(np.int32)
    return x, ids, S, rng.standard_normal((S, W)).astype(np.float32)


def _ref_grad(x, ids, ns, cot, *, op, policy, backend):
    kw = {} if ids is None else {"segment_ids": jnp.asarray(ids),
                                 "num_segments": ns}

    def f(v):
        out = repro.reduce(v, op=op, policy=policy, backend=backend,
                           block_size=BLOCK, **kw)
        return jnp.sum(out * jnp.asarray(cot))
    return np.asarray(jax.grad(f)(jnp.asarray(x)))


def _port_grad(x, ids, ns, cot, *, op, policy, backend):
    """(forward, dL/dx): zeros where the result is outside the graph."""
    kw = {} if ids is None else {"segment_ids": torch.from_numpy(ids),
                                 "num_segments": ns}
    v = torch.from_numpy(x).requires_grad_(True)
    out = treduce.reduce(v, op=op, policy=policy, backend=backend,
                         block_size=BLOCK, device=CPU, **kw)
    if not out.requires_grad:
        return out, torch.zeros_like(v)
    g, = torch.autograd.grad(out, v, torch.from_numpy(cot))
    return out.detach(), g


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("policy", TIERS)
@pytest.mark.parametrize("op", ("sum", "sumsq"))
def test_reduce_grad_matches_jax(op, policy):
    """``reduce``'s gradient on ``ref`` and ``blocked``, labelled (with
    sentinel rows) and one-label streams, against ``jax.grad`` of the
    reference on the same executor: the integer tiers' zeros bitwise, the
    float tiers' within ``GRAD_RTOL``.  The float tiers' gradients are
    bitwise equal across the port's executors."""
    for seed, labelled in ((1, True), (2, False)):
        x, ids, ns, cot = _stream(seed, labelled)
        grads = {}
        for backend in ("ref", "blocked"):
            want = _ref_grad(x, ids, ns, cot, op=op, policy=policy,
                             backend=backend)
            _, got = _port_grad(x, ids, ns, cot, op=op, policy=policy,
                                backend=backend)
            grads[backend] = got.numpy()
            if policy in FLOAT_TIERS:
                np.testing.assert_allclose(got.numpy(), want,
                                           rtol=GRAD_RTOL, atol=0)
                if labelled:
                    dropped = (ids < 0) | (ids >= ns)
                    assert dropped.any() and not got.numpy()[dropped].any()
            else:
                assert not want.any()
                np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(grads["ref"]),
                                      _bits(grads["blocked"]))


@pytest.mark.parametrize("policy", TIERS)
def test_rmsnorm_grad_matches_jax(policy):
    """``rmsnorm(g, x, policy=)`` (one label: each token's mean square
    over the feature stream) on ``ref`` and ``blocked``: output, dL/dx
    and dL/dg against ``jax.grad`` of the reference's ``rmsnorm``, within
    ``GRAD_RTOL``, and bitwise across the two executors."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 4, 96)).astype(np.float32)
    gam = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    cot = rng.standard_normal((3, 4, 96)).astype(np.float32)

    def f(g, v):
        return jnp.sum(RL.rmsnorm(g, v, 1e-5, policy=policy)
                       * jnp.asarray(cot))
    want_g, want_x = (np.asarray(a) for a in
                      jax.grad(f, argnums=(0, 1))(jnp.asarray(gam),
                                                  jnp.asarray(x)))
    want_y = np.asarray(RL.rmsnorm(jnp.asarray(gam), jnp.asarray(x), 1e-5,
                                   policy=policy))
    got = {}
    for backend in ("ref", "blocked"):
        g = torch.from_numpy(gam).requires_grad_(True)
        v = torch.from_numpy(x).requires_grad_(True)
        y = TL.rmsnorm(g, v, 1e-5, policy=policy, backend=backend)
        dg, dx = torch.autograd.grad(y, (g, v), torch.from_numpy(cot))
        got[backend] = (y.detach().numpy(), dx.numpy(), dg.numpy())
        for a, b in zip(got[backend], (want_y, want_x, want_g)):
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=1e-6)
    for a, b in zip(got["ref"], got["blocked"]):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_carry_grad_function_bitwise_autograd_through_blocked(monkeypatch):
    """``run_with_carry_grad`` around ``blocked`` (the forward the
    executor's, the backward a gather by label) against autograd through
    the bare ``blocked`` executor: the carry and dL/dx bitwise for both
    float tiers at one label and at many, with a -0 in the incoming
    gradient; then through ``reduce`` with ``blocked`` registered as a
    kernel (``autograd=False``), as the ``cuda`` executor is."""
    bk = TB.get_backend("blocked")
    for policy in FLOAT_TIERS:
        pol = treduce.get_policy(policy)
        for ns in (1, S):
            rng = np.random.default_rng(ns)
            x = torch.from_numpy(rng.standard_normal((N, W))
                                 .astype(np.float32))
            ids = torch.from_numpy(rng.integers(-1, ns + 1, N)
                                   .astype(np.int32))
            cot = torch.from_numpy(rng.standard_normal((ns, W))
                                   .astype(np.float32))
            cot[0, 0] = -0.0
            res = []
            for wrap in (False, True):
                v = x.clone().requires_grad_(True)
                ids_m = TB.mask_out_of_range(ids, ns)
                if wrap:
                    carry = TB.run_with_carry_grad(bk.run, v, ids_m, ns,
                                                   policy=pol,
                                                   block_size=BLOCK)
                else:
                    carry = bk.run(v, ids_m, ns, policy=pol,
                                   block_size=BLOCK)
                out = pol.finalize(carry, None)
                g, = torch.autograd.grad(out, v, cot)
                res.append((out.detach(), g))
            for a, b in zip(*res):
                np.testing.assert_array_equal(_bits(a), _bits(b))
    x, ids, ns, cot = _stream(5, True)
    want = {p: _port_grad(x, ids, ns, cot, op="sumsq", policy=p,
                          backend="blocked") for p in TIERS}
    monkeypatch.setitem(TB.BACKENDS, "blocked",
                        dataclasses.replace(bk, autograd=False))
    for p in TIERS:
        got = _port_grad(x, ids, ns, cot, op="sumsq", policy=p,
                         backend="blocked")
        for a, b in zip(got, want[p]):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_exact2_forward_bitwise_reference_under_autograd():
    """``exact2`` on values that require grad (its domain leaves the graph
    in ``to_domain``, where ``nan_to_num(out=)`` used to refuse them):
    the forward bitwise the reference's and the detached run's on both
    executors, labelled and one-label, and outside the graph."""
    for seed, labelled in ((3, True), (4, False)):
        x, ids, ns, _ = _stream(seed, labelled)
        kw = {} if ids is None else {"segment_ids": jnp.asarray(ids),
                                     "num_segments": ns}
        want = np.asarray(repro.reduce(jnp.asarray(x), policy="exact2",
                                       block_size=BLOCK, **kw))
        tkw = {} if ids is None else {"segment_ids": torch.from_numpy(ids),
                                      "num_segments": ns}
        for backend in ("ref", "blocked"):
            for grad in (True, False):
                v = torch.from_numpy(x).requires_grad_(grad)
                out = treduce.reduce(v, policy="exact2", backend=backend,
                                     block_size=BLOCK, device=CPU, **tkw)
                assert not out.requires_grad
                np.testing.assert_array_equal(_bits(out.numpy()),
                                              _bits(want))
