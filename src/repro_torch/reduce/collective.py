"""Policy-selectable means across the ranks of a process group — the
distributed face of ``repro_torch.reduce``, as the reference's
``reduce/collective.py``.

Each function runs in every rank of ``group`` (one process per rank) and
returns the same result on each.  One accuracy knob, as in the array API:

  * ``fast``          — the ranks' tensors gathered and summed by the fixed
                        pairwise tree (``core.trees``) in rank order, then
                        divided once.  The reference takes a float psum
                        here, whose order is unspecified; the port pins it.
  * ``compensated``   — the compressed mean with error feedback
                        (``core.intac.compressed_psum_mean``): ``bits``-bit
                        quanta on a pmax-shared scale, summed as integers;
                        the local quantization error is the next step's
                        residual.
  * ``exact``         — ``intac_psum``: one int32 psum, bitwise the same at
                        any rank count or order.
  * ``exact2``        — ``intac_psum3``: two limbs and the residual's
                        digits in one int32 psum; bitwise at any rank count
                        and within 1 ulp of float64.
  * ``procrastinate`` — ``bin_psum``: exponent-bin digits in one int32 psum.

Every tier returns ``(mean, new_residual)``; only compensated makes a
residual, the others pass ``residual`` through.

``merge_carry_across`` is the other face: it merges the *policy carries*
the ``shard_map`` executor's ranks produced (``Policy.merge_across``).
``elastic_reduce_mean`` reduces a stack of items (microbatch gradients,
losses) sharded over the ranks to its global mean, bitwise the same
however the stack is split across ranks, for the integer tiers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import intac
from ..core.trees import pairwise_tree_sum
from ..distributed import comm
from .backends import select_local_backend
from .policy import Policy, get_policy

COLLECTIVE_POLICIES = ("fast", "compensated", "exact", "exact2",
                       "procrastinate")


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """x / n with a float32 tensor divisor, as the reference divides by
    a float32 count: an IEEE division on every device (a Python-scalar
    divisor may become a reciprocal multiply)."""
    return x / torch.tensor(float(n), dtype=torch.float32, device=x.device)


def merge_carry_across(policy: Policy, carry, group):
    """Merge the ranks' policy carries with the policy's own combiner
    (``Policy.merge_across``): one integer ``psum`` for an integer carry,
    a gather and a strict rank-order fold with ``merge`` for a float
    carry.  Every rank gets the merged carry."""
    return policy.merge_across(carry, group)


def _fast_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' tensors summed by the fixed pairwise tree, rank order."""
    return pairwise_tree_sum(comm.all_gather(x, group), axis=0)


def collective_mean(x: torch.Tensor, group, *, policy: str = "fast",
                    bits: int = 8, residual: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The mean of ``x`` over ``group``'s ranks under an accuracy policy
    -> (mean, new residual).

    >>> import torch
    >>> from repro_torch.distributed import comm
    >>> g = comm.init_group("gloo")                 # one rank alone
    >>> collective_mean(torch.tensor([1.5, -2.0]), g,
    ...                 policy="exact2")[0].tolist()
    [1.5, -2.0]
    """
    n = comm.axis_size(group)
    if policy == "fast":
        return _div(_fast_sum(x, group), n), residual
    if policy == "exact":
        return _div(intac.intac_psum(x, group), n), residual
    if policy == "exact2":
        return _div(intac.intac_psum3(x, group), n), residual
    if policy == "procrastinate":
        return _div(intac.bin_psum(x, group), n), residual
    if policy == "compensated":
        if residual is None:       # only this policy makes a state
            residual = torch.zeros(x.shape, dtype=torch.float32,
                                   device=x.device)
        return intac.compressed_psum_mean(x, residual, group, bits=bits)
    raise ValueError(f"unknown collective policy {policy!r}; "
                     f"choose from {COLLECTIVE_POLICIES}")


def collective_weighted_mean(x: torch.Tensor, w: torch.Tensor, group, *,
                             policy: str = "fast", bits: int = 8,
                             eps: float = 1e-9) -> torch.Tensor:
    """``sum(w * x) / sum(w)`` over the ranks: the weighted numerator and
    the weight mass each through ``collective_mean`` (the rank counts
    cancel), each on its own quantization grid."""
    num, _ = collective_mean(x * w, group, policy=policy, bits=bits)
    den, _ = collective_mean(w, group, policy=policy, bits=bits)
    return num / torch.clamp(den, min=eps)


def collective_moments(x: torch.Tensor, group, *, policy: str = "fast",
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise (mean, var) over the ranks: E[x] and E[x^2] through two
    ``collective_mean`` calls (each on its own grid), var = max(E[x^2] -
    E[x]^2, 0)."""
    m1, _ = collective_mean(x, group, policy=policy, bits=bits)
    m2, _ = collective_mean(x * x, group, policy=policy, bits=bits)
    return m1, torch.clamp(m2 - m1 * m1, min=0.0)


def elastic_reduce_mean(stack: torch.Tensor, group, *,
                        policy: str = "exact2",
                        block_size: int = 512) -> torch.Tensor:
    """The global mean of a stack of items sharded over the ranks.

    ``stack`` is this rank's (m_local, ...) slice of a global stack of
    items; the result is the mean over all items of all ranks.  Under a
    bitwise policy (``exact2``, ``exact``, ``procrastinate``) its bits do
    not depend on how the global stack is split across ranks: the
    quantization grid comes from the pmax-shared global max, the local
    block schedule's integer carry is a function of the integer sums
    alone, and the carries merge by one integer ``psum``.  The local fold
    is the device's executor (K1 on a CUDA device; the reference pins
    ``blocked``, which is bitwise the same for the integer tiers)."""
    pol = get_policy(policy)
    m_local = stack.shape[0]
    flat = stack.reshape(m_local, -1).to(torch.float32)
    num_total = comm.psum_int(m_local, group, device=flat.device)
    gmax = comm.pmax(torch.max(torch.abs(flat)), group)
    domain, ctx = pol.prepare(flat, num_total, shared_max=gmax)
    del flat
    ids = torch.zeros(m_local, dtype=torch.int32, device=stack.device)
    carry = select_local_backend(pol, stack.device).run(
        domain, ids, 1, policy=pol, block_size=block_size)
    del domain
    carry = merge_carry_across(pol, carry, group)
    out = pol.finalize(carry, ctx)[0]
    return _div(out, num_total).reshape(stack.shape[1:])


def collective_mean_tree(grads, residuals, group, *, policy: str = "fast",
                         bits: int = 8):
    """``collective_mean`` over a dict of tensors -> (means, residuals);
    ``residuals`` may be None.

    The fast tier fuses the dict: every leaf of a dtype is flattened into
    one payload, gathered once and summed by the pairwise tree (each
    element's sum is the one a leaf alone gets).  The integer tiers keep
    one reduction per leaf: each leaf's quantization grid is its own."""
    keys = list(grads)
    res = {k: None for k in keys} if residuals is None else residuals
    if policy == "fast" and len(keys) > 1:
        n = comm.axis_size(group)
        by_dtype: dict = {}
        for k in keys:
            by_dtype.setdefault(grads[k].dtype, []).append(k)
        out = {}
        for ks in by_dtype.values():
            flat = torch.cat([grads[k].reshape(-1) for k in ks])
            total = _div(_fast_sum(flat, group), n)
            off = 0
            for k in ks:
                size = grads[k].numel()
                out[k] = total[off:off + size].reshape(grads[k].shape)
                off += size
        return {k: out[k] for k in keys}, residuals
    means, new_res = {}, {}
    for k in keys:
        means[k], new_res[k] = collective_mean(grads[k], group,
                                               policy=policy, bits=bits,
                                               residual=res[k])
    if residuals is None and policy != "compensated":
        return means, None
    return means, new_res


__all__ = ["COLLECTIVE_POLICIES", "merge_carry_across", "collective_mean",
           "collective_weighted_mean", "collective_moments",
           "elastic_reduce_mean", "collective_mean_tree"]
