"""repro_torch.reduce — one front door for every reduction, on one device
or across the ranks of a process group.

Three orthogonal knobs, as in the reference package:

  * **op** (``algebra.py``): sum / mean / weighted_sum / sumsq / moments /
    poly — row-local pre/post hooks around the one block schedule;
  * **policy** (``policy.py``): fast / compensated / exact / exact2 /
    procrastinate;
  * **backend** (``backends.py``): ref / blocked (plain PyTorch) and cuda
    (the hand-written Hopper kernel) — bitwise equal per policy — and
    shard_map, which runs one of them in each rank of a process group.

``collective.py`` holds the means across ranks (``collective_mean`` and
its tree, weighted and moments faces, ``elastic_reduce_mean``) and the
carry merge of the ``shard_map`` executor.

The module itself is callable: ``repro_torch.reduce(values, ...)``.
"""

from .accumulator import (Accumulator, BinAccumulator,  # noqa: F401
                          CascadeAccumulator, FlashAccumulator,
                          KahanAccumulator, Limb3Accumulator,
                          LimbAccumulator, TreeAccumulator,
                          accumulate_microbatch_grads, merge_across,
                          merge_tree, reduce_microbatch_grads,
                          scan_accumulate)
from .algebra import (REDUCE_OPS, ReduceOp, cascade_poly_coeffs,  # noqa: F401
                      cascade_weights, fir_weights, get_op, poly_weights,
                      register_op)
from .api import ReduceSpec, ReduceStatus, reduce  # noqa: F401
from .backends import (BACKENDS, Backend, OUT_OF_RANGE_LABEL,  # noqa: F401
                       get_backend, mask_out_of_range, register_backend,
                       select_backend, select_local_backend)
from .collective import (COLLECTIVE_POLICIES,  # noqa: F401
                         collective_mean, collective_mean_tree,
                         collective_moments, collective_weighted_mean,
                         elastic_reduce_mean, merge_carry_across)
from .policy import (POLICIES, Policy, fused_psum, get_policy,  # noqa: F401
                     register_policy, two_sum)
from .program import (BlockProgram, BlockStage,  # noqa: F401
                      block_contrib, plan_program)
from . import interop  # noqa: F401

import sys as _sys


class _CallableModule(_sys.modules[__name__].__class__):
    def __call__(self, *args, **kwargs):
        return reduce(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule

__all__ = [
    "reduce", "ReduceSpec", "ReduceStatus", "OUT_OF_RANGE_LABEL",
    "Policy", "POLICIES", "register_policy", "get_policy", "two_sum",
    "ReduceOp", "REDUCE_OPS", "register_op", "get_op",
    "poly_weights", "fir_weights", "cascade_weights",
    "cascade_poly_coeffs",
    "BlockProgram", "BlockStage", "plan_program", "block_contrib",
    "Backend", "BACKENDS", "register_backend", "get_backend",
    "select_backend", "select_local_backend", "mask_out_of_range",
    "interop",
    "Accumulator", "TreeAccumulator", "KahanAccumulator",
    "LimbAccumulator", "Limb3Accumulator", "BinAccumulator",
    "FlashAccumulator", "CascadeAccumulator",
    "scan_accumulate", "merge_tree", "merge_across",
    "reduce_microbatch_grads", "accumulate_microbatch_grads",
    "COLLECTIVE_POLICIES", "collective_mean", "collective_mean_tree",
    "collective_moments", "collective_weighted_mean", "elastic_reduce_mean",
    "merge_carry_across", "fused_psum",
]
