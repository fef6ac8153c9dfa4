"""Hand-written Hopper kernels and their plain PyTorch versions.

  * ``jugglepac_segsum`` — K1, the block-schedule kernel every accuracy
    tier runs on a CUDA device (``csrc/segsum.cu``), with its plain
    version ``segsum_policy_torch`` and the launch counter ``LAUNCHES``;
  * ``flash_decode`` (module) — K2, K3, K4, decode attention dense,
    chunked into raw partials, and paged (``csrc/flash_decode.cu``), with
    their plain versions and the counters ``LAUNCHES[mode]``;
  * ``intac_accum`` (module) — K5, exact fixed-point column sums
    (``csrc/intac_accum.cu``), its plain version and ``LAUNCHES``;
  * ``jugglepac_fsm`` — the JugglePAC state machine, one CUDA thread a
    circuit (``csrc/jugglepac_fsm.cu``; the counterpart of the reference's
    ``lax.scan`` in ``core/circuit_jax.py``, not of a TPU kernel), its
    plain version and ``LAUNCHES``; ``core.circuit_scan`` calls it;
  * ``ops``     — the public wrappers ``segment_sum``, ``intac_accum``,
    ``flash_decode`` and ``flash_decode_paged`` (exported here; they
    shadow the two module names as attributes of this package, so reach
    the modules with ``from repro_torch.kernels.flash_decode import ...``
    or ``importlib.import_module``), and K1's tiling rule;
  * ``ref``     — the math oracles;
  * ``_build``  — builds each CUDA source with ``nvcc`` on first use and
    loads it with ``ctypes``.

Nothing here compiles or loads a kernel at import time.
"""

from . import ops, ref  # noqa: F401
from .ops import (flash_decode, flash_decode_paged,  # noqa: F401
                  intac_accum, segment_sum)
