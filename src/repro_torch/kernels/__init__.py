"""Hand-written Hopper kernels and their plain PyTorch versions.

  * ``jugglepac_segsum`` — K1, the block-schedule kernel every accuracy
    tier runs on a CUDA device (``csrc/segsum.cu``), with its plain
    version ``segsum_policy_torch`` and the launch counter ``LAUNCHES``;
  * ``ops``     — ``seg_tile_for`` (the label tile of one CUDA block) and
    the fast-tier ``segment_sum`` wrapper;
  * ``ref``     — ``segsum_ref``, the scatter-add math oracle;
  * ``_build``  — builds each CUDA source with ``nvcc`` on first use and
    loads it with ``ctypes``.

Nothing here compiles or loads a kernel at import time.
"""
