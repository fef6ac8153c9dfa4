"""K5: INTAC exact fixed-point accumulation.

The Hopper counterpart of the TPU kernel ``_intac_kernel``
(``intac_accum_pallas``, ``src/repro/kernels/intac_accum.py``): a (N, D)
stream and a scale -> (2, D) int32 limbs, ``q = round(x * scale)``
(half to even), ``hi = floor(q / 2^15)``, ``lo = q - hi * 2^15``, column
sums of each.  Resolve with ``ref.limbs_to_float``.

Overflow discipline (checked in ``ops.intac_accum``):
|x| * scale < 2^30 and N <= 2^15, so each limb's sum fits int32.

  * ``intac_accum_cuda`` launches the CUDA kernel (``csrc/intac_accum.cu``)
    on a CUDA tensor and counts its launches in ``LAUNCHES``;
  * ``intac_accum_torch`` is its plain PyTorch version.

Integer sums are order-free, so the two agree to the bit, at any tile
size.
"""

from __future__ import annotations

import torch

from ..core.intac import LIMB_SHIFT, to_i32

#: launches of the K5 kernel, counted by ``intac_accum_cuda``
LAUNCHES = 0


def _quantize(values: torch.Tensor, scale):
    q = torch.round(values.to(torch.float32)
                    * torch.as_tensor(scale, dtype=torch.float32,
                                      device=values.device))
    hi = torch.floor(q * (1.0 / (1 << LIMB_SHIFT)))
    return hi, q - hi * (1 << LIMB_SHIFT)


def intac_accum_torch(values: torch.Tensor, scale) -> torch.Tensor:
    """The plain version: values (N, D), scale () -> (2, D) int32.

    Each limb is cast as the reference's ``astype(int32)`` and the
    kernel's ``static_cast<int>`` cast it, saturating with NaN -> 0, so a
    +-Inf row adds INT32_MAX / INT32_MIN to its hi limb and 0 to its lo
    limb (whose ``Inf - Inf`` is NaN); the int64 sum then wraps to int32
    as the reference's int32 sum does."""
    hi, lo = _quantize(values, scale)
    # detlint: ok[DET002] int32 domain: the limbs add in int64 and wrap to
    # int32, exact in any order
    return torch.stack([to_i32(hi).to(torch.int64).sum(0),
                        # detlint: ok[DET002] int32 domain: as the line above
                        to_i32(lo).to(torch.int64).sum(0)]).to(torch.int32)


def intac_accum_cuda(values: torch.Tensor, scale, *,
                     block_rows: int = 256) -> torch.Tensor:
    """Launch K5: values (N, D) f32, contiguous, on a CUDA device; scale a
    number or a 0-d tensor -> (2, D) int32.  ``block_rows`` rows per CUDA
    block; any N (the last tile may be short)."""
    global LAUNCHES
    from . import _build
    if not values.is_cuda:
        raise ValueError("intac_accum_cuda needs a CUDA tensor; got values "
                         f"on {values.device}")
    if values.dtype != torch.float32 or values.ndim != 2 \
            or not values.is_contiguous():
        raise ValueError("intac_accum_cuda: values must be a contiguous "
                         f"(N, D) float32 tensor; got {values.dtype} "
                         f"{tuple(values.shape)}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    n, d = values.shape
    out = torch.zeros((2, d), dtype=torch.int32, device=values.device)
    if n == 0 or d == 0:                # nothing to launch, nothing counted
        return out
    scale = float(torch.as_tensor(scale, dtype=torch.float32))
    lib = _build.load("intac_accum")
    rc = lib.intac_accum_launch(
        values.data_ptr(), scale, out.data_ptr(), n, d, block_rows,
        torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
