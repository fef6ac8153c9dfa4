"""The JugglePAC state machine, one CUDA thread per circuit.

Not a TPU kernel's port: the Hopper counterpart of the reference's
``lax.scan`` of one clock cycle (``_step``, src/repro/core/circuit_jax.py:67)
under ``jax.vmap``, the batch of circuits as the leading dimension.  A
loop over cycles in PyTorch would launch some 60 small operations a
simulated cycle; the kernel (``csrc/jugglepac_fsm.cu``) runs the whole
scan of every circuit in one launch, ``THREADS`` circuits a CUDA block,
each circuit's pipeline and registers in the block's shared memory
(``smem_bytes``).

In: values (B, T) float32, starts and valids (B, T) bool.  Out, one
entry a cycle: res_v (B, T) float32, res_set (B, T) int32, res_en (B, T)
bool, overflow (B, T) bool.

  * ``jugglepac_fsm_cuda`` launches the kernel on a CUDA tensor, on the
    current stream, and counts its launches in ``LAUNCHES``.  It takes
    float32 values and 1 <= latency <= ``MAX_LATENCY``, 1 <=
    num_registers <= ``MAX_REGISTERS`` (the paper's design point is
    L = 14, R <= 8); outside these it raises;
  * ``jugglepac_fsm_torch`` is its plain PyTorch version: ``step`` of
    ``core/circuit_scan.py`` cycle by cycle, any float dtype;
  * ``smem_bytes(latency, num_registers)`` is a block's shared memory,
    which the wrapper passes to the launch, and ``blocks_per_sm`` the
    blocks one SM holds (the occupancy calculator, on the card).

Adds are IEEE round-to-nearest in both (the kernel is built with
``--fmad=false``), so the two agree to the bit on every cycle, including
cycles that emit nothing (there the reference outputs register 0's stale
value and owner).
"""

from __future__ import annotations

import torch

#: launches of the kernel, counted by ``jugglepac_fsm_cuda``
LAUNCHES = 0
#: the kernel's limits: at most 64 pipeline slots and 64 PIS registers
MAX_LATENCY = 64
MAX_REGISTERS = 64
#: circuits a CUDA block and cycles a staged tile, as in the source
THREADS = 128
CHUNK = 32


def smem_bytes(latency: int, num_registers: int) -> int:
    """Dynamic shared memory of one CUDA block at (L, R), as
    ``csrc/jugglepac_fsm.cu`` lays it out, per circuit: the pipeline
    ring (8 B a slot), the registers' value and owner (8 B) and timeout
    cycle (4 B), the value and set tiles (4 B each a cycle of CHUNK) and
    the timeout ring (a byte a cycle of L + 3).  The launch refuses any
    other size."""
    lat, regs = latency, num_registers
    return THREADS * (8 * lat + 12 * regs + 8 * CHUNK + lat + 3)


def blocks_per_sm(latency: int = 14, num_registers: int = 4) -> int:
    """Blocks of ``THREADS`` circuits one SM of the current CUDA device
    holds at (L, R), from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    (registers, shared memory and threads together)."""
    import ctypes
    from . import _build
    _check_shape(latency, num_registers)
    _check_limits(latency, num_registers)
    out = ctypes.c_int(0)
    rc = _build.load("jugglepac_fsm").jugglepac_fsm_blocks_per_sm(
        latency, num_registers, smem_bytes(latency, num_registers),
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"jugglepac_fsm occupancy query failed: CUDA "
                           f"error {rc}")
    return out.value


def _check_shape(latency, num_registers):
    if not (1 <= latency and 1 <= num_registers):
        raise ValueError("jugglepac_fsm: latency and num_registers must be "
                         f"positive; got {latency}, {num_registers}")


def _check_limits(latency, num_registers):
    if latency > MAX_LATENCY or num_registers > MAX_REGISTERS:
        raise ValueError(
            f"jugglepac_fsm: the kernel takes latency <= {MAX_LATENCY}"
            f" and num_registers <= {MAX_REGISTERS}; got {latency}, "
            f"{num_registers}")


def jugglepac_fsm_torch(values: torch.Tensor, starts: torch.Tensor,
                        valids: torch.Tensor, *, latency: int = 14,
                        num_registers: int = 4):
    """The plain version: (B, T) inputs -> (res_v, res_set, res_en,
    overflow), each (B, T); ``circuit_scan.step`` once a cycle."""
    from ..core.circuit_scan import init_state, step
    _check_shape(latency, num_registers)
    b, t = values.shape
    dev = values.device
    state = init_state(latency, num_registers, values.dtype, batch=b,
                       device=dev)
    res_v = torch.empty((b, t), dtype=values.dtype, device=dev)
    res_set = torch.empty((b, t), dtype=torch.int32, device=dev)
    res_en = torch.empty((b, t), dtype=torch.bool, device=dev)
    ovf = torch.empty((b, t), dtype=torch.bool, device=dev)
    starts, valids = starts.to(torch.bool), valids.to(torch.bool)
    for c in range(t):
        state, (rv, rs, re, of) = step(
            latency, num_registers, state,
            (values[:, c], starts[:, c], valids[:, c]))
        res_v[:, c], res_set[:, c], res_en[:, c], ovf[:, c] = rv, rs, re, of
    return res_v, res_set, res_en, ovf


def jugglepac_fsm_cuda(values: torch.Tensor, starts: torch.Tensor,
                       valids: torch.Tensor, *, latency: int = 14,
                       num_registers: int = 4):
    """Launch the kernel: values (B, T) float32, starts and valids (B, T)
    bool, all contiguous on one CUDA device -> (res_v, res_set, res_en,
    overflow), each (B, T)."""
    global LAUNCHES
    from . import _build
    _check_shape(latency, num_registers)
    _check_limits(latency, num_registers)
    if not values.is_cuda:
        raise ValueError("jugglepac_fsm_cuda needs a CUDA tensor; got "
                         f"values on {values.device}")
    if values.dtype != torch.float32 or values.ndim != 2:
        raise ValueError("jugglepac_fsm_cuda: values must be a (B, T) "
                         f"float32 tensor; got {values.dtype} "
                         f"{tuple(values.shape)}")
    for name, x in (("starts", starts), ("valids", valids)):
        if x.dtype != torch.bool or x.shape != values.shape \
                or x.device != values.device:
            raise ValueError(f"jugglepac_fsm_cuda: {name} must be a bool "
                             f"tensor of values' shape on {values.device}; "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not (values.is_contiguous() and starts.is_contiguous()
            and valids.is_contiguous()):
        raise ValueError("jugglepac_fsm_cuda: inputs must be contiguous")
    b, t = values.shape
    dev = values.device
    res_v = torch.empty((b, t), dtype=torch.float32, device=dev)
    res_set = torch.empty((b, t), dtype=torch.int32, device=dev)
    res_en = torch.empty((b, t), dtype=torch.bool, device=dev)
    ovf = torch.empty((b, t), dtype=torch.bool, device=dev)
    if b == 0 or t == 0:                # nothing to launch, nothing counted
        return res_v, res_set, res_en, ovf
    lib = _build.load("jugglepac_fsm")
    rc = lib.jugglepac_fsm_launch(
        values.data_ptr(), starts.data_ptr(), valids.data_ptr(),
        res_v.data_ptr(), res_set.data_ptr(), res_en.data_ptr(),
        ovf.data_ptr(), b, t, latency, num_registers,
        smem_bytes(latency, num_registers),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jugglepac_fsm launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return res_v, res_set, res_en, ovf
