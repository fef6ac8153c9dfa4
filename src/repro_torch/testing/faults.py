"""Fault injectors for the robustness tests, as the reference's
``repro.testing.faults``.

Each injector models one failure, and the tests pair it with an
assertion that the port detects it, degrades or recovers — never
silently corrupts:

  * ``inject_nonfinite``      — NaN/Inf bursts in a value stream (a
                                poisoned loss or gradient microbatch);
  * ``flip_bit`` /
    ``truncate_file`` /
    ``corrupt_checkpoint``    — storage faults in a snapshot's shard file,
                                caught by its CRC sidecar as a
                                ``CheckpointError``;
  * ``kill-mid-save`` (CLI)   — a host dying between the shard write and
                                the atomic rename, leaving a ``.tmp``
                                directory that must never be restored.

The kill-mid-save fault needs a real process death, so it ships as a CLI:

    python -m repro_torch.testing.faults kill-mid-save <ckpt_dir> <step>

It saves a small fixed tree with ``repro_torch.ckpt.save`` and dies with
exit code 9 the moment the save reaches its rename.  (The reference's
``drop_shard_carry``, a device dropping out of a collective, waits for
the port's multi-device path.)
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

KILL_EXIT_CODE = 9


# ---------------------------------------------------------------------------
# numerical faults
# ---------------------------------------------------------------------------


def inject_nonfinite(values, *, rows, kind: str = "nan"):
    """A float32 copy of ``values`` (N,) or (N, D) with ``rows`` poisoned.

    ``kind``: "nan", "inf", or "both" (alternating NaN / -Inf).  A numpy
    array (or anything array-like) gives a numpy array, as the
    reference's; a tensor gives a tensor on its device."""
    if isinstance(values, torch.Tensor):
        out = values.detach().to(torch.float32).clone()
        nan, inf = float("nan"), float("-inf")
    else:
        out = np.array(values, dtype=np.float32, copy=True)
        nan, inf = np.nan, -np.inf
    for j, r in enumerate(rows):
        if kind == "nan" or (kind == "both" and j % 2 == 0):
            out[r] = nan
        elif kind == "inf" or kind == "both":
            out[r] = inf
        else:
            raise ValueError(f"kind must be nan/inf/both, got {kind!r}")
    return out


# ---------------------------------------------------------------------------
# storage faults
# ---------------------------------------------------------------------------


def flip_bit(path, *, seed: int = 0) -> int:
    """Flip one pseudo-randomly chosen bit of ``path`` in place; returns
    the byte offset.  The reference's choice for a (file size, seed),
    made without reading the file whole."""
    p = Path(path)
    size = p.stat().st_size
    if not size:
        raise ValueError(f"flip_bit: {p} is empty")
    rng = np.random.RandomState(seed)
    off = int(rng.randint(0, size))
    bit = 1 << int(rng.randint(0, 8))
    with open(p, "rb+") as f:
        f.seek(off)
        byte = f.read(1)[0]
        f.seek(off)
        f.write(bytes([byte ^ bit]))
    return off


def truncate_file(path, *, frac: float = 0.5) -> int:
    """Truncate ``path`` to ``frac`` of its size (storage ran out, a torn
    write); returns the new size."""
    p = Path(path)
    keep = int(p.stat().st_size * frac)
    with open(p, "rb+") as f:
        f.truncate(keep)
    return keep


def corrupt_checkpoint(ckpt_dir, step: int, *, mode: str = "bitflip",
                       seed: int = 0) -> Path:
    """Apply a storage fault to a finished snapshot's first shard file:
    ``mode`` "bitflip" (one flipped bit) or "truncate" (half the file
    gone).  The CRC sidecar is left as it was, for restore to notice the
    mismatch.  Returns the path touched."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    shards = sorted(d.glob("shard_*.msgpack"))
    if not shards:
        raise FileNotFoundError(f"no shard files under {d}")
    target = shards[0]
    if mode == "bitflip":
        flip_bit(target, seed=seed)
    elif mode == "truncate":
        truncate_file(target)
    else:
        raise ValueError(f"mode must be bitflip/truncate, got {mode!r}")
    return target


# ---------------------------------------------------------------------------
# kill-mid-save CLI
# ---------------------------------------------------------------------------


def _demo_tree():
    """The reference's small fixed tree, as CPU tensors."""
    rng = np.random.RandomState(1234)
    return {"w": torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(4).astype(np.float32))}


def _kill_mid_save(ckpt_dir: str, step: int):
    """Run ``ckpt.save`` but die at the atomic rename, as a host loss
    would: shard and manifest written into the ``.tmp`` directory, the
    rename never made."""
    from ..ckpt import checkpoint as ckpt

    def dying_replace(src, dst):          # noqa: ARG001 — signature match
        sys.stderr.write(f"[faults] dying before rename of {src}\n")
        sys.stderr.flush()
        os._exit(KILL_EXIT_CODE)

    os.replace = dying_replace
    ckpt.save(ckpt_dir, step, _demo_tree(), extra={"next_step": step + 1})
    raise AssertionError("save returned: the injected crash did not fire")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 3 and argv[0] == "kill-mid-save":
        _kill_mid_save(argv[1], int(argv[2]))
    sys.stderr.write("usage: python -m repro_torch.testing.faults "
                     "kill-mid-save <ckpt_dir> <step>\n")
    return 2


if __name__ == "__main__":
    sys.exit(main())
