"""Checkpoints of a tree of tensors, in the reference's format 2.

The files are those ``repro.ckpt.checkpoint`` writes and reads, so each
package restores the other's snapshots:

  * ``step_XXXXXXXX/shard_XXXXXofXXXXX.msgpack`` — a MessagePack map
    ``{leaf key: {"dtype", "shape", "data"}}`` in sorted key order;
    ``data`` is the leaf's raw bytes as one zlib stream (a snapshot
    written with zstd frames reads too, when ``zstandard`` imports);
  * ``shard_....crc.json`` — the whole file's CRC32 and one per
    compressed leaf, checked before a byte is decoded (a v1 snapshot
    without it still restores);
  * ``manifest.json`` — step, host count, format, time and ``extra``;
  * written under ``step_XXXXXXXX.tmp`` and renamed (``os.replace``) when
    whole, so a crash mid-save never leaves a snapshot that restores.

A leaf key is the path ``jax.tree_util`` prints for the leaf: ``['k']``
for a dict key, ``[i]`` for a list or tuple index and ``.field`` for a
NamedTuple field, joined by ``/`` — for example
``['opt']/.mu/['blocks']/[0]/['core']/['wk']``.  A tree is dicts, lists,
tuples and NamedTuples of tensors (or numpy arrays); ``None`` holds no
leaf.  A bfloat16 leaf is written as its 16-bit words with
``dtype: "bfloat16"``.

The port writes a snapshot of the full-width train state (16 GB for
stablelm-1.6b) without holding it whole: each leaf is copied to the host
as the writer reaches it and deflated in ``CHUNK_BYTES`` chunks by a
thread pool (``zlib`` releases the GIL).  Every chunk but the last ends
on a sync flush, so the chunks joined behind the zlib header, with the
leaf's Adler-32 at the end, are one zlib stream that ``zlib.decompress``
reads; a leaf of one chunk is byte for byte ``zlib.compress(raw,
level)``.  The map is streamed: its header, then each entry once its
leaf is compressed, the file's and the leaf's CRC32 carried along.  A
restore maps the shard file, checks the CRCs and inflates the leaves in
parallel, and only then places them, so a snapshot that fails its
checks changes nothing.  ``restore(..., inplace=True)`` writes the
snapshot into the template's own tensors (the train state's leaves, of
which the model's parameters are views).

The reference's ``shardings=`` (placing leaves on a JAX mesh) has no
counterpart beyond the device: under the port's pure data parallelism
every rank holds the whole train state, so each rank restores the same
snapshot onto its own device (``device=``, or in place into its own
tensors), and a snapshot resumes at any world size.  A train state with
``residuals`` (the data-parallel step's error feedback,
``train.checkpoint_state``) is a tree like any other; the launcher
saves each rank's residuals stacked in rank order.
"""

from __future__ import annotations

import json
import mmap
import os
import shutil
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from . import _msgpack

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

#: sidecar/manifest format with CRC32 integrity records
FORMAT_VERSION = 2
#: the reference's zlib level (its format without ``zstandard``)
LEVEL = 6
#: raw bytes per compression job
CHUNK_BYTES = 16 << 20
#: compressed bytes per inflate step on restore
_INFLATE_STEP = 64 << 20


class CheckpointError(Exception):
    """A checkpoint could not be read back faithfully: a missing or corrupt
    manifest, no shard files, a CRC mismatch, a truncated or undecodable
    shard or leaf.  The message names the step and the path; ``step`` and
    ``path`` are attributes too (``restore_latest_valid`` falls back on
    them)."""

    def __init__(self, message: str, *, step: Optional[int] = None,
                 path=None):
        self.step = step
        self.path = None if path is None else str(path)
        where = ""
        if step is not None:
            where += f" step {step}"
        if path is not None:
            where += f" at {path}"
        super().__init__(f"checkpoint{where}: {message}")


def _crc(blob) -> int:
    return zlib.crc32(blob) & 0xFFFFFFFF


def _threads() -> int:
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:                      # not on Linux
        return max(1, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# trees under the reference's key strings
# ---------------------------------------------------------------------------


def _map_with_keys(fn, tree, path: str = ""):
    """A tree of the same structure with each leaf ``fn(key, leaf)``."""
    def join(part):
        return f"{path}/{part}" if path else part
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, join(f"[{k!r}]"))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_keys(fn, getattr(tree, f),
                                           join(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, join(f"[{i}]"))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flatten(tree) -> dict:
    """{key: leaf} in sorted key order."""
    flat = {}
    _map_with_keys(lambda k, leaf: flat.setdefault(k, leaf), tree)
    return dict(sorted(flat.items()))


# ---------------------------------------------------------------------------
# leaf bytes
# ---------------------------------------------------------------------------


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".", 1)[1]
    return str(np.asarray(leaf).dtype)


def _host_bytes(leaf) -> memoryview:
    """The leaf's bytes in C order on the host (a copy for a CUDA tensor)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.contiguous().cpu().numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return memoryview(arr).cast("B") if arr.size else memoryview(b"")


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(name))).dtype


# ---------------------------------------------------------------------------
# chunked zlib
# ---------------------------------------------------------------------------


def _zlib_header(level: int) -> bytes:
    """The two-byte zlib header ``zlib.compress(data, level)`` writes."""
    flags = 0 if level < 2 else 1 if level < 6 else 2 if level == 6 else 3
    head = (0x78 << 8) | (flags << 6)
    head += 31 - head % 31
    return head.to_bytes(2, "big")


def _deflate(raw: memoryview, level: int, last: bool):
    """One chunk as raw deflate (a sync flush ends it unless it is the
    leaf's last) and the chunk's Adler-32."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(raw) + c.flush(zlib.Z_FINISH if last
                                     else zlib.Z_SYNC_FLUSH)
    return body, zlib.adler32(raw)


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """The Adler-32 of A + B from those of A and B (zlib's
    ``adler32_combine``)."""
    base = 65521
    rem = len2 % base
    s1 = a1 & 0xFFFF
    s2 = (rem * s1) % base
    s1 += (a2 & 0xFFFF) + base - 1
    s2 += ((a1 >> 16) & 0xFFFF) + ((a2 >> 16) & 0xFFFF) + base - rem
    s1 %= base
    s2 %= base
    return s1 | (s2 << 16)


def _gf2_times(mat, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(c1: int, c2: int, len2: int) -> int:
    """The CRC32 of A + B from those of A and B (zlib's
    ``crc32_combine``: apply len2 zero bytes to ``c1`` by squaring the
    shift operator over GF(2))."""
    if len2 <= 0:
        return c1
    odd = [0xEDB88320] + [1 << n for n in range(31)]
    even = _gf2_square(odd)
    odd = _gf2_square(even)
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            c1 = _gf2_times(even, c1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            c1 = _gf2_times(odd, c1)
        len2 >>= 1
        if not len2:
            break
    return (c1 ^ c2) & 0xFFFFFFFF


def _parallel_crc(buf, pool, piece: int = 256 << 20) -> int:
    """CRC32 of ``buf``, its pieces checked in parallel and combined."""
    n = len(buf)
    if n <= piece:
        return _crc(buf)
    view = memoryview(buf)
    starts = range(0, n, piece)
    crcs = list(pool.map(lambda s: _crc(view[s:s + piece]), starts))
    out = crcs[0]
    for s, c in zip(starts[1:], crcs[1:]):
        out = crc32_combine(out, c, min(piece, n - s))
    return out


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def _write_shard(path: Path, leaves: dict, level: int, threads: int):
    """Stream {key: leaf} (sorted) into ``path`` as one MessagePack map;
    returns (file CRC32, {key: compressed leaf CRC32})."""
    leaf_crcs = {}
    with open(path, "wb") as f, ThreadPoolExecutor(threads) as pool:
        file_crc = 0

        def put(b):
            nonlocal file_crc
            f.write(b)
            file_crc = zlib.crc32(b, file_crc)

        def jobs():
            """(key, dtype, shape, chunk index, chunks, raw bytes, future),
            a leaf's host copy taken as its first chunk is submitted."""
            for key, leaf in leaves.items():
                dtype, shape = _dtype_name(leaf), list(leaf.shape)
                raw = _host_bytes(leaf)
                n = raw.nbytes
                starts = range(0, max(n, 1), CHUNK_BYTES)
                for j, s in enumerate(starts):
                    piece = raw[s:s + CHUNK_BYTES]
                    yield (key, dtype, shape, j, len(starts), piece.nbytes,
                           pool.submit(_deflate, piece, level,
                                       j == len(starts) - 1))
                del raw

        put(_msgpack.map_header(len(leaves)))
        window, todo = deque(), jobs()
        bodies, adler = [], 1
        while True:
            while len(window) < 2 * threads:
                nxt = next(todo, None)
                if nxt is None:
                    break
                window.append(nxt)
            if not window:
                break
            key, dtype, shape, j, count, nraw, fut = window.popleft()
            body, a = fut.result()
            bodies.append(body)
            adler = adler32_combine(adler, a, nraw)
            if j < count - 1:
                continue
            head, tail = _zlib_header(level), adler.to_bytes(4, "big")
            size = len(head) + sum(map(len, bodies)) + len(tail)
            put(_msgpack.pack(key) + _msgpack.map_header(3)
                + _msgpack.pack("dtype") + _msgpack.pack(dtype)
                + _msgpack.pack("shape") + _msgpack.pack(shape)
                + _msgpack.pack("data") + _msgpack.bin_header(size))
            crc = 0
            for b in [head] + bodies + [tail]:
                put(b)
                crc = zlib.crc32(b, crc)
            leaf_crcs[key] = crc & 0xFFFFFFFF
            bodies, adler = [], 1
    return file_crc & 0xFFFFFFFF, leaf_crcs


def save(ckpt_dir, step: int, tree, *, host_id: int = 0,
         num_hosts: int = 1, keep: int = 3, extra: Optional[dict] = None,
         level: int = LEVEL) -> str:
    """Snapshot ``tree`` at ``step``: host ``host_id`` of ``num_hosts``
    writes every ``num_hosts``-th leaf of the sorted keys, host 0 the
    manifest, renames the directory into place and keeps the newest
    ``keep`` snapshots.  A snapshot already at ``step`` is replaced: a
    run that fell back past a corrupt snapshot writes that step again
    (the reference's ``os.replace`` fails on it).  ``level`` is the zlib
    level (any level reads back the same way); one compression thread
    runs per CPU.  Returns the snapshot's directory."""
    d = Path(ckpt_dir)
    tmp = d / f"step_{step:08d}.tmp"
    final = d / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    mine = {k: leaf for i, (k, leaf) in enumerate(flatten(tree).items())
            if i % num_hosts == host_id}
    stem = f"shard_{host_id:05d}of{num_hosts:05d}"
    file_crc, leaf_crcs = _write_shard(tmp / f"{stem}.msgpack", mine, level,
                                       _threads())
    # integrity sidecar: whole-file CRC32 plus one per compressed leaf
    sidecar = {"format": FORMAT_VERSION, "file_crc32": file_crc,
               "leaves": leaf_crcs}
    (tmp / f"{stem}.crc.json").write_text(json.dumps(sidecar))
    if host_id == 0:
        manifest = {"step": step, "num_hosts": num_hosts,
                    "format": FORMAT_VERSION, "time": time.time(),
                    "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _retain(d, keep)
    return str(final)


def _retain(d: Path, keep: int):
    steps = sorted(p for p in d.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest step with a manifest (``.tmp`` directories ignored)."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def save_every(step: int, interval: int) -> bool:
    return interval > 0 and step > 0 and step % interval == 0


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _map_file(path: Path):
    with open(path, "rb") as fh:
        if os.fstat(fh.fileno()).st_size == 0:
            return b""
        return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)


def _inflate(data, nbytes: int) -> torch.Tensor:
    """A zlib (or zstd-framed) blob -> its ``nbytes`` raw bytes as a CPU
    uint8 tensor.  Raises ImportError for a zstd frame without
    ``zstandard``, ValueError or zlib.error for a bad stream."""
    if bytes(data[:4]) == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise ImportError("checkpoint was written with zstd but "
                              "zstandard is not installed") from None
        raw = zstandard.ZstdDecompressor().decompress(
            bytes(data), max_output_size=nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{len(raw)} bytes, want {nbytes}")
        return torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    out = torch.empty(nbytes, dtype=torch.uint8)
    dst = out.numpy()
    inflater = zlib.decompressobj()
    pos = 0
    for s in range(0, len(data), _INFLATE_STEP):
        piece = inflater.decompress(data[s:s + _INFLATE_STEP])
        if pos + len(piece) > nbytes:
            raise ValueError(f"more than the {nbytes} bytes the leaf holds")
        dst[pos:pos + len(piece)] = np.frombuffer(piece, np.uint8)
        pos += len(piece)
        if inflater.eof:
            break
    if not inflater.eof or inflater.unused_data or pos != nbytes:
        raise ValueError(f"incomplete or truncated stream ({pos} of "
                         f"{nbytes} bytes, end {'seen' if inflater.eof else 'missing'})")
    return out


def _read_shards(d: Path, step: int, pool) -> dict:
    """{key: entry} of every shard under ``d``, CRC-checked where a
    sidecar exists."""
    shard_files = sorted(d.glob("shard_*.msgpack"))
    if not shard_files:
        raise CheckpointError("no shard files", step=step, path=d)
    raw = {}
    for shard_file in shard_files:
        blob = _map_file(shard_file)
        sidecar_file = shard_file.with_name(
            shard_file.name[: -len(".msgpack")] + ".crc.json")
        sidecar = None
        if sidecar_file.exists():             # v1 snapshots have none
            try:
                sidecar = json.loads(sidecar_file.read_text())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise CheckpointError(f"integrity sidecar is corrupt ({e})",
                                      step=step, path=sidecar_file) from e
            got = _parallel_crc(blob, pool)
            if got != sidecar["file_crc32"]:
                raise CheckpointError(
                    f"shard file CRC32 {got:#010x} does not match the "
                    f"recorded {sidecar['file_crc32']:#010x} (bit flip or "
                    f"truncation)", step=step, path=shard_file)
        try:
            part = _msgpack.unpack(blob)
            if not isinstance(part, dict) or not all(
                    isinstance(e, dict) and {"dtype", "shape", "data"} <= set(e)
                    for e in part.values()):
                raise ValueError("not a map of leaf entries")
        except Exception as e:
            raise CheckpointError(f"shard is truncated or undecodable "
                                  f"({type(e).__name__}: {e})",
                                  step=step, path=shard_file) from e
        if sidecar is not None:
            keys = [k for k in part if sidecar["leaves"].get(k) is not None]
            crcs = pool.map(lambda k: _crc(part[k]["data"]), keys)
            for key, got in zip(keys, crcs):
                if got != sidecar["leaves"][key]:
                    raise CheckpointError(
                        f"leaf {key!r} CRC32 mismatch (bit flip in the "
                        f"compressed blob)", step=step, path=shard_file)
        raw.update(part)
    return raw


def restore(ckpt_dir, step: int, like_tree, *, device=None,
            inplace: bool = False):
    """Restore ``step`` into the structure of ``like_tree`` -> (tree,
    manifest).

    Each leaf comes back as a tensor of the snapshot's dtype and shape,
    on ``device``, or else on the template leaf's device (the CPU for a
    leaf that is no tensor).  ``inplace=True`` instead copies each leaf
    into the template's tensor (same dtype and shape, else ValueError)
    and returns ``like_tree`` itself; nothing is written unless every
    leaf verified and decoded.

    Every availability or integrity failure — an absent or corrupt
    manifest, no shard files, a CRC mismatch, a truncated shard, an
    undecodable leaf — raises ``CheckpointError`` naming the step and
    path.  A leaf of ``like_tree`` absent from the snapshot raises
    ``KeyError`` (a structure mismatch, not corruption).
    """
    d = Path(ckpt_dir) / f"step_{step:08d}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except FileNotFoundError as e:
        raise CheckpointError("manifest.json is missing (no such step, or "
                              "a partially-written snapshot)",
                              step=step, path=d) from e
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"manifest.json is corrupt ({e})",
                              step=step, path=d) from e
    want = flatten(like_tree)
    with ThreadPoolExecutor(_threads()) as pool:
        raw = _read_shards(d, step, pool)
        for key in want:
            if key not in raw:
                raise KeyError(f"checkpoint missing leaf {key}")

        def decode(key):
            ent = raw[key]
            dtype = _torch_dtype(ent["dtype"])
            shape = tuple(int(s) for s in ent["shape"])
            nbytes = int(np.prod(shape, dtype=np.int64)) \
                * torch.empty((), dtype=dtype).element_size()
            try:
                buf = _inflate(ent["data"], nbytes)
            except ImportError:
                raise                    # zstd frame, zstandard missing
            except Exception as e:
                raise CheckpointError(f"leaf {key!r} failed to decompress "
                                      f"({type(e).__name__}: {e})",
                                      step=step, path=d) from e
            return buf.view(dtype).reshape(shape)

        host = dict(zip(want, pool.map(decode, want)))
    if inplace:
        for key, leaf in want.items():
            if not isinstance(leaf, torch.Tensor) or \
                    leaf.dtype != host[key].dtype or \
                    tuple(leaf.shape) != tuple(host[key].shape):
                raise ValueError(
                    f"restore(inplace=True): leaf {key} is "
                    f"{getattr(leaf, 'dtype', type(leaf).__name__)} "
                    f"{tuple(getattr(leaf, 'shape', ()))}, the snapshot "
                    f"holds {host[key].dtype} {tuple(host[key].shape)}")
        with torch.no_grad():
            for key, leaf in want.items():
                leaf.copy_(host.pop(key))
        return like_tree, manifest

    def place(key, leaf):
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        return host.pop(key).to(dev)
    return _map_with_keys(place, like_tree), manifest


def restore_latest_valid(ckpt_dir, like_tree, *, device=None,
                         inplace: bool = False, retries: int = 2):
    """Restore the newest snapshot that verifies -> (tree, manifest,
    step); None when the directory holds no snapshot.

    Steps are tried newest-first: a ``CheckpointError`` skips to the next
    older step, a transient ``OSError`` is retried ``retries`` times.
    When snapshots exist but none verifies, raises ``CheckpointError``
    listing every failure."""
    d = Path(ckpt_dir)
    steps: list = []
    if d.exists():
        steps = sorted((int(p.name.split("_")[1]) for p in d.iterdir()
                        if p.is_dir() and p.name.startswith("step_")
                        and not p.name.endswith(".tmp")), reverse=True)
    if not steps:
        return None
    failures = []
    for step in steps:
        attempt = 0
        while True:
            try:
                tree, manifest = restore(ckpt_dir, step, like_tree,
                                         device=device, inplace=inplace)
                return tree, manifest, step
            except CheckpointError as e:
                failures.append(f"step {step}: {e}")
                break
            except OSError as e:            # transient read failure: retry
                attempt += 1
                if attempt > retries:
                    failures.append(f"step {step}: {type(e).__name__}: {e}")
                    break
                time.sleep(0.05 * attempt)
    raise CheckpointError(
        "no valid checkpoint among steps "
        f"{steps}; " + "; ".join(failures), path=d)


__all__ = ["CheckpointError", "FORMAT_VERSION", "save", "restore",
           "restore_latest_valid", "latest_step", "save_every", "flatten"]
