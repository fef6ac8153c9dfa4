"""The subset of MessagePack a checkpoint shard uses, written and read
without the ``msgpack`` package.

A shard is one map ``{leaf key: {"dtype": str, "shape": [int, ...],
"data": bin}}``.  ``pack`` writes what ``msgpack.packb(obj,
use_bin_type=True)`` writes for such objects, byte for byte: maps, str
and bin in their smallest form, arrays of up to 65,535 items and
non-negative ints.  The header functions let a writer stream a map whose
entries are produced one at a time.  ``unpack`` reads the same
subset back (bytes or any buffer; ``bin`` values come back as
``memoryview`` slices of it, so a large shard is never copied) and
raises ``ValueError`` on anything else, a truncated buffer or trailing
bytes.
"""

from __future__ import annotations

import struct


def _sized(n: int, fix_base, fix_limit, codes) -> bytes:
    """The header of a container or string of length ``n``: the fix form
    below ``fix_limit`` (when there is one), else the smallest of the
    (code, struct format, limit) forms."""
    if fix_base is not None and n < fix_limit:
        return bytes([fix_base | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16),)
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, _MAP)


def bin_header(n: int) -> bytes:
    return _sized(n, None, 0, _BIN)


_UINT = ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16), (0xce, ">I", 1 << 32),
         (0xcf, ">Q", 1 << 64))


def _int(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"msgpack subset: negative int {v}")
    return _sized(v, 0x00, 128, _UINT)


def pack(obj) -> bytes:
    """``obj`` (dict, str, bytes-like, list or tuple, int) -> bytes."""
    out = []

    def emit(o):
        if isinstance(o, bool) or o is None:
            raise TypeError(f"msgpack subset: cannot pack {o!r}")
        if isinstance(o, dict):
            out.append(map_header(len(o)))
            for k, v in o.items():
                emit(k)
                emit(v)
        elif isinstance(o, str):
            b = o.encode("utf-8")
            out.append(_sized(len(b), 0xa0, 32, _STR))
            out.append(b)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            b = memoryview(o).cast("B")
            out.append(bin_header(b.nbytes))
            out.append(bytes(b))
        elif isinstance(o, (list, tuple)):
            out.append(_sized(len(o), 0x90, 16, _ARR))
            for v in o:
                emit(v)
        elif isinstance(o, int):
            out.append(_int(o))
        else:
            raise TypeError(f"msgpack subset: cannot pack "
                            f"{type(o).__name__}")

    emit(obj)
    return b"".join(out)


def unpack(buf):
    """bytes (or a buffer) -> the object ``pack`` wrote."""
    view = memoryview(buf).cast("B")
    n = view.nbytes
    pos = 0

    def take(k: int) -> memoryview:
        nonlocal pos
        if pos + k > n:
            raise ValueError(f"msgpack: truncated at byte {pos} (need {k} "
                             f"more of {n})")
        piece = view[pos:pos + k]
        pos += k
        return piece

    def length(fmt: str) -> int:
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def read():
        b = take(1)[0]
        if b < 0x80:
            return b
        if 0x80 <= b <= 0x8f:
            return read_map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return read_str(b & 0x1f)
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
        if b in ints:
            return length(ints[b])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in strs:
            return read_str(length(strs[b]))
        bins = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in bins:
            return take(length(bins[b]))
        if b == 0xdc:
            return [read() for _ in range(length(">H"))]
        if b in (0xde, 0xdf):
            return read_map(length(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack subset: unsupported type byte {b:#04x} "
                         f"at {pos - 1}")

    def read_str(k: int) -> str:
        return str(take(k), "utf-8")

    def read_map(k: int) -> dict:
        out = {}
        for _ in range(k):
            key = read()
            if isinstance(key, (list, dict, memoryview)):
                raise ValueError(f"msgpack: unhashable map key at {pos}")
            out[key] = read()
        return out

    obj = read()
    if pos != n:
        raise ValueError(f"msgpack: {n - pos} trailing bytes after the "
                         f"object")
    return obj
