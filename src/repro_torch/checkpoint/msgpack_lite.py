"""The msgpack subset a checkpoint uses, in plain Python.

The machine with the card has no `msgpack` package, so the port carries
this encoder and decoder. `packb` gives the bytes of
`msgpack.packb(obj, use_bin_type=True)` for None, bools, ints, floats,
str, bytes, lists / tuples and dicts (the smallest encoding of each, as
the package picks it; dict keys in insertion order); `unpackb` reads those
types back as `msgpack.unpackb(data, raw=False)` does (arrays as lists,
str as str, bin as bytes).
"""
from __future__ import annotations

import struct


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(struct.pack("B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack("b", obj))
        elif 0 <= obj < 0x100:
            out.append(struct.pack(">BB", 0xCC, obj))
        elif 0 <= obj < 0x10000:
            out.append(struct.pack(">BH", 0xCD, obj))
        elif 0 <= obj < 0x100000000:
            out.append(struct.pack(">BI", 0xCE, obj))
        elif 0 <= obj < 0x10000000000000000:
            out.append(struct.pack(">BQ", 0xCF, obj))
        elif -0x80 <= obj:
            out.append(struct.pack(">Bb", 0xD0, obj))
        elif -0x8000 <= obj:
            out.append(struct.pack(">Bh", 0xD1, obj))
        elif -0x80000000 <= obj:
            out.append(struct.pack(">Bi", 0xD2, obj))
        elif -0x8000000000000000 <= obj:
            out.append(struct.pack(">Bq", 0xD3, obj))
        else:
            raise OverflowError(f"msgpack: int {obj} out of range")
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(struct.pack("B", 0xA0 | n))
        elif n < 0x100:
            out.append(struct.pack(">BB", 0xD9, n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", 0xDA, n))
        else:
            out.append(struct.pack(">BI", 0xDB, n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        if n < 0x100:
            out.append(struct.pack(">BB", 0xC4, n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", 0xC5, n))
        else:
            out.append(struct.pack(">BI", 0xC6, n))
        out.append(bytes(obj) if not isinstance(obj, bytes) else obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(struct.pack("B", 0x90 | n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", 0xDC, n))
        else:
            out.append(struct.pack(">BI", 0xDD, n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(struct.pack("B", 0x80 | n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", 0xDE, n))
        else:
            out.append(struct.pack(">BI", 0xDF, n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width scalars: type byte -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# length-prefixed: type byte -> (length format, kind)
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(data, pos: int):
    t = data[pos]
    pos += 1
    if t < 0x80:
        return t, pos
    if t >= 0xE0:
        return t - 0x100, pos
    if 0xA0 <= t < 0xC0:
        kind, n = "str", t & 0x1F
    elif 0x90 <= t < 0xA0:
        kind, n = "array", t & 0x0F
    elif 0x80 <= t < 0x90:
        kind, n = "map", t & 0x0F
    elif t == 0xC0:
        return None, pos
    elif t in (0xC2, 0xC3):
        return t == 0xC3, pos
    elif t in _SCALARS:
        fmt = _SCALARS[t]
        return (struct.unpack_from(fmt, data, pos)[0],
                pos + struct.calcsize(fmt))
    elif t in _SIZED:
        fmt, kind = _SIZED[t]
        n = struct.unpack_from(fmt, data, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack: type byte 0x{t:02x} is not in the "
                         f"subset this reader takes")
    if kind == "str":
        return bytes(data[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(data[pos:pos + n]), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(data, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        out[k], pos = _unpack(data, pos)
    return out, pos


def unpackb(data: bytes):
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} bytes after the "
                         f"object")
    return obj
