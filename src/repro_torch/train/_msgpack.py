"""The msgpack subset of the reference's checkpoints, in pure Python.

``repro/train/checkpoint.py`` writes ``msgpack.packb`` of a flat map
``{path: {"dtype": str, "shape": [int, ...], "data": bytes}}``; the GPU
machine has no ``msgpack``. ``packb`` writes what ``msgpack.packb`` writes
for nil, booleans, integers, floats (as float 64), str, bytes, lists,
tuples and dicts with its defaults (``use_bin_type=True``): the smallest
form of each. ``unpackb`` reads those forms and float 32, as
``msgpack.unpackb`` does with its defaults (str as str, bin as bytes,
arrays as lists); extension types raise.
"""
from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: ``fix | n`` up to ``fix_max``, else the smallest
    of ``codes`` = (8-bit, 16-bit, 32-bit) codes (None: no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif 0 < n:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out += bytes((code,)) + struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: integer {n} too large")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out += bytes((code,)) + struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: integer {n} too small")


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot pack {type(x).__name__}")


def packb(x) -> bytes:
    out = bytearray()
    _pack(out, x)
    return bytes(out)


# code -> (struct format, byte count) of the fixed-size scalars
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
            0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
            0xD3: (">q", 8)}
# code -> (kind, byte count of the length) of the sized forms
_SIZED = {0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


def _unpack(buf: memoryview, i: int):
    """The object at ``buf[i:]`` -> (object, index after it)."""
    code = buf[i]
    i += 1
    if code <= 0x7F:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], i
    elif code in _SCALARS:
        fmt, size = _SCALARS[code]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    elif code in _SIZED:
        kind, size = _SIZED[code]
        n = int.from_bytes(buf[i:i + size], "big")
        i += size
    else:
        raise ValueError(f"msgpack: unsupported type code 0x{code:02x} at "
                         f"byte {i - 1}")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("msgpack: truncated data")
        data = bytes(buf[i:i + n])
        return (data.decode("utf-8") if kind == "str" else data), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    buf = memoryview(data)
    x, i = _unpack(buf, 0)
    if i != len(buf):
        raise ValueError(f"msgpack: {len(buf) - i} extra bytes after the "
                         f"object")
    return x
