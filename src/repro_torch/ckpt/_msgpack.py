"""The msgpack subset that checkpoint frames use, without the ``msgpack``
package (the H100 machine has none).

A checkpoint's shard file is one msgpack array of maps with str keys,
lists of ints and ``bin`` data (``repro_torch.ckpt.checkpoint``).
:func:`packb` encodes ints, str, bytes, lists and dicts, each in the
smallest format, as ``msgpack.packb(obj, use_bin_type=True)`` does, so the
port's raw frames are byte-equal to the reference's.  :func:`unpackb`
decodes the same types and returns ``bin`` payloads as zero-copy
``memoryview`` slices of its input.  Anything else raises.
"""
from __future__ import annotations

import struct


def _header(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The type byte(s) of a length-prefixed value: the fix form when
    ``fix`` is given and n fits it, else the first of ``codes`` (8-, 16-,
    32-bit lengths) that holds n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} exceeds 2**32 - 1")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                              (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= lo:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack(obj, out: list) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        out.append(_int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        out.append(_header(raw.nbytes, None, 0, (0xC4, 0xC5, 0xC6)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (``use_bin_type=True`` formats)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
         0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTH = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
           0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: memoryview, pos: int):
    """(the value at ``pos``, the position after it)."""
    if pos >= len(buf):
        raise ValueError("truncated msgpack data")
    c = buf[pos]
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c in _INTS:
        fmt = _INTS[c]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        n, pos = _length(buf, c, pos, 0x80)
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        return out, pos
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        n, pos = _length(buf, c, pos, 0x90)
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
        n, pos = _length(buf, c, pos, 0xA0)
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if c in (0xC4, 0xC5, 0xC6):
        n, pos = _length(buf, c, pos, None)
        if pos + n > len(buf):
            raise ValueError("truncated msgpack bin")
        return buf[pos:pos + n], pos + n
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


def _length(buf, c, pos, fix_base):
    if c in _LENGTH:
        fmt = _LENGTH[c]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    return c - fix_base, pos


def unpackb(data) -> object:
    """The object msgpack ``data`` encodes (``raw=False``: str as str)."""
    buf = memoryview(data).cast("B")
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra data after msgpack object")
    return obj
