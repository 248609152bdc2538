"""Minimal CBOR (RFC 8949) codec for trace files.

The environment has no cbor2 wheel, and the reference's trace files
(ciborium-serialized structs, trace/src/lookup.rs:23) only use a small CBOR
subset: unsigned/negative integers, byte strings, text strings, arrays, maps,
plus indefinite-length variants.  This codec covers exactly that; the
native/ C++ extension accelerates bulk decoding for zkevm-scale files.
"""

from __future__ import annotations

import struct
from io import BytesIO

_BREAK = object()


def _read_uint(f, info: int) -> int:
    if info < 24:
        return info
    if info == 24:
        return f.read(1)[0]
    if info == 25:
        return struct.unpack(">H", f.read(2))[0]
    if info == 26:
        return struct.unpack(">I", f.read(4))[0]
    if info == 27:
        return struct.unpack(">Q", f.read(8))[0]
    raise ValueError(f"unsupported additional info {info}")


def _decode_item(f):
    first = f.read(1)
    if not first:
        raise EOFError("truncated CBOR")
    b = first[0]
    major, info = b >> 5, b & 0x1F
    if b == 0xFF:
        return _BREAK
    if major == 0:
        return _read_uint(f, info)
    if major == 1:
        return -1 - _read_uint(f, info)
    if major == 2:  # byte string
        if info == 31:
            chunks = []
            while True:
                c = _decode_item(f)
                if c is _BREAK:
                    break
                chunks.append(c)
            return b"".join(chunks)
        return f.read(_read_uint(f, info))
    if major == 3:  # text string
        if info == 31:
            parts = []
            while True:
                c = _decode_item(f)
                if c is _BREAK:
                    break
                parts.append(c)
            return "".join(parts)
        return f.read(_read_uint(f, info)).decode("utf-8")
    if major == 4:  # array
        if info == 31:
            out = []
            while True:
                c = _decode_item(f)
                if c is _BREAK:
                    break
                out.append(c)
            return out
        return [_decode_item(f) for _ in range(_read_uint(f, info))]
    if major == 5:  # map
        if info == 31:
            out = {}
            while True:
                k = _decode_item(f)
                if k is _BREAK:
                    break
                out[k] = _decode_item(f)
            return out
        n = _read_uint(f, info)
        return {_decode_item(f): _decode_item(f) for _ in range(n)}
    if major == 6:  # tag
        tag = _read_uint(f, info)
        item = _decode_item(f)
        if tag == 2:  # unsigned bignum (RFC 8949 §3.4.3)
            return int.from_bytes(item, "big")
        if tag == 3:  # negative bignum
            return -1 - int.from_bytes(item, "big")
        return item
    if major == 7:
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return None
        if info == 26:
            return struct.unpack(">f", f.read(4))[0]
        if info == 27:
            return struct.unpack(">d", f.read(8))[0]
        raise ValueError(f"unsupported simple value {info}")
    raise ValueError(f"unsupported major type {major}")


def load(f):
    return _decode_item(f)


def loads(data: bytes):
    return _decode_item(BytesIO(data))


def _write_head(out, major: int, n: int) -> None:
    if n < 24:
        out.append((major << 5) | n)
    elif n < 256:
        out.append((major << 5) | 24)
        out.append(n)
    elif n < 65536:
        out.append((major << 5) | 25)
        out.extend(struct.pack(">H", n))
    elif n < 2**32:
        out.append((major << 5) | 26)
        out.extend(struct.pack(">I", n))
    else:
        out.append((major << 5) | 27)
        out.extend(struct.pack(">Q", n))


def _encode_item(out: bytearray, v) -> None:
    if isinstance(v, bool):
        out.append(0xF5 if v else 0xF4)
    elif isinstance(v, int):
        mag = v if v >= 0 else -1 - v
        if mag < 2**64:
            _write_head(out, 0 if v >= 0 else 1, mag)
        else:  # bignum: tag 2/3 + BE byte string (field elements are 253-bit)
            _write_head(out, 6, 2 if v >= 0 else 3)
            data = mag.to_bytes((mag.bit_length() + 7) // 8, "big")
            _write_head(out, 2, len(data))
            out.extend(data)
    elif isinstance(v, (bytes, bytearray)):
        _write_head(out, 2, len(v))
        out.extend(v)
    elif isinstance(v, str):
        enc = v.encode("utf-8")
        _write_head(out, 3, len(enc))
        out.extend(enc)
    elif isinstance(v, (list, tuple)):
        _write_head(out, 4, len(v))
        for item in v:
            _encode_item(out, item)
    elif isinstance(v, dict):
        _write_head(out, 5, len(v))
        for k, val in v.items():
            _encode_item(out, k)
            _encode_item(out, val)
    elif v is None:
        out.append(0xF6)
    else:
        raise TypeError(f"cannot encode {type(v)}")


def dumps(v) -> bytes:
    out = bytearray()
    _encode_item(out, v)
    return bytes(out)


def dump(v, f) -> None:
    f.write(dumps(v))
