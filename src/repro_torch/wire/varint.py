"""Varint primitives of the wire codec: LEB128 unsigned varints frame every
message and carry the tree frames' headers, counts and leaf d's."""
from __future__ import annotations


class WireError(ValueError):
    """Malformed or corrupted wire data."""


class WireTruncated(WireError):
    """Buffer ended before the declared structure was complete."""


def encode_uvarint(v: int) -> bytes:
    if v < 0:
        raise WireError(f"uvarint of negative value {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf: bytes, off: int = 0) -> tuple[int, int]:
    """(value, next offset); raises WireTruncated / WireError."""
    shift = 0
    v = 0
    while True:
        if off >= len(buf):
            raise WireTruncated("uvarint runs past end of buffer")
        if shift > 63:
            raise WireError("uvarint longer than 64 bits")
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, off
        shift += 7


def uvarint_len(v: int) -> int:
    n = 1
    v >>= 7
    while v:
        n += 1
        v >>= 7
    return n
