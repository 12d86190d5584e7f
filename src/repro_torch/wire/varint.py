"""Varint + bit-stream primitives for the wire codec.

LEB128 unsigned varints frame every message; zigzag maps the signed ToW
sketch values onto them.  ``BitWriter``/``BitReader`` pack the protocol's
sub-byte fields (m-bit syndromes and bin positions, 1-bit ok/done flags)
MSB-first, so a frame's payload length is exactly
``ceil(payload_bits / 8)`` — what lets measured frame sizes reconcile with
the paper's Formula-(1) bit accounting.  Dependency-free on purpose:
``core.tow`` mirrors the framed-length arithmetic without importing jax or
the frames module.
"""
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


def framed_len(payload_len: int) -> int:
    """Total frame-envelope size for a payload of ``payload_len`` bytes:
    ``uvarint(1 + payload_len) + type byte + payload`` (see frames.frame)."""
    return uvarint_len(1 + payload_len) + 1 + payload_len


def zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def unzigzag(z: int) -> int:
    return (z >> 1) ^ -(z & 1)


class BitWriter:
    """MSB-first bit packer; ``getvalue`` zero-pads the final byte."""

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits < 0 or (nbits < 64 and value >> nbits):
            raise WireError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def getvalue(self) -> bytes:
        out = bytes(self._out)
        if self._nbits:
            out += bytes([(self._acc << (8 - self._nbits)) & 0xFF])
        return out


class BitReader:
    """MSB-first bit unpacker over a byte slice."""

    def __init__(self, buf: bytes, off: int = 0) -> None:
        self._buf = buf
        self._byte = off
        self._bit = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            if self._byte >= len(self._buf):
                raise WireTruncated("bit field runs past end of buffer")
            v = (v << 1) | ((self._buf[self._byte] >> (7 - self._bit)) & 1)
            self._bit += 1
            if self._bit == 8:
                self._bit = 0
                self._byte += 1
        return v

    def finish(self) -> int:
        """Consume zero padding to the end; returns the next byte offset.

        Raises WireError on nonzero pad bits or leftover whole bytes —
        the corrupted/over-long frame rejection path.
        """
        if self._bit:
            pad = self._buf[self._byte] & ((1 << (8 - self._bit)) - 1)
            if pad:
                raise WireError("nonzero padding bits at end of bit stream")
            self._byte += 1
            self._bit = 0
        if self._byte != len(self._buf):
            raise WireError(
                f"{len(self._buf) - self._byte} unconsumed bytes after bit stream"
            )
        return self._byte
