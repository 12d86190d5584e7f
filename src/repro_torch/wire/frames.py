"""Frame codecs of the tree front end's ``MSG_TREE`` exchange (DESIGN.md §9,
§15), carried over unchanged from the reference package's ``wire.frames``.

Envelope: ``uvarint(1 + len(payload)) || msg_type byte || payload``.  Each
payload is a varint header plus an MSB-first bit stream zero-padded to the
byte boundary, so framed sizes are ``header + ceil(payload_bits / 8)``.
The tree walk ledgers the framed length of each level's digest and verdict
frames as transport overhead.  The other protocol messages' codecs come
over with the endpoint port that uses them.

Every decoder is strict: truncated buffers, nonzero padding, trailing
bytes and out-of-range values raise ``WireError``.
"""
from __future__ import annotations

import numpy as np

from .varint import WireError, WireTruncated, decode_uvarint, encode_uvarint

MSG_TREE = 0x0B           # either direction: tree-phase digest/verdict exchange

KEY_BITS = 32  # element keys are 32-bit (core.pbs.KEY_BITS)


def frame(msg_type: int, payload: bytes) -> bytes:
    return encode_uvarint(1 + len(payload)) + bytes((msg_type,)) + payload


def _bit_array(payload: bytes, off: int) -> np.ndarray:
    """MSB-first 0/1 uint8 view of ``payload[off:]`` — the whole remaining
    bit stream in one ``np.unpackbits`` pass."""
    return np.unpackbits(np.frombuffer(payload, dtype=np.uint8, offset=off))


def _weights(nbits: int) -> np.ndarray:
    """MSB-first bit weights: dot a (N, nbits) 0/1 matrix to get values."""
    return np.left_shift(
        np.int64(1), np.arange(nbits - 1, -1, -1, dtype=np.int64)
    )


def _field_bits(values, nbits: int) -> np.ndarray:
    """(N,) non-negative ints -> (N*nbits,) MSB-first bits."""
    v = np.asarray(values, dtype=np.uint64).reshape(-1, 1)
    sh = np.arange(nbits - 1, -1, -1, dtype=np.uint64)
    return ((v >> sh) & np.uint64(1)).astype(np.uint8).ravel()


def _read_fields(bits: np.ndarray, offsets: np.ndarray, nbits: int) -> np.ndarray:
    """Gather one nbits-wide MSB-first value at each bit offset."""
    if nbits == 0:
        return np.zeros(len(offsets), dtype=np.int64)
    idx = np.asarray(offsets, dtype=np.int64)[:, None] + np.arange(
        nbits, dtype=np.int64
    )
    return bits[idx].astype(np.int64) @ _weights(nbits)


def _pack_payload(header: bytes, bit_segments: list) -> bytes:
    """Header + the concatenated bit segments packed MSB-first, final byte
    zero-padded."""
    if not bit_segments:
        return header
    bits = np.concatenate(bit_segments)
    if not len(bits):
        return header
    return header + np.packbits(bits).tobytes()


def _finish_bits(bits: np.ndarray, used: int, payload: bytes, off: int) -> None:
    """The payload must be exactly ``ceil(used / 8)`` bytes past ``off`` and
    every pad bit zero (corrupted/over-long frame rejection)."""
    avail = len(payload) - off
    need = (used + 7) // 8
    if avail > need:
        raise WireError(f"{avail - need} unconsumed bytes after bit stream")
    if used < need * 8 and np.any(bits[used : need * 8]):
        raise WireError("nonzero padding bits at end of bit stream")


def tow_value_bits(set_size: int) -> int:
    """Bits per sketch value: Y_i in [-|S|, |S|] (ceil(log2(2|S| + 1)))."""
    return int(2 * set_size).bit_length()


# MSG_TREE payloads open with a flavor uvarint: one message type, two
# directions of the per-level barrier.
TREE_DIGEST = 0    # initiator -> responder: per-range digests for a frontier
TREE_VERDICT = 1   # responder -> initiator: per-range verdicts + leaf d̂

# per-range verdicts carried 2 bits wide in TREE_VERDICT frames
TREE_PRUNE = 0     # digests match: the range holds no symmetric difference
TREE_RECURSE = 1   # divergent and too hot for PBS: split and go deeper
TREE_LEAF = 2      # divergent with small residual d̂: hand range to PBS


def encode_tree_digest(level, counts, checksums, sketches) -> bytes:
    """One tree level's frontier digests, range order == frontier order.

    Payload: ``uvarint(TREE_DIGEST) || uvarint(level) || uvarint(ell) ||
    uvarint(R) || uvarint(count_r) x R`` then one MSB-first bit stream:
    per range a ``KEY_BITS``-bit checksum followed by ``ell`` zigzag ToW
    values at ``tow_value_bits(count_r)`` each (a range's sketch values are
    bounded by its own element count, so empty ranges cost zero sketch
    bits).  Ranges themselves are never shipped: both sides derive the
    frontier deterministically from the previous level's verdicts.
    """
    cnt = np.asarray(counts, dtype=np.int64)
    cs = np.asarray(checksums, dtype=np.int64)
    sk = np.asarray(sketches, dtype=np.int64)
    if sk.ndim != 2 or len(sk) != len(cnt):
        raise WireError("tree sketches must be one (R, ell) matrix")
    n_ranges = len(cnt)
    ell = int(sk.shape[1])
    if ell < 1:
        raise WireError("tree digest with empty sketch rows")
    header = (
        encode_uvarint(TREE_DIGEST)
        + encode_uvarint(int(level))
        + encode_uvarint(ell)
        + encode_uvarint(n_ranges)
        + b"".join(encode_uvarint(int(c)) for c in cnt)
    )
    segs = []
    for r in range(n_ranges):
        vbits = tow_value_bits(int(cnt[r]))
        z = (sk[r] << 1) ^ (sk[r] >> 63)
        if np.any(z > 2 * cnt[r]):
            v = int(sk[r][int(np.argmax(z > 2 * cnt[r]))])
            raise WireError(
                f"tree sketch value {v} exceeds range count {int(cnt[r])}"
            )
        segs.append(_field_bits([int(cs[r]) & 0xFFFFFFFF], KEY_BITS))
        if vbits:
            segs.append(_field_bits(z, vbits))
    return frame(MSG_TREE, _pack_payload(header, segs))


def decode_tree_digest(payload: bytes):
    """(level, ell, counts, checksums, sketches); strict.

    Rejects a non-``TREE_DIGEST`` flavor, truncated bit fields, sketch
    values out of range for their own range count, nonzero padding, and
    trailing bytes.
    """
    flavor, off = decode_uvarint(payload)
    if flavor != TREE_DIGEST:
        raise WireError(f"expected tree digest flavor, got {flavor}")
    level, off = decode_uvarint(payload, off)
    ell, off = decode_uvarint(payload, off)
    if ell < 1:
        raise WireError("tree digest with empty sketch rows")
    n_ranges, off = decode_uvarint(payload, off)
    counts = np.zeros(n_ranges, dtype=np.int64)
    for r in range(n_ranges):
        counts[r], off = decode_uvarint(payload, off)
    vbits = np.array(
        [tow_value_bits(int(c)) for c in counts], dtype=np.int64
    )
    total = int(np.sum(vbits) * ell) + n_ranges * KEY_BITS
    bstream = _bit_array(payload, off)
    if total > len(bstream):
        raise WireTruncated("bit field runs past end of buffer")
    csums = np.zeros(n_ranges, dtype=np.int64)
    sketches = np.zeros((n_ranges, ell), dtype=np.int64)
    pos = 0
    for r in range(n_ranges):
        csums[r] = _read_fields(bstream, [pos], KEY_BITS)[0]
        pos += KEY_BITS
        vb = int(vbits[r])
        if vb:
            offs = pos + np.arange(ell, dtype=np.int64) * vb
            z = _read_fields(bstream, offs, vb)
            if np.any(z > 2 * counts[r]):
                raise WireError(
                    "tree sketch value out of range for its range count"
                )
            sketches[r] = (z >> 1) ^ -(z & 1)
            pos += ell * vb
    _finish_bits(bstream, total, payload, off)
    return int(level), int(ell), counts, csums, sketches


def encode_tree_verdict(level, verdicts, leaf_ds) -> bytes:
    """One tree level's verdicts, range order == frontier order.

    Payload: ``uvarint(TREE_VERDICT) || uvarint(level) || uvarint(R)`` then
    R two-bit verdicts packed MSB-first (zero-padded to the byte), then one
    ``uvarint(d_plan)`` per ``TREE_LEAF`` verdict in range order — the
    planned d the matching PBS leaf session is built with on both sides.
    """
    v = np.asarray(verdicts, dtype=np.int64)
    ds = [int(d) for d in leaf_ds]
    if np.any((v < 0) | (v > TREE_LEAF)):
        raise WireError("tree verdict out of range")
    if len(ds) != int(np.sum(v == TREE_LEAF)):
        raise WireError("leaf d list does not match leaf verdict count")
    if any(d < 1 for d in ds):
        raise WireError("leaf d_plan must be >= 1")
    header = (
        encode_uvarint(TREE_VERDICT)
        + encode_uvarint(int(level))
        + encode_uvarint(len(v))
    )
    body = _pack_payload(header, [_field_bits(v, 2)] if len(v) else [])
    return frame(MSG_TREE, body + b"".join(encode_uvarint(d) for d in ds))


def decode_tree_verdict(payload: bytes):
    """(level, verdicts, leaf_ds); strict.

    Rejects a non-``TREE_VERDICT`` flavor, the reserved verdict value 3,
    nonzero verdict padding bits, zero leaf d, truncation, and trailing
    bytes after the final leaf ``uvarint``.
    """
    flavor, off = decode_uvarint(payload)
    if flavor != TREE_VERDICT:
        raise WireError(f"expected tree verdict flavor, got {flavor}")
    level, off = decode_uvarint(payload, off)
    n_ranges, off = decode_uvarint(payload, off)
    nbytes = (2 * n_ranges + 7) // 8
    if off + nbytes > len(payload):
        raise WireTruncated("bit field runs past end of buffer")
    bits = (
        np.unpackbits(
            np.frombuffer(payload, dtype=np.uint8, offset=off, count=nbytes)
        )
        if nbytes
        else np.zeros(0, dtype=np.uint8)
    )
    if np.any(bits[2 * n_ranges :]):
        raise WireError("nonzero padding bits at end of bit stream")
    verdicts = (
        _read_fields(bits, np.arange(n_ranges, dtype=np.int64) * 2, 2)
        if n_ranges
        else np.zeros(0, dtype=np.int64)
    )
    if np.any(verdicts > TREE_LEAF):
        raise WireError("tree verdict out of range")
    off += nbytes
    leaf_ds = np.zeros(int(np.sum(verdicts == TREE_LEAF)), dtype=np.int64)
    for i in range(len(leaf_ds)):
        leaf_ds[i], off = decode_uvarint(payload, off)
        if leaf_ds[i] < 1:
            raise WireError("leaf d_plan must be >= 1")
    if off != len(payload):
        raise WireError(f"{len(payload) - off} unconsumed bytes after frame")
    return int(level), verdicts, leaf_ds
