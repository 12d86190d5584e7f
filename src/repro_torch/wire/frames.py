"""Frame codecs for every PBS protocol message (DESIGN.md §9), carried over
unchanged from the reference package's ``wire.frames`` so that both
packages frame every message byte for byte alike.

Envelope: ``uvarint(1 + len(payload)) || msg_type byte || payload``.  Each
payload is a varint header plus an MSB-first bit stream zero-padded to the
byte boundary, so framed sizes are ``header + ceil(payload_bits / 8)``.

Sub-byte field widths come from the session's BCH code — m-bit syndromes
and bin positions, 32-bit XOR folds and checksums — which is why the
round-frame decoders take a *schema* (``(n_units, t, m)`` per live session)
instead of shipping redundant structure: both endpoints derive the schema
from the same deterministic round state machine, exactly like the paper's
Formula (1) assumes.  ``*_ledger_bits`` report the protocol-information
bits of a decoded frame per that accounting; structural bits (per-unit
position counts, done flags, headers, padding) are measured separately by
the endpoints as wire overhead.

The public codecs are **numpy-batched** (DESIGN.md §12): every fixed-width
field of a frame is packed/unpacked in whole-frame ``np.packbits`` /
``np.unpackbits`` passes (MSB-first, final-byte zero padding — exactly the
``BitWriter``/``BitReader`` stream), instead of one Python bit loop per
unit row.  The original per-bit codecs are kept under ``*_scalar`` names as
the differential oracle of each batched codec
(tests/test_torch_wire_codecs.py holds both against the reference's).

Every decoder is strict: truncated buffers, nonzero padding, trailing
bytes, out-of-range positions/counts, and unknown message types all raise
``WireError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .varint import (
    BitReader,
    BitWriter,
    WireError,
    WireTruncated,
    decode_uvarint,
    encode_uvarint,
    unzigzag,
    uvarint_len,
    zigzag,
)

MSG_TOW_SKETCH = 0x01     # Alice -> Bob: phase-0 ToW sketch vector
MSG_DHAT = 0x02           # Bob -> Alice: d_hat numerator (sum of squared diffs)
MSG_ROUND_SKETCHES = 0x03  # Alice -> Bob: per-unit BCH syndrome sketches
MSG_ROUND_REPLY = 0x04    # Bob -> Alice: ok flags, positions, XORs, checksums
MSG_ROUND_OUTCOME = 0x05  # Alice -> Bob: per-unit checksum-settled flags
MSG_VERIFY = 0x06         # Alice -> Bob: success + c(A xor D_hat) per session
MSG_VERIFY_ACK = 0x07     # Bob -> Alice: per-session verification verdicts
MSG_MUX = 0x08            # either direction: channel-tagged envelope (hub)
MSG_EPOCH = 0x09          # either direction: epoch-open envelope (continuous sync)
MSG_RESUME = 0x0A         # either direction: session-resumption handshake (hub)
MSG_TREE = 0x0B           # either direction: tree-phase digest/verdict exchange
MSG_PARITY = 0x0C         # Alice -> Bob: incremental parity syndromes (rateless)

_KNOWN = frozenset(
    (MSG_TOW_SKETCH, MSG_DHAT, MSG_ROUND_SKETCHES, MSG_ROUND_REPLY,
     MSG_ROUND_OUTCOME, MSG_VERIFY, MSG_VERIFY_ACK, MSG_MUX, MSG_EPOCH,
     MSG_RESUME, MSG_TREE, MSG_PARITY)
)

KEY_BITS = 32  # element keys are 32-bit (core.pbs.KEY_BITS)


# ---------------------------------------------------------------------------
# Envelope
# ---------------------------------------------------------------------------


def frame(msg_type: int, payload: bytes) -> bytes:
    return encode_uvarint(1 + len(payload)) + bytes((msg_type,)) + payload


def split_frame(buf: bytes, off: int = 0):
    """Parse one frame at ``off``: (msg_type, payload, next_off).

    Returns None when the buffer holds only a frame prefix (stream
    transports deliver partial reads); raises WireError on malformed input.
    """
    if off >= len(buf):
        return None
    try:
        body_len, hdr_end = decode_uvarint(buf, off)
    except WireTruncated:
        return None
    if body_len < 1:
        raise WireError("frame with empty body")
    if hdr_end + body_len > len(buf):
        return None
    msg_type = buf[hdr_end]
    if msg_type not in _KNOWN:
        raise WireError(f"unknown message type 0x{msg_type:02x}")
    return msg_type, buf[hdr_end + 1 : hdr_end + body_len], hdr_end + body_len


# ---------------------------------------------------------------------------
# Multiplexing envelope (repro.net.hub, DESIGN.md §10)
# ---------------------------------------------------------------------------


def encode_mux(channel: int, inner: bytes) -> bytes:
    """Wrap one complete frame in a channel-tagged envelope.

    Payload: ``uvarint(channel) || inner frame`` where ``inner`` is a full
    frame (envelope + type + payload) — the hub demultiplexes N peers by
    this tag and rejects frames whose tag is not the peer's assigned
    channel.  Channel 0 is reserved (never assigned), so a zero tag is
    always a protocol error at the hub.
    """
    if channel < 1:
        raise WireError(f"mux channel {channel} out of range (must be >= 1)")
    return frame(MSG_MUX, encode_uvarint(channel) + inner)


def decode_mux(payload: bytes) -> tuple[int, int, bytes]:
    """(channel, inner msg_type, inner payload); strict.

    The inner frame must parse completely (no trailing bytes) and must not
    itself be a mux envelope — nesting is rejected.
    """
    channel, off = decode_uvarint(payload)
    if channel < 1:
        raise WireError(f"mux channel {channel} out of range (must be >= 1)")
    got = split_frame(payload, off)
    if got is None:
        raise WireTruncated("mux envelope holds an incomplete inner frame")
    msg_type, inner_payload, end = got
    if msg_type == MSG_MUX:
        raise WireError("nested mux envelope")
    if end != len(payload):
        raise WireError(
            f"{len(payload) - end} trailing bytes after mux inner frame"
        )
    return channel, msg_type, inner_payload


def mux_overhead_bytes(channel: int, inner_len: int) -> int:
    """Envelope bytes ``encode_mux`` adds on top of the inner frame — the
    transport-level cost of hub multiplexing (excluded from the protocol
    ledger exactly like ARQ overhead)."""
    payload_len = uvarint_len(channel) + inner_len
    return uvarint_len(1 + payload_len) + 1 + uvarint_len(channel)


# ---------------------------------------------------------------------------
# Epoch envelope (continuous sync, DESIGN.md §11)
# ---------------------------------------------------------------------------


def encode_epoch(epoch: int, inner: bytes = b"") -> bytes:
    """Wrap one continuous-sync epoch-handshake step in an epoch-tagged
    envelope.

    Payload: ``uvarint(epoch) || inner`` where ``inner`` is either empty —
    a bare epoch-open, sent when the epoch needs no d̂ re-estimation — or
    exactly one complete phase-0 frame (``MSG_TOW_SKETCH`` outbound,
    ``MSG_DHAT`` on the reply), so the d̂ handshake rides the same codecs
    admission uses.  Epoch 0 is the admission epoch (plain ``submit`` +
    phase 0), so an epoch tag below 1 is always a protocol error.  The
    ledger mirrors ``MSG_MUX``: the inner frame's bits count per Formula
    (1) (estimator bytes), the envelope's extra bytes are transport
    overhead.
    """
    if epoch < 1:
        raise WireError(f"epoch {epoch} out of range (must be >= 1)")
    return frame(MSG_EPOCH, encode_uvarint(epoch) + inner)


def decode_epoch(payload: bytes) -> tuple[int, int | None, bytes | None]:
    """(epoch, inner msg_type | None, inner payload | None); strict.

    A non-empty inner region must parse as exactly one complete frame (no
    trailing bytes) and must not itself be an envelope — nested
    ``MSG_EPOCH`` or ``MSG_MUX`` is rejected (the mux wrap, when present,
    goes *outside* the epoch envelope).
    """
    epoch, off = decode_uvarint(payload)
    if epoch < 1:
        raise WireError(f"epoch {epoch} out of range (must be >= 1)")
    if off == len(payload):
        return epoch, None, None
    got = split_frame(payload, off)
    if got is None:
        raise WireTruncated("epoch envelope holds an incomplete inner frame")
    msg_type, inner_payload, end = got
    if msg_type in (MSG_EPOCH, MSG_MUX):
        raise WireError(f"nested envelope 0x{msg_type:02x} in epoch frame")
    if end != len(payload):
        raise WireError(
            f"{len(payload) - end} trailing bytes after epoch inner frame"
        )
    return epoch, msg_type, inner_payload


def epoch_overhead_bytes(epoch: int, inner_len: int) -> int:
    """Envelope bytes ``encode_epoch`` adds on top of the inner frame —
    transport overhead, excluded from the protocol ledger like mux/ARQ."""
    payload_len = uvarint_len(epoch) + inner_len
    return uvarint_len(1 + payload_len) + 1 + uvarint_len(epoch)


# ---------------------------------------------------------------------------
# Session-resumption handshake (repro.net.resilience, DESIGN.md §13)
# ---------------------------------------------------------------------------

_DIGEST_BYTES = 8
_DIGEST_MASK = (1 << 64) - 1
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x00000100000001B3


def transcript_digest0(epoch: int) -> int:
    """The rolling transcript digest's per-epoch starting value.

    Both sides reset to this at admission and at each epoch install, then
    fold every completed round's outcome frame via ``fold_transcript`` —
    so two transcripts agree iff both sides applied the same outcome
    frames in the same rounds of the same epoch.
    """
    return fold_transcript(_FNV_OFFSET, 0, int(epoch).to_bytes(8, "big"))


def fold_transcript(digest: int, rnd: int, frame_bytes: bytes) -> int:
    """Fold one completed round barrier into the rolling transcript digest
    (FNV-1a over the round number then the framed outcome bytes).  The
    digest is a divergence *guard* for ``MSG_RESUME``, not a proof: a peer
    whose replayed state drifted from the hub's mirror is rejected at the
    resume handshake instead of corrupting the shared cohort state.
    """
    d = digest & _DIGEST_MASK
    for b in int(rnd).to_bytes(8, "big") + bytes(frame_bytes):
        d = ((d ^ b) * _FNV_PRIME) & _DIGEST_MASK
    return d


def encode_resume(
    channel: int, epoch: int, last_round: int, digest: int, digest_prev: int
) -> bytes:
    """One side of the resumption handshake (DESIGN.md §13).

    Payload: ``uvarint(channel) || uvarint(epoch) || uvarint(last_round) ||
    digest[8] || digest_prev[8]`` — the sender's channel id, its current
    epoch, its last *completed* local round barrier, and the rolling
    transcript digests at that barrier and the one before it (the previous
    digest is what the receiver checks when it is exactly one outcome
    frame behind, i.e. the peer's last outcome frame was lost in flight).
    The reconnecting peer sends it first; the hub answers with its own
    ``MSG_RESUME`` carrying the mirror's barrier, which tells the peer
    whether to replay its buffered outcome frame.  Channel 0 is reserved,
    exactly like ``MSG_MUX``.  Resume frames are transport overhead —
    ledgered like ARQ/mux bytes, never Formula-(1) bits.
    """
    if channel < 1:
        raise WireError(f"resume channel {channel} out of range (must be >= 1)")
    if last_round < 0:
        raise WireError(f"resume round {last_round} out of range")
    return frame(
        MSG_RESUME,
        encode_uvarint(channel)
        + encode_uvarint(epoch)
        + encode_uvarint(last_round)
        + (digest & _DIGEST_MASK).to_bytes(_DIGEST_BYTES, "big")
        + (digest_prev & _DIGEST_MASK).to_bytes(_DIGEST_BYTES, "big"),
    )


def decode_resume(payload: bytes) -> tuple[int, int, int, int, int]:
    """(channel, epoch, last_round, digest, digest_prev); strict."""
    channel, off = decode_uvarint(payload)
    if channel < 1:
        raise WireError(f"resume channel {channel} out of range (must be >= 1)")
    epoch, off = decode_uvarint(payload, off)
    last_round, off = decode_uvarint(payload, off)
    if len(payload) - off != 2 * _DIGEST_BYTES:
        raise WireError(
            f"resume frame carries {len(payload) - off} digest bytes, "
            f"expected {2 * _DIGEST_BYTES}"
        )
    digest = int.from_bytes(payload[off : off + _DIGEST_BYTES], "big")
    digest_prev = int.from_bytes(payload[off + _DIGEST_BYTES :], "big")
    return channel, epoch, last_round, digest, digest_prev


def resume_overhead_bytes(channel: int, epoch: int, last_round: int) -> int:
    """Framed size of one ``MSG_RESUME`` — all of it transport overhead
    (the handshake re-establishes a channel; it carries no set data)."""
    payload_len = (
        uvarint_len(channel) + uvarint_len(epoch) + uvarint_len(last_round)
        + 2 * _DIGEST_BYTES
    )
    return uvarint_len(1 + payload_len) + 1 + payload_len


# ---------------------------------------------------------------------------
# Batched bit-stream helpers (DESIGN.md §12)
# ---------------------------------------------------------------------------

# widest fixed field the int64 weight vectors handle exactly; wider ToW
# value fields (astronomical declared set sizes) fall back to the scalar
# codec, which reads them with Python integers
_MAX_FIELD_BITS = 48


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
    zero-padded — byte-identical to ``BitWriter.getvalue()``."""
    if not bit_segments:
        return header
    bits = np.concatenate(bit_segments)
    if not len(bits):
        return header
    return header + np.packbits(bits).tobytes()


def _finish_bits(bits: np.ndarray, used: int, payload: bytes, off: int) -> None:
    """``BitReader.finish`` semantics over the batched view: the payload
    must be exactly ``ceil(used / 8)`` bytes past ``off`` and every pad bit
    zero (corrupted/over-long frame rejection)."""
    avail = len(payload) - off
    need = (used + 7) // 8
    if avail > need:
        raise WireError(f"{avail - need} unconsumed bytes after bit stream")
    if used < need * 8 and np.any(bits[used : need * 8]):
        raise WireError("nonzero padding bits at end of bit stream")


# ---------------------------------------------------------------------------
# Phase 0: ToW sketch + d_hat reply
# ---------------------------------------------------------------------------


def tow_value_bits(set_size: int) -> int:
    """Bits per sketch value: Y_i in [-|S|, |S|] (ceil(log2(2|S| + 1)))."""
    return int(2 * set_size).bit_length()


def encode_tow_sketch(values, set_size: int) -> bytes:
    vals = np.asarray(values, dtype=np.int64)
    bits = tow_value_bits(set_size)
    if bits > _MAX_FIELD_BITS:
        return encode_tow_sketch_scalar(values, set_size)
    # arithmetic-shift zigzag works for both signs: n>>63 is 0 or -1
    z = (vals << 1) ^ (vals >> 63)
    bad = z > 2 * set_size
    if np.any(bad):
        v = int(vals[int(np.argmax(bad))])
        raise WireError(f"sketch value {v} exceeds set size {set_size}")
    payload = _pack_payload(
        encode_uvarint(set_size) + encode_uvarint(len(vals)),
        [_field_bits(z, bits)] if len(vals) else [],
    )
    return frame(MSG_TOW_SKETCH, payload)


def encode_tow_sketch_scalar(values, set_size: int) -> bytes:
    """Per-value ``BitWriter`` form of ``encode_tow_sketch`` (test oracle)."""
    vals = np.asarray(values, dtype=np.int64)
    bits = tow_value_bits(set_size)
    w = BitWriter()
    for v in vals:
        z = zigzag(int(v))
        if z > 2 * set_size:
            raise WireError(f"sketch value {int(v)} exceeds set size {set_size}")
        w.write(z, bits)
    payload = encode_uvarint(set_size) + encode_uvarint(len(vals)) + w.getvalue()
    return frame(MSG_TOW_SKETCH, payload)


def decode_tow_sketch(payload: bytes) -> tuple[int, np.ndarray]:
    set_size, off = decode_uvarint(payload)
    ell, off = decode_uvarint(payload, off)
    bits = tow_value_bits(set_size)
    if bits > _MAX_FIELD_BITS:
        return decode_tow_sketch_scalar(payload)
    bstream = _bit_array(payload, off)
    total = ell * bits
    if total > len(bstream):
        raise WireTruncated("bit field runs past end of buffer")
    z = (
        bstream[:total].reshape(ell, bits).astype(np.int64) @ _weights(bits)
        if ell
        else np.zeros(0, dtype=np.int64)
    )
    if np.any(z > 2 * set_size):
        raise WireError("sketch value out of range for declared set size")
    _finish_bits(bstream, total, payload, off)
    return set_size, (z >> 1) ^ -(z & 1)


def decode_tow_sketch_scalar(payload: bytes) -> tuple[int, np.ndarray]:
    """Per-value ``BitReader`` form of ``decode_tow_sketch`` (test oracle)."""
    set_size, off = decode_uvarint(payload)
    ell, off = decode_uvarint(payload, off)
    bits = tow_value_bits(set_size)
    r = BitReader(payload, off)
    out = np.zeros(ell, dtype=np.int64)
    for i in range(ell):
        z = r.read(bits)
        if z > 2 * set_size:
            raise WireError("sketch value out of range for declared set size")
        out[i] = unzigzag(z)
    r.finish()
    return set_size, out


def encode_dhat(numerator: int) -> bytes:
    return frame(MSG_DHAT, encode_uvarint(int(numerator)))


def decode_dhat(payload: bytes) -> int:
    num, off = decode_uvarint(payload)
    if off != len(payload):
        raise WireError("trailing bytes after d_hat numerator")
    return num


# ---------------------------------------------------------------------------
# Round frames
# ---------------------------------------------------------------------------


def sketches_ledger_bits(n_units: int, t: int, m: int) -> int:
    """Formula-(1) bits of one session's sketch block: t*m per unit."""
    return n_units * t * m


def encode_round_sketches(rnd: int, blocks) -> bytes:
    """``blocks``: per live session (schema order), (sketches (U, t), m).

    All of a block's m-bit syndromes bit-pack in one vectorized pass."""
    segs = []
    for sk, m in blocks:
        sk = np.asarray(sk, dtype=np.int64)
        if np.any(sk < 0) or np.any(sk >> m):
            raise WireError(f"syndrome out of range for m={m}")
        if sk.size:
            segs.append(_field_bits(sk.ravel(), m))
    return frame(MSG_ROUND_SKETCHES, _pack_payload(encode_uvarint(rnd), segs))


def encode_round_sketches_scalar(rnd: int, blocks) -> bytes:
    """Per-bit ``BitWriter`` form of ``encode_round_sketches`` (test oracle)."""
    w = BitWriter()
    for sk, m in blocks:
        sk = np.asarray(sk, dtype=np.int64)
        if np.any(sk < 0) or np.any(sk >> m):
            raise WireError(f"syndrome out of range for m={m}")
        for row in sk:
            for s in row:
                w.write(int(s), m)
    return frame(MSG_ROUND_SKETCHES, encode_uvarint(rnd) + w.getvalue())


def decode_round_sketches(payload: bytes, schema) -> tuple[int, list[np.ndarray]]:
    """``schema``: [(n_units, t, m)] per live session, both-endpoint-derived."""
    rnd, off = decode_uvarint(payload)
    bits = _bit_array(payload, off)
    total = sum(n_units * t * m for n_units, t, m in schema)
    if total > len(bits):
        raise WireTruncated("bit field runs past end of buffer")
    out = []
    pos = 0
    for n_units, t, m in schema:
        nb = n_units * t * m
        blk = (
            bits[pos : pos + nb].reshape(n_units * t, m).astype(np.int64)
            @ _weights(m)
        )
        out.append(blk.reshape(n_units, t))
        pos += nb
    _finish_bits(bits, total, payload, off)
    return rnd, out


def decode_round_sketches_scalar(
    payload: bytes, schema
) -> tuple[int, list[np.ndarray]]:
    """Per-bit ``BitReader`` form of ``decode_round_sketches`` (test oracle)."""
    rnd, off = decode_uvarint(payload)
    r = BitReader(payload, off)
    out = []
    for n_units, t, m in schema:
        sk = np.zeros((n_units, t), dtype=np.int64)
        for u in range(n_units):
            for j in range(t):
                sk[u, j] = r.read(m)
        out.append(sk)
    r.finish()
    return rnd, out


def parity_ledger_bits(n_units: int, dt: int, m: int) -> int:
    """Formula-(1) bits of one session's parity-extension block: dt
    incremental m-bit syndromes per still-overloaded unit.  Telescoping
    (DESIGN.md §16): a unit that decodes at extension level e has shipped
    exactly t_e * m total syndrome bits across the round — the prefix plus
    every increment IS the fresh (n, t_e) sketch, so nothing is re-sent."""
    return n_units * dt * m


def encode_parity(rnd: int, level: int, blocks) -> bytes:
    """``blocks``: per extending session (schema order), (inc (U, dt), m) —
    the incremental odd syndromes S_{2*t_prev+1}..S_{2*t_e-1} of each
    still-overloaded unit, slots in ascending order.

    Payload: ``uvarint(rnd) || uvarint(level)`` then one MSB-first bit
    stream of m-bit syndromes.  Which units extend at which level is
    derived deterministically by both sides from the reply's ok flags and
    the shared t-ladder, so the frame ships no unit identities — the same
    schema convention as every round frame (DESIGN.md §9).
    """
    if level < 1:
        raise WireError(f"parity level {level} out of range (must be >= 1)")
    segs = []
    for inc, m in blocks:
        inc = np.asarray(inc, dtype=np.int64)
        if np.any(inc < 0) or np.any(inc >> m):
            raise WireError(f"syndrome out of range for m={m}")
        if inc.size:
            segs.append(_field_bits(inc.ravel(), m))
    header = encode_uvarint(rnd) + encode_uvarint(level)
    return frame(MSG_PARITY, _pack_payload(header, segs))


def encode_parity_scalar(rnd: int, level: int, blocks) -> bytes:
    """Per-bit ``BitWriter`` form of ``encode_parity`` (test oracle)."""
    if level < 1:
        raise WireError(f"parity level {level} out of range (must be >= 1)")
    w = BitWriter()
    for inc, m in blocks:
        inc = np.asarray(inc, dtype=np.int64)
        if np.any(inc < 0) or np.any(inc >> m):
            raise WireError(f"syndrome out of range for m={m}")
        for row in inc:
            for s in row:
                w.write(int(s), m)
    payload = encode_uvarint(rnd) + encode_uvarint(level) + w.getvalue()
    return frame(MSG_PARITY, payload)


def decode_parity(payload: bytes, schema) -> tuple[int, int, list[np.ndarray]]:
    """``schema``: [(n_units, dt, m)] per extending session, both-endpoint-
    derived from the failing slots and the t-ladder; strict."""
    rnd, off = decode_uvarint(payload)
    level, off = decode_uvarint(payload, off)
    if level < 1:
        raise WireError(f"parity level {level} out of range (must be >= 1)")
    bits = _bit_array(payload, off)
    total = sum(n_units * dt * m for n_units, dt, m in schema)
    if total > len(bits):
        raise WireTruncated("bit field runs past end of buffer")
    out = []
    pos = 0
    for n_units, dt, m in schema:
        nb = n_units * dt * m
        blk = (
            bits[pos : pos + nb].reshape(n_units * dt, m).astype(np.int64)
            @ _weights(m)
            if nb
            else np.zeros(0, dtype=np.int64)
        )
        out.append(blk.reshape(n_units, dt))
        pos += nb
    _finish_bits(bits, total, payload, off)
    return rnd, level, out


def decode_parity_scalar(
    payload: bytes, schema
) -> tuple[int, int, list[np.ndarray]]:
    """Per-bit ``BitReader`` form of ``decode_parity`` (test oracle)."""
    rnd, off = decode_uvarint(payload)
    level, off = decode_uvarint(payload, off)
    if level < 1:
        raise WireError(f"parity level {level} out of range (must be >= 1)")
    r = BitReader(payload, off)
    out = []
    for n_units, dt, m in schema:
        inc = np.zeros((n_units, dt), dtype=np.int64)
        for u in range(n_units):
            for j in range(dt):
                inc[u, j] = r.read(m)
        out.append(inc)
    r.finish()
    return rnd, level, out


@dataclass
class ReplyUnit:
    """Bob's per-unit decode outcome: located bins, his XOR folds, checksum."""

    positions: np.ndarray  # (k,) int64 decoded bin indices, k <= t
    xors: np.ndarray       # (k,) uint32 Bob's bin XOR fold at each position
    csum: int              # Bob's unit checksum, 32-bit

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ReplyUnit)
            and np.array_equal(self.positions, other.positions)
            and np.array_equal(self.xors, other.xors)
            and self.csum == other.csum
        )


def reply_ledger_bits(ok, units, m: int) -> int:
    """Formula-(1) bits of one session's reply: 1 ok flag per unit, plus
    k*(m + 32) + 32 per decoded unit (positions + XOR sums + checksum)."""
    bits = len(ok)
    for flag, unit in zip(ok, units):
        if flag:
            bits += len(unit.positions) * (m + KEY_BITS) + KEY_BITS
    return bits


def encode_round_reply(rnd: int, entries, schema) -> bytes:
    """``entries``: per session (ok flags, units with ``units[i] is None``
    exactly where ``ok[i]`` is False); ``schema``: [(n_units, t, m)].

    Per session, every count/position/XOR/checksum field lands at a
    precomputed bit offset via vectorized scatters — no per-unit bit loop.
    """
    segs = []
    for (ok, units), (n_units, t, m) in zip(entries, schema):
        if len(ok) != n_units or len(units) != n_units:
            raise WireError("reply entry does not match schema unit count")
        cbits = t.bit_length()
        if n_units:
            segs.append(
                np.fromiter((1 if f else 0 for f in ok), np.uint8, count=n_units)
            )
        sel = [u for f, u in zip(ok, units) if f]
        if not sel:
            continue
        ks = np.fromiter((len(u.positions) for u in sel), np.int64, count=len(sel))
        bad = ks > t
        if np.any(bad):
            raise WireError(f"{int(ks[int(np.argmax(bad))])} positions exceed t={t}")
        em = m + KEY_BITS
        body_len = cbits + ks * em + KEY_BITS
        starts = np.cumsum(body_len) - body_len
        arr = np.zeros(int(body_len.sum()), dtype=np.uint8)
        cnt_idx = (starts[:, None] + np.arange(cbits, dtype=np.int64)).ravel()
        arr[cnt_idx] = _field_bits(ks, cbits)
        total_p = int(ks.sum())
        if total_p:
            pos_all = np.concatenate(
                [np.asarray(u.positions, dtype=np.int64) for u in sel]
            )
            bad_p = (pos_all < 0) | (pos_all >= (1 << m) - 1)
            if np.any(bad_p):
                p = int(pos_all[int(np.argmax(bad_p))])
                raise WireError(f"bin position {p} out of range for m={m}")
            xor_all = np.concatenate(
                [
                    np.asarray(u.xors, dtype=np.uint32).astype(np.int64)
                    for u in sel
                ]
            )
            ent_unit = np.repeat(np.arange(len(sel)), ks)
            within = np.arange(total_p) - np.repeat(np.cumsum(ks) - ks, ks)
            ent_off = starts[ent_unit] + cbits + within * em
            arr[(ent_off[:, None] + np.arange(m, dtype=np.int64)).ravel()] = (
                _field_bits(pos_all, m)
            )
            arr[
                (
                    ent_off[:, None] + m + np.arange(KEY_BITS, dtype=np.int64)
                ).ravel()
            ] = _field_bits(xor_all, KEY_BITS)
        csums = np.fromiter(
            (int(u.csum) & 0xFFFFFFFF for u in sel), np.int64, count=len(sel)
        )
        cs_off = starts + cbits + ks * em
        arr[(cs_off[:, None] + np.arange(KEY_BITS, dtype=np.int64)).ravel()] = (
            _field_bits(csums, KEY_BITS)
        )
        segs.append(arr)
    return frame(MSG_ROUND_REPLY, _pack_payload(encode_uvarint(rnd), segs))


def encode_round_reply_scalar(rnd: int, entries, schema) -> bytes:
    """Per-bit ``BitWriter`` form of ``encode_round_reply`` (test oracle)."""
    w = BitWriter()
    for (ok, units), (n_units, t, m) in zip(entries, schema):
        if len(ok) != n_units or len(units) != n_units:
            raise WireError("reply entry does not match schema unit count")
        cbits = t.bit_length()
        for flag in ok:
            w.write(1 if flag else 0, 1)
        for flag, unit in zip(ok, units):
            if not flag:
                continue
            k = len(unit.positions)
            if k > t:
                raise WireError(f"{k} positions exceed t={t}")
            w.write(k, cbits)
            for p, x in zip(unit.positions, unit.xors):
                if not 0 <= int(p) < (1 << m) - 1:
                    raise WireError(f"bin position {int(p)} out of range for m={m}")
                w.write(int(p), m)
                w.write(int(x) & 0xFFFFFFFF, KEY_BITS)
            w.write(int(unit.csum) & 0xFFFFFFFF, KEY_BITS)
    return frame(MSG_ROUND_REPLY, encode_uvarint(rnd) + w.getvalue())


def decode_round_reply(payload: bytes, schema):
    """Two-pass batched decode: a light sequential scan reads only the
    data-dependent per-unit count fields (they gate where the next unit's
    body begins), then every position/XOR/checksum field of the session is
    gathered in one vectorized pass at the scanned offsets."""
    rnd, off = decode_uvarint(payload)
    bits = _bit_array(payload, off)
    nb = len(bits)
    pos_b = 0
    out = []
    for n_units, t, m in schema:
        cbits = t.bit_length()
        n = (1 << m) - 1
        em = m + KEY_BITS
        if pos_b + n_units > nb:
            raise WireTruncated("bit field runs past end of buffer")
        ok = bits[pos_b : pos_b + n_units].astype(bool)
        pos_b += n_units
        ok_idx = np.nonzero(ok)[0]
        cw = _weights(cbits)
        ks = np.zeros(len(ok_idx), dtype=np.int64)
        body = np.zeros(len(ok_idx), dtype=np.int64)
        for i in range(len(ok_idx)):
            if pos_b + cbits > nb:
                raise WireTruncated("bit field runs past end of buffer")
            k = int(bits[pos_b : pos_b + cbits] @ cw)
            if k > t:
                raise WireError(f"decoded position count {k} exceeds t={t}")
            pos_b += cbits
            body[i] = pos_b
            ks[i] = k
            pos_b += k * em + KEY_BITS
        if pos_b > nb:
            raise WireTruncated("bit field runs past end of buffer")
        units: list[ReplyUnit | None] = [None] * n_units
        if len(ok_idx):
            total_p = int(ks.sum())
            ent_unit = np.repeat(np.arange(len(ok_idx)), ks)
            within = np.arange(total_p) - np.repeat(np.cumsum(ks) - ks, ks)
            ent_off = body[ent_unit] + within * em
            pvals = _read_fields(bits, ent_off, m)
            over = pvals >= n
            if np.any(over):
                p = int(pvals[int(np.argmax(over))])
                raise WireError(f"bin position {p} out of range for n={n}")
            xvals = _read_fields(bits, ent_off + m, KEY_BITS).astype(np.uint32)
            csums = _read_fields(bits, body + ks * em, KEY_BITS)
            bnds = np.cumsum(ks)[:-1]
            psplit = np.split(pvals, bnds)
            xsplit = np.split(xvals, bnds)
            for i, u in enumerate(ok_idx):
                units[int(u)] = ReplyUnit(
                    positions=psplit[i], xors=xsplit[i], csum=int(csums[i])
                )
        out.append((ok, units))
    _finish_bits(bits, pos_b, payload, off)
    return rnd, out


def decode_round_reply_scalar(payload: bytes, schema):
    """Per-bit ``BitReader`` form of ``decode_round_reply`` (test oracle)."""
    rnd, off = decode_uvarint(payload)
    r = BitReader(payload, off)
    out = []
    for n_units, t, m in schema:
        cbits = t.bit_length()
        n = (1 << m) - 1
        ok = np.zeros(n_units, dtype=bool)
        for u in range(n_units):
            ok[u] = bool(r.read(1))
        units: list[ReplyUnit | None] = [None] * n_units
        for u in range(n_units):
            if not ok[u]:
                continue
            k = r.read(cbits)
            if k > t:
                raise WireError(f"decoded position count {k} exceeds t={t}")
            pos = np.zeros(k, dtype=np.int64)
            xor = np.zeros(k, dtype=np.uint32)
            for i in range(k):
                p = r.read(m)
                if p >= n:
                    raise WireError(f"bin position {p} out of range for n={n}")
                pos[i] = p
                xor[i] = r.read(KEY_BITS)
            units[u] = ReplyUnit(positions=pos, xors=xor, csum=r.read(KEY_BITS))
        out.append((ok, units))
    r.finish()
    return rnd, out


def encode_round_outcome(rnd: int, done_lists) -> bytes:
    """Alice's checksum verdicts: 1 settled-bit per unit per live session.
    Pure structure (0 ledger bits): it is what lets Bob mirror the unit
    queue; Formula (1) folds it into the per-unit flag already counted."""
    segs = [
        np.asarray(done, dtype=bool).astype(np.uint8)
        for done in done_lists
        if len(done)
    ]
    return frame(MSG_ROUND_OUTCOME, _pack_payload(encode_uvarint(rnd), segs))


def encode_round_outcome_scalar(rnd: int, done_lists) -> bytes:
    """Per-bit ``BitWriter`` form of ``encode_round_outcome`` (test oracle)."""
    w = BitWriter()
    for done in done_lists:
        for flag in done:
            w.write(1 if flag else 0, 1)
    return frame(MSG_ROUND_OUTCOME, encode_uvarint(rnd) + w.getvalue())


def decode_round_outcome(payload: bytes, unit_counts) -> tuple[int, list[np.ndarray]]:
    rnd, off = decode_uvarint(payload)
    counts = list(unit_counts)
    bits = _bit_array(payload, off)
    total = sum(counts)
    if total > len(bits):
        raise WireTruncated("bit field runs past end of buffer")
    flat = bits[:total].astype(bool)
    out = []
    pos = 0
    for n_units in counts:
        out.append(flat[pos : pos + n_units])
        pos += n_units
    _finish_bits(bits, total, payload, off)
    return rnd, out


def decode_round_outcome_scalar(
    payload: bytes, unit_counts
) -> tuple[int, list[np.ndarray]]:
    """Per-bit ``BitReader`` form of ``decode_round_outcome`` (test oracle)."""
    rnd, off = decode_uvarint(payload)
    r = BitReader(payload, off)
    out = []
    for n_units in unit_counts:
        done = np.zeros(n_units, dtype=bool)
        for u in range(n_units):
            done[u] = bool(r.read(1))
        out.append(done)
    r.finish()
    return rnd, out


# ---------------------------------------------------------------------------
# Final verification exchange
# ---------------------------------------------------------------------------


def encode_verify(entries) -> bytes:
    """Per session (sid order): (success flag, c(A xor D_hat) checksum)."""
    items = list(entries)
    span = 1 + KEY_BITS
    arr = np.zeros(len(items) * span, dtype=np.uint8)
    if items:
        arr[::span] = np.fromiter(
            (1 if s else 0 for s, _ in items), np.uint8, count=len(items)
        )
        csums = np.fromiter(
            (int(c) & 0xFFFFFFFF for _, c in items), np.int64, count=len(items)
        )
        idx = (
            np.arange(len(items), dtype=np.int64)[:, None] * span
            + 1
            + np.arange(KEY_BITS, dtype=np.int64)
        ).ravel()
        arr[idx] = _field_bits(csums, KEY_BITS)
    return frame(MSG_VERIFY, _pack_payload(b"", [arr]))


def encode_verify_scalar(entries) -> bytes:
    """Per-bit ``BitWriter`` form of ``encode_verify`` (test oracle)."""
    w = BitWriter()
    for success, csum in entries:
        w.write(1 if success else 0, 1)
        w.write(int(csum) & 0xFFFFFFFF, KEY_BITS)
    return frame(MSG_VERIFY, w.getvalue())


def decode_verify(payload: bytes, n_sessions: int):
    bits = _bit_array(payload, 0)
    span = 1 + KEY_BITS
    total = n_sessions * span
    if total > len(bits):
        raise WireTruncated("bit field runs past end of buffer")
    succ = bits[0:total:span].astype(bool)
    csums = _read_fields(
        bits, np.arange(n_sessions, dtype=np.int64) * span + 1, KEY_BITS
    )
    _finish_bits(bits, total, payload, 0)
    return [(bool(s), int(c)) for s, c in zip(succ, csums)]


def decode_verify_scalar(payload: bytes, n_sessions: int):
    """Per-bit ``BitReader`` form of ``decode_verify`` (test oracle)."""
    r = BitReader(payload)
    out = []
    for _ in range(n_sessions):
        success = bool(r.read(1))
        out.append((success, r.read(KEY_BITS)))
    r.finish()
    return out


def encode_verify_ack(flags) -> bytes:
    arr = np.asarray(list(flags), dtype=bool).astype(np.uint8)
    return frame(MSG_VERIFY_ACK, _pack_payload(b"", [arr]) if len(arr) else b"")


def encode_verify_ack_scalar(flags) -> bytes:
    """Per-bit ``BitWriter`` form of ``encode_verify_ack`` (test oracle)."""
    w = BitWriter()
    for f in flags:
        w.write(1 if f else 0, 1)
    return frame(MSG_VERIFY_ACK, w.getvalue())


def decode_verify_ack(payload: bytes, n_sessions: int) -> list[bool]:
    bits = _bit_array(payload, 0)
    if n_sessions > len(bits):
        raise WireTruncated("bit field runs past end of buffer")
    out = [bool(b) for b in bits[:n_sessions]]
    _finish_bits(bits, n_sessions, payload, 0)
    return out


def decode_verify_ack_scalar(payload: bytes, n_sessions: int) -> list[bool]:
    """Per-bit ``BitReader`` form of ``decode_verify_ack`` (test oracle)."""
    r = BitReader(payload)
    out = [bool(r.read(1)) for _ in range(n_sessions)]
    r.finish()
    return out


# ---------------------------------------------------------------------------
# Tree-phase digest exchange (repro.tree, DESIGN.md §15)
# ---------------------------------------------------------------------------

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
