"""Every codec of the port's ``wire`` == the reference's, byte for byte.

For each codec, on a seeded corpus whose values are built identically for
both packages: the port's encoder gives the reference's bytes; the port's
decoder of the reference's bytes gives the reference decoder's values; each
``*_scalar`` oracle of the port equals its batched codec; and on every
truncation and on seeded bit flips of a payload the port raises its own
``WireError`` exactly where the reference raises its own, and decodes to
the same values where the reference accepts.  Tolerance: 0.
"""
import numpy as np
import pytest

from repro.wire import frames as ref
from repro.wire import varint as ref_varint
from repro_torch import wire as port_pkg
from repro_torch.wire import frames as port
from repro_torch.wire import varint as port_varint


def _norm(x):
    """A package-independent form of a decoded value (a ``ReplyUnit`` of
    either package compares by its fields)."""
    if x is None or isinstance(x, (bool, int, bytes, str)):
        return (type(x).__name__, x)
    if isinstance(x, (np.integer, np.bool_)):
        return ("np", x.dtype.str, x.item())
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_norm(v) for v in x])
    if type(x).__name__ == "ReplyUnit":
        return ("unit", _norm(x.positions), _norm(x.xors), x.csum)
    raise TypeError(type(x))


def _payload(wf, buf: bytes) -> bytes:
    msg_type, payload, end = wf.split_frame(buf)
    assert end == len(buf)
    return payload


def _schema(rng, max_sessions=4):
    out = []
    for _ in range(int(rng.integers(1, max_sessions + 1))):
        out.append((int(rng.integers(0, 7)), int(rng.integers(1, 9)), int(rng.integers(3, 11))))
    return out


def _entries(wf, rng, schema):
    entries = []
    for n_units, t, m in schema:
        n = (1 << m) - 1
        ok = [bool(rng.integers(2)) for _ in range(n_units)]
        units = []
        for flag in ok:
            if not flag:
                units.append(None)
                continue
            k = int(rng.integers(0, t + 1))
            units.append(wf.ReplyUnit(
                positions=rng.integers(0, n, size=k).astype(np.int64),
                xors=rng.integers(0, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32),
                csum=int(rng.integers(0, 1 << 32)),
            ))
        entries.append((ok, units))
    return entries


# Each case: (wf, seed) -> (encode(), decode(payload), encode_scalar() | None,
# decode_scalar(payload) | None).  Values come from ``seed`` alone, so the
# two packages encode the same message.

def _tow(wf, seed):
    rng = np.random.default_rng(seed)
    size = int(rng.integers(1, 100_000))
    vals = rng.integers(-size, size + 1, size=int(rng.integers(0, 200))).astype(np.int64)
    return (lambda: wf.encode_tow_sketch(vals, size), wf.decode_tow_sketch,
            lambda: wf.encode_tow_sketch_scalar(vals, size), wf.decode_tow_sketch_scalar)


def _dhat(wf, seed):
    num = int(np.random.default_rng(seed).integers(0, 1 << 62))
    return lambda: wf.encode_dhat(num), wf.decode_dhat, None, None


def _sketches(wf, seed):
    rng = np.random.default_rng(100 + seed)
    schema = _schema(rng)
    blocks = [(rng.integers(0, 1 << m, size=(u, t)).astype(np.int64), m) for u, t, m in schema]
    rnd = int(rng.integers(0, 50))
    return (lambda: wf.encode_round_sketches(rnd, blocks),
            lambda p: wf.decode_round_sketches(p, schema),
            lambda: wf.encode_round_sketches_scalar(rnd, blocks),
            lambda p: wf.decode_round_sketches_scalar(p, schema))


def _parity(wf, seed):
    rng = np.random.default_rng(150 + seed)
    schema = _schema(rng)
    blocks = [(rng.integers(0, 1 << m, size=(u, dt)).astype(np.int64), m) for u, dt, m in schema]
    rnd, level = int(rng.integers(1, 50)), int(rng.integers(1, 4))
    return (lambda: wf.encode_parity(rnd, level, blocks),
            lambda p: wf.decode_parity(p, schema),
            lambda: wf.encode_parity_scalar(rnd, level, blocks),
            lambda p: wf.decode_parity_scalar(p, schema))


def _reply(wf, seed):
    rng = np.random.default_rng(200 + seed)
    schema = _schema(rng)
    entries = _entries(wf, rng, schema)
    rnd = int(rng.integers(0, 50))
    return (lambda: wf.encode_round_reply(rnd, entries, schema),
            lambda p: wf.decode_round_reply(p, schema),
            lambda: wf.encode_round_reply_scalar(rnd, entries, schema),
            lambda p: wf.decode_round_reply_scalar(p, schema))


def _outcome(wf, seed):
    rng = np.random.default_rng(300 + seed)
    counts = [int(rng.integers(0, 9)) for _ in range(int(rng.integers(1, 5)))]
    done = [rng.integers(0, 2, size=c).astype(bool) for c in counts]
    rnd = int(rng.integers(0, 50))
    return (lambda: wf.encode_round_outcome(rnd, done),
            lambda p: wf.decode_round_outcome(p, counts),
            lambda: wf.encode_round_outcome_scalar(rnd, done),
            lambda p: wf.decode_round_outcome_scalar(p, counts))


def _verify(wf, seed):
    rng = np.random.default_rng(400 + seed)
    n = int(rng.integers(0, 10))
    entries = [(bool(rng.integers(2)), int(rng.integers(0, 1 << 32))) for _ in range(n)]
    return (lambda: wf.encode_verify(entries), lambda p: wf.decode_verify(p, n),
            lambda: wf.encode_verify_scalar(entries), lambda p: wf.decode_verify_scalar(p, n))


def _verify_ack(wf, seed):
    rng = np.random.default_rng(450 + seed)
    n = int(rng.integers(0, 12))
    flags = [bool(rng.integers(2)) for _ in range(n)]
    return (lambda: wf.encode_verify_ack(flags), lambda p: wf.decode_verify_ack(p, n),
            lambda: wf.encode_verify_ack_scalar(flags),
            lambda p: wf.decode_verify_ack_scalar(p, n))


def _mux(wf, seed):
    rng = np.random.default_rng(500 + seed)
    schema = _schema(rng)
    inner = wf.encode_round_reply(5, _entries(wf, rng, schema), schema)
    ch = int(rng.integers(1, 1 << 20))
    return lambda: wf.encode_mux(ch, inner), wf.decode_mux, None, None


def _epoch(wf, seed):
    rng = np.random.default_rng(600 + seed)
    e = int(rng.integers(1, 1000))
    inner = b"" if seed % 2 else wf.encode_tow_sketch(np.arange(-8, 9, dtype=np.int64), 64)
    return lambda: wf.encode_epoch(e, inner), wf.decode_epoch, None, None


def _resume(wf, seed):
    rng = np.random.default_rng(700 + seed)
    ch, e, rnd = (int(v) for v in rng.integers(1, 1 << 16, size=3))
    d0 = wf.transcript_digest0(e)
    d1 = wf.fold_transcript(d0, rnd, bytes(rng.integers(0, 256, size=40, dtype=np.uint8)))
    return lambda: wf.encode_resume(ch, e, rnd, d1, d0), wf.decode_resume, None, None


def _tree_digest(wf, seed):
    rng = np.random.default_rng(800 + seed)
    n_r, ell = int(rng.integers(1, 12)), int(rng.integers(1, 40))
    counts = rng.integers(0, 1 << 12, size=n_r)
    csums = rng.integers(0, 1 << 32, size=n_r)
    sk = np.zeros((n_r, ell), dtype=np.int64)
    for r in range(n_r):
        if counts[r]:
            sk[r] = rng.integers(-counts[r], counts[r] + 1, size=ell)
    level = int(rng.integers(0, 33))
    return lambda: wf.encode_tree_digest(level, counts, csums, sk), wf.decode_tree_digest, None, None


def _tree_verdict(wf, seed):
    rng = np.random.default_rng(900 + seed)
    v = rng.integers(0, 3, size=int(rng.integers(0, 40)))
    ds = rng.integers(1, 1 << 16, size=int(np.sum(v == wf.TREE_LEAF)))
    level = int(rng.integers(0, 33))
    return lambda: wf.encode_tree_verdict(level, v, ds), wf.decode_tree_verdict, None, None


CODECS = {
    "tow_sketch": _tow, "dhat": _dhat, "round_sketches": _sketches, "parity": _parity,
    "round_reply": _reply, "round_outcome": _outcome, "verify": _verify,
    "verify_ack": _verify_ack, "mux": _mux, "epoch": _epoch, "resume": _resume,
    "tree_digest": _tree_digest, "tree_verdict": _tree_verdict,
}


def _decoded(wf, decode, payload):
    """(accepted, normalized value) — a reference decoder raises the
    reference's ``WireError``, a port decoder the port's."""
    try:
        return True, _norm(decode(payload))
    except wf.WireError:
        return False, None


@pytest.mark.parametrize("name", sorted(CODECS))
def test_port_codec_equals_reference(name):
    make = CODECS[name]
    for seed in range(6):
        enc_r, dec_r, _, _ = make(ref, seed)
        enc_p, dec_p, enc_ps, dec_ps = make(port, seed)
        frame = enc_r()
        assert enc_p() == frame, (name, seed)
        assert port.split_frame(frame) == ref.split_frame(frame)
        payload = _payload(ref, frame)
        want = _norm(dec_r(payload))
        assert _norm(dec_p(payload)) == want, (name, seed)
        if enc_ps is not None:
            assert enc_ps() == frame, (name, seed)
            assert _norm(dec_ps(payload)) == want, (name, seed)

        # truncations and seeded bit flips: the port rejects exactly where
        # the reference does and agrees on every accepted value
        rng = np.random.default_rng(seed)
        bad = [payload[:cut] for cut in range(len(payload))] + [payload + b"\x00"]
        for _ in range(20 if payload else 0):
            b = bytearray(payload)
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            bad.append(bytes(b))
        for p in bad:
            got = _decoded(port, dec_p, p)
            assert got == _decoded(ref, dec_r, p), (name, seed, p.hex())
            if dec_ps is not None:
                assert _decoded(port, dec_ps, p) == got, (name, seed, p.hex())


def test_envelope_helpers_and_split_frame_equal_reference():
    rng = np.random.default_rng(11)
    for _ in range(50):
        ch, e, n = (int(v) for v in rng.integers(1, 1 << 30, size=3))
        inner_len = int(rng.integers(0, 1 << 16))
        assert port.mux_overhead_bytes(ch, inner_len) == ref.mux_overhead_bytes(ch, inner_len)
        assert port.epoch_overhead_bytes(e, inner_len) == ref.epoch_overhead_bytes(e, inner_len)
        assert port.resume_overhead_bytes(ch, e, n) == ref.resume_overhead_bytes(ch, e, n)
        u, t, m = (int(v) for v in rng.integers(1, 12, size=3))
        assert port.sketches_ledger_bits(u, t, m) == ref.sketches_ledger_bits(u, t, m)
        assert port.parity_ledger_bits(u, t, m) == ref.parity_ledger_bits(u, t, m)
        assert port.tow_value_bits(n) == ref.tow_value_bits(n)
    for seed in range(4):
        schema = _schema(np.random.default_rng(seed))
        for (ok_r, units_r), (ok_p, units_p), (_, _, m) in zip(
                _entries(ref, np.random.default_rng(seed + 9), schema),
                _entries(port, np.random.default_rng(seed + 9), schema), schema):
            assert port.reply_ledger_bits(ok_p, units_p, m) == ref.reply_ledger_bits(
                ok_r, units_r, m)
    # split_frame on a partial buffer, an unknown type, and a stream of two
    two = ref.encode_dhat(7) + ref.encode_verify_ack([True, False])
    for buf in (two, two[:3], b"\x02\x7f\x00"):
        for off in (0, 3):
            try:
                want = ("ok", ref.split_frame(buf, off))
            except ref.WireError:
                want = ("raise",)
            try:
                got = ("ok", port.split_frame(buf, off))
            except port.WireError:
                got = ("raise",)
            assert got == want, (buf.hex(), off)
    assert port._KNOWN == ref._KNOWN
    for k in dir(ref):
        if k.startswith(("MSG_", "TREE_")):
            assert getattr(port, k) == getattr(ref, k), k


def test_varint_and_bit_streams_equal_reference():
    rng = np.random.default_rng(3)
    for v in [0, 1, 63, 64, -1, -64, -65, (1 << 62), -(1 << 62),
              *rng.integers(-(1 << 40), 1 << 40, size=50)]:
        v = int(v)
        assert port_varint.zigzag(v) == ref_varint.zigzag(v)
        assert port_varint.unzigzag(ref_varint.zigzag(v)) == v
    for n in [0, 1, 126, 127, 128, 1 << 20, *rng.integers(0, 1 << 40, size=20)]:
        assert port_varint.framed_len(int(n)) == ref_varint.framed_len(int(n))
    fields = [(int(w), int(rng.integers(0, 1 << w))) for w in rng.integers(1, 40, size=64)]
    wr, wp = ref_varint.BitWriter(), port_varint.BitWriter()
    for w, v in fields:
        wr.write(v, w)
        wp.write(v, w)
    assert wp.getvalue() == wr.getvalue() and wp.bit_length == wr.bit_length
    r = port_varint.BitReader(wr.getvalue())
    assert [r.read(w) for w, _ in fields] == [v for _, v in fields]
    assert r.finish() == len(wr.getvalue())
    with pytest.raises(port_varint.WireError):
        port_varint.BitWriter().write(4, 2)
    with pytest.raises(port_varint.WireTruncated):
        port_varint.BitReader(b"\x01").read(9)
    with pytest.raises(port_varint.WireError):
        rd = port_varint.BitReader(b"\x01")
        rd.read(4)
        rd.finish()                                       # nonzero pad bits
    assert issubclass(port_varint.WireTruncated, port_varint.WireError)
    assert port.WireError is port_varint.WireError


def test_package_exports_every_reference_name():
    import repro.wire as ref_pkg

    assert set(ref_pkg.__all__) <= set(port_pkg.__all__)
    for name in port_pkg.__all__:
        assert getattr(port_pkg, name) is not None
