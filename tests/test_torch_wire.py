"""The port's ``wire`` package == the reference's, byte for byte.

On a seeded corpus of both ``MSG_TREE`` flavors, each ``encode_tree_*`` of
``repro_torch.wire`` gives the reference's bytes, and each
``decode_tree_*`` of the reference's bytes gives values equal to the
reference decoder's.  Tolerance: 0.
"""
import numpy as np
import pytest

from repro.wire import frames as ref
from repro.wire import varint as ref_varint
from repro_torch.wire import frames as port
from repro_torch.wire import varint as port_varint


def _same(got, exp):
    """Structural equality of decoded values."""
    if isinstance(exp, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == exp.dtype
        assert np.array_equal(got, exp)
    elif isinstance(exp, tuple):
        assert type(got) is tuple and len(got) == len(exp)
        for g, e in zip(got, exp):
            _same(g, e)
    else:
        assert type(got) is type(exp) and got == exp


def _case(kind, seed):
    """Encoder arguments from ``seed``; the same values serve both packages."""
    rng = np.random.default_rng(seed)
    if kind == "tree_digest":
        n_r, ell = int(rng.integers(1, 12)), int(rng.integers(1, 40))
        counts = rng.integers(0, 1 << 12, size=n_r)
        counts[rng.integers(0, n_r)] = 0
        csums = rng.integers(0, 1 << 32, size=n_r)
        sk = np.zeros((n_r, ell), dtype=np.int64)
        for r in range(n_r):
            if counts[r]:
                sk[r] = rng.integers(-counts[r], counts[r] + 1, size=ell)
        return int(rng.integers(0, 33)), counts, csums, sk
    v = rng.integers(0, 3, size=int(rng.integers(0, 40)))
    ds = rng.integers(1, 1 << 16, size=int(np.sum(v == ref.TREE_LEAF)))
    return int(rng.integers(0, 33)), v, ds


@pytest.mark.parametrize("kind", ["tree_digest", "tree_verdict", "varint"])
def test_port_codecs_equal_reference(kind):
    if kind == "varint":
        rng = np.random.default_rng(0)
        for v in [0, 1, 127, 128, 300, (1 << 63) - 1, *rng.integers(0, 1 << 62, size=50)]:
            v = int(v)
            buf = ref_varint.encode_uvarint(v)
            assert port_varint.encode_uvarint(v) == buf
            assert port_varint.decode_uvarint(buf + b"\x05") == ref_varint.decode_uvarint(buf + b"\x05")
            assert port_varint.uvarint_len(v) == ref_varint.uvarint_len(v)
        return
    for seed in range(6):
        args = _case(kind, seed)
        buf = getattr(ref, f"encode_{kind}")(*args)
        assert getattr(port, f"encode_{kind}")(*args) == buf, (kind, seed)
        mtype, payload, _ = ref.split_frame(buf)
        assert mtype == port.MSG_TREE
        exp = getattr(ref, f"decode_{kind}")(payload)
        _same(getattr(port, f"decode_{kind}")(payload), exp)
        # a payload cut short is refused by both
        if len(payload) > 1:
            with pytest.raises(ref.WireError):
                getattr(ref, f"decode_{kind}")(payload[:-1])
            with pytest.raises(port.WireError):
                getattr(port, f"decode_{kind}")(payload[:-1])


def test_port_wire_constants_equal_reference():
    names = [n for n in dir(port) if n.isupper() and not n.startswith("_")]
    assert {"MSG_TREE", "KEY_BITS", "TREE_PRUNE", "TREE_LEAF", "TREE_RECURSE"} <= set(names)
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
