"""``bch_decode_batched`` of the port == the JAX function ==
``core.bch.batched_decode``, exactly, on the CPU.

Covers random error patterns of weight 0..t, overload rows (weight > t —
the rows that drive the 3-way split, where a port that mishandles signed
modulo or the root-gather sentinel would differ), t = 1, all-zero rows and
padded rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bch import BCHCode, batched_decode, sketch_from_positions
from repro.kernels.ops import bch_decode_batched as decode_jax
from repro_torch.kernels.ops import bch_decode_batched

torch.set_num_threads(1)


def _three_way(code, sketches):
    """Port == JAX == numpy oracle on every output; returns the port's."""
    sk = np.asarray(sketches, dtype=np.int32)
    ok, pos, cnt = bch_decode_batched(torch.from_numpy(sk), n=code.n, t=code.t)
    assert ok.dtype == torch.bool and pos.shape == (len(sk), code.t)
    ok, pos, cnt = ok.numpy(), pos.numpy(), cnt.numpy()
    ok_j, pos_j, cnt_j = decode_jax(jnp.asarray(sk), n=code.n, t=code.t)
    assert np.array_equal(ok, np.asarray(ok_j))
    assert np.array_equal(pos, np.asarray(pos_j))
    assert np.array_equal(cnt, np.asarray(cnt_j))
    ok_ref, pos_ref = batched_decode(code, np.asarray(sketches, dtype=np.int64))
    assert np.array_equal(ok, ok_ref)
    for u in range(len(sk)):
        assert np.array_equal(pos[u, : cnt[u]], pos_ref[u])
        assert np.all(pos[u, cnt[u]:] == -1)
    return ok, pos, cnt


@pytest.mark.parametrize("n,t", [(63, 8), (127, 13), (255, 9), (511, 10)])
def test_random_weights_up_to_t(n, t):
    code = BCHCode(n, t)
    rng = np.random.default_rng(n + t)
    sk = np.stack([
        sketch_from_positions(code, rng.choice(n, size=w % (t + 1), replace=False))
        for w in range(2 * (t + 1))
    ])
    ok, _, cnt = _three_way(code, sk)
    assert ok.all()
    assert np.array_equal(cnt, [w % (t + 1) for w in range(2 * (t + 1))])


@pytest.mark.parametrize("n,t", [(63, 8), (127, 13), (255, 9), (63, 2)])
def test_overload_rows(n, t):
    """Weight > t: every implementation must fail the same rows and expose
    no positions for them."""
    code = BCHCode(n, t)
    rng = np.random.default_rng(7 * n + t)
    rows = []
    for i in range(40):
        w = int(rng.integers(t + 1, min(n, 4 * t + 6)))
        rows.append(sketch_from_positions(code, rng.choice(n, size=w, replace=False)))
        if i % 5 == 0:      # interleave decodable rows
            rows.append(sketch_from_positions(code, rng.choice(n, size=t, replace=False)))
    ok, pos, cnt = _three_way(code, np.stack(rows))
    assert (~ok).any()
    assert np.all(cnt[~ok] == 0) and np.all(pos[~ok] == -1)


def test_t1_code():
    code = BCHCode(127, 1)
    sk = np.stack([
        np.zeros(1, np.int64),
        sketch_from_positions(code, np.array([13])),
        sketch_from_positions(code, np.array([5, 97])),  # aliases to one root
        sketch_from_positions(code, np.array([0])),
        sketch_from_positions(code, np.array([126])),
    ])
    ok, pos, cnt = _three_way(code, sk)
    assert ok.all()
    assert list(pos[1, :1]) == [13] and list(pos[3, :1]) == [0]
    assert list(pos[4, :1]) == [126] and cnt[2] == 1


def test_zero_rows_mixed_with_overload():
    code = BCHCode(255, 3)
    sk = np.stack([
        np.zeros(3, np.int64),
        sketch_from_positions(code, np.array([7, 19, 200])),
        sketch_from_positions(code, np.arange(1, 9)),
        np.zeros(3, np.int64),
        sketch_from_positions(code, np.arange(11, 16)),
    ])
    ok, pos, cnt = _three_way(code, sk)
    assert np.array_equal(ok, [True, True, False, True, False])
    assert cnt[0] == cnt[3] == 0 and np.all(pos[0] == -1)
    assert list(pos[1, :3]) == [7, 19, 200]
    assert cnt[2] == cnt[4] == 0 and np.all(pos[2] == -1)


def test_random_garbage_sketches():
    """Arbitrary field elements (not sketches of any error pattern): mostly
    failures, decided identically by all three."""
    code = BCHCode(255, 6)
    sk = np.random.default_rng(3).integers(0, 256, size=(64, 6))
    _three_way(code, sk)


def test_all_padding_batch():
    code = BCHCode(63, 7)
    ok, pos, cnt = _three_way(code, np.zeros((8, 7), np.int64))
    assert ok.all() and not cnt.any() and np.all(pos == -1)
