"""Fault injection for the port's ``net.transport`` (the pair's cases of
tests/test_net_transport_faults.py, run on ``repro_torch.net``).

Covers the ARQ state machine under adversarial datagrams (duplicates,
stale ACKs), every transport's typed timeout path, endpoint behavior when
the peer closes mid-protocol (a clean ``TransportError``, never a hang;
the port's endpoints on the CPU), and the linger tail of the ARQ layer.
"""
import threading

import numpy as np
import pytest

from repro_torch.core.pbs import PBSConfig
from repro_torch.core.simdata import make_pair
from repro_torch.net import (
    AliceEndpoint,
    BobEndpoint,
    ChaosTransport,
    FaultPlan,
    InMemoryDuplex,
    ReliableTransport,
    SimulatedChannel,
    Transport,
    TransportError,
    TransportTimeout,
    run_pair,
)
from repro_torch.net.transport import FrameStream
from repro_torch.wire.varint import decode_uvarint, encode_uvarint

_DATA, _ACK = 0x00, 0x01


def _dgram(kind: int, seq: int, payload: bytes = b"") -> bytes:
    return bytes((kind,)) + encode_uvarint(seq) + payload


def _parse(dgram: bytes):
    kind = dgram[0]
    seq, off = decode_uvarint(dgram, 1)
    return kind, seq, dgram[off:]


# ---------------------------------------------------------------------------
# ReliableTransport vs adversarial datagrams
# ---------------------------------------------------------------------------


def test_duplicated_data_datagrams_are_suppressed_and_reacked():
    raw, side = InMemoryDuplex.pair()
    rt = ReliableTransport(side, timeout=0.05)
    raw.send(_dgram(_DATA, 0, b"hello"))
    raw.send(_dgram(_DATA, 0, b"hello"))      # duplicate of the same seq
    assert rt.recv(timeout=0.5) == b"hello"
    # the duplicate is suppressed: nothing further is delivered
    with pytest.raises(TransportTimeout):
        rt.recv(timeout=0.2)
    # but BOTH copies were ACKed (the dupe re-ACK is what heals a lost ack)
    acks = [_parse(raw.recv(timeout=0.5)) for _ in range(2)]
    assert acks == [(_ACK, 0, b""), (_ACK, 0, b"")]


def test_stale_data_seq_after_progress_is_reacked_not_delivered():
    raw, side = InMemoryDuplex.pair()
    rt = ReliableTransport(side, timeout=0.05)
    raw.send(_dgram(_DATA, 0, b"one"))
    raw.send(_dgram(_DATA, 1, b"two"))
    assert rt.recv(timeout=0.5) == b"one"
    assert rt.recv(timeout=0.5) == b"two"
    raw.send(_dgram(_DATA, 0, b"one"))        # stale retransmit from the past
    with pytest.raises(TransportTimeout):
        rt.recv(timeout=0.2)
    kinds = [_parse(raw.recv(timeout=0.5)) for _ in range(3)]
    assert kinds == [(_ACK, 0, b""), (_ACK, 1, b""), (_ACK, 0, b"")]


def test_stale_ack_does_not_complete_send():
    """An ACK for the wrong sequence number must not satisfy an in-flight
    send — the sender keeps retransmitting until the *matching* ACK."""
    raw, side = InMemoryDuplex.pair()
    rt = ReliableTransport(side, timeout=0.05, max_retries=50)
    done = threading.Event()

    def _send():
        rt.send(b"payload")
        done.set()

    th = threading.Thread(target=_send, daemon=True)
    th.start()
    kind, seq, payload = _parse(raw.recv(timeout=1.0))
    assert (kind, seq, payload) == (_DATA, 0, b"payload")
    raw.send(_dgram(_ACK, 99))                # stale/foreign ack: ignored
    # the sender must retransmit (stale ack did not complete the send)
    kind2, seq2, _ = _parse(raw.recv(timeout=1.0))
    assert (kind2, seq2) == (_DATA, 0)
    assert not done.is_set()
    raw.send(_dgram(_ACK, 0))                 # the genuine ack
    assert done.wait(1.0)
    th.join(1.0)
    assert rt.retransmits >= 1


def test_ack_exhaustion_raises_transport_error():
    raw, side = InMemoryDuplex.pair()
    rt = ReliableTransport(side, timeout=0.01, max_retries=3)
    with pytest.raises(TransportError, match="no ACK"):
        rt.send(b"into the void")


# ---------------------------------------------------------------------------
# typed timeout paths
# ---------------------------------------------------------------------------


def test_recv_timeouts_are_typed_across_transports():
    mem, _ = InMemoryDuplex.pair()
    with pytest.raises(TransportTimeout):
        mem.recv(timeout=0.05)

    ch, _ = SimulatedChannel.pair(latency=0.0)
    with pytest.raises(TransportTimeout):
        ch.recv(timeout=0.05)

    raw, side = InMemoryDuplex.pair()
    rt = ReliableTransport(side, timeout=0.05)
    with pytest.raises(TransportTimeout):
        rt.recv(timeout=0.05)

    # FrameStream propagates the typed timeout (the hub's poll signal)
    stream = FrameStream(InMemoryDuplex.pair()[0])
    with pytest.raises(TransportTimeout):
        stream.recv(timeout=0.05)


class _Trickle(Transport):
    """Delivers a frame one byte at a time with a delay per chunk — a peer
    trying to hold a recv open forever by always sending *something*."""

    def __init__(self, frame_bytes: bytes, delay: float):
        super().__init__()
        self._data = frame_bytes
        self._pos = 0
        self._delay = delay

    def send(self, data: bytes) -> None:
        pass

    def recv(self, timeout: float | None = None) -> bytes:
        import time as _time

        if timeout is not None and timeout < self._delay:
            _time.sleep(max(0.0, timeout))
            raise TransportTimeout("trickle")
        _time.sleep(self._delay)
        b = self._data[self._pos : self._pos + 1]
        self._pos += 1
        return b


def test_frame_recv_deadline_bounds_whole_frame_not_chunks():
    """A trickling peer (1 byte per 30ms, forever) must not hold
    FrameStream.recv open past its deadline — the timeout bounds the whole
    frame, and partial data stays buffered."""
    import time as _time
    from repro_torch.wire import frames as wf

    frame = wf.encode_dhat(1 << 40)           # several bytes long
    stream = FrameStream(_Trickle(frame, delay=0.03))
    t0 = _time.monotonic()
    with pytest.raises(TransportTimeout):
        stream.recv(timeout=0.1)
    assert _time.monotonic() - t0 < 0.5       # not one-timeout-per-chunk


def test_closed_pipe_is_not_a_timeout():
    a, b = InMemoryDuplex.pair()
    b.close()
    with pytest.raises(TransportError) as ei:
        a.recv(timeout=0.5)
    assert not isinstance(ei.value, TransportTimeout)


# ---------------------------------------------------------------------------
# close mid-protocol: errors, never hangs
# ---------------------------------------------------------------------------


class _CloseAfter(Transport):
    """Pass through ``n_sends`` frames, then close and fail."""

    def __init__(self, inner: Transport, n_sends: int):
        super().__init__()
        self._inner = inner
        self._left = n_sends

    def send(self, data: bytes) -> None:
        if self._left <= 0:
            self._inner.close()
            raise TransportError("simulated mid-protocol disconnect")
        self._left -= 1
        self._inner.send(data)

    def recv(self, timeout: float | None = None) -> bytes:
        return self._inner.recv(timeout)

    def close(self) -> None:
        self._inner.close()

    @property
    def bytes_out(self) -> int:  # type: ignore[override]
        return self._inner.bytes_out

    @property
    def bytes_in(self) -> int:  # type: ignore[override]
        return self._inner.bytes_in

    @bytes_out.setter
    def bytes_out(self, v):
        pass

    @bytes_in.setter
    def bytes_in(self, v):
        pass


def test_close_mid_serve_raises_transport_error_not_hang():
    """Alice vanishing after her round-1 sketches must surface as a
    TransportError from run_pair on both sides' plumbing — not a hang."""
    a, b = make_pair(600, 6, np.random.default_rng(3))
    ta, tb = InMemoryDuplex.pair()
    alice = AliceEndpoint(_CloseAfter(ta, n_sends=1), device="cpu")
    bob = BobEndpoint(tb, device="cpu")
    alice.submit(a, cfg=PBSConfig(seed=2), d_known=6)
    bob.submit(b, cfg=PBSConfig(seed=2), d_known=6)
    with pytest.raises(TransportError):
        run_pair(alice, bob)


# ---------------------------------------------------------------------------
# hub: one of N peers drops at each protocol phase


# ---------------------------------------------------------------------------
# close/linger: the two-army tail (DESIGN.md §13)
# ---------------------------------------------------------------------------


def test_linger_delivers_final_frame_exactly_once_under_ack_loss():
    """The lost-final-ACK problem: the receiver's ACK of the last frame is
    dropped, the sender retransmits, and the receiver's linger window
    re-ACKs — the frame is delivered exactly once and the sender's send
    completes instead of exhausting its retries."""
    raw_a, raw_b = InMemoryDuplex.pair()
    rt_s = ReliableTransport(raw_a, timeout=0.03, max_retries=50,
                             rto_max=0.1)
    # the receiver's first send op IS the ACK of the final frame: drop it
    rt_r = ReliableTransport(
        ChaosTransport(raw_b, FaultPlan(partitions=((0, 1),))),
        timeout=0.03, rto_max=0.1,
    )

    done = threading.Event()

    def _send():
        rt_s.send(b"final frame")
        done.set()

    th = threading.Thread(target=_send, daemon=True)
    th.start()
    assert rt_r.recv(timeout=2.0) == b"final frame"   # its ACK was dropped
    assert not done.is_set()                          # sender still waiting
    rt_r.linger(budget=5.0)      # re-ACK the retransmitted tail until quiet
    assert done.wait(2.0), "sender never completed: final ACK not healed"
    th.join(2.0)
    assert rt_s.retransmits >= 1
    # exactly once: the retransmitted copies were suppressed, not delivered
    with pytest.raises(TransportTimeout):
        rt_r.recv(timeout=0.2)


def test_linger_budget_bounds_a_babbling_peer():
    """``linger`` must respect its budget even when the peer never goes
    quiet — a babbler cannot hold close open forever."""
    import time as _time

    raw, side = InMemoryDuplex.pair()
    rt = ReliableTransport(side, timeout=0.02, rto_max=0.05)
    stop = threading.Event()

    def _babble():
        seq = 0
        while not stop.is_set():
            raw.send(_dgram(_DATA, seq))
            seq += 1
            _time.sleep(0.005)

    th = threading.Thread(target=_babble, daemon=True)
    th.start()
    t0 = _time.monotonic()
    rt.linger(budget=0.3)
    dt = _time.monotonic() - t0
    stop.set()
    th.join(2.0)
    assert 0.25 <= dt < 1.5, f"linger ignored its budget: {dt:.2f}s"
