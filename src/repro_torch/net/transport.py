"""Transports the PBS endpoints exchange encoded bytes over (DESIGN.md §9).

Three concrete transports, one reliability wrapper, one framing helper:

* ``InMemoryDuplex`` — a thread-safe in-process pipe pair; the default for
  tests and the wire-byte measurement path in benchmarks.
* ``SocketTransport`` / ``tcp_loopback_pair`` — a real TCP connection over
  127.0.0.1; what a two-host test drives.
* ``SimulatedChannel`` — datagram semantics with configurable loss
  probability and one-way latency.  Lossy by construction, so endpoints
  must run it under ``ReliableTransport``.
* ``ReliableTransport`` — stop-and-wait ARQ (seq + ack + retransmit timer
  + duplicate suppression) turning a lossy datagram channel back into a
  reliable one; ``retransmits`` counts the recoveries.
* ``FrameStream`` — varint length-framing over any reliable transport:
  accumulates stream chunks and yields whole ``repro_torch.wire`` frames.

Every transport counts ``bytes_out``/``bytes_in``, so tests can assert the
measured wire traffic of a full reconciliation, including ARQ overhead.
"""
from __future__ import annotations

import socket
import threading
import time
from collections import deque

import numpy as np

from ..obs.trace import NULL_TRACER
from ..wire import frames as wire_frames
from ..wire.frames import WireError, split_frame
from ..wire.varint import decode_uvarint, encode_uvarint, framed_len

_UNSET = object()  # sentinel: FrameStream.recv falls back to its default timeout


class TransportError(Exception):
    """Transport failure: closed peer, timeout, or retry exhaustion."""


class TransportTimeout(TransportError):
    """A ``recv`` deadline elapsed with no data.

    Distinct from other ``TransportError``s so pollers (the hub's
    round-barrier loop) can tell "nothing arrived yet" from "peer is gone":
    a timeout keeps the peer's deadline clock running, any other transport
    failure evicts immediately.
    """


class Transport:
    """Reliable duplex byte channel; concrete classes fill send/recv."""

    def __init__(self) -> None:
        self.bytes_out = 0
        self.bytes_in = 0

    def send(self, data: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: float | None = None) -> bytes:
        """One inbound chunk (stream segment or datagram); blocks until
        available.  ``timeout`` None = block forever; raises TransportError
        on timeout or closed-and-drained peer."""
        raise NotImplementedError

    def linger(self, budget: float | None = None) -> None:
        """Service the channel briefly after the last expected message.

        No-op for inherently reliable transports.  An ARQ layer overrides
        this to keep acknowledging retransmitted tails (the peer's final
        datagram whose ack was lost) until the channel goes quiet —
        otherwise the peer's last reliable ``send`` can never complete.
        ``budget`` caps the whole linger window regardless of traffic.
        """

    def close(self) -> None:
        pass


class InMemoryDuplex(Transport):
    """In-process duplex pipe; ``pair()`` returns the two connected ends."""

    def __init__(self) -> None:
        super().__init__()
        self._rx: deque[bytes] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.peer: InMemoryDuplex | None = None

    @classmethod
    def pair(cls) -> tuple["InMemoryDuplex", "InMemoryDuplex"]:
        one, two = cls(), cls()
        one.peer, two.peer = two, one
        return one, two

    def _deliver(self, data: bytes) -> None:
        with self._cond:
            self._rx.append(data)
            self._cond.notify_all()

    def send(self, data: bytes) -> None:
        if self.peer is None or self.peer._closed:
            raise TransportError("send on closed in-memory pipe")
        self.bytes_out += len(data)
        self.peer._deliver(bytes(data))

    def recv(self, timeout: float | None = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._rx:
                # either end closing ends the conversation once drained
                if self._closed or (self.peer is not None and self.peer._closed):
                    raise TransportError("recv on closed in-memory pipe")
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise TransportTimeout("in-memory recv timeout")
                self._cond.wait(wait)
            data = self._rx.popleft()
        self.bytes_in += len(data)
        return data

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self.peer is not None:
            with self.peer._cond:       # wake a peer blocked in recv
                self.peer._cond.notify_all()


class SocketTransport(Transport):
    """A connected stream socket as a Transport."""

    def __init__(self, sock: socket.socket) -> None:
        super().__init__()
        self._sock = sock

    def send(self, data: bytes) -> None:
        try:
            self._sock.sendall(data)
        except OSError as e:
            raise TransportError(f"socket send failed: {e}") from e
        self.bytes_out += len(data)

    def recv(self, timeout: float | None = None) -> bytes:
        self._sock.settimeout(timeout)
        try:
            data = self._sock.recv(65536)
        except socket.timeout as e:
            raise TransportTimeout("socket recv timeout") from e
        except OSError as e:
            raise TransportError(f"socket recv failed: {e}") from e
        if not data:
            raise TransportError("socket closed by peer")
        self.bytes_in += len(data)
        return data

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def tcp_loopback_pair() -> tuple[SocketTransport, SocketTransport]:
    """A real TCP connection over 127.0.0.1 (ephemeral port)."""
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    client.connect(listener.getsockname())
    server, _ = listener.accept()
    listener.close()
    for s in (client, server):
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return SocketTransport(client), SocketTransport(server)


class SimulatedChannel(Transport):
    """Datagram channel with loss probability and one-way latency.

    Each ``send`` is one datagram: dropped with probability ``loss``
    (deterministic per ``seed``), otherwise delivered after ``latency``
    seconds.  Unreliable by design — wrap both ends in
    ``ReliableTransport`` to force the retransmit path.
    """

    def __init__(self, loss: float = 0.0, latency: float = 0.0, seed: int = 0) -> None:
        super().__init__()
        self._loss = float(loss)
        self._latency = float(latency)
        self._rng = np.random.default_rng(seed)
        self._rx: deque[tuple[float, bytes]] = deque()  # (ready_time, data)
        self._cond = threading.Condition()
        self._closed = False
        self.peer: SimulatedChannel | None = None
        self.dropped = 0

    @classmethod
    def pair(
        cls, loss: float = 0.0, latency: float = 0.0, seed: int = 0
    ) -> tuple["SimulatedChannel", "SimulatedChannel"]:
        one = cls(loss, latency, seed)
        two = cls(loss, latency, seed + 1)
        one.peer, two.peer = two, one
        return one, two

    def send(self, data: bytes) -> None:
        peer = self.peer
        if self._closed or peer is None or peer._closed:
            raise TransportError("send on closed simulated channel")
        self.bytes_out += len(data)
        if self._rng.random() < self._loss:
            self.dropped += 1
            return
        ready = time.monotonic() + self._latency
        with peer._cond:
            peer._rx.append((ready, bytes(data)))
            peer._cond.notify_all()

    def recv(self, timeout: float | None = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                if self._rx and self._rx[0][0] <= now:
                    _, data = self._rx.popleft()
                    self.bytes_in += len(data)
                    return data
                # either end closing ends the conversation; datagrams already
                # in flight (scheduled but not ready) still deliver first
                if self._closed or (
                    self.peer is not None and self.peer._closed and not self._rx
                ):
                    raise TransportError("recv on closed simulated channel")
                wait = self._rx[0][0] - now if self._rx else None
                if deadline is not None:
                    remain = deadline - now
                    if remain <= 0:
                        raise TransportTimeout("simulated channel recv timeout")
                    wait = remain if wait is None else min(wait, remain)
                self._cond.wait(wait)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self.peer is not None:
            with self.peer._cond:       # wake a peer blocked in recv
                self.peer._cond.notify_all()


_DATA, _ACK = 0x00, 0x01


class ReliableTransport(Transport):
    """Stop-and-wait ARQ over an unreliable datagram transport.

    Datagram layout: ``kind byte (DATA/ACK) || uvarint(seq) || payload``.
    ``send`` retransmits until the matching ACK arrives (handling any DATA
    that lands in between); ``recv`` ACKs every DATA datagram and
    suppresses duplicates by sequence number.

    The retransmit timer is adaptive (DESIGN.md §13): each attempt waits
    the current RTO (initially ``timeout``), backing off by ``backoff``
    per retransmission up to ``rto_max`` with seeded ±``jitter``
    randomization so synchronized peers decorrelate their retry storms; a
    delivered ACK resets the timer.  ``max_retries`` caps attempts per
    datagram.  A non-timeout channel failure (closed pipe) aborts the send
    immediately instead of burning the attempt budget.  ``retransmits``
    counts recoveries and ``rto_ms`` exposes the live timer — both
    surfaced through the endpoint ``wire_stats()``.
    """

    def __init__(
        self,
        channel: Transport,
        *,
        timeout: float = 0.05,
        max_retries: int = 200,
        rto_max: float = 0.4,
        backoff: float = 2.0,
        jitter: float = 0.1,
        seed: int = 0,
        tracer=None,
    ) -> None:
        super().__init__()
        self._ch = channel
        # per-datagram tracing is hot-path: every site below checks
        # ``_tracer.enabled`` first so the disabled default costs one
        # attribute read per send/recv (DESIGN.md §14)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._timeout = float(timeout)
        self._max_retries = int(max_retries)
        self._rto_max = max(float(rto_max), float(timeout))
        self._backoff = float(backoff)
        self._jitter = float(jitter)
        self._rng = np.random.default_rng(seed)
        self._rto = self._timeout
        self._tx_seq = 0
        self._rx_next = 0
        self._ready: deque[bytes] = deque()
        self.retransmits = 0

    @property
    def rto_ms(self) -> float:
        """Current retransmit timeout in milliseconds (pre-jitter)."""
        return self._rto * 1e3

    def _attempt_wait(self) -> float:
        """One attempt's ACK wait: the current RTO with ±jitter applied."""
        if self._jitter <= 0.0:
            return self._rto
        spread = self._jitter * (2.0 * float(self._rng.random()) - 1.0)
        return self._rto * (1.0 + spread)

    def _handle(self, dgram: bytes, want_ack: int | None) -> bool:
        """Process one inbound datagram; True iff it ACKs ``want_ack``."""
        if not dgram:
            raise TransportError("empty datagram")
        kind = dgram[0]
        seq, off = decode_uvarint(dgram, 1)
        if kind == _ACK:
            return want_ack is not None and seq == want_ack
        if kind != _DATA:
            raise TransportError(f"unknown datagram kind {kind}")
        self._ch.send(bytes((_ACK,)) + encode_uvarint(seq))
        if seq == self._rx_next:       # new in-order data; dupes just re-ACK
            self._rx_next += 1
            self._ready.append(dgram[off:])
        return False

    def send(self, data: bytes) -> None:
        seq = self._tx_seq
        self._tx_seq += 1
        dgram = bytes((_DATA,)) + encode_uvarint(seq) + bytes(data)
        self.bytes_out += len(data)
        if self._tracer.enabled:
            with self._tracer.span("arq.send", cat="arq", seq=seq,
                                   bytes=len(data)):
                return self._send_arq(seq, dgram)
        return self._send_arq(seq, dgram)

    def _send_arq(self, seq: int, dgram: bytes) -> None:
        for attempt in range(self._max_retries):
            self._ch.send(dgram)
            if attempt:
                self.retransmits += 1
                if self._tracer.enabled:
                    self._tracer.instant("arq.retransmit", cat="arq", seq=seq,
                                         attempt=attempt, rto_ms=self.rto_ms)
            deadline = time.monotonic() + self._attempt_wait()
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    inbound = self._ch.recv(timeout=remain)
                except TransportTimeout:
                    break
                if self._handle(inbound, want_ack=seq):
                    self._rto = self._timeout      # delivery: reset the timer
                    return
            self._rto = min(self._rto_max, self._rto * self._backoff)
        raise TransportError(f"no ACK for seq {seq} after {self._max_retries} tries")

    def recv(self, timeout: float | None = None) -> bytes:
        if self._tracer.enabled:
            with self._tracer.span("arq.recv", cat="arq"):
                return self._recv_arq(timeout)
        return self._recv_arq(timeout)

    def _recv_arq(self, timeout: float | None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._ready:
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                raise TransportTimeout("reliable recv timeout")
            self._handle(self._ch.recv(timeout=remain), want_ack=None)
        data = self._ready.popleft()
        self.bytes_in += len(data)
        return data

    def linger(self, budget: float | None = None) -> None:
        """Re-ACK retransmitted tails until the channel stays quiet for a
        full backed-off retransmit window (the two-army tail: our ACK of
        the peer's last datagram may have been lost while we no longer
        expect data).  The quiet window covers the peer's maximum RTO plus
        jitter, else a backed-off peer would retransmit into a dead
        channel; ``budget`` caps the whole linger regardless of traffic so
        a babbling peer cannot hold close open forever."""
        quiet = self._rto_max * (1.0 + self._jitter) + 4 * self._timeout
        if budget is None:
            budget = 16 * quiet
        deadline = time.monotonic() + budget
        while True:
            remain = deadline - time.monotonic()
            if remain <= 0:
                return
            try:
                self._handle(
                    self._ch.recv(timeout=min(quiet, remain)), want_ack=None
                )
            except TransportError:
                return

    def close(self) -> None:
        self._ch.close()


class FrameStream:
    """Varint-framed ``repro_torch.wire`` messages over a reliable Transport.

    Counts protocol frames and their exact framed byte sizes in each
    direction — the measured quantities the endpoint wire ledgers and the
    benchmark's bytes-per-diff gate are built from.

    With ``channel`` set (hub multiplexing, DESIGN.md §10), every outbound
    frame is wrapped in a ``MSG_MUX`` envelope tagged with that channel id
    and every inbound frame must arrive so wrapped with the *same* id — a
    missing envelope or any other id (unknown, stale, zero) raises
    ``WireError``.  Byte counters keep ledger semantics: ``bytes_out`` /
    ``bytes_in`` count the *inner* framed bytes (what the protocol ledger
    sees); the envelope's extra bytes accrue to ``mux_bytes_out`` /
    ``mux_bytes_in`` — transport-level overhead, exactly like ARQ bytes.
    """

    def __init__(
        self,
        transport: Transport,
        *,
        recv_timeout: float | None = 60.0,
        channel: int | None = None,
    ):
        self.transport = transport
        self.channel = channel
        self._buf = bytearray()
        self._off = 0
        self._recv_timeout = recv_timeout
        self.frames_out = 0
        self.frames_in = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.mux_bytes_out = 0
        self.mux_bytes_in = 0

    def send(self, frame_bytes: bytes) -> None:
        self.frames_out += 1
        self.bytes_out += len(frame_bytes)
        if self.channel is not None:
            wrapped = wire_frames.encode_mux(self.channel, frame_bytes)
            self.mux_bytes_out += len(wrapped) - len(frame_bytes)
            frame_bytes = wrapped
        self.transport.send(frame_bytes)

    def recv(self, timeout: float | None = _UNSET) -> tuple[int, bytes]:
        """Next whole frame as (msg_type, payload).

        ``timeout`` overrides the stream's default recv timeout for this
        call only (the hub's per-peer round-barrier deadline) and bounds
        the WHOLE frame, not each transport chunk — a peer trickling bytes
        cannot hold the call open past the deadline (partial data stays
        buffered for the next call).
        """
        if timeout is _UNSET:
            timeout = self._recv_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            got = split_frame(self._buf, self._off)
            if got is not None:
                msg_type, payload, self._off = got
                if self._off == len(self._buf):
                    self._buf.clear()
                    self._off = 0
                if self.channel is not None:
                    if msg_type != wire_frames.MSG_MUX:
                        raise WireError(
                            "unmultiplexed frame on a channel-tagged stream"
                        )
                    outer_len = framed_len(len(payload))
                    ch, msg_type, payload = wire_frames.decode_mux(payload)
                    if ch != self.channel:
                        raise WireError(
                            f"frame for channel {ch} on channel {self.channel}"
                        )
                    self.mux_bytes_in += outer_len - framed_len(len(payload))
                self.bytes_in += framed_len(len(payload))
                self.frames_in += 1
                return msg_type, payload
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                raise TransportTimeout("frame recv deadline elapsed")
            self._buf += self.transport.recv(timeout=remain)
