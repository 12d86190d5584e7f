"""Fault injection and failure taxonomy for the PBS network stack (§13).

Two pieces:

* ``FaultPlan`` / ``ChaosTransport`` — a scripted, seeded fault injector
  wrapping any ``Transport``.  Faults are decided per *send operation
  index* from a frozen plan plus a seeded RNG, so a given (plan, op
  sequence) always injects the same faults: random loss, periodic loss
  bursts, duplication, adjacent-pair reordering, header corruption,
  op-indexed partitions (blackhole windows), and scripted crash — the
  machinery under the chaos soak, where K of N hub peers crash
  mid-epoch and resume via ``MSG_RESUME``.
* ``classify_error`` / ``PeerDeadline`` — the typed failure taxonomy
  ``PeerOutcome.error_kind`` reports, so tests and operators assert on
  failure *cause* instead of string-matching exception text.

Layering: chaos wraps the raw datagram channel, ``ReliableTransport``
wraps chaos — so injected loss/dup/reorder exercise the real ARQ recovery
path.  Corruption garbles the ARQ header byte (the one surface with no
structural redundancy): the ARQ layer detects it and surfaces a
``TransportError``, after which recovery is the ordinary suspend→resume
path — exactly how a TCP-like medium converts residual corruption into
connection failure rather than silent data damage.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.tow import EstimateOutOfRange
from ..obs.trace import NULL_TRACER
from ..wire.frames import WireError

from .transport import Transport, TransportError, TransportTimeout


class PeerDeadline(TransportError):
    """A hub peer missed its round-barrier deadline (straggler eviction).

    Raised by the hub's poll loop, never by a transport itself — distinct
    from ``TransportTimeout`` so ``classify_error`` can tell "the hub gave
    up waiting" from "the channel broke".
    """


def classify_error(err: BaseException | None) -> str | None:
    """Collapse an exception to the ``PeerOutcome.error_kind`` taxonomy.

    ``deadline`` — the hub's round-barrier deadline elapsed (or a recv
    deadline did); ``estimate`` — phase-0 d̂ left the PBS operating regime
    (``EstimateOutOfRange``: the pair belongs to the tree front end);
    ``wire`` — the peer spoke malformed or out-of-protocol bytes;
    ``transport`` — the channel itself failed (closed pipe, ARQ
    exhaustion, injected crash).  Wrapper exceptions are unwrapped through
    ``__cause__`` so an eviction that re-wraps the root failure still
    classifies by the root.  Anything else is ``"error"``; None stays
    None (no failure).  The two non-exception kinds (``degraded``,
    ``resumed``) are assigned by the hub's bookkeeping, not derived here.
    """
    fallback = None
    while err is not None:
        if isinstance(err, (PeerDeadline, TransportTimeout)):
            return "deadline"
        if isinstance(err, EstimateOutOfRange):
            return "estimate"
        if isinstance(err, WireError):
            return "wire"
        if isinstance(err, TransportError):
            fallback = "transport"       # keep digging for a root cause
        elif fallback is None:
            fallback = "error"
        err = err.__cause__
    return fallback


@dataclass(frozen=True)
class FaultPlan:
    """A frozen, seeded fault script for one ``ChaosTransport`` direction.

    Random faults (``loss``/``dup``/``reorder``/``corrupt``) are
    probabilities drawn from a ``seed``-determined RNG; scripted faults
    key off the send-operation index: ``burst_every``/``burst_len`` drop
    ``burst_len`` consecutive sends at the start of every
    ``burst_every``-send window, ``partitions`` blackholes whole
    ``[start_op, end_op)`` windows, and ``crash_after_sends`` kills the
    transport at that op — closing the wrapped channel (the peer observes
    a clean disconnect) or, with ``crash_silent``, going dark (the peer
    observes a straggler and the hub's deadline eviction fires).
    """

    seed: int = 0
    loss: float = 0.0
    burst_every: int = 0
    burst_len: int = 0
    dup: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    corrupt_at: tuple = ()      # exact send ops to corrupt (scripted form)
    partitions: tuple = ()
    crash_after_sends: int | None = None
    crash_silent: bool = False


class ChaosTransport(Transport):
    """Inject a ``FaultPlan``'s faults into every send through ``inner``.

    Pure wrapper: no protocol knowledge, works over any ``Transport``.
    Wrap the *datagram* channel and run ``ReliableTransport`` on top so
    every injected fault exercises real ARQ recovery.  Counters
    (``sends``/``recvs``/``dropped``/``duplicated``/``reordered``/
    ``corrupted``) expose what was actually injected; ``crashed`` reports
    whether the scripted crash fired.
    """

    def __init__(
        self, inner: Transport, plan: FaultPlan, tracer=None
    ) -> None:
        super().__init__()
        self._inner = inner
        self._plan = plan
        # injected faults mark instants on the shared timeline so a chaos
        # soak's trace shows each drop/crash next to the ARQ recovery it
        # provoked; per-datagram, so guarded by ``enabled`` (DESIGN.md §14)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._rng = np.random.default_rng(plan.seed)
        self._held: bytes | None = None    # reorder: datagram awaiting swap
        self.crashed = False
        self.sends = 0
        self.recvs = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.corrupted = 0

    def _crash(self) -> None:
        self.crashed = True
        self._held = None
        if not self._plan.crash_silent:
            self._inner.close()

    def _dropped_at(self, op: int) -> bool:
        plan = self._plan
        for start, end in plan.partitions:
            if start <= op < end:
                return True
        if plan.burst_every and op % plan.burst_every < plan.burst_len:
            return True
        return plan.loss > 0.0 and float(self._rng.random()) < plan.loss

    def send(self, data: bytes) -> None:
        if self.crashed:
            raise TransportError("chaos: send on crashed transport")
        op = self.sends
        self.sends += 1
        self.bytes_out += len(data)
        plan = self._plan
        if plan.crash_after_sends is not None and op >= plan.crash_after_sends:
            self._crash()
            if self._tracer.enabled:
                self._tracer.instant("chaos.crash", cat="chaos", op=op,
                                     silent=plan.crash_silent)
            raise TransportError(f"chaos: scripted crash at send {op}")
        if self._dropped_at(op):
            self.dropped += 1
            if self._tracer.enabled:
                self._tracer.instant("chaos.drop", cat="chaos", op=op)
            return
        data = bytes(data)
        if op in plan.corrupt_at or (
            plan.corrupt > 0.0 and float(self._rng.random()) < plan.corrupt
        ):
            # garble the ARQ header byte: detected, never silent damage
            data = bytes((data[0] ^ 0x80,)) + data[1:] if data else data
            self.corrupted += 1
            if self._tracer.enabled:
                self._tracer.instant("chaos.corrupt", cat="chaos", op=op)
        if self._held is not None:
            held, self._held = self._held, None
            self._inner.send(data)       # adjacent swap completes
            self._inner.send(held)
            self.reordered += 1
            if self._tracer.enabled:
                self._tracer.instant("chaos.reorder", cat="chaos", op=op)
        elif plan.reorder > 0.0 and float(self._rng.random()) < plan.reorder:
            self._held = data            # hold until the next delivered send
        else:
            self._inner.send(data)
            if plan.dup > 0.0 and float(self._rng.random()) < plan.dup:
                self._inner.send(data)
                self.duplicated += 1
                if self._tracer.enabled:
                    self._tracer.instant("chaos.dup", cat="chaos", op=op)

    def recv(self, timeout: float | None = None) -> bytes:
        if self.crashed:
            # the crashed side's own process is gone either way — it fails
            # fast; the *remote* side experiences the silent variant as
            # pure silence because the wrapped channel was never closed
            raise TransportError("chaos: recv on crashed transport")
        data = self._inner.recv(timeout=timeout)
        self.recvs += 1
        self.bytes_in += len(data)
        return data

    def linger(self, budget: float | None = None) -> None:
        if not self.crashed:
            self._inner.linger(budget)

    def close(self) -> None:
        self._inner.close()
