"""Two-endpoint PBS reconciliation over real transports (DESIGN.md §9),
ported from the reference package's ``net``.

``AliceEndpoint`` and ``BobEndpoint`` split the in-process
``repro_torch.recon.ReconcileServer`` into genuine peers that communicate
*only* via ``repro_torch.wire``-encoded bytes over a ``Transport``: an
in-memory duplex for tests, a TCP loopback socket, or a simulated
lossy/latent channel behind the stop-and-wait ``ReliableTransport``.  Each
endpoint drives the device-resident cohort pipeline for its own side on its
``device`` (None = the CUDA card) — S concurrent sessions still batch into
fused kernel launches per round — and both sides advance the *same*
``core.pbs`` round state machine, so per-session results and measured wire
ledgers are byte-identical to ``core.pbs.reconcile``.

With ``continuous=True`` the endpoints reconcile divergent replicas epoch
after epoch (DESIGN.md §11): ``advance_epoch`` stages the next epoch's set
mutations, ``run_epoch``/``serve_epoch`` exchange the ``MSG_EPOCH`` d̂
handshake and delta-patch the resident stores in place.  ``submit_tree``
runs the tree front end's walk over ``MSG_TREE`` before phase 0 (§15), and
``rateless`` sessions recover overloaded units over ``MSG_PARITY`` (§16).

``resilience`` (DESIGN.md §13) types every failure (``classify_error``)
and scripts seeded faults under any transport (``FaultPlan`` /
``ChaosTransport``).  Frames are the contract: a port endpoint pairs with
a reference endpoint over either package's transports.
"""
from .endpoint import AliceEndpoint, BobEndpoint, run_pair, run_pair_epoch
from .resilience import ChaosTransport, FaultPlan, PeerDeadline, classify_error
from .transport import (
    FrameStream,
    InMemoryDuplex,
    ReliableTransport,
    SimulatedChannel,
    SocketTransport,
    Transport,
    TransportError,
    TransportTimeout,
    tcp_loopback_pair,
)

__all__ = [
    "AliceEndpoint",
    "BobEndpoint",
    "ChaosTransport",
    "FaultPlan",
    "FrameStream",
    "InMemoryDuplex",
    "PeerDeadline",
    "ReliableTransport",
    "SimulatedChannel",
    "SocketTransport",
    "Transport",
    "TransportError",
    "TransportTimeout",
    "classify_error",
    "run_pair",
    "run_pair_epoch",
    "tcp_loopback_pair",
]
