"""The unified metrics registry (DESIGN.md §14).

Before this module, the serving stack verified the paper's quantitative
claims through five ad-hoc, mutually inconsistent stats surfaces —
``ReconcileServer._stats``, the hub ``PeerOutcome``/``HubEndpoint.stats``
ledgers, per-stream ``wire_stats``, the ``count_retrace`` census, and the
per-epoch sync counters — each with its own spelling, units, and reset
semantics, stitched together by hand in every bench and test.

This module replaces the *contract*, not the plumbing: every stats key any
layer publishes is declared once in ``SCHEMA`` as a typed ``MetricSpec``
(name, kind, unit, owner), and each layer hands its ledger dict to a shared
``Recorder`` at the same points it used to freeze its ad-hoc dict.  The
legacy views (``ReconcileServer.stats``, ``HubEndpoint.stats``, endpoint
``wire_stats``) are now *derived snapshots* of the recorder — built back
from the registry values, byte/count-identical to their pre-obs shapes —
so no caller changes semantics, while every metric gains a single
discoverable schema row and an enforced no-undeclared-keys rule: a
``publish`` of an unknown key raises ``MetricsError`` instead of silently
minting a new counter (the schema test pins the DESIGN.md §14 table to
``SCHEMA`` exactly).

The recorder also owns the *mark* mechanism the per-run store ledgers are
derived from: cumulative counters (``SessionBatch.counters()``) are
published as ``store.*`` metrics and a named mark snapshots them at the end
of each run, so the next run's per-epoch view is ``delta_since_mark``.
Discarding a batch (``ReconcileServer.submit`` after a run) must drop the
mark along with the batch — a stale mark would subtract a dead batch's
counters from the fresh batch's zeros and leak negative deltas into the
ledger (the submit-after-run regression test).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


class MetricsError(KeyError):
    """An undeclared metric name reached the registry (add it to SCHEMA
    and the DESIGN.md §14 table, or fix the typo)."""


@dataclass(frozen=True)
class MetricSpec:
    """One declared metric: the schema row the DESIGN.md §14 table mirrors."""

    name: str           # full dotted name: "<owner>.<key>"
    kind: str           # counter | gauge | labeled_counter | histogram
    unit: str           # bytes | count | seconds | ms | ratio | rounds | 1
    owner: str          # server | hub | wire | endpoint | store | kernels
    desc: str = ""

    @property
    def key(self) -> str:
        """The legacy dict key: the name without its owner prefix."""
        return self.name.split(".", 1)[1]


_KINDS = ("counter", "gauge", "labeled_counter", "histogram")
_UNITS = ("bytes", "count", "seconds", "ms", "ratio", "rounds", "1")


def _specs() -> list[MetricSpec]:
    M = MetricSpec
    return [
        # -- server: ReconcileServer.run's per-run ledger (DESIGN.md §5/§11/§12)
        M("server.epoch", "gauge", "count", "server", "epoch the run served"),
        M("server.phase0_s", "gauge", "seconds", "server", "batched ToW estimation wall time"),
        M("server.rounds", "gauge", "rounds", "server", "global rounds driven"),
        M("server.cohort_rounds", "counter", "rounds", "server", "per-cohort round executions"),
        M("server.h2d_round_bytes", "counter", "bytes", "server", "per-round overlay H2D bytes"),
        M("server.legacy_h2d_round_bytes", "counter", "bytes", "server", "re-pack-per-round H2D equivalent"),
        M("server.kernel_launches", "counter", "count", "server", "fused executor launches"),
        M("server.legacy_kernel_launches", "counter", "count", "server", "pre-fusion launch equivalent"),
        M("server.sessions_degraded", "counter", "count", "server", "degradation-ladder escalations"),
        M("server.parity_extensions", "counter", "count", "server", "rateless MSG_PARITY-equivalent extensions applied"),
        M("server.device_s", "gauge", "seconds", "server", "device wait inside the round loop"),
        M("server.host_s", "gauge", "seconds", "server", "run wall minus device wait"),
        M("server.total_s", "gauge", "seconds", "server", "run wall time"),
        M("server.h2d_store_bytes", "counter", "bytes", "server", "cohort-store builds this run"),
        M("server.store_builds", "counter", "count", "server", "store (re)builds this run"),
        M("server.store_compactions", "counter", "count", "server", "capacity-overflow rebuilds this run"),
        M("server.h2d_delta_bytes", "counter", "bytes", "server", "O(churn) delta-patch H2D this run"),
        M("server.h2d_bytes", "counter", "bytes", "server", "total H2D this run"),
        M("server.legacy_h2d_bytes", "counter", "bytes", "server", "legacy total H2D equivalent"),
        M("server.h2d_bytes_per_round", "gauge", "bytes", "server", "H2D bytes per round"),
        M("server.legacy_h2d_bytes_per_round", "gauge", "bytes", "server", "legacy H2D bytes per round"),
        M("server.h2d_ratio", "gauge", "ratio", "server", "legacy/actual H2D win"),
        M("server.retraces", "counter", "count", "server", "jit traces attributed to the run"),
        M("server.tree_levels", "gauge", "count", "server", "tree levels walked by the front end"),
        M("server.tree_digest_bytes", "counter", "bytes", "server", "framed MSG_TREE exchange bytes"),
        M("server.tree_leaves", "gauge", "count", "server", "divergent ranges handed to PBS"),
        M("server.tree_bytes_per_diff", "gauge", "ratio", "server", "(tree + PBS bytes) per recovered diff"),
        # -- hub: HubEndpoint.serve's fusion/resilience ledger (DESIGN.md §10/§13)
        M("hub.epoch", "gauge", "count", "hub", "epoch the serve drove"),
        M("hub.rounds", "gauge", "rounds", "hub", "global rounds driven"),
        M("hub.cohort_rounds", "counter", "rounds", "hub", "per-cohort round executions"),
        M("hub.kernel_launches", "counter", "count", "hub", "fused encode launches (2/cohort-round)"),
        M("hub.decode_launches", "counter", "count", "hub", "batched BCH decode launches (1/cohort-round)"),
        M("hub.h2d_round_bytes", "counter", "bytes", "hub", "per-round overlay H2D bytes"),
        M("hub.peers", "counter", "count", "hub", "peers ever admitted (cumulative)"),
        M("hub.peers_failed", "counter", "count", "hub", "peers evicted (cumulative)"),
        M("hub.peers_failed_by_kind", "labeled_counter", "count", "hub", "evictions by classify_error kind"),
        M("hub.peers_resumed", "counter", "count", "hub", "MSG_RESUME re-attachments (cumulative)"),
        M("hub.resume_replay_bytes", "counter", "bytes", "hub", "replayed outcome frames (transport overhead)"),
        M("hub.sessions_degraded", "counter", "count", "hub", "degradation-ladder escalations (cumulative)"),
        M("hub.parity_extensions", "counter", "count", "hub", "rateless MSG_PARITY extensions served (cumulative)"),
        M("hub.store_uploads", "counter", "count", "hub", "cohort-store builds (cumulative)"),
        M("hub.h2d_store_bytes", "counter", "bytes", "hub", "store-build H2D this serve"),
        M("hub.store_builds", "counter", "count", "hub", "store (re)builds this serve"),
        M("hub.store_compactions", "counter", "count", "hub", "capacity-overflow rebuilds this serve"),
        M("hub.h2d_delta_bytes", "counter", "bytes", "hub", "O(churn) delta-patch H2D this serve"),
        M("hub.h2d_bytes", "counter", "bytes", "hub", "total H2D this serve"),
        M("hub.retraces", "counter", "count", "hub", "jit traces attributed to the serve"),
        M("hub.tree_levels", "gauge", "count", "hub", "deepest tree phase driven this serve"),
        M("hub.tree_digest_bytes", "counter", "bytes", "hub", "framed MSG_TREE exchange bytes this serve"),
        M("hub.tree_leaves", "counter", "count", "hub", "tree leaf sessions admitted this serve"),
        # -- wire: per-stream measured traffic (DESIGN.md §9/§13)
        M("wire.frames_out", "counter", "count", "wire", "protocol frames sent"),
        M("wire.frames_in", "counter", "count", "wire", "protocol frames received"),
        M("wire.frame_bytes_out", "counter", "bytes", "wire", "framed bytes sent (inner, sans mux)"),
        M("wire.frame_bytes_in", "counter", "bytes", "wire", "framed bytes received (inner, sans mux)"),
        M("wire.transport_bytes_out", "counter", "bytes", "wire", "raw transport bytes out incl. ARQ"),
        M("wire.transport_bytes_in", "counter", "bytes", "wire", "raw transport bytes in incl. ARQ"),
        M("wire.mux_bytes_out", "counter", "bytes", "wire", "MSG_MUX envelope overhead out"),
        M("wire.mux_bytes_in", "counter", "bytes", "wire", "MSG_MUX envelope overhead in"),
        M("wire.estimator_frame_bytes", "counter", "bytes", "wire", "phase-0 exchange bytes"),
        M("wire.protocol_frame_bytes", "counter", "bytes", "wire", "round sketch/reply/outcome bytes"),
        M("wire.verify_frame_bytes", "counter", "bytes", "wire", "final verify exchange bytes"),
        M("wire.epoch_envelope_bytes", "counter", "bytes", "wire", "MSG_EPOCH envelope overhead"),
        M("wire.resume_frame_bytes", "counter", "bytes", "wire", "resume handshake/replay/rollback bytes"),
        M("wire.tree_frame_bytes", "counter", "bytes", "wire", "tree digest/verdict exchange bytes"),
        M("wire.retransmits", "counter", "count", "wire", "ARQ retransmissions"),
        M("wire.rto_ms", "gauge", "ms", "wire", "live adaptive retransmit timeout"),
        # -- endpoint: per-endpoint recovery state (DESIGN.md §13)
        M("endpoint.resumes", "counter", "count", "endpoint", "MSG_RESUME reconnects driven"),
        M("endpoint.sessions_degraded", "counter", "count", "endpoint", "degradation-ladder escalations"),
        M("endpoint.parity_extensions", "counter", "count", "endpoint", "rateless MSG_PARITY extensions applied"),
        # -- store: SessionBatch cumulative counters (DESIGN.md §11)
        M("store.store_builds", "counter", "count", "store", "cohort-store builds incl. rebuilds"),
        M("store.store_compactions", "counter", "count", "store", "capacity overflows -> forced rebuilds"),
        M("store.store_delta_bytes", "counter", "bytes", "store", "cumulative delta-patch H2D bytes"),
        M("store.store_build_bytes", "counter", "bytes", "store", "cumulative store-build H2D bytes"),
        # -- kernels: the jit retrace census (DESIGN.md §12)
        M("kernels.retraces_total", "counter", "count", "kernels", "jit traces across every entry point"),
        M("kernels.retraces_by_fn", "labeled_counter", "count", "kernels", "jit traces per entry point"),
    ]


SCHEMA: dict[str, MetricSpec] = {s.name: s for s in _specs()}

for _s in SCHEMA.values():      # the schema must be self-consistent
    assert _s.kind in _KINDS, _s
    assert _s.unit in _UNITS, _s
    assert _s.name.startswith(_s.owner + "."), _s


@dataclass
class Recorder:
    """The one typed sink every layer's ledger lands in (DESIGN.md §14).

    Thread-safe; values live under their full dotted names.  Layers keep
    computing their dicts exactly as before and ``publish`` them whole; the
    legacy surfaces rebuild their dict shapes with ``view``.  ``mark`` /
    ``delta_since_mark`` / ``drop_mark`` carry the per-run derivation of
    cumulative counters (the old ``_counter_mark`` mechanism, now owned by
    the recorder so batch-discard resets cannot drift from it).
    """

    schema: dict[str, MetricSpec] = field(default_factory=lambda: SCHEMA)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._values: dict[str, object] = {}
        self._hists: dict[str, list] = {}
        self._marks: dict[str, dict] = {}

    # -- writes ----------------------------------------------------------

    def _spec(self, name: str) -> MetricSpec:
        spec = self.schema.get(name)
        if spec is None:
            raise MetricsError(
                f"undeclared metric {name!r}: declare it in repro_torch.obs SCHEMA "
                "and the DESIGN.md §14 table"
            )
        return spec

    def set(self, name: str, value, label: str | None = None) -> None:
        """Record ``name``'s current value (counters included: the layers'
        dicts already carry the correct cumulative/per-run semantics)."""
        spec = self._spec(name)
        with self._lock:
            if label is not None or spec.kind == "labeled_counter":
                if spec.kind != "labeled_counter" and label is not None:
                    raise MetricsError(f"{name} is {spec.kind}, not labeled")
                slot = self._values.setdefault(name, {})
                if label is None:       # whole label-dict publish
                    self._values[name] = dict(value)
                else:
                    slot[label] = value
            else:
                self._values[name] = value

    def inc(self, name: str, value=1, label: str | None = None) -> None:
        spec = self._spec(name)
        if spec.kind not in ("counter", "labeled_counter"):
            raise MetricsError(f"inc on non-counter metric {name}")
        with self._lock:
            if spec.kind == "labeled_counter":
                slot = self._values.setdefault(name, {})
                slot[label] = slot.get(label, 0) + value
            else:
                self._values[name] = self._values.get(name, 0) + value

    def observe(self, name: str, value) -> None:
        """Append one sample to a histogram metric."""
        spec = self._spec(name)
        if spec.kind != "histogram":
            raise MetricsError(f"observe on non-histogram metric {name}")
        with self._lock:
            self._hists.setdefault(name, []).append(value)

    def publish(self, owner: str, mapping: dict) -> None:
        """Record a whole legacy ledger dict under ``owner.*`` names.

        Every key must be declared — the enforcement point that keeps new
        counters from shipping un-schema'd.
        """
        for key, value in mapping.items():
            self.set(f"{owner}.{key}", value)

    # -- marks (per-run derivation of cumulative counters) ---------------

    def mark(self, name: str, counters: dict) -> None:
        """Snapshot ``counters`` under mark ``name`` (end-of-run)."""
        with self._lock:
            self._marks[name] = dict(counters)

    def delta_since_mark(self, name: str, counters: dict) -> dict:
        """Per-run view: ``counters`` minus the named mark (0 when unset)."""
        with self._lock:
            base = self._marks.get(name, {})
            return {k: v - base.get(k, 0) for k, v in counters.items()}

    def drop_mark(self, name: str) -> None:
        """Forget a mark — the batch it described was discarded, so the
        next run's delta must diff against zero, not a dead batch."""
        with self._lock:
            self._marks.pop(name, None)

    # -- reads -----------------------------------------------------------

    def value(self, name: str, label: str | None = None, default=None):
        self._spec(name)
        with self._lock:
            v = self._values.get(name, default)
            if label is not None:
                return v.get(label, default) if isinstance(v, dict) else default
            return dict(v) if isinstance(v, dict) else v

    def view(self, owner: str) -> dict:
        """The legacy dict shape, derived back from the registry: every
        recorded ``owner.*`` metric keyed by its un-prefixed name."""
        prefix = owner + "."
        with self._lock:
            return {
                name[len(prefix):]: (dict(v) if isinstance(v, dict) else v)
                for name, v in self._values.items()
                if name.startswith(prefix)
            }

    def snapshot(self) -> dict:
        """Full registry dump: name -> value (histograms as lists)."""
        with self._lock:
            out = {
                n: (dict(v) if isinstance(v, dict) else v)
                for n, v in self._values.items()
            }
            out.update({n: list(v) for n, v in self._hists.items()})
            return out
