"""Structured span tracing for the reconciliation stack (DESIGN.md §14).

Zero-dependency, monotonic-clock, thread-aware tracing around the natural
phase boundaries of the serving stack: the phase-0 ToW sweep, per-cohort
plan/dispatch/collect, round barriers, epoch advances, ARQ
send/recv/retransmit, and resume/degrade transitions — each span carrying
per-peer / per-session attribution in its ``args``.  The overlap
pipeline and the hub's straggler behavior become *visible* timelines
instead of inferred numbers.

Two exports of the same event list:

* ``export_jsonl`` — one event dict per line, the machine-friendly form
  ``tools/trace_report.py`` summarizes;
* ``export_chrome`` — Chrome trace format (a ``{"traceEvents": [...]}``
  JSON document) loadable directly in ``chrome://tracing`` or Perfetto
  (https://ui.perfetto.dev), with thread-name metadata so each endpoint /
  hub / peer thread renders as its own labeled track.

Tracing is **disabled by default and off the hot path**: every traced call
site holds a ``Tracer`` reference that defaults to the module-level
``NULL_TRACER`` singleton, whose ``span`` returns one shared no-op context
manager and whose ``instant``/``counter`` are pass statements — no event
list, no lock, no clock read.  Hot loops additionally guard per-datagram
instrumentation behind ``tracer.enabled`` so the disabled path costs a
single attribute read (the warm S=1024 bench gate runs with tracing
disabled and is asserted unchanged).

``Tracer(torch_profiler=True)`` opt-in: ``annotate(name)`` then returns a
``torch.profiler.record_function`` so kernel dispatch windows show up inside
a ``torch.profiler.profile`` capture alongside the host spans; without the
opt-in it is a no-op context.
"""
from __future__ import annotations

import json
import threading
import time


class _NullSpan:
    """The shared no-op context manager disabled tracing hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op (DESIGN.md §14)."""

    __slots__ = ()
    enabled = False

    def span(self, name, cat="host", **args):
        return _NULL_SPAN

    def instant(self, name, cat="host", **args):
        pass

    def counter(self, name, value, cat="host"):
        pass

    def annotate(self, name):
        return _NULL_SPAN


NULL_TRACER = NullTracer()


class _Span:
    """One live span: records a Chrome 'X' (complete) event on exit."""

    __slots__ = ("_tracer", "_ev", "_t0")

    def __init__(self, tracer: "Tracer", ev: dict):
        self._tracer = tracer
        self._ev = ev

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        ev = self._ev
        ev["ts"] = (self._t0 - self._tracer._origin_ns) / 1e3
        ev["dur"] = (t1 - self._t0) / 1e3
        self._tracer._emit(ev)
        return False


class Tracer:
    """Collects trace events; timestamps are µs from tracer creation.

    Thread-aware: every event carries the OS thread id and the first event
    from each thread also emits a ``thread_name`` metadata record, so
    Perfetto lays the hub, each peer endpoint, and any transport worker
    out as separate named tracks.
    """

    enabled = True

    def __init__(self, *, torch_profiler: bool = False):
        self._origin_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._named_tids: set[int] = set()
        self._torch_profiler = torch_profiler

    # -- event creation --------------------------------------------------

    def _emit(self, ev: dict) -> None:
        tid = threading.get_ident()
        ev["tid"] = tid
        with self._lock:
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self._events.append({
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            self._events.append(ev)

    def span(self, name: str, cat: str = "host", **args) -> _Span:
        """A timed region: ``with tracer.span("cohort.collect", rnd=3):``.

        ``cat`` buckets spans for occupancy accounting — ``device`` marks
        time blocked on device readback, everything else is host time.
        ``args`` carry attribution (peer/channel/sid/round/cohort).
        """
        return _Span(self, {"name": name, "cat": cat, "ph": "X", "pid": 1,
                            "args": args})

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """A point event (retransmit, eviction, degrade rung, ...)."""
        self._emit({
            "name": name, "cat": cat, "ph": "i", "s": "t", "pid": 1,
            "ts": (time.perf_counter_ns() - self._origin_ns) / 1e3,
            "args": args,
        })

    def counter(self, name: str, value, cat: str = "host") -> None:
        """A Chrome counter-track sample (rto_ms over time, bytes, ...)."""
        self._emit({
            "name": name, "cat": cat, "ph": "C", "pid": 1,
            "ts": (time.perf_counter_ns() - self._origin_ns) / 1e3,
            "args": {"value": value},
        })

    def annotate(self, name: str):
        """Opt-in ``torch.profiler`` hook around kernel dispatch: inside a
        ``torch.profiler.profile`` capture the dispatch window shows up
        under ``name``; a no-op unless the tracer was built with
        ``torch_profiler=True``."""
        if self._torch_profiler:
            from torch.profiler import record_function
            return record_function(name)
        return _NULL_SPAN

    # -- reads / export --------------------------------------------------

    def events(self) -> list[dict]:
        """A snapshot copy of every event recorded so far."""
        with self._lock:
            return [dict(ev) for ev in self._events]

    def export_jsonl(self, path) -> int:
        """One JSON event per line; returns the event count."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)

    def export_chrome(self, path) -> int:
        """Chrome trace format: load the file as-is in ``chrome://tracing``
        or Perfetto.  Returns the event count."""
        evs = self.events()
        doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(evs)


def load_events(path) -> list[dict]:
    """Read a trace back: either export format (Chrome JSON or JSONL)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        # not a single document: one event object per line (JSONL)
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    return doc["traceEvents"] if isinstance(doc, dict) else doc
