"""The port's observability layer (``repro_torch.obs``, DESIGN.md §14) held
against the reference's.

Every test of ``tests/test_obs.py`` has a counterpart here, in the same
order, run on the port's server, hub, endpoints and transports on
``device="cpu"``:

* the **schema contract** — the port's ``SCHEMA`` is self-consistent,
  equals ``repro.obs.SCHEMA`` spec for spec, and matches the DESIGN.md §14
  table field for field; its ``Recorder`` rejects undeclared keys;
* **derived-snapshot parity** — the port's legacy dicts (``server.stats``,
  ``hub.stats``, ``wire_stats``) are registry views, and equal the
  reference's for the same sessions (the chaos hub runs on both hubs at
  once, ``both()``);
* **tracing** — spans, exports and the hub chaos acceptance trace, and
  the trace files of the two packages are one contract: either package's
  ``load_events`` reads the other's exports into the same events;
* **``tools/trace_report.py``** over a trace the port's server exported,
  and its refusal of the empty file a port tracer with no events exports.

Last, the port's own profiler hook: ``Tracer(torch_profiler=True)`` as the
engine's dispatch tracer opens one ``torch.profiler`` window per executor
dispatch, and a plain ``Tracer()`` opens none.
"""
import json
import pathlib
import re
import sys
import threading

import numpy as np
import pytest

import repro.obs as ref_obs
from repro.core.pbs import reconcile
from repro.core.simdata import make_pair
from repro_torch.core.pbs import PBSConfig
from repro_torch.net import (
    AliceEndpoint,
    ChaosTransport,
    FaultPlan,
    HubEndpoint,
    InMemoryDuplex,
    ReliableTransport,
    TransportError,
    run_hub,
)
from repro_torch.obs import (
    NULL_TRACER,
    SCHEMA,
    MetricsError,
    Recorder,
    Tracer,
    load_events,
)
from repro_torch.recon import ReconcileServer, engine

from _torch_hub import PORT, assert_same_results, assert_same_stats, both, crash_resume_hub
from _torch_port import run_both

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import trace_report  # noqa: E402

DEV = "cpu"


# ---------------------------------------------------------------------------
# schema contract
# ---------------------------------------------------------------------------


def test_schema_self_consistent():
    for name, spec in SCHEMA.items():
        assert spec.name == name
        assert name.startswith(spec.owner + ".")
        assert spec.key == name[len(spec.owner) + 1:]
        assert spec.desc
    # one schema for both packages: same names, and every field of every spec
    assert list(SCHEMA) == list(ref_obs.SCHEMA)
    for name, spec in SCHEMA.items():
        want = ref_obs.SCHEMA[name]
        for field in ("name", "kind", "unit", "owner", "key", "desc"):
            assert getattr(spec, field) == getattr(want, field), (name, field)


_ROW_RE = re.compile(
    r"^\| `([\w.]+)` \| (\w+) \| (\w+) \| (\w+) \| (.+?) \|$", re.MULTILINE
)


def test_design_section14_table_matches_schema_exactly():
    """The §14 table is the port's schema too: every metric row matches its
    MetricSpec field for field, with no extras on either side."""
    text = (ROOT / "DESIGN.md").read_text()
    sect = text.split("## §14", 1)
    assert len(sect) == 2, "DESIGN.md has no §14 section"
    rows = {m.group(1): m.groups()[1:] for m in _ROW_RE.finditer(sect[1])}
    assert set(rows) == set(SCHEMA), (
        f"table/schema drift: only in table {set(rows) - set(SCHEMA)}, "
        f"only in schema {set(SCHEMA) - set(rows)}"
    )
    for name, (kind, unit, owner, desc) in rows.items():
        spec = SCHEMA[name]
        assert (kind, unit, owner) == (spec.kind, spec.unit, spec.owner), name
        assert desc == spec.desc, name


def test_recorder_rejects_undeclared_keys():
    r = Recorder()
    with pytest.raises(MetricsError):
        r.inc("server.not_a_metric")
    with pytest.raises(MetricsError):
        r.set("nowhere.rounds", 1)
    with pytest.raises(MetricsError):
        r.publish("server", {"rounds": 1, "bogus_key": 2})
    # error inherits KeyError so existing dict-shaped handling still works
    assert issubclass(MetricsError, KeyError)


def test_recorder_basics_and_views():
    r = Recorder()
    r.inc("wire.retransmits")
    r.inc("wire.retransmits", 2)
    r.set("wire.rto_ms", 12.5)
    r.set("hub.peers_failed_by_kind", {"deadline": 1})
    r.inc("hub.peers_failed_by_kind", label="transport")
    assert r.value("wire.retransmits") == 3
    assert r.value("wire.rto_ms") == 12.5
    assert r.value("hub.peers_failed_by_kind") == {
        "deadline": 1, "transport": 1
    }
    assert r.value("hub.peers_failed_by_kind", label="deadline") == 1
    assert r.value("server.rounds", default=0) == 0
    view = r.view("wire")
    assert view["retransmits"] == 3 and view["rto_ms"] == 12.5
    # views hand out copies: mutating one can't corrupt the registry
    r.view("hub")["peers_failed_by_kind"]["deadline"] = 99
    assert r.value("hub.peers_failed_by_kind", label="deadline") == 1
    snap = r.snapshot()
    assert snap["wire.retransmits"] == 3


def test_recorder_marks():
    r = Recorder()
    r.mark("store", {"store_builds": 2, "store_delta_bytes": 100})
    d = r.delta_since_mark("store", {"store_builds": 5,
                                     "store_delta_bytes": 160})
    assert d == {"store_builds": 3, "store_delta_bytes": 60}
    r.drop_mark("store")
    d = r.delta_since_mark("store", {"store_builds": 5,
                                     "store_delta_bytes": 160})
    assert d == {"store_builds": 5, "store_delta_bytes": 160}
    r.drop_mark("store")   # idempotent on a missing mark


# ---------------------------------------------------------------------------
# derived snapshots: legacy dicts == registry values
# ---------------------------------------------------------------------------


def test_server_stats_is_registry_view():
    """The port server's ``stats`` is its registry's view, and its integer
    ledgers equal the reference server's for the same session."""
    a, b = make_pair(600, 10, np.random.default_rng(0))
    srv, results, _, _ = run_both([(a, b, PBSConfig(seed=0), 10)])
    assert results[0].success
    st = srv.stats
    assert st == srv.recorder.view("server")
    assert srv.recorder.value("server.rounds") == st["rounds"]
    assert srv.recorder.value("server.h2d_ratio") == st["h2d_ratio"]
    # kernel retrace attribution flows into the kernels owner too
    assert srv.recorder.value("kernels.retraces_total") is not None
    by_fn = srv.recorder.value("kernels.retraces_by_fn")
    assert isinstance(by_fn, dict)


def test_submit_after_run_resets_store_mark():
    """Regression: a post-run ``submit`` discards the finished batch; the
    recorder's store mark must die with it, or the next run's store
    ledger diffs against the dead batch's counters (reporting 0 builds
    for a store that was just built)."""
    a, b = make_pair(600, 10, np.random.default_rng(0))
    srv = ReconcileServer(device=DEV)
    srv.submit(a, b, cfg=PBSConfig(seed=0), d_known=10)
    srv.run()
    assert srv.stats["store_builds"] >= 1

    a2, b2 = make_pair(600, 10, np.random.default_rng(1))
    sid = srv.submit(a2, b2, cfg=PBSConfig(seed=1), d_known=10)
    res = srv.run()[sid]
    oracle = reconcile(a2, b2, PBSConfig(seed=1), d_known=10)
    assert res.success and res.diff == oracle.diff
    st = srv.stats
    # the fresh batch built exactly one store (only the new session has
    # live work); the dead-mark bug reported 0 here
    assert st["store_builds"] == 1
    assert st["store_compactions"] == 0 and st["h2d_delta_bytes"] == 0


def test_chaos_registry_parity_with_legacy_stats():
    """The chaos stats read through the port's registries match its legacy
    dicts under a seeded ChaosTransport run, and the port hub's ledgers and
    results equal the reference hub's on the same scenario."""
    port, ref = both(crash_resume_hub)
    hub, alices, outcomes, results, ch0, _ = port
    rhub, _, routcomes, rresults, _, _ = ref
    st = hub.stats
    assert outcomes[ch0].error_kind == routcomes[ch0].error_kind == "resumed"
    assert st["peers_resumed"] == 1 and st["resume_replay_bytes"] > 0
    rec = hub.recorder
    for key in ("peers_resumed", "resume_replay_bytes", "sessions_degraded",
                "peers_failed", "peers_failed_by_kind", "rounds", "epoch"):
        assert rec.value(f"hub.{key}") == st[key], key
    # per-peer wire stats are registry views on the peer's own recorder
    hw = hub._peers[ch0].wire_stats()
    prec = hub._peers[ch0].recorder
    for key, val in hw.items():
        assert prec.value(f"wire.{key}") == val, key
    aw = alices[ch0].wire_stats
    arec = alices[ch0].recorder
    for key, val in aw.items():
        assert arec.value(f"wire.{key}") == val, key
    assert arec.value("endpoint.resumes") == alices[ch0].resumes == 1
    assert_same_stats(st, rhub.stats)
    assert_same_results(results, rresults)


def test_eviction_and_degradation_registry_parity():
    """peers_failed_by_kind and sessions_degraded hold registry/legacy
    parity on the port hub's eviction and degradation-ladder paths too."""
    rng = np.random.default_rng(17)
    univ = rng.choice(1 << 20, size=2400, replace=False).astype(np.uint32)
    a, b = univ[:2100], univ[300:]
    cfg = PBSConfig(seed=8)
    d = len(np.setxor1d(a, b))
    t_a_raw, t_h = InMemoryDuplex.pair()
    t_a = ChaosTransport(t_a_raw, FaultPlan(crash_after_sends=2))
    hub = HubEndpoint(resume_window=0.3, recv_deadline=5.0, device=DEV)
    ch = hub.add_peer(t_h, label="gone")
    hub.submit(ch, b, cfg=cfg, d_known=d)
    ep = AliceEndpoint(t_a, channel=ch, device=DEV)
    ep.submit(a, cfg=cfg, d_known=d)

    def drive():
        with pytest.raises(TransportError):
            ep.run()

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    hub.serve()
    th.join(timeout=60)
    st = hub.stats
    assert st["peers_failed_by_kind"] == {"transport": 1}
    assert hub.recorder.value("hub.peers_failed_by_kind") == {"transport": 1}
    assert hub.recorder.value("hub.peers_failed") == st["peers_failed"] == 1

    # degradation ladder: hopeless d̂ = 250 against d = 1000, budget 2
    rngd = np.random.default_rng(11)
    univ = rngd.choice(1 << 20, size=4000, replace=False).astype(np.uint32)
    th_a, th_h = InMemoryDuplex.pair()
    dhub = HubEndpoint(degrade=True, recv_deadline=30.0, device=DEV)
    dcfg = PBSConfig(seed=5, max_rounds=2)
    dch = dhub.add_peer(th_h)
    dhub.submit(dch, univ[500:], cfg=dcfg, d_known=250)
    dep = AliceEndpoint(th_a, channel=dch, degrade=True, device=DEV)
    dep.submit(univ[:3500], cfg=dcfg, d_known=250)
    _, dresults, derrors = run_hub(dhub, {dch: dep})
    assert not derrors and dresults[dch][0].success
    # the oracle has no ladder (it fails within its budget): hold the result
    # to the true difference instead
    assert dresults[dch][0].diff == set(np.setxor1d(univ[:3500], univ[500:]).tolist())
    dst = dhub.stats
    assert dst["sessions_degraded"] >= 1
    assert dhub.recorder.value("hub.sessions_degraded") == dst["sessions_degraded"]
    dep.wire_stats    # the endpoint.* freeze point
    assert dep.recorder.value("endpoint.sessions_degraded") == dep.sessions_degraded


# ---------------------------------------------------------------------------
# tracing: spans, exports, acceptance trace
# ---------------------------------------------------------------------------


def test_null_tracer_is_inert_and_shared():
    assert NULL_TRACER.enabled is False
    s1 = NULL_TRACER.span("x", cat="device", anything=1)
    s2 = NULL_TRACER.annotate("y")
    with s1:
        pass
    NULL_TRACER.instant("z")
    NULL_TRACER.counter("c", 1)
    assert s1 is s2    # one shared no-op context manager, zero allocation
    # a tracer without the profiler opt-in annotates with the same no-op
    assert Tracer().annotate("y") is s1


def test_tracer_span_structure():
    tr = Tracer()
    with tr.span("outer", cat="host", k=1):
        with tr.span("inner", cat="device"):
            pass
    tr.instant("mark", v=2)
    tr.counter("gauge", 7)
    evs = tr.events()
    by_name = {e["name"]: e for e in evs}
    assert by_name["outer"]["ph"] == "X" and by_name["outer"]["args"] == {"k": 1}
    assert by_name["inner"]["cat"] == "device"
    # inner closed first and nests within outer on the timeline
    assert by_name["inner"]["ts"] >= by_name["outer"]["ts"]
    assert (by_name["inner"]["ts"] + by_name["inner"]["dur"]
            <= by_name["outer"]["ts"] + by_name["outer"]["dur"] + 1e-6)
    assert by_name["mark"]["ph"] == "i" and by_name["mark"]["s"] == "t"
    assert by_name["gauge"]["ph"] == "C"
    assert by_name["thread_name"]["ph"] == "M"
    assert all(e["pid"] == 1 for e in evs)


def test_exports_roundtrip(tmp_path):
    """Both exports round-trip, and the trace files are one contract across
    the packages: each package's ``load_events`` reads the other's exports
    into the same events."""
    tr, rtr = Tracer(), ref_obs.Tracer()
    for t in (tr, rtr):
        with t.span("a", cat="device", peer="p0"):
            pass
        t.instant("b", x=1)
        t.counter("c", 3)
    chrome, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    n1 = tr.export_chrome(chrome)
    n2 = tr.export_jsonl(jsonl)
    assert n1 == n2 == len(tr.events())
    assert load_events(chrome) == load_events(jsonl) == tr.events()
    assert ref_obs.load_events(chrome) == ref_obs.load_events(jsonl) == tr.events()
    doc = json.loads(chrome.read_text())
    assert doc["displayTimeUnit"] == "ms"

    rchrome, rjsonl = tmp_path / "r.json", tmp_path / "r.jsonl"
    rtr.export_chrome(rchrome)
    rtr.export_jsonl(rjsonl)
    assert load_events(rchrome) == load_events(rjsonl) == rtr.events()
    assert json.loads(rchrome.read_text()).keys() == doc.keys()
    # the same calls leave events of the same shape in both packages
    strip = ("ts", "dur", "tid")
    assert ([{k: v for k, v in e.items() if k not in strip} for e in tr.events()]
            == [{k: v for k, v in e.items() if k not in strip} for e in rtr.events()])


def test_arq_retransmit_instrumentation():
    """A seeded partition drops the first datagram: the port's ARQ layer
    retransmits and the tracer records it, seq- and attempt-tagged."""
    tr = Tracer()
    raw_a, raw_b = InMemoryDuplex.pair()
    chaos = ChaosTransport(raw_a, FaultPlan(partitions=((0, 1),)), tracer=tr)
    ta = ReliableTransport(chaos, timeout=0.02, max_retries=50, tracer=tr)
    tb = ReliableTransport(raw_b, timeout=0.02, max_retries=50)
    got = {}

    def receiver():
        got["data"] = tb.recv(timeout=5.0)

    th = threading.Thread(target=receiver, daemon=True)
    th.start()
    ta.send(b"payload")
    th.join(timeout=10)
    assert got.get("data") == b"payload"
    assert ta.retransmits >= 1
    names = [e["name"] for e in tr.events()]
    assert "chaos.drop" in names
    retrans = [e for e in tr.events() if e["name"] == "arq.retransmit"]
    assert len(retrans) == ta.retransmits
    assert retrans[0]["args"]["attempt"] >= 1
    assert {"seq", "attempt"} <= retrans[0]["args"].keys()
    sends = [e for e in tr.events() if e["name"] == "arq.send"]
    assert sends and sends[0]["cat"] == "arq" and "dur" in sends[0]


def test_hub_chaos_trace_acceptance(tmp_path):
    """The acceptance trace on the port hub: ONE shared tracer across a hub
    chaos run exports a Perfetto-loadable Chrome trace showing per-peer
    round spans, ARQ retransmits, and a resume transition."""
    tr = Tracer()
    hub, alices, outcomes, _, ch0, ch1 = crash_resume_hub(PORT, tracer=tr, arq_peer=True)
    assert outcomes[ch0].error_kind == "resumed"
    assert outcomes[ch1].ok

    path = tmp_path / "chaos_trace.json"
    n = tr.export_chrome(path)
    evs = load_events(path)
    assert len(evs) == n > 0
    assert ref_obs.load_events(path) == evs
    names = {e["name"] for e in evs}

    # per-peer round spans, attributed by peer label and channel
    replies = [e for e in evs if e["name"] == "peer.round.reply"]
    assert {e["args"]["peer"] for e in replies} == {"crasher", "lossy"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in replies)
    # ARQ retransmits fired on the lossy peer and were recorded
    retrans = sum(ep.wire_stats.get("retransmits", 0)
                  for ep in alices.values())
    assert retrans >= 1
    assert "arq.retransmit" in names
    # the resume transition, both sides
    assert "peer.suspend" in names and "peer.resume" in names
    assert "resume" in names           # the Alice-side span
    assert "chaos.crash" in names
    # Perfetto-loadable: a JSON object document, complete events carry
    # ts/dur/pid/tid, instants are scoped, metadata names the threads
    doc = json.loads(path.read_text())
    assert isinstance(doc["traceEvents"], list)
    for e in doc["traceEvents"]:
        assert "name" in e and "ph" in e and "pid" in e and "tid" in e
        if e["ph"] == "X":
            assert "ts" in e and "dur" in e
        if e["ph"] == "i":
            assert e["s"] == "t"
    assert sum(e["ph"] == "M" for e in doc["traceEvents"]) >= 2  # threads


# ---------------------------------------------------------------------------
# trace_report over the port's exports
# ---------------------------------------------------------------------------


def _traced_server_run(tracer):
    srv = ReconcileServer(tracer=tracer, device=DEV)
    for s in range(4):
        a, b = make_pair(600, 10, np.random.default_rng(s))
        srv.submit(a, b, cfg=PBSConfig(seed=s), d_known=10)
    results = srv.run()
    assert all(r.success for r in results.values())
    return srv, results


def test_trace_report_sections(tmp_path):
    tr = Tracer()
    _, results = _traced_server_run(tr)
    path = tmp_path / "t.json"
    tr.export_chrome(path)

    rep = trace_report.build_report(load_events(path))
    occ = rep["occupancy"]
    assert occ, "no occupancy rows"
    row = next(iter(occ.values()))
    assert row["device_ms"] > 0 and row["wall_ms"] >= row["device_ms"]
    assert 0 < row["device_frac"] <= 1

    peers = rep["peers"]
    assert peers["local"]["sessions"] == 4
    assert peers["local"]["diff"] == sum(len(r.diff) for r in results.values())
    assert peers["local"]["bytes"] == sum(r.bytes_sent
                                          for r in results.values())

    hist = rep["round_histogram"]
    assert hist, "no parameter classes in the histogram"
    h = hist[0]
    assert sum(h["rounds_hist"]) == h["sessions"] == 4
    assert "markov_round_fracs" in h
    assert abs(sum(h["markov_round_fracs"]) - 1.0) < 0.1

    # the CLI wrapper runs on the same file
    assert trace_report.main([str(path)]) == 0
    assert trace_report.main([str(path), "--json"]) == 0


def test_trace_report_empty_trace_fails(tmp_path):
    """A port tracer that recorded nothing exports files (either format)
    that the report refuses."""
    tr = Tracer()
    jsonl, chrome = tmp_path / "empty.jsonl", tmp_path / "empty.json"
    assert tr.export_jsonl(jsonl) == tr.export_chrome(chrome) == 0
    assert jsonl.read_text() == ""
    assert trace_report.main([str(jsonl)]) == 1
    assert trace_report.main([str(chrome)]) == 1


# ---------------------------------------------------------------------------
# the port's own hook: torch.profiler windows around executor dispatch
# ---------------------------------------------------------------------------

_WINDOWS = ("repro.execute_round", "repro.execute_round_ext",
            "repro.encode_side", "repro.encode_side_ext")


def _profiled_windows(dispatch_tracer):
    """A 4-session port server run inside a CPU ``torch.profiler`` capture
    with ``dispatch_tracer`` as the engine's dispatch tracer; returns the
    server's stats and the profiler's windows by name."""
    from torch.profiler import ProfilerActivity, profile

    engine.set_dispatch_tracer(dispatch_tracer)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            srv, _ = _traced_server_run(Tracer())
    finally:
        engine.set_dispatch_tracer(None)
    counts = dict.fromkeys(_WINDOWS, 0)
    for ev in prof.events():
        if ev.name in counts:
            counts[ev.name] += 1
    return srv.stats, counts


def test_profiler_hook_opens_one_window_per_dispatch():
    st, counts = _profiled_windows(Tracer(torch_profiler=True))
    # one execute_round per cohort-round; no rateless session, no extension
    assert st["cohort_rounds"] > 0 and st["parity_extensions"] == 0
    assert counts == {**dict.fromkeys(_WINDOWS, 0),
                      "repro.execute_round": st["cohort_rounds"]}
    assert engine._DISPATCH_TRACER is NULL_TRACER

    st, counts = _profiled_windows(Tracer())
    assert st["cohort_rounds"] > 0
    assert counts == dict.fromkeys(_WINDOWS, 0)
