"""Shared helpers of the ``test_torch_*`` differential suites: run the same
sessions through the port's server (on the CPU), the JAX package's server
and the numpy oracle, and hold all three together."""
from repro.core.pbs import reconcile
from repro.recon import ReconcileServer as RefServer
from repro_torch.recon import ReconcileServer as PortServer

RESULT_FIELDS = (
    "diff", "rounds", "success", "bytes_sent", "estimator_bytes",
    "bytes_per_round", "n", "t", "g", "d_est", "decode_failures",
    "fake_rejections",
)
# the integer ledgers of ``server.stats`` that must equal the reference's
LEDGER_KEYS = (
    "epoch", "rounds", "cohort_rounds", "kernel_launches",
    "legacy_kernel_launches", "h2d_store_bytes", "h2d_round_bytes",
    "h2d_delta_bytes", "h2d_bytes", "legacy_h2d_round_bytes",
    "legacy_h2d_bytes", "store_builds", "store_compactions",
    "sessions_degraded", "parity_extensions",
)


def assert_same_result(got, exp, tag=""):
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(exp, f), (tag, f)


def assert_same_ledgers(port, ref):
    ps, rs = port.stats, ref.stats
    assert set(ps) == set(rs)                 # the stats schema is unchanged
    for k in LEDGER_KEYS:
        assert ps[k] == rs[k], (k, ps[k], rs[k])


def submit_all(server, cases):
    for a, b, cfg, dk in cases:
        server.submit(a, b, cfg=cfg, d_known=dk)


def run_both(cases, **server_kw):
    """cases: [(a, b, cfg, d_known)].  Returns (port server, port results,
    reference server, reference results) after asserting port == reference
    on every result field and every integer ledger."""
    port, ref = PortServer(device="cpu", **server_kw), RefServer(**server_kw)
    submit_all(port, cases)
    submit_all(ref, cases)
    got, exp = port.run(), ref.run()
    assert got.keys() == exp.keys()
    for sid in exp:
        assert_same_result(got[sid], exp[sid], sid)
    assert_same_ledgers(port, ref)
    return port, got, ref, exp


def assert_oracle(results, cases):
    """Port results == ``repro.core.pbs.reconcile`` per session."""
    for sid, (a, b, cfg, dk) in enumerate(cases):
        assert_same_result(results[sid], reconcile(a, b, cfg, d_known=dk), sid)
