"""Blockchain transaction relay (the paper's §1.3.4) on the PyTorch/CUDA
port, as a multi-peer serving topology (DESIGN.md §10).

The twin of ``examples/blockchain_relay.py`` on ``repro_torch``: one relay
node holds the canonical mempool and serves N downstream peers at once
through a ``repro_torch.net.HubEndpoint`` on the relay's device.  Every
peer is a real ``AliceEndpoint`` exchanging mux-enveloped wire bytes over
its own transport (three in-memory pipes and one genuine TCP loopback
socket below), and the relay fuses all peers' per-round work into shared
cohort kernel launches — one element-store upload and 2 encode + 1 decode
launches per cohort-round for the whole peer set, not per peer.

Each peer's mempool has diverged from the relay's (missed broadcasts both
ways, the Erlay [31] setting); each peer learns its full symmetric
difference, per peer byte-identical to what a dedicated pair of endpoints
would have measured.

With ``--epochs N`` (default 3) the relay keeps serving: mempools churn —
blocks mine txids out, fresh ones gossip in on both ends — and each epoch
reconciles only the drift over the SAME sessions, channels, and
device-resident stores (DESIGN.md §11): the ``MSG_EPOCH`` handshake
re-syncs d̂, and the stores take an O(churn) in-place delta patch instead
of a rebuild (the per-epoch ledger below shows delta-H2D bytes and
rebuild counts).

Run:  PYTHONPATH=src python examples/blockchain_relay_torch.py [--epochs N] [--device cpu]
(default device: the CUDA card.)
"""
import argparse
import pathlib
import sys
import time

if __name__ == "__main__":  # standalone: make src/ importable
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.pbs import PBSConfig, true_diff
from repro_torch.core.simdata import random_set
from repro_torch.kernels.platform import resolve_device
from repro_torch.net import (
    AliceEndpoint,
    HubEndpoint,
    InMemoryDuplex,
    run_hub,
    run_hub_epoch,
    tcp_loopback_pair,
)
from repro_torch.recon.session import apply_churn

N_PEERS = 4
MEMPOOL = 12_000             # txids in the relay's canonical mempool
CHURN = 150                  # per direction, per peer (admission epoch)
EPOCH_CHURN = 75             # mempool drift per side between epochs


def diverged_mempool(relay_pool: np.ndarray, rng: np.random.Generator):
    """A peer's view: missed CHURN of the relay's txs, saw CHURN fresh ones."""
    missed = rng.permutation(len(relay_pool))[:CHURN]
    fresh = random_set(CHURN, rng)
    peer = np.concatenate([np.delete(relay_pool, missed), fresh])
    return np.unique(peer)


def main(device=None, epochs: int = 3):
    """Serve the relay on ``device`` (None: the card, and raise without one)
    for ``epochs`` epochs.  Returns one row per epoch (``_epoch_row``),
    each with the peers' configs under ``cfgs``."""
    device = resolve_device(device)
    rng = np.random.default_rng(1)
    relay_pool = random_set(MEMPOOL, rng)

    hub = HubEndpoint(recv_deadline=300.0, continuous=True, device=device)
    alices, pools, cfgs, links = {}, {}, {}, []
    for p in range(N_PEERS):
        peer_pool = diverged_mempool(relay_pool, rng)
        d = len(true_diff(peer_pool, relay_pool))
        # the last peer connects over a real TCP loopback socket
        ta, tb = (
            tcp_loopback_pair() if p == N_PEERS - 1 else InMemoryDuplex.pair()
        )
        links += [ta, tb]
        cfg = PBSConfig(seed=3 + p)
        ch = hub.add_peer(tb, label=f"peer{p}")
        hub.submit(ch, relay_pool, cfg=cfg)          # estimator path: d unknown
        ep = AliceEndpoint(ta, channel=ch, continuous=True, device=device)
        ep.submit(peer_pool, cfg=cfg)
        alices[ch], cfgs[ch] = ep, cfg
        pools[ch] = (peer_pool, d, "tcp" if p == N_PEERS - 1 else "mem")
    try:
        rows = _serve(hub, alices, pools, relay_pool, rng, epochs)
    finally:
        for t in links:
            t.close()
    for row in rows:
        row["cfgs"] = cfgs
    return rows


def _serve(hub, alices, pools, relay_pool, rng, epochs):
    print(f"relay mempool |B|={MEMPOOL:,} on {hub.device}; "
          f"serving {N_PEERS} diverged peers")
    t0 = time.perf_counter()
    outcomes, results, errors = run_hub(hub, alices)
    wall = time.perf_counter() - t0
    assert not errors, errors

    print(f"\n{'ch':>3} {'link':<4} {'d':>4} {'rounds':>6} {'wire B':>7} "
          f"{'est B':>6} {'vs INV':>7}  exact")
    total_pbs = total_inv = 0
    for ch, (peer_pool, d, link) in pools.items():
        r = results[ch][0]
        assert r.success and r.diff == true_diff(peer_pool, relay_pool)
        assert outcomes[ch].ok and outcomes[ch].verified == [True]
        inv = 4 * d            # ideal INV: one 4-byte announcement per diff
        total_pbs += r.bytes_sent
        total_inv += inv
        print(f"{ch:>3} {link:<4} {d:>4} {r.rounds:>6} {r.bytes_sent:>7,} "
              f"{r.estimator_bytes:>6} {r.bytes_sent / inv:>6.2f}x  ok")

    naive = 4 * MEMPOOL * N_PEERS
    st = hub.stats
    print(f"\nrelay served {N_PEERS} peers in {wall:.1f}s "
          f"({N_PEERS / wall:.2f} peers/s)")
    print(f"  fusion: {st['store_uploads']} store upload(s) for "
          f"{st['cohort_rounds']} cohort-rounds, "
          f"{st['kernel_launches']} encode + {st['decode_launches']} decode "
          f"launches shared across all peers")
    print(f"  bytes: {total_pbs:,} B PBS vs {naive:,} B full announcement "
          f"({naive / total_pbs:.0f}x saved), {total_pbs / total_inv:.2f}x "
          f"the ideal INV minimum")
    mux = sum(
        o.wire_stats["mux_bytes_in"] + o.wire_stats["mux_bytes_out"]
        for o in outcomes.values()
    )
    print(f"  multiplexing overhead: {mux:,} B of MSG_MUX envelopes "
          f"({100 * mux / max(1, total_pbs):.1f}% of protocol bytes)")
    rows = [_epoch_row(0, hub, alices, outcomes, results, relay_pool, wall,
                       {ch: pools[ch][0] for ch in alices}, None)]

    # ---- continuous sync: the mempool keeps churning (DESIGN.md §11) ----
    if epochs <= 1:
        return rows
    peer_churn = EPOCH_CHURN // 2
    d_nom = 2 * (EPOCH_CHURN + peer_churn)   # the relay's churn budget
    store_bytes = hub._batch.store_upload_bytes()
    print(f"\ncontinuous sync: {epochs - 1} more epochs of mempool "
          f"churn ({EPOCH_CHURN} txids/side relay, {peer_churn}/side peer; "
          f"resident stores = {store_bytes:,} B)")
    print(f"{'epoch':>5} {'d tot':>6} {'wire B':>8} {'B/diff':>7} "
          f"{'delta-H2D':>9} {'rebuilds':>8} {'wall s':>7}")
    for e in range(1, epochs):
        mined = rng.permutation(relay_pool)[:EPOCH_CHURN]
        fresh = random_set(EPOCH_CHURN, rng)
        relay_pool = apply_churn(relay_pool, fresh, mined)
        hub_muts, peer_pools = {}, {}
        for ch, ep in alices.items():
            hub_muts[ch] = {0: (fresh, mined)}
            # the peer converged to the relay's previous pool, then drifts
            peer_pool = ep.sessions[0].state.a
            peer_mined = rng.permutation(peer_pool)[:peer_churn]
            peer_fresh = random_set(peer_churn, rng)
            ep.advance_epoch({0: (peer_fresh, peer_mined)},
                             d_known={0: d_nom})
        hub.advance_epoch(hub_muts, d_known={
            ch: {0: d_nom} for ch in alices
        })
        t0 = time.perf_counter()
        outcomes, results, errors = run_hub_epoch(hub, alices)
        wall = time.perf_counter() - t0
        assert not errors, errors
        st = hub.stats
        d_tot = wire = 0
        for ch, ep in alices.items():
            r = results[ch][0]
            peer_pools[ch] = ep.sessions[0].state.a
            assert r.success and outcomes[ch].verified == [True]
            assert r.diff == true_diff(peer_pools[ch], relay_pool)
            d_tot += len(r.diff)
            wire += r.bytes_sent
        print(f"{e:>5} {d_tot:>6} {wire:>8,} {wire / max(1, d_tot):>7.2f} "
              f"{st['h2d_delta_bytes']:>9,} {st['store_builds']:>8} "
              f"{wall:>7.2f}")
        rows.append(_epoch_row(e, hub, alices, outcomes, results, relay_pool, wall,
                               peer_pools, d_nom))
    print("  (epoch 1 re-plans the pinned churn-budget code — one counted "
          "rebuild; every later epoch is a pure O(churn) delta patch)")
    return rows


def _epoch_row(epoch, hub, alices, outcomes, results, relay_pool, wall, peer_pools,
               d_known):
    """One epoch's record: the relay's pool and the d the epoch was planned
    for (None: estimated), per channel the result, the peer's pool and the
    outcome's wire ledger; the hub's stats."""
    return {"epoch": epoch, "wall_s": wall, "relay_pool": relay_pool,
            "peer_pools": peer_pools, "d_known": d_known,
            "results": {ch: results[ch][0] for ch in alices},
            "wire_stats": {ch: outcomes[ch].wire_stats for ch in alices},
            "stats": dict(hub.stats)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3,
                    help="total reconciliation epochs (1 = one-shot relay)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(args.device, args.epochs)
