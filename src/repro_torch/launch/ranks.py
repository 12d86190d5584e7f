"""Start the ranks of a mesh as processes.

``run_ranks(fn, world, rdv_dir, device=..., backend=...)`` spawns ``world``
processes (``torch.multiprocessing``'s ``spawn`` context), joins them into
one ``torch.distributed`` process group through a ``file://`` rendezvous in
``rdv_dir`` (a directory of the caller's: no port to pick, so test workers
running side by side never meet), calls ``fn(device, *args)`` in each and
returns the ranks' results in rank order.  ``fn`` must be importable by
name (a module-level function), and so must its arguments and result.

The backend is decided by one rule (``choose_backend``) and never by
trying one and falling back:

* ``nccl`` where every rank has a card of its own (``world <=
  torch.cuda.device_count()``);
* ``gloo`` on the CPU, and for ranks that share a card, where the caller
  asks for it by name (``backend="gloo"``).

Rank ``r`` runs on ``cuda:(r % device_count)`` on the card (all on
``cuda:0`` where there is one), on the CPU with ``device="cpu"``.  A
rank's exception fails the whole call with every rank's traceback; ranks
that are not done after ``timeout`` seconds are killed and the call raises
``TimeoutError``, so a hang fails its caller instead of blocking it.  Where
every rank ends by ``SystemExit`` with one code (a simulated failure), the
call raises that ``SystemExit``.

This module and ``_child``, the children's entry point, import nothing but
torch and the standard library: a child imports what ``fn`` needs, and only
that.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def choose_backend(world: int, device="cuda", backend: str | None = None) -> str:
    """The process group's backend for ``world`` ranks on ``device``'s type
    (see the module docstring).  Raises ``ValueError`` where the rule names
    none: ranks sharing a card without ``backend="gloo"``, or NCCL asked
    for on the CPU or for ranks that would share a card."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA cards, not on the CPU")
        return "gloo"
    cards = torch.cuda.device_count()
    if backend == "gloo":
        return "gloo"
    if world <= cards:
        return "nccl"
    if backend == "nccl":
        raise ValueError(f"nccl needs a card per rank: {world} ranks, {cards} card(s)")
    raise ValueError(f"{world} ranks share {cards} card(s): pass backend='gloo' to run "
                     "them over host collectives")


def rank_device(rank: int, device) -> torch.device:
    """Where rank ``rank`` runs: the CPU, or card ``rank % device_count``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def _child(rank: int, world: int, init: str, backend: str, device, threads: int | None,
           out: str, fn, args: tuple) -> None:
    """A rank's entry point: join the group, run ``fn``, write its result
    (or its traceback) to ``out``."""
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    result = {"rank": rank}
    try:
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=timedelta(seconds=600))
        try:
            result["value"] = fn(dev, *args)
        finally:
            dist.destroy_process_group()
    except SystemExit as e:
        result["exit"] = e.code
    except BaseException:
        result["error"] = traceback.format_exc()
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    if "error" in result:
        raise SystemExit(1)


def run_ranks(fn, world: int, rdv_dir, *, device="cuda", backend: str | None = None,
              args: tuple = (), timeout: float = 120.0, threads: int | None = 1) -> list:
    """Run ``fn(device, *args)`` on ``world`` ranks (see the module
    docstring); returns their results in rank order.  ``threads``: each
    child's ``torch.set_num_threads`` (None leaves torch's default)."""
    backend = choose_backend(world, device, backend)
    rdv = Path(rdv_dir)
    rdv.mkdir(parents=True, exist_ok=True)
    store = rdv / "rendezvous"
    outs = [rdv / f"rank{r}.pkl" for r in range(world)]
    for p in [store, *outs]:
        p.unlink(missing_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world, f"file://{store}", backend, str(device), threads,
                               str(outs[r]), fn, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        # poll, so one rank's failure ends the others at once instead of
        # leaving them to wait in a collective until the deadline
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.02)
        late = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    results = []
    for r, path in enumerate(outs):
        if path.exists():
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        else:
            results.append({"rank": r, "missing": procs[r].exitcode})
    errors = [f"rank {r['rank']}:\n{r['error']}" for r in results if "error" in r]
    if errors:
        raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n" + "\n".join(errors))
    if late:
        raise TimeoutError(f"ranks {late} of {world} still running after {timeout} s")
    missing = {r["rank"]: r["missing"] for r in results if "missing" in r}
    if missing:
        raise RuntimeError(f"ranks ended with no result (rank: exit code): {missing}")
    exits = {r["exit"] for r in results if "exit" in r}
    if exits:
        if len(exits) == 1 and all("exit" in r for r in results):
            raise SystemExit(exits.pop())
        raise RuntimeError(f"ranks ended by SystemExit {sorted(map(str, exits))}, not all alike")
    return [r["value"] for r in results]
