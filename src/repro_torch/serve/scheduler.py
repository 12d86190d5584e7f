"""Batch scheduler for serving: bucketed prefill + decode loop.

Buckets requests by prompt length, packs them into the fixed decode batch,
runs the decode loop with a per-request done mask and collects the tokens.
Underfull batches are padded with a copy of the first request (left out of
the results).  ``run(extras=)`` adds the same inputs to every batch's
prefill, as the reference's does: ``"enc"`` (batch, enc_len, d), an
encoder-decoder's frames, or ``"frontend"``, a ``patch_stub`` model's
embeddings, whose shape (batch, T, d) fits one prompt length.  They are
moved to the mesh's device once a run.

One difference from the reference (``repro.serve.scheduler``): where the
model's layer plan holds a cache of ``max_len`` positions (``attn`` blocks'
KV caches, a ``dec`` block's self-attention cache, ``mla_dense`` and
``mla_moe`` blocks' latent caches), ``run``
refuses a request whose decode would write past it,
``len(prompt) + max_new - 1 > max_len``.  The reference checks only
``len(prompt) >= max_len``, and its decode then writes each position past
the end at that position modulo ``max_len``, over the oldest ones, so it
returns other tokens.  A plan of
recurrent and sliding-window blocks (``hybrid``, ``ssm``) keeps caches of a
fixed size that ``max_len`` does not bound: a state, conv rings and KV
rings of ``window`` slots.  There only the reference's check applies.

Across ranks (a ``LocalMesh`` of several ranks: every family) every rank
calls ``run`` with its own parameter shards, the same requests and the
same global ``extras`` (the engine's prefill keeps each rank's rows and
sequence chunk of them), and returns the same completions: each step's
token is global (the engine gathers it over the batch axes), so every rank
takes the same ``done`` and early-``break`` decisions.  A rank that broke
alone would leave the others waiting in their next collective.

Throughput accounting (prefill tokens, decode steps, wall time) is returned
with the completions.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.backbone import layer_plan
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import make_serve_fns


@dataclass
class Request:
    rid: int
    prompt: list            # token ids
    max_new: int = 16


@dataclass
class Completion:
    rid: int
    tokens: list
    finished: bool


@dataclass
class ServeStats:
    requests: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    wall_s: float = 0.0
    batches: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_steps / self.wall_s if self.wall_s else 0.0


class BatchScheduler:
    def __init__(self, cfg: ModelConfig, mesh, *, batch: int, max_len: int,
                 eos_id: int = 0, enc_len: int = 32):
        self.cfg = cfg
        self.mesh = mesh
        self.batch = batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.enc_len = enc_len
        # one bundle for every prompt length: the reference keeps one per
        # length because jit specializes on shape, the port's steps do not
        self._engine = make_serve_fns(cfg, mesh, batch=batch, max_len=max_len,
                                      enc_len=enc_len)
        # a cache of max_len positions bounds prompt + decoded positions
        self._bounded = any(kind in ("attn", "dec", "mla_dense", "mla_moe")
                            for kind, _, _ in layer_plan(cfg))

    def run(self, params, requests: list[Request], *, extras=None) -> tuple[dict, ServeStats]:
        """Serve all requests; returns ({rid: Completion}, stats).  ``extras``
        (numpy arrays or tensors) join every batch's prefill inputs.  Above
        one rank ``params`` are this rank's shards, and every rank passes
        the same ``requests``."""
        stats = ServeStats(requests=len(requests))
        t0 = time.perf_counter()
        extras = {k: torch.as_tensor(v, device=self.mesh.device)
                  for k, v in (extras or {}).items()}
        buckets: dict[int, list[Request]] = defaultdict(list)
        for r in requests:
            if len(r.prompt) >= self.max_len:
                raise ValueError(f"prompt {r.rid} longer than max_len")
            if self._bounded and len(r.prompt) + r.max_new - 1 > self.max_len:
                raise ValueError(
                    f"request {r.rid}: {len(r.prompt)} prompt + {r.max_new - 1} decoded "
                    f"positions exceed the {self.max_len}-position KV cache")
            buckets[len(r.prompt)].append(r)

        out: dict[int, Completion] = {}
        for plen, reqs in sorted(buckets.items()):
            for i in range(0, len(reqs), self.batch):
                chunk = reqs[i : i + self.batch]
                out.update(self._run_batch(params, chunk, plen, stats, extras))
                stats.batches += 1
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        stats.wall_s = time.perf_counter() - t0
        return out, stats

    def _run_batch(self, params, chunk: list[Request], plen: int,
                   stats: ServeStats, extras: dict) -> dict:
        sv = self._engine
        B = self.batch
        rows = chunk + [chunk[0]] * (B - len(chunk))     # pad with a copy
        toks = np.stack([np.asarray(r.prompt, np.int32) for r in rows])
        inputs = {"tokens": torch.from_numpy(toks).to(self.mesh.device), **extras}
        caches, tok = sv.prefill(params, inputs)
        stats.prefill_tokens += plen * len(chunk)

        max_new = max(r.max_new for r in chunk)
        arr = tok.cpu().numpy()
        gen = [[int(t)] for t in arr]
        done = np.array([int(t) == self.eos_id for t in arr])
        for _ in range(max_new - 1):
            if all(done[: len(chunk)]):
                break
            tok, caches = sv.decode(params, caches, tok[:, None])
            stats.decode_steps += int((~done[: len(chunk)]).sum())
            arr = tok.cpu().numpy()
            for b in range(B):
                if not done[b]:
                    gen[b].append(int(arr[b]))
                    if int(arr[b]) == self.eos_id or len(gen[b]) >= rows[b].max_new:
                        done[b] = True
        return {
            r.rid: Completion(r.rid, gen[b][: r.max_new],
                              finished=bool(done[b]))
            for b, r in enumerate(chunk)
        }
