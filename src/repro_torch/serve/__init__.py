"""Serving layer: prefill/decode step factories and cache specs; the batch
scheduler is ``serve.scheduler``."""
from .engine import (  # noqa: F401
    ServeBundle,
    abstract_cache,
    cache_spec,
    make_serve_fns,
)
