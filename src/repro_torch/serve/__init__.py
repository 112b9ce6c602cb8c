"""Public serving API of the port (the names of ``repro.serve`` that exist
here so far): import from ``repro_torch.serve``, not the implementation
modules.

Engine / generation: :class:`BatchingEngine`, :class:`Request`,
:func:`generate`, :class:`SampleCfg`, :func:`make_prefill_step`,
:func:`make_decode_step`.  Cache construction and contracts:
:func:`make_cache`, :func:`cache_specs`, :func:`advance_meta` ->
:class:`CacheWrite`, :func:`update_kv_cache`, :class:`CacheOverflowError`.
"""
from repro_torch.serve._cache import (
    CacheOverflowError,
    CacheWrite,
    advance_meta,
    cache_specs,
    update_kv_cache,
)
from repro_torch.serve._engine import (
    BatchingEngine,
    Request,
    SampleCfg,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
)

__all__ = [
    "BatchingEngine",
    "CacheOverflowError",
    "CacheWrite",
    "Request",
    "SampleCfg",
    "advance_meta",
    "cache_specs",
    "generate",
    "make_cache",
    "make_decode_step",
    "make_prefill_step",
    "update_kv_cache",
]
