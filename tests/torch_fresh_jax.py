"""Make the JAX package trace afresh before a profiled comparison.

JAX's kernel profiler (``repro.obs.kprof.profiled``) records a dispatch
that sits inside a jitted function only while that function is traced.
Several of the JAX package's jitted builders are also ``functools.
lru_cache``-d on hashable specs, so a test that built the same fixture
earlier in the process (another test file on the same pytest-xdist
worker) leaves the trace cached, and a later profiled run records none of
those dispatches.  ``fresh_jax_traces()`` empties JAX's own caches and
every such builder cache, so the next call traces, and profiles, again.
"""

from __future__ import annotations

import jax

# (module, name) of every lru_cache in src/repro that wraps a jitted builder
JITTED_BUILDER_CACHES = (
    ("repro.core.maintenance", "_fused_eval_fn"),
    ("repro.core.maintenance", "_fleet_assemble_fn"),
    ("repro.core.outliers", "_topk_merge_fn"),
    ("repro.relational.execute", "_jitted_executor"),
)


def fresh_jax_traces() -> None:
    """``jax.clear_caches()`` and ``cache_clear()`` on each cache of
    ``JITTED_BUILDER_CACHES``."""
    import importlib

    jax.clear_caches()
    for module, name in JITTED_BUILDER_CACHES:
        getattr(importlib.import_module(module), name).cache_clear()
