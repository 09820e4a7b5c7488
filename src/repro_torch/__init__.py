"""SVC (Stale View Cleaning) on PyTorch and CUDA: the port of ``repro``.

The single-view SVC loop — register a view, ingest deltas, clean the hash
sample (``ViewManager.svc_refresh``), answer queries with confidence
intervals (``query``/``query_batch``), pin skewed groups with an outlier
index — the fleet control plane, streaming ingest, and the LM serving
stack that feeds SVC its telemetry (``models``, ``serving.ServeEngine``)
run on a CUDA device through hand-written kernels (``kernels/``, sources
in ``csrc/``).  Every entry point runs on the card
unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version stands in.  This package imports neither ``jax`` nor
``repro``.
"""
