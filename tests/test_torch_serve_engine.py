"""The port's ServeEngine against the JAX package's.

With the same parameters (JAX's ``init``, carried over by
``models.convert``) and the same prompts, the port's engine emits exactly
JAX's ``out_tokens``: greedy decoding is deterministic, mixed-length
prompts pooled equal each prompt served alone, and an empty prompt
decodes from a zero token (mirroring tests/test_pipeline_serving.py).
The telemetry cases mirror tests/test_streaming.py with a stub model: the
engine streams one row per decode tick into a ``StreamingViewService``
over a CPU ``ViewManager`` and answers its dashboard in one batched pass.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.core import Query, ViewDef
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.relational.plan import GroupByNode, Scan
from repro_torch.relational.relation import from_columns
from repro_torch.serving import Request, ServeEngine
from repro_torch.streaming import StreamConfig
from repro_torch.views import ViewManager


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    jm = jax_get_model(jax_get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg, device="cpu"), tp, cfg


def _serve(engine_cls, request_cls, model, params, max_batch, reqs, max_new, max_seq=64):
    eng = engine_cls(model, params, max_batch=max_batch, max_seq=max_seq)
    for i, p in reqs:
        eng.submit(request_cls(rid=i, prompt=p, max_new=max_new))
    return {r.rid: tuple(r.out_tokens) for r in eng.run()}


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma-2b"])
def test_engine_is_deterministic_and_emits_jax_tokens(arch):
    jm, jp, tm, tp, cfg = _models(arch)
    rng = np.random.default_rng(1)
    reqs = list(enumerate(rng.integers(0, cfg.vocab, 5).astype(np.int32) for _ in range(6)))
    a = _serve(ServeEngine, Request, tm, tp, 3, reqs, 4)
    b = _serve(ServeEngine, Request, tm, tp, 3, reqs, 4)
    assert len(a) == 6 and a == b
    assert all(len(v) == 5 for v in a.values())  # prefill argmax + 4 decode ticks
    assert a == _serve(jserving.ServeEngine, jserving.Request, jm, jp, 3, reqs, 4)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_moe_vlm_and_encdec_engines_emit_jax_tokens(arch):
    """The moe, vlm and encdec smoke configs through both engines: mixed
    prompt lengths (each tick decodes several position groups, so a MoE
    call routes rows outside its ``rows``; the vlm's first positions fall
    in the M-RoPE vision grid; the encdec cache holds a zero memory of
    length max_seq, as JAX's does), the same tokens."""
    jm, jp, tm, tp, cfg = _models(arch)
    rng = np.random.default_rng(3)
    reqs = list(enumerate(rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (2, 7, 4, 5, 1)))
    got = _serve(ServeEngine, Request, tm, tp, 3, reqs, 4, max_seq=32)
    assert len(got) == 5 and all(len(v) == 5 for v in got.values())
    assert got == _serve(jserving.ServeEngine, jserving.Request, jm, jp, 3, reqs, 4, max_seq=32)


class _PortLogits:
    """The port model's ``decode_step``, recording each call's (pos, rows,
    logits at rows)."""

    def __init__(self, model):
        self.inner, self.calls = model.decode_step, []

    def __call__(self, params, cache, tokens, pos, rows=None):
        logits, cache = self.inner(params, cache, tokens, pos, rows)
        self.calls.append((int(pos), list(rows), logits[list(rows)].numpy().copy()))
        return logits, cache


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_hybrid_and_ssm_engines_emit_jax_tokens_and_logits(arch):
    """The hybrid and ssm smoke configs through both engines: prompts of
    4–40 tokens in a pool of 3, so the slots decode at mixed positions past
    the hybrid's window of 16 and its ring wraps.  JAX's cache leaf
    ``attn_pos`` has no batch axis, so its engine keeps the newest decode's
    for every row; the port's ``decode_step(rows=...)`` writes it on every
    call.  Greedy tokens equal, and every decoded row's logits within the
    model tests' rtol 1e-4, atol 2e-5, call by call."""
    import dataclasses

    jm, jp, tm, tp, cfg = _models(arch)
    rng = np.random.default_rng(5)
    lens = (4, 40, 17, 9, 33)
    reqs = list(enumerate(rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens))
    probe = _PortLogits(tm)
    got = _serve(ServeEngine, Request, dataclasses.replace(tm, decode_step=probe), tp, 3, reqs, 6)
    jeng = jserving.ServeEngine(jm, jp, max_batch=3, max_seq=64)
    jdecode, jcalls = jeng._decode, []

    def recording(p, c, t, pos):
        logits, cache = jdecode(p, c, t, pos)
        jcalls.append((int(pos), np.asarray(logits)))
        return logits, cache

    jeng._decode = recording
    for i, p in reqs:
        jeng.submit(jserving.Request(rid=i, prompt=p, max_new=6))
    want = {r.rid: tuple(r.out_tokens) for r in jeng.run()}
    assert len(got) == 5 and all(len(v) == 7 for v in got.values())
    assert got == want
    assert [c[0] for c in probe.calls] == [c[0] for c in jcalls]
    assert max(pos for pos, _ in jcalls) >= max(lens)
    if cfg.family == "hybrid":
        positions = {pos for pos, rows, _ in probe.calls if len(rows) < 3}
        assert any(p > cfg.attn_window for p in positions)  # groups split past the window
    for (_pos, rows, lg), (_jpos, jlg) in zip(probe.calls, jcalls):
        np.testing.assert_allclose(lg, jlg[rows], rtol=1e-4, atol=2e-5)


def test_mixed_length_prompts_match_isolated_decode_and_jax():
    jm, jp, tm, tp, cfg = _models("granite-3-2b")
    rng = np.random.default_rng(7)
    reqs = list(enumerate(rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (2, 7, 4)))
    pooled = _serve(ServeEngine, Request, tm, tp, 3, reqs, 5)
    isolated = {}
    for r in reqs:
        isolated.update(_serve(ServeEngine, Request, tm, tp, 1, [r], 5))
    assert pooled == isolated
    assert pooled == _serve(jserving.ServeEngine, jserving.Request, jm, jp, 3, reqs, 5)


def test_queue_longer_than_pool_with_eos_and_max_seq():
    """Slots refill from the queue; a request stops at eos or when its
    cache is full, as in JAX."""
    jm, jp, tm, tp, cfg = _models("phi3-mini-3.8b")
    rng = np.random.default_rng(11)
    reqs = list(enumerate(rng.integers(0, cfg.vocab, n).astype(np.int32)
                          for n in (3, 9, 1, 12, 5, 2, 7)))
    outs = {}
    for engine_cls, request_cls, model, params in (
            (ServeEngine, Request, tm, tp), (jserving.ServeEngine, jserving.Request, jm, jp)):
        eng = engine_cls(model, params, max_batch=3, max_seq=16, eos_id=int(reqs[0][1][0]))
        for i, p in reqs:
            eng.submit(request_cls(rid=i, prompt=p, max_new=10))
        outs[engine_cls] = ({r.rid: tuple(r.out_tokens) for r in eng.run()}, eng.ticks)
    assert outs[ServeEngine] == outs[jserving.ServeEngine]
    assert len(outs[ServeEngine][0]) == len(reqs)


class _StubModel:
    """Minimal model: constant logits, empty cache."""

    vocab = 16
    device = torch.device("cpu")

    def init_cache(self, max_batch, max_seq):
        return {}

    def decode_step(self, params, cache, tokens, pos, rows=None):
        B, T = tokens.shape
        return torch.zeros((B, T, self.vocab)), cache


def test_admit_handles_empty_prompt():
    eng = ServeEngine(_StubModel(), params={}, max_batch=2, max_seq=8)
    eng.submit(Request(rid=0, prompt=np.array([], np.int32), max_new=3))
    eng.submit(Request(rid=1, prompt=np.array([1, 2], np.int32), max_new=3))
    by_rid = {r.rid: r for r in eng.run(max_ticks=20)}
    assert set(by_rid) == {0, 1}
    assert len(by_rid[0].out_tokens) == 3  # decode-only output
    assert len(by_rid[1].out_tokens) == 4  # prefill argmax + 3 decode ticks


# ---------------------------------------------------------------------------
# telemetry → streaming DeltaLog (tests/test_streaming.py's cases)
# ---------------------------------------------------------------------------

def _telemetry_service(aggs, tick_caps=64, base_rows=4):
    """tests/test_streaming.py's ServeLog (``base_rows`` idle ticks 0, 1, …)
    and serveView, a group-by on tickId, streamed without auto refresh."""
    vm = ViewManager(device="cpu")
    base = from_columns(
        {
            "tickId": np.arange(base_rows, dtype=np.int32),
            "active": np.zeros(base_rows, np.float32),
            "emitted": np.zeros(base_rows, np.float32),
            "queued": np.zeros(base_rows, np.float32),
        },
        pk=["tickId"],
        capacity=tick_caps,
        device="cpu",
    )
    vm.register_base("ServeLog", base)
    plan = GroupByNode(child=Scan("ServeLog", pk=("tickId",)), keys=("tickId",), aggs=aggs,
                       num_groups=tick_caps)
    vm.register_view(ViewDef("serveView", plan), delta_bases=("ServeLog",), m=1.0,
                     delta_group_capacity=tick_caps)
    return vm, vm.configure_streaming(
        StreamConfig(max_rows=10**9, max_age_s=1e9, auto_refresh=False))


def _run_stub(svc):
    eng = ServeEngine(_StubModel(), params={}, max_batch=2, max_seq=8, telemetry=svc,
                      telemetry_base="ServeLog")
    eng.submit(Request(rid=0, prompt=np.array([1, 2], np.int32), max_new=3))
    eng.run(max_ticks=10)
    return eng


def test_serve_engine_streams_telemetry():
    _, svc = _telemetry_service((("ticks", "count", None), ("tokens", "sum", "emitted")))
    eng = _run_stub(svc)
    assert eng.ticks == 3
    st = svc.staleness()
    assert st.pending_rows > 0  # ticks buffered in the DeltaLog
    svc.refresh()
    res = svc.query("serveView", Query(agg="sum", col="tokens"))
    assert float(res.value) == 3.0  # one token per tick
    assert res.staleness.pending_rows == 0


SUM_AGGS = (("active", "sum", "active"), ("emitted", "sum", "emitted"),
            ("queued", "sum", "queued"))


def test_streaming_query_batch_shares_one_snapshot():
    _, svc = _telemetry_service(SUM_AGGS)
    _run_stub(svc)
    svc.refresh()
    queries = [Query(agg="count"), Query(agg="sum", col="emitted"), Query(agg="avg", col="active")]
    batch = svc.query_batch("serveView", queries)
    assert len(batch) == len(queries)
    assert all(r.staleness is batch[0].staleness for r in batch)
    for q, r in zip(queries, batch):
        np.testing.assert_allclose(float(r.value), float(svc.query("serveView", q).value),
                                   rtol=1e-5)


def test_serve_engine_dashboard_is_batched():
    _, svc = _telemetry_service(SUM_AGGS)
    eng = _run_stub(svc)
    svc.refresh()
    dash = eng.dashboard()
    assert set(dash) == {"ticks", "avg_active", "tokens_emitted", "avg_queued"}
    # ticks 1..3 upsert onto the base's tickIds 0..3: one group per tickId
    assert float(dash["ticks"].value) == 4
    assert float(dash["tokens_emitted"].value) == eng.ticks
    assert len({id(v.staleness) for v in dash.values()}) == 1
    custom = eng.dashboard(queries={"n": Query(agg="count")})
    assert set(custom) == {"n"} and float(custom["n"].value) > 0
    panel = eng.dashboard("observatory")
    assert set(panel) >= {"metrics", "trace", "kernels", "staleness", "reconciliation"}
    assert panel["reconciliation"]["queries_ok"]
    assert panel["metrics"]["stream_refreshes"] >= 1.0
    with pytest.raises(RuntimeError, match="telemetry"):
        ServeEngine(_StubModel(), params={}, max_batch=1, max_seq=4).dashboard()


def test_smoke_model_serves_with_telemetry():
    """gemma-2b-smoke through the engine with telemetry: every tick lands
    in the view, and the dashboard counts what the engine emitted."""
    cfg = get_smoke_config("gemma-2b")
    model = get_model(cfg, device="cpu")
    _, svc = _telemetry_service(SUM_AGGS, base_rows=0)
    eng = ServeEngine(model, model.init(0), max_batch=4, max_seq=64, telemetry=svc)
    rng = np.random.default_rng(0)
    for rid, n in enumerate((3, 9, 5, 12, 4, 7)):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                           max_new=6))
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(len(r.out_tokens) == 7 for r in done)
    svc.refresh()
    dash = eng.dashboard()
    assert float(dash["ticks"].value) == eng.ticks  # an empty base: one group per tick
    assert float(dash["tokens_emitted"].value) == 6 * 6  # the decode ticks' tokens


def test_launcher_serves_on_the_cpu():
    from repro_torch.launch.serve import main

    out = main(["--smoke", "--device", "cpu"])
    assert out["completed"] == 16
    assert out["tokens"] == 16 * 13  # prefill argmax + 12 decode ticks each
    assert out["ticks"] > 0 and out["p50_latency_s"] > 0
    assert set(out) == {"completed", "tokens", "tok_per_s", "p50_latency_s", "ticks"}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "seamless-m4t-large-v2",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
def test_launcher_serves_the_moe_and_encdec_families_on_the_cpu(arch):
    from repro_torch.launch.serve import main

    out = main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert out["completed"] == 16
    assert out["tokens"] == 16 * 13
    assert out["ticks"] > 0 and out["p50_latency_s"] > 0
