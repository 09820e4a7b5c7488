"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX package's.

  * FLOPs parity: ``analysis["flops"]`` of the port's step traced on the
    meta device, at the smoke config of each family (dense, moe, vlm,
    encdec, hybrid, ssm), for the train step (one family also with 4
    microbatches) and for prefill and decode on the dense family, against
    ``hlo_analysis.analyze`` of ``jax.jit(step).lower(...).compile()`` on
    one CPU device, within 1% (the tolerance of JAX's own analyzer test,
    ``tests/test_dryrun_artifacts.py``);
  * the sLSTM loop counted once and multiplied (``obs.opcount.repeated``)
    against the same step run step by step on CPU tensors;
  * the record schema and ``shape_applicable``'s skips over the full
    10 × 4 × 2 matrix, the statuses from ``run_cell`` on each arch's smoke
    config; one full-size cell (gemma-2b × decode_32k × single);
  * the flash wrapper on meta: shape and dtype, ``launches`` unmoved, and
    a ``cuda:1`` tensor (a fake tensor here) still raises.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils.checkpoint

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro.models.api import get_model as jax_get_model
from repro.training.optim import AdamWConfig as JaxAdamWConfig
from repro.training.train_step import init_train_state as jax_init_train_state
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import ALL_SHAPES, ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ShapeCell, shape_applicable
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models.api import get_model
from repro_torch.obs import opcount
from repro_torch.training import AdamWConfig, init_train_state, make_train_step

FLOPS_RTOL = 0.01
ONE = LocalMesh(["meta"], {"data": 1, "model": 1})
FAMILY_ARCHS = {"dense": "gemma-2b", "moe": "granite-moe-3b-a800m", "vlm": "qwen2-vl-72b",
                "encdec": "seamless-m4t-large-v2", "hybrid": "recurrentgemma-9b",
                "ssm": "xlstm-1.3b"}
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "chips", "params",
               "status"}
OK_KEYS = {"total_s", "trace_s", "microbatches", "memory_analysis", "analysis", "analysis_global",
           "per_device_rule"}
ANALYSIS_KEYS = {"flops", "flops_aside", "memory_bytes", "peak_live_bytes", "output_bytes",
                 "collective_bytes", "collectives", "loop_multipliers", "split", "dispatches"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batch(cfg, B, S, decode=False):
    s = 1 if decode else S
    b = {"tokens": jax.ShapeDtypeStruct((B, s), jnp.int32),
         "labels": jax.ShapeDtypeStruct((B, s), jnp.int32),
         "domain": jax.ShapeDtypeStruct((B,), jnp.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = jax.ShapeDtypeStruct((B, cfg.n_vision_tokens, 1024), jnp.float32)
    if cfg.family == "encdec":
        b["frames"] = jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.float32)
    return b


def _jax_flops(arch, cell, microbatches):
    """JAX's dry-run figure for the smoke config's step on one CPU device."""
    cfg = jax_get_smoke_config(arch)
    m = jax_get_model(cfg)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        state = jax.eval_shape(lambda k: jax_init_train_state(m, k), jax.random.PRNGKey(0))
        low = jax.jit(jax_make_train_step(m, JaxAdamWConfig(), microbatches=microbatches)).lower(
            state, _jax_batch(cfg, B, S))
    else:
        params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
        if cell.kind == "prefill":
            low = jax.jit(lambda p, b: m.prefill(p, b, cache_len=S)).lower(
                params, _jax_batch(cfg, B, S))
        else:
            cache = jax.eval_shape(lambda: m.init_cache(B, S))
            low = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos)).lower(
                params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
    return hlo_analyze(low.compile().as_text())["flops"]


PARITY = ([(fam, "train", 1) for fam in FAMILY_ARCHS]
          + [("dense", "train", 4), ("dense", "prefill", 1), ("dense", "decode", 1)])


@pytest.mark.parametrize("family,kind,microbatches", PARITY,
                         ids=[f"{f}-{k}-mb{m}" for f, k, m in PARITY])
def test_flops_match_jax_hlo_analysis(family, kind, microbatches):
    arch = FAMILY_ARCHS[family]
    cell = ShapeCell("parity", 64, 8, kind)
    rec = dryrun.trace_cell(get_smoke_config(arch), cell, ONE, False, microbatches)
    got, want = rec["analysis"]["flops"], _jax_flops(arch, cell, microbatches)
    assert abs(got - want) / want < FLOPS_RTOL, (got, want)
    if kind == "train":  # the plain backward's recompute is counted apart
        assert (rec["analysis"]["flops_aside"] > 0) == (family != "ssm")
        assert rec["analysis"]["loop_multipliers"].get("microbatches", 1) == microbatches


def test_mlstm_chunks_skip_the_masked_key_blocks():
    """At S = 512 (two chunks of ``CHUNK``) JAX's mLSTM scans its query
    chunks, each against all S keys; the port's chunk i reads the keys up
    to its last query, (i + 1)·C.  The port's step counts JAX's less the
    skipped (query, key) pairs, C²·n(n−1)/2 of them, in the two score
    products of each mLSTM layer, each forward and in both gradients."""
    from repro_torch.models.xlstm import CHUNK, head_dim
    arch = FAMILY_ARCHS["ssm"]
    cfg = get_smoke_config(arch)
    cell = ShapeCell("parity", 2 * CHUNK, 2, "train")
    rec = dryrun.trace_cell(cfg, cell, ONE, False, 1)
    got, want = rec["analysis"]["flops"], _jax_flops(arch, cell, 1)
    n = cell.seq_len // CHUNK
    pairs = CHUNK * CHUNK * n * (n - 1) // 2
    n_mlstm = cfg.n_layers - cfg.n_layers // cfg.slstm_every
    passes = 3 + (cfg.remat != "none")
    skipped = cell.global_batch * n_mlstm * passes * 2 * 2 * cfg.mlstm_heads * head_dim(cfg) * pairs
    assert abs(got - (want - skipped)) / want < FLOPS_RTOL, (got, want, skipped)


def _step_flops(cfg, B, S, device):
    """FLOPs of one train step of ``cfg`` at (B, S) on ``device`` (the state
    drawn on the CPU; on meta, built)."""
    model = get_model(cfg, device, train=True)
    state = init_train_state(model)
    batch = {k: torch.zeros(shape, dtype=torch.int32, device=device)
             for k, shape in (("tokens", (B, S)), ("labels", (B, S)), ("domain", (B,)))}
    step = make_train_step(model, AdamWConfig())
    _, figures = op_analysis.analyze(step, state, batch)
    return figures


def test_slstm_loop_counted_once_equals_the_unrolled_loop():
    """The meta step counts one sLSTM step S times, its carry's gradient
    included at every trip, as JAX's scan transposes; the CPU loop's first
    step has no carry gradient (its state is zeros that need none), one
    (B, 4, d/4) × (4, d/4, d) product a sLSTM layer fewer."""
    cfg = get_smoke_config("xlstm-1.3b")
    B, S = 2, 64
    meta = _step_flops(cfg, B, S, "meta")
    cpu = _step_flops(cfg, B, S, "cpu")
    n_slstm = cfg.n_layers // cfg.slstm_every
    assert meta["loop_multipliers"] == {"slstm_time": S}
    assert cpu["loop_multipliers"] == {}
    assert meta["flops"] == cpu["flops"] + n_slstm * 2 * B * cfg.d_model ** 2
    assert cpu["dispatches"] > meta["dispatches"] + S


def test_repeated_counts_forward_and_backward_and_aside_sets_apart():
    w = torch.empty((8, 8), device="meta", requires_grad=True)
    x = torch.empty((4, 8), device="meta", requires_grad=True)

    def body():
        y = opcount.repeated(lambda a, b: a @ b, 5, x, w, name="loop")[0]
        with opcount.aside():
            _ = x @ w
        y.sum().backward()

    _, fig = op_analysis.analyze(body)
    one = 2 * 4 * 8 * 8
    assert fig["flops"] == 5 * 3 * one  # forward and the two gradient products
    assert fig["flops_aside"] == one
    assert fig["loop_multipliers"] == {"loop": 5}

    def remat():  # the loop last in a checkpoint, nothing saved after it
        def region(a):
            return opcount.repeated(lambda a, b: a @ b, 5, torch.sin(a), w, name="loop")[0]
        torch.utils.checkpoint.checkpoint(region, x, use_reentrant=False).sum().backward()

    _, fig = op_analysis.analyze(remat)
    assert fig["flops"] == 5 * 4 * one  # and the recompute of the forward
    with pytest.raises(ValueError, match="meta"):
        opcount.repeated(lambda a: a, 2, torch.zeros(1))


def test_matrix_schema_and_spec_skips(tmp_path, monkeypatch):
    """``run_cell`` over every (arch × shape × mesh) of the production
    matrix, each arch at its smoke config: 80 records, the long_500k cells
    of the full-attention archs skipped by name, every other cell ok."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(S, "get_config", get_smoke_config)
    recs = []
    for arch in ARCH_IDS:
        for cell in ALL_SHAPES:
            for multi in (False, True):
                recs.append(dryrun.run_cell(arch, cell, multi, str(tmp_path)))
    assert len(list(tmp_path.glob("*.json"))) == len(recs) == 80
    skipped = [(r["arch"], r["shape"]) for r in recs if r["status"] == "skipped"]
    assert len(skipped) == 16
    for r in recs:
        assert RECORD_KEYS <= set(r), r.get("error")
        ok, reason = shape_applicable(get_config(r["arch"]), next(
            c for c in ALL_SHAPES if c.name == r["shape"]))
        if not ok:
            assert r["status"] == "skipped" and r["skip_reason"] == reason
            assert r["shape"] == "long_500k" and not get_config(r["arch"]).sub_quadratic
            continue
        assert r["status"] == "ok", (r["arch"], r["shape"], r.get("error"))
        assert OK_KEYS <= set(r) and ANALYSIS_KEYS <= set(r["analysis"])
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert r["analysis"]["flops"] > 0 and r["analysis"]["memory_bytes"] > 0
        assert r["memory_analysis"]["argument_size_in_bytes"] > 0
        assert r["memory_analysis"]["temp_size_in_bytes"] >= 0
    path = tmp_path / "gemma-2b__train_4k__single.json"
    assert json.loads(path.read_text())["status"] == "ok"


def test_error_cell_is_recorded_and_fails_the_cli(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    rec = dryrun.run_cell("gemma-2b", ALL_SHAPES[0], False, str(tmp_path))
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: injected"
    assert "injected" in rec["traceback"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert e.value.code == 1


def test_full_size_decode_cell_on_meta(tmp_path):
    """gemma-2b × decode_32k × single at its published size: arguments are
    the TP-resident bf16 weights (it fits) and the cache, per device."""
    cell = next(c for c in ALL_SHAPES if c.name == "decode_32k")
    rec = dryrun.run_cell("gemma-2b", cell, False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("gemma-2b")
    # one KV head does not split over model: the cache's time axis does
    cache = 2 * cfg.n_layers * (cell.global_batch // 16) * (cell.seq_len // 16) * cfg.head_dim * 2
    tokens = (cell.global_batch // 16) * 4
    weights = rec["memory_analysis"]["argument_size_in_bytes"] - cache - tokens
    bf16_tp = rec["params"]["total"] * 2 / 16
    assert abs(weights - bf16_tp) / bf16_tp < 0.01, (weights, bf16_tp)
    a = rec["analysis"]
    tokens = cell.global_batch // 16
    assert a["flops"] > 2 * rec["params"]["non_embed"] * tokens / 16
    assert a["collectives"]["all-gather"] == 0  # TP-resident: nothing gathered over data
    assert a["loop_multipliers"] == {}


def test_flash_wrapper_on_meta_takes_the_plain_version():
    from torch._subclasses.fake_tensor import FakeTensorMode

    q = torch.empty((2, 5, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 7, 2, 16), dtype=torch.bfloat16, device="meta")
    before = flash_attention.launches
    for kw in ({}, {"causal": False}, {"window": 3}):
        out = flash_attention(q, k, k, **kw)
        assert out.device.type == "meta" and out.dtype == q.dtype
        assert tuple(out.shape) == (2, 5, 4, 16)
    ring = flash_attention(q[:, :1], k, k, key_pos=torch.empty(7, dtype=torch.int32,
                                                                 device="meta"), qpos=9, window=4)
    assert tuple(ring.shape) == (2, 1, 4, 16)
    assert flash_attention.launches == before
    with FakeTensorMode(allow_non_fake_inputs=True):
        qc = torch.empty((1, 4, 2, 16), device="cuda:1")
        with pytest.raises(ValueError, match="cuda:1 is not a visible CUDA device"):
            flash_attention(qc, qc, qc)
