"""The port's token pipeline and SVC loss view against the JAX package's.

``TokenPipeline`` draws its batches with numpy exactly as JAX's does, so
tokens, labels and domains are equal bit for bit, under the uniform
mixture and after ``set_mixture``.  ``PipelineStats`` over the same
ingests and refreshes gives the same per-domain estimates and confidence
intervals within 1e-5 relative (float32 group sums in other orders) and
the same sample: its hash is bit-identical to JAX's, so the cleaned view
holds the same statIds.  After ``full_maintenance`` both answer exactly.
"""

import numpy as np
import pytest
import torch

from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import PipelineStats as JPipelineStats
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro_torch.data.pipeline import LOSS_VIEW, PipelineConfig, PipelineStats, TokenPipeline


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 8, 5), (256_000, 512, 8, 0),
                                                  (50, 7, 3, 11)])
def test_batches_equal_jax_token_for_token(vocab, seq, batch, seed):
    jp = JTokenPipeline(JPipelineConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed))
    tp = TokenPipeline(PipelineConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed),
                       device="cpu")
    w = np.random.default_rng(seed).uniform(0.1, 1.0, 16)
    for step in range(4):
        if step == 2:
            jp.set_mixture(w)
            tp.set_mixture(w)
        want, got = jp.batch(step), tp.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_batches_are_deterministic_and_shifted():
    cfg = PipelineConfig(vocab=512, seq_len=32, global_batch=8, seed=5)
    a, b = TokenPipeline(cfg, device="cpu"), TokenPipeline(cfg, device="cpu")
    x, y = a.batch(3), b.batch(3)
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["labels"][:, :-1], x["tokens"][:, 1:])
    w = np.zeros(cfg.n_domains)
    w[0] = 1.0
    a.set_mixture(w)
    assert bool((a.batch(4)["domain"] == 0).all())


def _feed(n_steps, seed):
    rng = np.random.default_rng(seed)
    for step in range(n_steps):
        counts = rng.integers(0, 4, 16).astype(np.float32)
        yield step, (counts * rng.uniform(1, 5, 16)).astype(np.float32), counts


@pytest.mark.parametrize("m,refresh_every", [(0.25, 2), (0.5, 5)])
def test_stats_estimates_and_cis_match_jax(m, refresh_every):
    js = JPipelineStats(n_domains=16, m=m, seed=2)
    ts = PipelineStats(n_domains=16, m=m, seed=2, device="cpu")
    for step, sums, counts in _feed(12, int(m * 100)):
        js.ingest_step(sums, counts)
        ts.ingest_step(torch.from_numpy(sums), counts)  # tensors or arrays
        if step > 0 and step % refresh_every == 0:
            js.svc_refresh()
            ts.svc_refresh()
            jv, tv = js.vm.views[LOSS_VIEW], ts.vm.views[LOSS_VIEW]
            jkeys = np.asarray(jv.clean_sample.col("statId"))[np.asarray(jv.clean_sample.valid)]
            tkeys = tv.clean_sample.col("statId")[tv.clean_sample.valid].numpy()
            assert sorted(jkeys.tolist()) == sorted(tkeys.tolist())
            for d in range(16):
                (je, (jlo, jhi)), (te, (tlo, thi)) = js.loss_estimate(d), ts.loss_estimate(d)
                np.testing.assert_allclose([te, tlo, thi], [je, jlo, jhi], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(ts.mixture_weights(), js.mixture_weights(), rtol=1e-5)
    js.full_maintenance()
    ts.full_maintenance()
    for d in range(16):
        for q in ts.domain_queries(d):
            assert float(ts.vm.query_stale(LOSS_VIEW, q)) == float(
                ts.vm.query_exact_fresh(LOSS_VIEW, q))
        np.testing.assert_allclose(ts.loss_estimate(d)[0], js.loss_estimate(d)[0], rtol=1e-6)


def test_stats_track_true_means():
    """JAX's ``tests/test_pipeline_serving.py`` check, on the port."""
    stats = PipelineStats(n_domains=4, m=0.5, seed=2, device="cpu")
    rng = np.random.default_rng(0)
    true_means = np.array([1.0, 2.0, 3.0, 4.0])
    for _ in range(30):
        counts = rng.integers(5, 15, 4).astype(np.float32)
        sums = (true_means * counts + rng.normal(0, 0.1, 4)).astype(np.float32)
        stats.ingest_step(sums, counts)
    stats.svc_refresh()
    for d in range(4):
        est, _ = stats.loss_estimate(d)
        assert abs(est - true_means[d]) < 0.5, (d, est)
    w = stats.mixture_weights()
    assert w[3] > w[0]


def test_stats_and_pipeline_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        PipelineStats()
