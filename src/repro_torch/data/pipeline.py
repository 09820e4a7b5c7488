"""Synthetic token pipeline with SVC-maintained statistics views: the port
of ``repro.data.pipeline``.

The pipeline is deterministic: token content is a pure function of
(domain, sequence id), so any host can regenerate any batch, and the
pipeline's state is the step counter and the mixture weights.  Batches are
drawn with numpy exactly as JAX's are (token for token) and handed over as
int32 tensors on the pipeline's device.

SVC integration (the paper's technique on training telemetry):
  * every train step emits per-domain (loss_sum, count) deltas;
  * a ``StepStats`` fact table ingests them; the per-domain loss view is
    FULL-maintained only at checkpoint cadence, while ``svc_refresh``
    keeps its hash sample fresh every few steps;
  * the mixture controller re-weights domain sampling from the fresh,
    bounded SVC estimates: monitoring never waits for IVM.

The view lives in a ``ViewManager`` on the trainer's device, so on the
card its group-bys run segment_aggsum and its clean the hash_threshold
kernel (a ``max`` aggregate keeps it off the fused clean).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import Query, ViewDef
from repro_torch.relational.expr import Cmp, Col, Lit
from repro_torch.relational.plan import GroupByNode, Scan
from repro_torch.relational.relation import from_columns
from repro_torch.views import ViewManager

N_DOMAINS = 16


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_domains: int = N_DOMAINS
    seed: int = 0


class TokenPipeline:
    """Deterministic mixture-of-domains synthetic corpus."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mixture = np.ones(cfg.n_domains, np.float64) / cfg.n_domains
        # per-domain unigram tables make domains statistically distinct so
        # per-domain loss actually differs (drives the mixture controller)
        rng = np.random.default_rng(cfg.seed)
        self._domain_bias = rng.integers(0, cfg.vocab, size=cfg.n_domains)
        self._domain_spread = rng.integers(50, max(51, cfg.vocab // 2), size=cfg.n_domains)

    def set_mixture(self, w) -> None:
        w = np.asarray(w, np.float64)
        self.mixture = w / w.sum()

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch on the pipeline's device: tokens and
        next-token labels (B, S) int32, domain (B,) int32."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        dom = rng.choice(cfg.n_domains, size=cfg.global_batch, p=self.mixture)
        tokens = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
        for i, d in enumerate(dom):
            r = np.random.default_rng((cfg.seed, step, int(d), i))
            tokens[i] = (
                self._domain_bias[d]
                + r.integers(0, self._domain_spread[d], size=cfg.seq_len)
            ) % cfg.vocab
        labels = np.roll(tokens, -1, axis=1)
        host = {"tokens": tokens, "labels": labels, "domain": dom.astype(np.int32)}
        return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}


# ---------------------------------------------------------------------------
# SVC-maintained statistics views
# ---------------------------------------------------------------------------

LOSS_VIEW = "domainLossView"


class PipelineStats:
    """StepStats fact table + SVC-managed per-domain loss view."""

    def __init__(self, n_domains: int = N_DOMAINS, m: float = 0.25, seed: int = 0,
                 capacity: int = 1 << 14, device="cuda"):
        self.n_domains = n_domains
        self.vm = ViewManager(device=device)
        self.device = self.vm.device
        self._next_id = 0
        empty = from_columns(
            {
                "statId": np.zeros(0, np.int32),
                "domain": np.zeros(0, np.int32),
                "loss_sum": np.zeros(0, np.float32),
                "count": np.zeros(0, np.float32),
            },
            pk=["statId"],
            capacity=capacity,
            device=self.device,
        )
        self.vm.register_base("StepStats", empty)
        # keyed by statId (one row per ingested stat record): high
        # cardinality, which is what makes the view *suitable for sampling*
        # — the paper excludes small-cardinality views (App. 12.6.4).
        plan = GroupByNode(
            child=Scan("StepStats", pk=("statId",)),
            keys=("statId",),
            aggs=(
                ("total_loss", "sum", "loss_sum"),
                ("total_count", "sum", "count"),
                ("domain", "max", "domain"),
            ),
            num_groups=capacity,
        )
        self.vm.register_view(
            ViewDef(LOSS_VIEW, plan), delta_bases=("StepStats",), m=m, seed=seed,
            delta_group_capacity=4096,
        )

    def ingest_step(self, domain_loss_sum, domain_count) -> None:
        """Feed one train step's per-domain sums as fact-table inserts
        (host arrays or tensors)."""
        n = self.n_domains
        ids = self._next_id + np.arange(n, dtype=np.int32)
        self._next_id += n
        delta = from_columns(
            {
                "statId": ids,
                "domain": np.arange(n, dtype=np.int32),
                "loss_sum": _host(domain_loss_sum),
                "count": _host(domain_count),
            },
            pk=["statId"],
            device=self.device,
        )
        self.vm.ingest("StepStats", inserts=delta)

    def svc_refresh(self) -> float:
        return self.vm.svc_refresh(LOSS_VIEW)

    def full_maintenance(self) -> float:
        return self.vm.maintain_all()

    def domain_queries(self, domain: int):
        """(sum of total_loss, sum of total_count) over ``domain``'s rows."""
        pred = Cmp("eq", Col("domain"), Lit(domain))
        return (Query(agg="sum", col="total_loss", pred=pred),
                Query(agg="sum", col="total_count", pred=pred))

    def loss_estimate(self, domain: int):
        """Fresh bounded estimate of a domain's mean loss (SVC)."""
        q_sum, q_cnt = self.domain_queries(domain)
        s = self.vm.query(LOSS_VIEW, q_sum)
        c = self.vm.query(LOSS_VIEW, q_cnt)
        denom = max(float(c.value), 1.0)
        return float(s.value) / denom, (float(s.ci_low) / denom, float(s.ci_high) / denom)

    def mixture_weights(self, temperature: float = 1.0) -> np.ndarray:
        """Loss-proportional mixture (sample hard domains more)."""
        est = np.array([self.loss_estimate(d)[0] for d in range(self.n_domains)])
        est = np.nan_to_num(est, nan=0.0, posinf=0.0, neginf=0.0)
        if est.max() <= 0:
            return np.ones(self.n_domains) / self.n_domains
        z = est / max(est.mean(), 1e-9)
        w = np.exp(z / max(temperature, 1e-6))
        return w / w.sum()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
