"""Architecture + run configuration dataclasses (a copy of ``repro.configs.base``).

One ``ArchConfig`` per assigned architecture lives in
``repro_torch/configs/<id>.py`` (exact published numbers) together with a
``smoke()`` reduction of the same family for CPU tests.  The input-shape
cells (train_4k / prefill_32k / decode_32k / long_500k) are below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"  # swiglu | geglu
    rope_theta: float = 10_000.0

    # multimodal (vlm / audio backbones; frontend is a stub per spec)
    m_rope: bool = False
    mrope_sections: Tuple[int, ...] = ()  # partitions of head_dim/2
    n_vision_tokens: int = 0  # stub patch embeddings prepended
    audio_frontend: bool = False  # stub frame embeddings into the encoder

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25

    # hybrid (RG-LRU + local attention)
    attn_window: int = 0
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    rglru_conv_width: int = 4

    # xLSTM
    slstm_every: int = 0  # every k-th block is sLSTM (rest mLSTM)
    mlstm_heads: int = 0

    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "none"  # none | dots | full

    # notes for DESIGN.md §Arch-applicability
    sub_quadratic: bool = False  # supports long_500k decode
    source: str = ""

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        if self.family == "ssm":  # xLSTM
            per_m = d * (3 * d) + d * d  # q,k,v + out (inner = d)
            per_m += 2 * d * 2 * d  # up/gate projections (pf=2)
            per_s = 4 * d * d * 2  # W and R for 4 gates (hidden = d)
            n_s = self.n_layers // max(self.slstm_every, 1)
            n_m = self.n_layers - n_s
            return v * d + n_m * per_m + n_s * per_s
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * f
        if self.family == "moe":
            mlp = self.moe_experts * 3 * d * f + d * self.moe_experts
        if self.family == "hybrid":
            n_attn = sum(1 for b in self._pattern() if b == "attn")
            n_rec = self.n_layers - n_attn
            rec = d * (2 * d) + 2 * d + d * d  # in/gate proj + rglru + out
            return v * d + n_attn * (attn + mlp) + n_rec * (rec + mlp)
        if self.family == "encdec":
            enc = self.enc_layers * (attn + mlp)
            dec = self.dec_layers * (2 * attn + mlp)  # self + cross
            return v * d + enc + dec
        return v * d + self.n_layers * (attn + mlp)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp_active = self.moe_top_k * 3 * d * f + d * self.moe_experts
        return self.vocab * d + self.n_layers * (attn + mlp_active)

    def _pattern(self) -> Tuple[str, ...]:
        if not self.block_pattern:
            return ()
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Per-spec skip rules (recorded in the roofline table)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k dense decode is quadratic (spec skip)"
    return True, ""
