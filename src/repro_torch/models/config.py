"""Unified model configuration for the assigned-architecture zoo (the port of
``repro.models.config``, a copy: the reference module imports no JAX, but the
port imports nothing of ``repro``).

One dataclass covers all five families (dense / moe / vlm / encdec / ssm /
hybrid); family-specific fields are ignored where inapplicable.  Every
assigned architecture instantiates this from ``repro_torch/configs/<id>.py``.
The port serves every family (``repro_torch.models.model.get_model``), and
every config equals the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | encdec | zamba | xlstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False  # qwen2
    qk_norm: bool = False  # qwen3
    window: Optional[int] = None  # h2o-danube sliding-window attention
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # -- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_dense: int = 0  # arctic parallel dense-residual MLP
    capacity_factor: float = 1.25
    # -- VLM (cross-attention image layers) --------------------------------
    cross_every: int = 0  # a cross-attn layer every `cross_every` layers
    vision_dim: int = 0
    n_vision_tokens: int = 0
    # -- encoder–decoder (whisper) ------------------------------------------
    n_encoder_layers: int = 0
    # -- SSM (mamba2 in zamba) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn_every: int = 0  # zamba: shared attention block cadence
    # -- xLSTM ----------------------------------------------------------------
    slstm_every: int = 0  # one sLSTM block every `slstm_every` blocks
    mlstm_qk_dim: int = 256  # per-head qk dim of the matrix memory
    # -- numerics / schedule knobs -------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    zero3_gather: bool = False  # explicit per-layer FSDP weight all-gather
    attn_chunk: int = 1024  # flash-attention KV chunk
    q_chunk: int = 512  # flash-attention query block (bounds remat-backward memory)
    ssm_chunk: int = 256  # SSD chunk length
    loss_chunk: int = 1024  # chunked-CE sequence block

    @property
    def padded_vocab(self) -> int:
        """LM-head/embedding vocab padded to 128 (MXU lanes + 16-way TP).

        Logit columns ≥ ``vocab`` are masked to −inf in ``lm_head`` — padding
        changes layout, never semantics."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA group must divide"
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.family == "vlm":
            assert self.cross_every > 0 and self.vision_dim > 0
        if self.family == "encdec":
            assert self.n_encoder_layers > 0
        if self.family == "zamba":
            assert self.ssm_state > 0 and self.shared_attn_every > 0
        if self.family == "xlstm":
            assert self.slstm_every > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}[
            self.kind
        ]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Families whose attention is bounded (sub-quadratic / recurrent): these run
# long_500k.  Pure full-attention archs skip it (DESIGN.md §4).
LONG_CONTEXT_FAMILIES = ("zamba", "xlstm")


def supports_long_context(cfg: ModelConfig) -> bool:
    return cfg.family in LONG_CONTEXT_FAMILIES or cfg.window is not None


def cells_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """The assigned shape cells this architecture runs (skips documented)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if supports_long_context(cfg):
        names.append("long_500k")
    return tuple(names)
