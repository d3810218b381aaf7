"""Decoder-only LM assembly, dense branch (the port of
``repro.models.transformer``).

One parameterized assembly covers codeqwen1.5-7b, qwen2-1.5b, h2o-danube
and qwen3-4b.  The parameters live in a :class:`DenseLM`: an ``nn.Module``
whose parameter names follow the reference's tree (``embed``,
``final_norm``, ``lm_head``, ``blocks.{i}.attn.wq``, ``blocks.{i}.mlp.wg``,
…), one :class:`DenseBlock` per layer in an ``nn.ModuleList`` where the
reference stacks the layers on a leading axis and scans them.  Each level
reads like the reference's dict (``params["wq"]``, ``"bq" in params``), so
the functions below keep the reference's bodies.

Decode keeps a KV cache ``{"k", "v"}`` of (L, B, S, KV, hd), written in
place; sliding-window archs use a ring buffer of ``window`` slots.
The VLM groups, the MoE blocks and the ``zero3_gather`` path wait for their
families and the LM sharding rules (ROADMAP.md, section 1, item 5).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, map_tree, torch_dtype


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _stack(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the reference's scanned layers) to every spec."""
    return map_tree(
        lambda s: ParamSpec(
            (n, *s.shape), (axis_name, *s.axes), dtype=s.dtype, init=s.init, scale=s.scale
        ),
        tree,
    )


def self_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attention_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": L.swiglu_specs(cfg.d_model, cfg.d_ff),
    }


def build_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's spec tree: ``blocks`` stacked on a leading layer axis."""
    d, v = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="normal", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    specs["blocks"] = _stack(self_block_specs(cfg), cfg.n_layers)
    return specs


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """One level of a parameter tree: tensors become (frozen) parameters and
    dicts submodules, under the tree's keys; indexed like the dict."""

    def __init__(self, tree: Dict[str, Any]) -> None:
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class DenseBlock(ParamTree):
    """One pre-norm block's parameters: ``ln1``, ``attn``, ``ln2``, ``mlp``
    (run by :func:`self_block_fwd` and :func:`_decode_self_block`)."""


class DenseLM(ParamTree):
    """The dense decoder-only LM's parameters (``embed``, ``final_norm``,
    ``lm_head``, ``blocks``); ``forward(tokens)`` gives every position's
    logits."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        """``tree``: the reference's parameter tree as tensors, ``blocks``
        stacked on a leading layer axis (unstacked here into views)."""
        top = {k: v for k, v in tree.items() if k != "blocks"}
        super().__init__(top)
        self.cfg = cfg
        stacked = tree["blocks"]
        self.blocks = nn.ModuleList(
            DenseBlock(map_tree(lambda t, i=i: t[i], stacked)) for i in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        hidden, _, _ = forward_hidden(self, tokens, self.cfg)
        return lm_head(self, hidden, self.cfg)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def self_block_fwd(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(x', (k, v)): the block's output and its attention's k and v."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, k, v = L.self_attention(p["attn"], h, cfg, positions)
    x = x + y
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h), (k, v)


# ---------------------------------------------------------------------------
# Full-sequence forward (training / prefill trunk)
# ---------------------------------------------------------------------------


def forward_hidden(
    params: DenseLM, tokens: torch.Tensor, cfg: ModelConfig, collect_kv: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Token ids (B, S) → final hidden states.  Returns (hidden, moe_aux,
    kv): the MoE auxiliary loss is 0 for the dense family; with
    ``collect_kv`` kv is the per-layer (k, v) stacked to (L, B, S, KV, hd)
    each (prefill), else None."""
    s = tokens.shape[1]
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for lp in params["blocks"]:
        x, (k, v) = self_block_fwd(lp, x, cfg, positions)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, torch.zeros((), dtype=torch.float32, device=x.device), kv


def lm_head(params: DenseLM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in the served dtype; columns ≥ ``vocab`` masked to −1e30."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.dot(x, w)  # x is in the served dtype
    if cfg.padded_vocab != cfg.vocab:  # mask pad columns (see padded_vocab)
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# KV caches & decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Effective cache length: sliding-window archs keep a ring of `window`."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    kv, hd = cfg.n_kv_heads, cfg.hd
    s = cache_len(cfg, seq_len)
    kv_spec = ParamSpec(
        (cfg.n_layers, batch, s, kv, hd),
        ("layers", "batch", "kv_seq", "kv_heads", None),
        dtype=torch_dtype(cfg.dtype),
        init="zeros",
    )
    return {"k": kv_spec, "v": kv_spec}


def _decode_self_block(lp, x_step, ck, cv, index: int, cfg: ModelConfig):
    h = L.rms_norm(x_step, lp["ln1"], cfg.norm_eps)
    y, ck, cv = L.decode_attention(lp["attn"], h, ck, cv, index, cfg)
    x_step = x_step + y
    h = L.rms_norm(x_step, lp["ln2"], cfg.norm_eps)
    return x_step + L.swiglu(lp["mlp"], h), ck, cv


def decode_step(
    params: DenseLM,
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,  # (B, 1) int
    index: int,  # number of tokens already cached
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the cache, which it updates in place (the
    reference donates it).  Returns (logits (B, V), cache)."""
    x = params["embed"][token].to(torch_dtype(cfg.dtype))  # (B, 1, D)
    for i, lp in enumerate(params["blocks"]):
        x, _, _ = _decode_self_block(lp, x, cache["k"][i], cache["v"][i], index, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(params, x, cfg)[:, 0]  # (B, V)
    return logits, cache


def prefill(params: DenseLM, tokens: torch.Tensor, cfg: ModelConfig):
    """Full-sequence prefill: returns (last-position logits, populated cache)."""
    x, _, (k_stack, v_stack) = forward_hidden(params, tokens, cfg, collect_kv=True)
    logits = lm_head(params, x[:, -1:, :], cfg)[:, 0]
    if cfg.window and tokens.shape[1] > cfg.window:
        k_stack = k_stack[:, :, -cfg.window :]
        v_stack = v_stack[:, :, -cfg.window :]
    return logits, {"k": k_stack, "v": v_stack}
