"""Decoder-only LM assembly: the dense, MoE and VLM families (the port of
``repro.models.transformer``).

One parameterized assembly covers codeqwen1.5-7b, qwen2-1.5b, h2o-danube,
qwen3-4b (dense), granite-moe and arctic-480b (MoE: ``moe`` in place of
``mlp``) and llama-3.2-vision (VLM).  The parameters live in a
:class:`DenseLM`: an ``nn.Module`` whose parameter names follow the
reference's tree (``embed``, ``final_norm``, ``lm_head``,
``blocks.{i}.attn.wq``, ``blocks.{i}.mlp.wg`` or ``blocks.{i}.moe.router``,
…), one :class:`DenseBlock` per layer in an ``nn.ModuleList`` where the
reference stacks the layers on a leading axis and scans them.  The VLM's
:class:`VisionLM` holds the reference's groups: each group is
(``cross_every`` − 1 self blocks, one gated cross-attention block), named
``blocks.{g}.{j}.…`` and ``cross_blocks.{g}.…``, with ``vision_proj``
taking the (B, Nv, vision_dim) patch embeddings into the model width.
Each level reads like the reference's dict (``params["wq"]``, ``"bq" in
params``), so the functions below keep the reference's bodies.

Decode keeps a KV cache ``{"k", "v"}`` of (L, B, S, KV, hd), written in
place; sliding-window archs use a ring buffer of ``window`` slots.  The
VLM's cache is (G, n_self, B, S, KV, hd) for the self layers and
``cross_k``/``cross_v`` (G, B, Nv, KV, hd), the prefill's projections of
the vision tokens.  The ``zero3_gather`` path waits for the LM sharding
rules (ROADMAP.md, section 1, item 5).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import tp
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
    specs: Dict[str, Any] = {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attention_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.family == "moe":
        specs["moe"] = L.moe_specs(cfg)
    else:
        specs["mlp"] = L.swiglu_specs(cfg.d_model, cfg.d_ff)
    return specs


def cross_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attention_specs(cfg, cross=True),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": L.swiglu_specs(cfg.d_model, cfg.d_ff),
        "mlp_gate": ParamSpec((), (), init="zeros"),
    }


def build_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's spec tree: ``blocks`` stacked on a leading layer axis
    (for the VLM, on (group, self layer) axes, beside ``cross_blocks``
    stacked by group)."""
    d, v = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="normal", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    if cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_every
        n_self_per_group = cfg.cross_every - 1
        specs["blocks"] = _stack(
            _stack(self_block_specs(cfg), n_self_per_group, "stack"), n_groups
        )
        specs["cross_blocks"] = _stack(cross_block_specs(cfg), n_groups)
        specs["vision_proj"] = ParamSpec((cfg.vision_dim, d), ("vision", "embed"))
    else:
        specs["blocks"] = _stack(self_block_specs(cfg), cfg.n_layers)
    return specs


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """One level of a parameter tree: tensors become (frozen) parameters and
    dicts submodules, under the tree's keys; indexed like the dict.  In a
    device's program (``models/tp.py``) indexing is where a layer reads a
    parameter: an FSDP block is gathered there (``tp.param``)."""

    #: Each parameter's ``tp.Split`` (``tp.annotate``): a device's program.
    _tp_split: Optional[Dict[str, Any]] = None

    def __init__(self, tree: Dict[str, Any]) -> None:
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        if self._tp_split is not None and name in self._tp_split:
            return tp.param(self, name)
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class DenseBlock(ParamTree):
    """One pre-norm block's parameters: ``ln1``, ``attn``, ``ln2``, and
    ``mlp`` or ``moe`` (run by :func:`self_block_fwd` and
    :func:`_decode_self_block`)."""


class CrossBlock(ParamTree):
    """One VLM cross-attention block's parameters: ``ln1``, ``attn`` (with
    its ``gate``), ``ln2``, ``mlp``, ``mlp_gate``."""


#: The tree's keys stacked on leading axes (unstacked into lists of blocks).
_STACKED = ("blocks", "cross_blocks")


def _unstack(stacked, n: int, block=DenseBlock) -> nn.ModuleList:
    """``n`` blocks holding views of the stacked tree's leading slices."""
    return nn.ModuleList(block(map_tree(lambda t, i=i: t[i], stacked)) for i in range(n))


class DenseLM(ParamTree):
    """The decoder-only LM's parameters (``embed``, ``final_norm``,
    ``lm_head``, ``blocks``) for the dense and MoE families;
    ``forward(tokens)`` gives every position's logits."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        """``tree``: the reference's parameter tree as tensors, ``blocks``
        stacked on a leading layer axis (unstacked here into views)."""
        super().__init__({k: v for k, v in tree.items() if k not in _STACKED})
        self.cfg = cfg
        self.blocks = _unstack(tree["blocks"], cfg.n_layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, vision: Optional[torch.Tensor] = None):
        hidden, _, _ = forward_hidden(self, tokens, self.cfg, vision=vision)
        return lm_head(self, hidden, self.cfg)


class VisionLM(DenseLM):
    """The VLM's parameters: ``blocks`` a list of groups, each a list of
    ``cross_every`` − 1 :class:`DenseBlock`; ``cross_blocks`` one
    :class:`CrossBlock` per group; ``vision_proj``.  ``forward(tokens,
    vision)`` gives every position's logits."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        """``tree``: the reference's tree, ``blocks`` stacked on (group, self
        layer) and ``cross_blocks`` on group (unstacked here into views)."""
        ParamTree.__init__(self, {k: v for k, v in tree.items() if k not in _STACKED})
        self.cfg = cfg
        n_groups, n_self = cfg.n_layers // cfg.cross_every, cfg.cross_every - 1
        self.blocks = nn.ModuleList(
            _unstack(map_tree(lambda t, g=g: t[g], tree["blocks"]), n_self)
            for g in range(n_groups)
        )
        self.cross_blocks = _unstack(tree["cross_blocks"], n_groups, CrossBlock)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def self_block_fwd(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                   cache_kv: bool = False):
    """(x', aux, (k, v)): the block's output, its MoE aux loss (None for an
    MLP block) and its attention's k and v (every KV head of the cache with
    ``cache_kv``)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, k, v = L.self_attention(p["attn"], h, cfg, positions, cache_kv=cache_kv)
    x = x + y
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = L.moe_ffn(p["moe"], h, cfg)
    else:
        y, aux = L.swiglu(p["mlp"], h), None
    return x + y, aux, (k, v)


def _gated_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A cross block's second half: x + tanh(mlp_gate) · swiglu(rms_norm(x))."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    gate = torch.tanh(p["mlp_gate"].float()).to(x.dtype)
    return x + gate * L.swiglu(p["mlp"], h)


def cross_block_fwd(p, x: torch.Tensor, vis: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + L.cross_attention(p["attn"], h, vis, cfg)
    return _gated_mlp(p, x, cfg)


# ---------------------------------------------------------------------------
# Full-sequence forward (training / prefill trunk)
# ---------------------------------------------------------------------------


def forward_hidden(
    params: DenseLM,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    vision: Optional[torch.Tensor] = None,
    collect_kv: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Token ids (B, S) → final hidden states.  Returns (hidden, moe_aux,
    kv): the MoE auxiliary loss summed over the layers in float32, in layer
    order (0 without MoE blocks); with ``collect_kv`` kv is the per-layer
    (k, v) stacked to (L, B, S, KV, hd) each (prefill), else None.  The VLM
    takes ``vision`` (B, Nv, vision_dim) and stacks its kv as ((k, v) of
    (G, n_self, B, S, KV, hd), (cross_k, cross_v) of (G, B, Nv, KV, hd))."""
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype), tp.parts(params, "embed", 0))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []

    def self_block(lp, x):
        nonlocal aux
        if collect_kv:
            x, a, (k, v) = self_block_fwd(lp, x, cfg, positions, cache_kv=True)
            ks.append(k)
            vs.append(v)
        else:  # the layer body recomputed in the backward pass under cfg.remat
            x, a = L.remat(lambda h: self_block_fwd(lp, h, cfg, positions)[:2], x,
                           enabled=cfg.remat)
        if a is not None:
            aux = aux + a
        return x

    if cfg.family == "vlm":
        if vision is None:
            raise ValueError(f"{cfg.name}: the vlm forward requires vision embeddings")
        vis = L.dot(vision.to(x.dtype), params["vision_proj"])
        xks: List[torch.Tensor] = []
        xvs: List[torch.Tensor] = []
        for group, cp in zip(params["blocks"], params["cross_blocks"]):
            for lp in group:
                x = self_block(lp, x)
            if collect_kv:
                xks.append(L.dot(vis, cp["attn"]["wk"]))
                xvs.append(L.dot(vis, cp["attn"]["wv"]))
            x = cross_block_fwd(cp, x, vis, cfg)
        kv = None
        if collect_kv:
            n_groups = len(params["blocks"])
            kv = ((torch.stack(ks).unflatten(0, (n_groups, -1)),
                   torch.stack(vs).unflatten(0, (n_groups, -1))),
                  (torch.stack(xks), torch.stack(xvs)))
    else:
        for lp in params["blocks"]:
            x = self_block(lp, x)
        kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, kv


def lm_head(params: DenseLM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in the served dtype; columns ≥ ``vocab`` masked to −1e30."""
    if cfg.tie_embeddings:
        w, parts = params["embed"].T, tp.parts(params, "embed", 0)
    else:
        w, parts = params["lm_head"], tp.parts(params, "lm_head", 1)
    return L.vocab_logits(x, w, cfg, parts)  # x is in the served dtype


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
    if cfg.family != "vlm":
        return {"k": kv_spec, "v": kv_spec}
    n_groups = cfg.n_layers // cfg.cross_every
    self_spec = ParamSpec(
        (n_groups, cfg.cross_every - 1, batch, s, kv, hd),
        ("layers", "stack", "batch", "kv_seq", "kv_heads", None),
        dtype=torch_dtype(cfg.dtype),
        init="zeros",
    )
    cross_spec = ParamSpec(
        (n_groups, batch, cfg.n_vision_tokens, kv, hd),
        ("layers", "batch", None, "kv_heads", None),
        dtype=torch_dtype(cfg.dtype),
        init="zeros",
    )
    return {"k": self_spec, "v": self_spec, "cross_k": cross_spec, "cross_v": cross_spec}


def _decode_self_block(lp, x_step, ck, cv, index: int, cfg: ModelConfig):
    h = L.rms_norm(x_step, lp["ln1"], cfg.norm_eps)
    y, ck, cv = L.decode_attention(lp["attn"], h, ck, cv, index, cfg)
    x_step = x_step + y
    h = L.rms_norm(x_step, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        y, _ = L.moe_ffn(lp["moe"], h, cfg)
    else:
        y = L.swiglu(lp["mlp"], h)
    return x_step + y, ck, cv


def decode_step(
    params: DenseLM,
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,  # (B, 1) int
    index: int,  # number of tokens already cached
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the cache, which it updates in place (the
    reference donates it).  Returns (logits (B, V), cache)."""
    x = L.embed(params["embed"], token, torch_dtype(cfg.dtype),
                tp.parts(params, "embed", 0))  # (B, 1, D)
    if cfg.family == "vlm":
        for g, (group, cp) in enumerate(zip(params["blocks"], params["cross_blocks"])):
            for j, lp in enumerate(group):
                x, _, _ = _decode_self_block(lp, x, cache["k"][g, j], cache["v"][g, j], index, cfg)
            h = L.rms_norm(x, cp["ln1"], cfg.norm_eps)
            x = x + L.cross_attention_cached(
                cp["attn"], h, cache["cross_k"][g], cache["cross_v"][g], cfg)
            x = _gated_mlp(cp, x, cfg)
    else:
        for i, lp in enumerate(params["blocks"]):
            x, _, _ = _decode_self_block(lp, x, cache["k"][i], cache["v"][i], index, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(params, x, cfg)[:, 0]  # (B, V)
    return logits, cache


def prefill(
    params: DenseLM, tokens: torch.Tensor, cfg: ModelConfig, vision: Optional[torch.Tensor] = None
):
    """Full-sequence prefill: returns (last-position logits, populated cache)."""
    x, _, kv = forward_hidden(params, tokens, cfg, vision=vision, collect_kv=True)
    logits = lm_head(params, x[:, -1:, :], cfg)[:, 0]
    if cfg.family == "vlm":
        (self_k, self_v), (cross_k, cross_v) = kv
        return logits, {"k": self_k, "v": self_v, "cross_k": cross_k, "cross_v": cross_v}
    k_stack, v_stack = kv
    if cfg.window and tokens.shape[1] > cfg.window:
        k_stack = k_stack[:, :, -cfg.window :]
        v_stack = v_stack[:, :, -cfg.window :]
    return logits, {"k": k_stack, "v": v_stack}
