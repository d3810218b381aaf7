"""Hybrid and recurrent LM assemblies: zamba2 (Mamba2 and one shared
attention block) and xLSTM (the port of ``repro.models.hybrid``).

zamba2-2.7b: 54 Mamba2 layers in groups of ``shared_attn_every``; after
each group, ONE shared transformer block (RoPE attention and a SwiGLU MLP,
its weights stored once) runs with that invocation's own input RMSNorms
(``shared_ln1``/``shared_ln2``, one row per invocation).  xlstm-1.3b: 48
blocks in groups of (``slstm_every`` − 1 mLSTM, one sLSTM).

The parameters live in a :class:`ZambaLM` (``blocks.{g}.{j}.mamba.in_proj``,
``shared.attn.wq``, ``shared_ln1``, …) or an :class:`XLSTMLM`
(``mblocks.{g}.{j}.mlstm.wq``, ``sblocks.{g}.slstm.r_gates``, …), names
following the reference's tree, its stacking axes unstacked.  The decode
caches are the reference's: Zamba's ``conv``/``state`` (G, E, B, …) for
the Mamba layers and ``k``/``v`` (G, B, S, KV, hd) for the shared block's
invocations; xLSTM's ``m_conv``/``m_state`` (G, M, B, …) and
``s_conv``/``s_c``/``s_n``/``s_h`` (G, B, …), O(1) in the context.  Decode
writes them in place.  Prompts must be whole SSD chunks (``ssm_chunk``),
as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import tp
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, map_tree, torch_dtype
from repro_torch.models.transformer import ParamTree, _stack, _unstack, lm_head


def _groups(stacked, n_groups: int, n_per_group: int) -> nn.ModuleList:
    """A tree stacked on (group, block) as a list of groups of blocks."""
    return nn.ModuleList(
        _unstack(map_tree(lambda t, g=g: t[g], stacked), n_per_group, ParamTree)
        for g in range(n_groups)
    )


class _Stacked:
    """Per-block tensors of one shape, in group order, written as they come
    into one (G, per group, …) tensor (so a prefill never holds its states
    twice)."""

    def __init__(self, groups: int, per_group: int) -> None:
        self.shape, self.out, self.count = (groups, per_group), None, 0

    def add(self, t: torch.Tensor) -> None:
        if self.out is None:
            self.out = t.new_empty((*self.shape, *t.shape))
        self.out.flatten(0, 1)[self.count].copy_(t)
        self.count += 1


# ---------------------------------------------------------------------------
# zamba2
# ---------------------------------------------------------------------------


def _zamba_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: n_layers must be a multiple of shared_attn_every")
    return cfg.n_layers // cfg.shared_attn_every


def zamba_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    g = _zamba_groups(cfg)
    mamba_block = {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "mamba": S.mamba_specs(cfg),
    }
    return {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="normal", scale=0.02),
        "blocks": _stack(_stack(mamba_block, cfg.shared_attn_every, "stack"), g),
        # the shared transformer block: ONE copy of the weights...
        "shared": {
            "attn": L.attention_specs(cfg),
            "mlp": L.swiglu_specs(d, cfg.d_ff),
        },
        # ...and a per-invocation input norm (g rows)
        "shared_ln1": ParamSpec((g, d), ("layers", "embed"), init="ones"),
        "shared_ln2": ParamSpec((g, d), ("layers", "embed"), init="ones"),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, cfg.padded_vocab), ("embed", "vocab")),
    }


class ZambaLM(ParamTree):
    """zamba2's parameters: ``blocks`` a list of groups of
    ``shared_attn_every`` Mamba blocks (``ln``, ``mamba``), one ``shared``
    block, ``shared_ln1``/``shared_ln2`` (G, D), ``embed``,
    ``final_norm``, ``lm_head``.  ``forward(tokens)`` gives every position's
    logits."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        super().__init__({k: v for k, v in tree.items() if k != "blocks"})
        self.cfg = cfg
        self.blocks = _groups(tree["blocks"], _zamba_groups(cfg), cfg.shared_attn_every)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_head(self, zamba_forward_hidden(self, tokens, self.cfg)[0], self.cfg)


def zamba_forward_hidden(params: ZambaLM, tokens: torch.Tensor, cfg: ModelConfig,
                         collect_cache: bool = False):
    """Token ids (B, S), S a whole number of SSD chunks → (final hidden
    states, caches): with ``collect_cache`` caches is (MambaCache of
    (G, E, B, …) tensors, (k, v) of (G, B, S, KV, hd)), else None."""
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype), tp.parts(params, "embed", 0))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    shared = params["shared"]
    groups, per_group = len(params["blocks"]), cfg.shared_attn_every
    convs, states = _Stacked(groups, per_group), _Stacked(groups, per_group)
    ks, vs = [], []
    # one view per invocation, taken once: indexing the (G, D) norms in the
    # loop would make each invocation's gradient a whole (G, D) tensor
    ln1s, ln2s = params["shared_ln1"].unbind(0), params["shared_ln2"].unbind(0)
    for g, group in enumerate(params["blocks"]):
        for lp in group:
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            if collect_cache:
                y, mc = S.mamba_forward(lp["mamba"], h, cfg, return_cache=True)
                convs.add(mc.conv)
                states.add(mc.state)
            else:
                y = L.remat(S.mamba_forward, lp["mamba"], h, cfg, enabled=cfg.remat)
            x = x + y
        # the shared attention block, with this invocation's norms
        h = L.rms_norm(x, ln1s[g], cfg.norm_eps)
        y, k, v = L.self_attention(shared["attn"], h, cfg, positions, cache_kv=collect_cache)
        if collect_cache:
            ks.append(k)
            vs.append(v)
        x = x + y
        h = L.rms_norm(x, ln2s[g], cfg.norm_eps)
        x = x + L.swiglu(shared["mlp"], h)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return x, None
    return x, (S.MambaCache(convs.out, states.out), (torch.stack(ks), torch.stack(vs)))


def zamba_cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    g, e = _zamba_groups(cfg), cfg.shared_attn_every
    di, n = cfg.d_inner, cfg.ssm_state
    dtype = torch_dtype(cfg.dtype)
    kv = ParamSpec((g, batch, seq_len, cfg.n_kv_heads, cfg.hd),
                   ("layers", "batch", "kv_seq", "kv_heads", None), dtype=dtype, init="zeros")
    return {
        "conv": ParamSpec((g, e, batch, cfg.ssm_conv - 1, di + 2 * n),
                          ("layers", "stack", "batch", None, "mlp"), dtype=dtype, init="zeros"),
        "state": ParamSpec((g, e, batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                           ("layers", "stack", "batch", "heads", None, None),
                           dtype=torch.float32, init="zeros"),
        "k": kv,
        "v": kv,
    }


def zamba_decode_step(params: ZambaLM, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                      index: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the cache, updated in place: (logits (B, V), cache)."""
    x = L.embed(params["embed"], token, torch_dtype(cfg.dtype), tp.parts(params, "embed", 0))
    shared = params["shared"]
    for g, group in enumerate(params["blocks"]):
        for j, lp in enumerate(group):
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            mc = S.MambaCache(cache["conv"][g, j], cache["state"][g, j])
            y, _ = S.mamba_decode_step(lp["mamba"], h, mc, cfg)
            x = x + y
        h = L.rms_norm(x, params["shared_ln1"][g], cfg.norm_eps)
        y, _, _ = L.decode_attention(shared["attn"], h, cache["k"][g], cache["v"][g], index, cfg)
        x = x + y
        h = L.rms_norm(x, params["shared_ln2"][g], cfg.norm_eps)
        x = x + L.swiglu(shared["mlp"], h)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(params, x, cfg)[:, 0], cache


def zamba_prefill(params: ZambaLM, tokens: torch.Tensor, cfg: ModelConfig):
    x, (mcache, (k, v)) = zamba_forward_hidden(params, tokens, cfg, collect_cache=True)
    logits = lm_head(params, x[:, -1:, :], cfg)[:, 0]
    return logits, {"conv": mcache.conv, "state": mcache.state, "k": k, "v": v}


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


def _xlstm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mLSTM blocks per group)."""
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.name}: n_layers must be a multiple of slstm_every")
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def xlstm_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    g, m = _xlstm_groups(cfg)
    mblock = {"ln": ParamSpec((d,), ("embed",), init="ones"), "mlstm": X.mlstm_specs(cfg)}
    sblock = {"ln": ParamSpec((d,), ("embed",), init="ones"), "slstm": X.slstm_specs(cfg)}
    return {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="normal", scale=0.02),
        "mblocks": _stack(_stack(mblock, m, "stack"), g),
        "sblocks": _stack(sblock, g),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, cfg.padded_vocab), ("embed", "vocab")),
    }


class XLSTMLM(ParamTree):
    """xLSTM's parameters: ``mblocks`` a list of groups of mLSTM blocks
    (``ln``, ``mlstm``), ``sblocks`` one sLSTM block (``ln``, ``slstm``) per
    group, ``embed``, ``final_norm``, ``lm_head``.  ``forward(tokens)``
    gives every position's logits."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        super().__init__({k: v for k, v in tree.items() if k not in ("mblocks", "sblocks")})
        self.cfg = cfg
        g, m = _xlstm_groups(cfg)
        self.mblocks = _groups(tree["mblocks"], g, m)
        self.sblocks = _unstack(tree["sblocks"], g, ParamTree)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_head(self, xlstm_forward_hidden(self, tokens, self.cfg)[0], self.cfg)


def xlstm_forward_hidden(params: XLSTMLM, tokens: torch.Tensor, cfg: ModelConfig,
                         collect_cache: bool = False):
    """Token ids (B, S), S a whole number of chunks → (final hidden states,
    caches): with ``collect_cache`` caches is (MLSTMCache of (G, M, B, …)
    tensors, (s_conv (G, B, K − 1, D), SLSTMCache of (G, B, H, hd))), else
    None."""
    x = L.embed(params["embed"], tokens, torch_dtype(cfg.dtype), tp.parts(params, "embed", 0))
    g, m = _xlstm_groups(cfg)
    m_convs, m_states, s_convs, s_cells = _Stacked(g, m), _Stacked(g, m), [], []
    for group, sp in zip(params["mblocks"], params["sblocks"]):
        for lp in group:
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            if collect_cache:
                y, mc = X.mlstm_forward(lp["mlstm"], h, cfg, return_cache=True)
                m_convs.add(mc.conv)
                m_states.add(mc.state)
            else:
                y = L.remat(X.mlstm_forward, lp["mlstm"], h, cfg, enabled=cfg.remat)
            x = x + y
        h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
        if collect_cache:
            y, (s_conv, s_cell) = X.slstm_forward(sp["slstm"], h, cfg, return_cache=True)
            s_convs.append(s_conv)
            s_cells.append(s_cell)
        else:
            y = X.slstm_forward(sp["slstm"], h, cfg)
        x = x + y
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return x, None
    cell = X.SLSTMCache(*(torch.stack(parts) for parts in zip(*s_cells)))
    return x, (X.MLSTMCache(m_convs.out, m_states.out), (torch.stack(s_convs), cell))


def xlstm_cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    del seq_len  # the state is O(1) in the context
    g, m = _xlstm_groups(cfg)
    h, qk, vd = cfg.n_heads, cfg.mlstm_qk_dim, cfg.d_inner // cfg.n_heads
    hd = cfg.d_model // h
    dtype = torch_dtype(cfg.dtype)

    def cell(init: str) -> ParamSpec:
        return ParamSpec((g, batch, h, hd), ("layers", "batch", "heads", None),
                         dtype=torch.float32, init=init)

    return {
        "m_conv": ParamSpec((g, m, batch, cfg.ssm_conv - 1, cfg.d_inner),
                            ("layers", "stack", "batch", None, "mlp"), dtype=dtype, init="zeros"),
        "m_state": ParamSpec((g, m, batch, h, qk, vd + 1),
                             ("layers", "stack", "batch", "heads", None, None),
                             dtype=torch.float32, init="zeros"),
        "s_conv": ParamSpec((g, batch, cfg.ssm_conv - 1, cfg.d_model),
                            ("layers", "batch", None, "embed"), dtype=dtype, init="zeros"),
        "s_c": cell("zeros"),
        "s_n": cell("ones"),
        "s_h": cell("zeros"),
    }


def xlstm_decode_step(params: XLSTMLM, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                      index: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token against the cache, updated in place: (logits (B, V),
    cache).  ``index`` is unused: the recurrence has no position."""
    del index
    x = L.embed(params["embed"], token, torch_dtype(cfg.dtype), tp.parts(params, "embed", 0))
    for g, (group, sp) in enumerate(zip(params["mblocks"], params["sblocks"])):
        for j, lp in enumerate(group):
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            mc = X.MLSTMCache(cache["m_conv"][g, j], cache["m_state"][g, j])
            y, _ = X.mlstm_decode_step(lp["mlstm"], h, mc, cfg)
            x = x + y
        h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
        cell = X.SLSTMCache(cache["s_c"][g], cache["s_n"][g], cache["s_h"][g])
        y, _ = X.slstm_decode_step(sp["slstm"], h, (cache["s_conv"][g], cell), cfg)
        x = x + y
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(params, x, cfg)[:, 0], cache


def xlstm_prefill(params: XLSTMLM, tokens: torch.Tensor, cfg: ModelConfig):
    x, (mcache, (s_conv, s_cell)) = xlstm_forward_hidden(params, tokens, cfg, collect_cache=True)
    logits = lm_head(params, x[:, -1:, :], cfg)[:, 0]
    return logits, {"m_conv": mcache.conv, "m_state": mcache.state, "s_conv": s_conv,
                    "s_c": s_cell.c, "s_n": s_cell.n, "s_h": s_cell.h}
