"""Whisper-style encoder–decoder backbone, the whisper-large-v3 layout (the
port of ``repro.models.encdec``).

The modality frontend is a stub, as in the reference: a request carries
precomputed frame embeddings ``frames`` (B, T_enc, d_model), the output the
two conv layers would produce.  The backbone: pre-LayerNorm blocks with
biased self-attention projections and GELU MLPs; the decoder's causal
self-attention, then its bias-free cross-attention over the encoder memory;
the head tied to ``embed``, the padded vocabulary's columns masked to −1e30.
Both stacks take sinusoidal positions and no RoPE.

The parameters live in an :class:`EncDecLM` whose names follow the
reference's tree (``embed``, ``enc_blocks.{i}.attn.wq``,
``dec_blocks.{i}.cross_attn.wk``, ``enc_norm.w``, …), the stacked layers
unstacked into one ``ParamTree`` per layer.  The decode cache holds the
decoder's self KV ``k``/``v`` (L, B, S, KV, hd) and the cross-attention's
``cross_k``/``cross_v`` (L, B, T_mem, KV, hd), the prefill's projections of
the encoder memory grafted into the first T_enc of T_mem slots.  The cached
cross-attention masks no slot, as the reference's does: with T_enc < T_mem
the zero slots take softmax weight (reference fault 7, ROADMAP.md section 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, torch_dtype
from repro_torch.models.transformer import ParamTree, _stack, _unstack


def sinusoid(seq_len: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """Sinusoidal position encoding (S, d) float32 of positions ``offset`` …
    ``offset + seq_len − 1``; the frequencies divide by ``d/2 − 1``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + float(offset)
    half = d // 2
    steps = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-math.log(10000.0) * steps / (half - 1))
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln_specs(d: int) -> Dict[str, ParamSpec]:
    return {
        "w": ParamSpec((d,), ("embed",), init="ones"),
        "b": ParamSpec((d,), ("embed",), init="zeros"),
    }


def enc_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": _ln_specs(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "ln2": _ln_specs(cfg.d_model),
        "mlp": L.gelu_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def dec_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    # The cross-attention has no biases (L.cross_attention reads none).
    no_bias_cfg = dataclasses.replace(cfg, qkv_bias=False)
    return {
        "ln1": _ln_specs(cfg.d_model),
        "self_attn": L.attention_specs(cfg),
        "ln_x": _ln_specs(cfg.d_model),
        "cross_attn": L.attention_specs(no_bias_cfg),
        "ln2": _ln_specs(cfg.d_model),
        "mlp": L.gelu_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def build_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="normal", scale=0.02),
        "enc_blocks": _stack(enc_block_specs(cfg), cfg.n_encoder_layers),
        "enc_norm": _ln_specs(d),
        "dec_blocks": _stack(dec_block_specs(cfg), cfg.n_layers),
        "dec_norm": _ln_specs(d),
        # the head is tied to embed (Whisper's convention)
    }


class EncDecLM(ParamTree):
    """The enc-dec LM's parameters: ``embed``, ``enc_norm``, ``dec_norm``,
    and ``enc_blocks``/``dec_blocks`` one ``ParamTree`` per layer (views of
    the reference's stacked tree).  ``forward(tokens, frames)`` gives every
    decoder position's logits."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]) -> None:
        stacked = ("enc_blocks", "dec_blocks")
        super().__init__({k: v for k, v in tree.items() if k not in stacked})
        self.cfg = cfg
        self.enc_blocks = _unstack(tree["enc_blocks"], cfg.n_encoder_layers, ParamTree)
        self.dec_blocks = _unstack(tree["dec_blocks"], cfg.n_layers, ParamTree)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        memory = encode(self, frames, self.cfg)
        x, _ = decode_sequence(self, memory, tokens, self.cfg)
        return lm_logits(self, x, self.cfg)


def _ln(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    return L.layer_norm(x, p["w"], p["b"], eps)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: EncDecLM, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T_enc, D) → the encoder memory (B, T_enc, D)."""
    _, s, d = frames.shape
    dtype = torch_dtype(cfg.dtype)
    x = frames.to(dtype) + sinusoid(s, d, device=frames.device).to(dtype)[None]

    def body(lp, x):
        h = _ln(x, lp["ln1"])
        y, _, _ = L.self_attention(lp["attn"], h, cfg, None, causal=False, rope=False)
        x = x + y
        h = _ln(x, lp["ln2"])
        return x + L.gelu_mlp(lp["mlp"], h)

    for lp in params["enc_blocks"]:
        x = L.remat(body, lp, x, enabled=cfg.remat)
    return _ln(x, params["enc_norm"])


# ---------------------------------------------------------------------------
# Decoder (full sequence: the loss and prefill)
# ---------------------------------------------------------------------------


def decode_sequence(
    params: EncDecLM,
    memory: torch.Tensor,  # (B, T_enc, D) encoder output
    tokens: torch.Tensor,  # (B, T_dec) int
    cfg: ModelConfig,
    collect_kv: bool = False,
):
    """The decoder over ``tokens`` → (normed hidden states, kv): with
    ``collect_kv`` kv is (k, v, cross_k, cross_v), each stacked over the
    layers to (L, B, T, KV, hd) (T = T_dec for the self KV, T_enc for the
    cross), else None."""
    s = tokens.shape[1]
    d = cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    pos = sinusoid(s, d, device=memory.device).to(dtype)[None]
    x = L.embed(params["embed"], tokens, dtype, tp.parts(params, "embed", 0)) + pos
    kv = ([], [], [], [])

    def body(lp, x, memory):
        h = _ln(x, lp["ln1"])
        y, k, v = L.self_attention(lp["self_attn"], h, cfg, None, causal=True, rope=False,
                                   cache_kv=collect_kv)
        if collect_kv:
            for out, t in zip(kv, (k, v, L.dot(memory, lp["cross_attn"]["wk"]),
                                   L.dot(memory, lp["cross_attn"]["wv"]))):
                out.append(t)
        x = x + y
        h = _ln(x, lp["ln_x"])
        x = x + L.cross_attention(lp["cross_attn"], h, memory, cfg)
        h = _ln(x, lp["ln2"])
        return x + L.gelu_mlp(lp["mlp"], h)

    for lp in params["dec_blocks"]:
        x = L.remat(body, lp, x, memory, enabled=cfg.remat and not collect_kv)
    x = _ln(x, params["dec_norm"])
    return x, (tuple(torch.stack(t) for t in kv) if collect_kv else None)


def lm_logits(params: EncDecLM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits on the tied ``embed`` in the served dtype; columns ≥ ``vocab``
    masked to −1e30."""
    return L.vocab_logits(x, params["embed"].T, cfg, tp.parts(params, "embed", 0))


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int, enc_len: int) -> Dict[str, Any]:
    kv, hd, lyr = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    dtype = torch_dtype(cfg.dtype)
    self_spec = ParamSpec((lyr, batch, seq_len, kv, hd),
                          ("layers", "batch", "kv_seq", "kv_heads", None), dtype=dtype,
                          init="zeros")
    cross_spec = ParamSpec((lyr, batch, enc_len, kv, hd),
                           ("layers", "batch", None, "kv_heads", None), dtype=dtype,
                           init="zeros")
    return {"k": self_spec, "v": self_spec, "cross_k": cross_spec, "cross_v": cross_spec}


def decode_step(
    params: EncDecLM,
    cache: Dict[str, torch.Tensor],
    token: torch.Tensor,  # (B, 1) int
    index: int,  # tokens already in the self cache
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token against the cache, whose self KV it writes in
    place at ``index``.  Returns (logits (B, V), cache)."""
    dtype = torch_dtype(cfg.dtype)
    x = L.embed(params["embed"], token, dtype, tp.parts(params, "embed", 0))
    x = x + sinusoid(1, cfg.d_model, offset=index, device=x.device).to(dtype)[None]
    for i, lp in enumerate(params["dec_blocks"]):
        h = _ln(x, lp["ln1"])
        y, _, _ = L.decode_attention(lp["self_attn"], h, cache["k"][i], cache["v"][i], index,
                                     cfg, rope=False)
        x = x + y
        h = _ln(x, lp["ln_x"])
        x = x + L.cross_attention_cached(lp["cross_attn"], h, cache["cross_k"][i],
                                         cache["cross_v"][i], cfg)
        h = _ln(x, lp["ln2"])
        x = x + L.gelu_mlp(lp["mlp"], h)
    x = _ln(x, params["dec_norm"])
    return lm_logits(params, x, cfg)[:, 0], cache


def prefill(params: EncDecLM, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Encode the frames and run the decoder prompt: (last-position logits,
    {"k", "v", "cross_k", "cross_v"})."""
    memory = encode(params, frames, cfg)
    x, (k, v, xk, xv) = decode_sequence(params, memory, tokens, cfg, collect_kv=True)
    logits = lm_logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, {"k": k, "v": v, "cross_k": xk, "cross_v": xv}
