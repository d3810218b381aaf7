"""Shared transformer layers of the dense family: RMSNorm, RoPE, blocked
attention, SwiGLU (the port of ``repro.models.layers``, dense subset).

Plain PyTorch on the tensors' own device, one function per reference
function and with its rounding order:

* every product keeps the activations' dtype, with bf16 weights upcast where
  the activations are float32 (JAX promotes bf16 × f32 to f32 inside an
  einsum; torch wants one dtype, and the upcast is exact);
* ``rms_norm`` sums squares in float32, rounds the scale to the activations'
  dtype, then multiplies in that dtype;
* ``apply_rope`` works in float32 and rounds back;
* attention scores and the softmax are float32, and the probabilities are
  rounded to the values' dtype before the PV product, whose sum is float32;
* ``swiglu`` applies SiLU in float32.

Attention is the reference's blocked online softmax over KV chunks, a Python
loop in place of its ``lax.scan``, with the query blocking (``q_chunk``) and
the static skip of fully masked KV ranges; no library attention call.  The
reference's ``shard(...)`` annotations are dropped: one controller, no
GSPMD.  ``layer_norm``, ``cross_attention*``, ``gelu_mlp*`` and ``moe_*``
wait for their families (ROADMAP.md, section 1, item 5).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dot(x: torch.Tensor, w: torch.Tensor, contract: int = 1) -> torch.Tensor:
    """``x``'s last ``contract`` dims against ``w``'s first ``contract``
    dims, in ``x``'s dtype (a bf16 ``w`` is upcast for float32 ``x``)."""
    k = math.prod(w.shape[:contract])
    out = torch.matmul(x.reshape(*x.shape[: x.dim() - contract], k), w.reshape(k, -1).to(x.dtype))
    return out.reshape(*x.shape[: x.dim() - contract], *w.shape[contract:])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the sum of squares in float32, the scale rounded to ``x``'s
    dtype, then ``x * scale * weight`` in that dtype."""
    d = x.shape[-1]
    xf = x.float()
    ss = (xf * xf).sum(dim=-1)
    scale = torch.rsqrt(ss / d + eps)[..., None].to(x.dtype)
    return x * scale * weight.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, n, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., S, hd/2)
    if angles.dim() == 2:  # (S, hd/2) → broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blocked attention (online softmax over KV chunks)
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_valid_len: Optional[int] = None,
    chunk: int = 1024,
    q_chunk: Optional[int] = None,
    kv_pos_offset: int = 0,
) -> torch.Tensor:
    """2-D blocked online-softmax attention; never holds the whole (Sq, Sk)
    score matrix once the KV axis spans several chunks.

    ``q_chunk``: block the query dim too.  Q blocks are a Python loop, so
    causal/window cells skip fully masked KV chunks.
    ``q_offset``: absolute position of q[0] (decode: the cache index).
    ``kv_valid_len``: keys at positions ≥ this are masked (decode: index+1).
    ``kv_pos_offset``: absolute position of k[0] (internal, for Q blocking).
    Query head ``h`` reads KV head ``h // (H // KV)`` (GQA).
    """
    b, sq, h, hd = q.shape
    if q_chunk is not None and sq > q_chunk and sq % q_chunk == 0:
        sk = k.shape[1]
        outs = []
        for i in range(sq // q_chunk):
            qs = i * q_chunk
            # Static KV-range skip: causal ⇒ keys after this block's last
            # query are fully masked; window ⇒ keys more than `window` before
            # this block's first query are fully masked.
            hi, lo = sk, 0
            if causal:
                hi = min(sk, _ceil_to(q_offset + qs + q_chunk, chunk))
            if window is not None:
                lo = max(0, ((q_offset + qs - window) // chunk) * chunk)
            outs.append(
                flash_attention(
                    q[:, qs : qs + q_chunk], k[:, lo:hi], v[:, lo:hi],
                    causal=causal, window=window, q_offset=q_offset + qs,
                    kv_valid_len=kv_valid_len, chunk=chunk, kv_pos_offset=lo,
                )
            )
        return torch.cat(outs, dim=1)

    _, sk, kv, _ = k.shape
    g = h // kv
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = k.shape[1] // chunk

    dev = q.device
    qg = q.reshape(b, sq, kv, g, hd).permute(0, 2, 3, 1, 4).float()  # (B, KV, G, Sq, hd)
    scale = 1.0 / math.sqrt(hd)
    q_pos = q_offset + torch.arange(sq, dtype=torch.int32, device=dev)
    valid_len = (sk + kv_pos_offset) if kv_valid_len is None else kv_valid_len

    m = torch.full((b, kv, g, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)  # noqa: E741
    acc = torch.zeros((b, kv, g, sq, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        k_blk = k[:, c * chunk : (c + 1) * chunk]  # (B, C, KV, hd)
        v_blk = v[:, c * chunk : (c + 1) * chunk]
        k_pos = kv_pos_offset + c * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)
        kt = k_blk.permute(0, 2, 3, 1)[:, :, None].float()  # (B, KV, 1, hd, C)
        s = torch.matmul(qg, kt) * scale  # (B, KV, G, Sq, C)
        mask = k_pos[None, :] < valid_len  # (1, C): padded/unwritten keys
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)  # noqa: E741
        vt = v_blk.permute(0, 2, 1, 3)[:, :, None].float()  # (B, KV, 1, C, hd)
        pv = torch.matmul(p.to(v.dtype).float(), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]  # (B, KV, G, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + optional bias / qk-norm / window)
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", None), init="zeros")
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", None), init="zeros")
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        specs["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return specs


def project_qkv(params, x, cfg: ModelConfig, positions: torch.Tensor):
    """Shared q/k/v projection path (bias, qk-norm, RoPE)."""
    q = dot(x, params["wq"])
    k = dot(x, params["wk"])
    v = dot(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Causal self-attention of ``x`` (B, S, D): (y, k, v), the layer's k and
    v being what prefill keeps as its cache (the reference recomputes them
    from the same input: the same values)."""
    q, k, v = project_qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, window=cfg.window, chunk=cfg.attn_chunk, q_chunk=cfg.q_chunk)
    return dot(out, params["wo"], contract=2), k, v


def decode_attention(
    params,
    x_step: torch.Tensor,  # (B, 1, D)
    cache_k: torch.Tensor,  # (B, S, KV, hd)
    cache_v: torch.Tensor,
    index: int,  # tokens already in cache
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a KV cache; returns (out, cache_k,
    cache_v), the caches written in place at ``index`` (a ring slot for a
    sliding-window cache of ``cfg.window`` slots).  An ``index`` past a
    linear cache raises ``IndexError`` where the reference's update would
    clamp."""
    pos = torch.full((1,), index, dtype=torch.int32, device=x_step.device)
    q, k_new, v_new = project_qkv(params, x_step, cfg, pos)
    s_ctx, window = cache_k.shape[1], cfg.window
    if window is not None and s_ctx == window:
        # Ring-buffer cache for sliding-window attention: positions rotate;
        # every slot is valid once the cache is full (mask via valid_len).
        slot, valid = index % window, min(index + 1, window)
    else:
        slot, valid = index, index + 1
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    out = flash_attention(
        q, cache_k, cache_v, causal=False, q_offset=index, kv_valid_len=valid,
        chunk=cfg.attn_chunk,
    )
    return dot(out, params["wo"], contract=2), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_specs(d: int, f: int) -> Dict[str, ParamSpec]:
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp")),
        "wu": ParamSpec((d, f), ("embed", "mlp")),
        "wd": ParamSpec((f, d), ("mlp", "embed")),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = dot(x, params["wg"])
    u = dot(x, params["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    return dot(h, params["wd"])
