"""Shared transformer layers: RMSNorm, LayerNorm, RoPE, blocked attention,
gated cross-attention, SwiGLU, the GELU MLP and the capacity-dispatch MoE
(the port of ``repro.models.layers``).

Plain PyTorch on the tensors' own device, one function per reference
function and with its rounding order:

* every product keeps the activations' dtype, with bf16 weights upcast where
  the activations are float32 (JAX promotes bf16 × f32 to f32 inside an
  einsum; torch wants one dtype, and the upcast is exact);
* ``rms_norm`` sums squares in float32, rounds the scale to the activations'
  dtype, then multiplies in that dtype;
* ``layer_norm`` takes the mean and the mean square in float32, rounds the
  mean and the rsqrt to the activations' dtype, then normalizes in that
  dtype (``F.layer_norm`` rounds otherwise in bf16);
* ``apply_rope`` works in float32 and rounds back;
* attention scores and the softmax are float32, and the probabilities are
  rounded to the values' dtype before the PV product, whose sum is float32;
* ``swiglu`` applies SiLU in float32, ``gelu_mlp`` the tanh-approximated
  GELU (``jax.nn.gelu``'s default; torch's default is the exact erf) in
  float32;
* the MoE router is float32 (weights and product; TF32 must stay off on the
  card), the top-k gates are rounded to the activations' dtype before they
  weight the expert outputs, and the sum over the k slots is in that dtype;
* the cross-attention gates' ``tanh`` is float32, rounded before the
  product.

Attention is the reference's blocked online softmax over KV chunks, a Python
loop in place of its ``lax.scan``, with the query blocking (``q_chunk``) and
the static skip of fully masked KV ranges; no library attention call.  The
reference's ``shard(...)`` annotations are dropped: one controller, no
GSPMD.

Under autograd, :func:`remat` recomputes in the backward pass what the
reference wraps in ``jax.checkpoint``: each query block and each KV chunk's
step of the attention here, each layer body when ``cfg.remat`` in the
assemblies, each chunk of the loss.  Without autograd (serving) it is a
plain call.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    reference's ``jax.checkpoint``) when ``enabled`` and autograd records
    the forward; otherwise a plain call."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` in ``dtype`` (an exact cast).
    Under autograd the table is cast before the lookup, as the reference
    does, so that a token's gradients are summed in ``dtype`` and rounded to
    the table's dtype once; otherwise only the looked-up rows are cast."""
    if torch.is_grad_enabled():
        return table.to(dtype)[tokens]
    return table[tokens].to(dtype)


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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: μ and E[x²] summed in float32, the variance max(E[x²] −
    μ², 0); μ and the rsqrt (taken in float32) rounded to ``x``'s dtype,
    then ``(x − μ) · rsqrt · weight + bias`` in that dtype."""
    d = x.shape[-1]
    xf = x.float()
    mu = (xf.sum(dim=-1) / d)[..., None]
    ss = (xf * xf).sum(dim=-1)
    var = torch.clamp(ss / d - mu[..., 0] ** 2, min=0.0)
    inv = torch.rsqrt(var + eps)[..., None]
    out = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return out * weight.to(x.dtype) + bias.to(x.dtype)


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
            blk = functools.partial(
                flash_attention, causal=causal, window=window, q_offset=q_offset + qs,
                kv_valid_len=kv_valid_len, chunk=chunk, kv_pos_offset=lo,
            )
            outs.append(remat(blk, q[:, qs : qs + q_chunk], k[:, lo:hi], v[:, lo:hi]))
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

    def body(m, l, acc, k_blk, v_blk, k_pos):  # noqa: E741
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
        return m_new, l, acc * corr[..., None] + pv

    m = torch.full((b, kv, g, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)  # noqa: E741
    acc = torch.zeros((b, kv, g, sq, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        k_pos = kv_pos_offset + c * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)
        m, l, acc = remat(body, m, l, acc, k[:, c * chunk : (c + 1) * chunk],  # noqa: E741
                          v[:, c * chunk : (c + 1) * chunk], k_pos)
    out = acc / torch.clamp(l, min=1e-20)[..., None]  # (B, KV, G, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + optional bias / qk-norm / window / cross)
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((h, hd), ("heads", None), init="zeros")
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", None), init="zeros")
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        specs["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    if cross:
        specs["gate"] = ParamSpec((), (), init="zeros")  # tanh-gated injection
    return specs


def project_qkv(params, x, cfg: ModelConfig, positions: Optional[torch.Tensor],
                rope: bool = True):
    """Shared q/k/v projection path (bias, qk-norm, and RoPE when ``rope``
    and ``positions`` is given)."""
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
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(params, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor], *, causal: bool = True,
                   rope: bool = True):
    """Self-attention of ``x`` (B, S, D), causal unless ``causal=False``:
    (y, k, v), the layer's k and v being what prefill keeps as its cache
    (the reference recomputes them from the same input: the same values)."""
    q, k, v = project_qkv(params, x, cfg, positions, rope=rope)
    out = flash_attention(q, k, v, causal=causal, window=cfg.window, chunk=cfg.attn_chunk,
                          q_chunk=cfg.q_chunk)
    return dot(out, params["wo"], contract=2), k, v


def decode_attention(
    params,
    x_step: torch.Tensor,  # (B, 1, D)
    cache_k: torch.Tensor,  # (B, S, KV, hd)
    cache_v: torch.Tensor,
    index: int,  # tokens already in cache
    cfg: ModelConfig,
    *,
    rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a KV cache; returns (out, cache_k,
    cache_v), the caches written in place at ``index`` (a ring slot for a
    sliding-window cache of ``cfg.window`` slots).  An ``index`` past a
    linear cache raises ``IndexError`` where the reference's update would
    clamp."""
    pos = torch.full((1,), index, dtype=torch.int32, device=x_step.device)
    q, k_new, v_new = project_qkv(params, x_step, cfg, pos, rope=rope)
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


def _gated(params, y: torch.Tensor) -> torch.Tensor:
    if "gate" in params:
        y = torch.tanh(params["gate"].float()).to(y.dtype) * y
    return y


def cross_attention(params, x: torch.Tensor, kv_feats: torch.Tensor, cfg: ModelConfig):
    """Gated cross-attention of ``x`` (B, S, D) on ``kv_feats`` (B, Nv, D)
    (the VLM's image layers, ungated in the enc-dec decoder), non-causal,
    with ``q_norm``/``k_norm`` when the config has them."""
    q = dot(x, params["wq"])
    k = dot(kv_feats, params["wk"])
    v = dot(kv_feats, params["wv"])
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    out = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk, q_chunk=cfg.q_chunk)
    return _gated(params, dot(out, params["wo"], contract=2))


def cross_attention_cached(params, x_step: torch.Tensor, cross_k, cross_v, cfg: ModelConfig):
    """Decode-time cross-attention against the prefill's (B, Nv, KV, hd)
    K/V.  As in the reference, neither ``q_norm`` here nor ``k_norm`` in
    the prefill's K is applied (reference fault 6, ROADMAP.md section 3)."""
    q = dot(x_step, params["wq"])
    out = flash_attention(q, cross_k, cross_v, causal=False, chunk=cfg.attn_chunk)
    return _gated(params, dot(out, params["wo"], contract=2))


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


def gelu_mlp_specs(d: int, f: int) -> Dict[str, ParamSpec]:
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp")),
        "b1": ParamSpec((f,), ("mlp",), init="zeros"),
        "w2": ParamSpec((f, d), ("mlp", "embed")),
        "b2": ParamSpec((d,), ("embed",), init="zeros"),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """Biased two-layer MLP with the tanh-approximated GELU in float32."""
    h = dot(x, params["w1"]) + params["b1"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dot(h, params["w2"]) + params["b2"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts: capacity-based scatter dispatch
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype=torch.float32),
        "wg": ParamSpec((e, d, f), ("experts", "expert_embed", "expert_mlp")),
        "wu": ParamSpec((e, d, f), ("experts", "expert_embed", "expert_mlp")),
        "wd": ParamSpec((e, f, d), ("experts", "expert_mlp", "expert_embed")),
    }
    if cfg.d_ff_dense:
        specs["dense"] = swiglu_specs(d, cfg.d_ff_dense)
    return specs


class Routing(NamedTuple):
    """One MoE call's dispatch: ``logits`` and ``probs`` (B, S, E) float32;
    ``gates`` and ``idx`` (B, S, k), the top-k in descending order, the
    lower expert first on ties; ``pos`` (B, S·k), each (token, slot) pair's
    rank among its expert's pairs of the same sequence; ``keep`` = pos <
    ``capacity``; ``dst`` the pair's slot in the (E·C + 1)-row dispatch
    buffer, the last row a sink for the dropped pairs."""

    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    dst: torch.Tensor
    capacity: int


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) by one comparison: the same ops on
    every device (``F.one_hot`` checks the indices' range with a host read
    on the CPU and scatters there, but compares on the meta device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router of :func:`moe_ffn` on ``x`` (B, S, D): float32 logits,
    softmax, top-k and the per-example capacity C = ⌈cf·k·S/E⌉."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, the lower index first on ties.
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[..., :k], order.indices[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    capacity = int(math.ceil(cfg.capacity_factor * k * s / e))
    e_flat = idx.reshape(b, s * k)
    ranks = torch.cumsum(_one_hot(e_flat, e), dim=1) - 1  # batch-local
    pos = torch.gather(ranks, -1, e_flat[..., None])[..., 0]
    keep = pos < capacity
    dst = torch.where(keep, e_flat * capacity + pos, e * capacity)
    return Routing(logits, probs, gates, idx, pos, keep, dst, capacity)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-dispatch MoE on ``x`` (B, S, D); returns (output,
    load-balance aux loss).  Dispatch is per example: each sequence fills
    its own C slots per expert, in token order, and pairs past them are
    dropped.  Every expert computes all of its C slots."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = moe_route(params["router"], x, cfg)
    capacity = r.capacity

    # Load-balance aux (Switch): E · Σ_e fraction_e · prob_e.
    me = r.probs.mean(dim=(0, 1))
    ce = _one_hot(r.idx, e).float().sum(dim=2).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    x_rep = torch.repeat_interleave(x, k, dim=1)  # (B, S·k, D)
    bidx = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e * capacity + 1, d))
    buf[bidx, r.dst] = x_rep  # duplicates only at the sink row, sliced off
    h = buf[:, : e * capacity].reshape(b, e, capacity, d).transpose(0, 1)
    h = h.reshape(e, b * capacity, d)  # (E, B·C, D): one product per expert
    g = torch.bmm(h, params["wg"].to(x.dtype))
    u = torch.bmm(h, params["wu"].to(x.dtype))
    y = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(y, params["wd"].to(x.dtype))  # (E, B·C, D)
    y = y.reshape(e, b, capacity, d).transpose(0, 1).reshape(b, e * capacity, d)
    yf = torch.cat([y, y.new_zeros((b, 1, d))], dim=1)
    weight = (r.gates.reshape(b, s * k, 1) * r.keep[..., None]).to(x.dtype)
    out = (yf[bidx, r.dst] * weight).reshape(b, s, k, d).sum(dim=2)
    if "dense" in params:
        out = out + swiglu(params["dense"], x)
    return out, aux
