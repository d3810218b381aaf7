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

from repro_torch.models import tp
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


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype,
          parts: int = 1) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` in ``dtype`` (an exact cast).
    Under autograd the table is cast before the lookup, as the reference
    does, so that a token's gradients are summed in ``dtype`` and rounded to
    the table's dtype once; otherwise only the looked-up rows are cast.

    ``parts`` > 1: ``table`` is this device's block of the vocab rows (a
    device's program, ``models/tp.py``); tokens outside it give zero rows,
    and the blocks' rows are summed over the ``"model"`` axis."""
    if parts > 1:
        local = tokens - tp.rank() * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        rows = embed(table, local.clamp(0, table.shape[0] - 1), dtype)
        return tp.reduce(rows * inside[..., None].to(dtype))
    if torch.is_grad_enabled():
        return table.to(dtype)[tokens]
    return table[tokens].to(dtype)


def vocab_logits(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, parts: int = 1):
    """``x · w`` over the (padded) vocab in ``x``'s dtype, the columns
    ≥ ``vocab`` masked to −1e30; with ``parts`` > 1 ``w`` holds this
    device's block of the columns, and the blocks are gathered."""
    if parts > 1:
        x = tp.enter(x)
    logits = dot(x, w)
    if cfg.padded_vocab != cfg.vocab:  # mask pad columns (see padded_vocab)
        cols = tp.rank() * w.shape[-1] if parts > 1 else 0
        pad = torch.arange(cols, cols + w.shape[-1], device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return tp.gather(logits, -1) if parts > 1 else logits


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


class HeadSplit(NamedTuple):
    """How a device's program holds an attention's heads (``models/tp.py``):
    ``parts`` blocks of the query heads; ``kv`` the KV heads its query
    heads read where the KV heads are whole on every device (None: its KV
    heads line up with its query heads); ``index`` each local query head's
    KV head within ``kv`` where they do not form equal groups (else None)."""

    parts: int
    kv: Optional[slice]
    index: Optional[Tuple[int, ...]]


def head_split(params, cfg: ModelConfig) -> HeadSplit:
    """The :class:`HeadSplit` of ``params`` (an attention's weights)."""
    hp = tp.parts(params, "wq", 1)
    if hp == 1 or tp.parts(params, "wk", 1) == hp:
        return HeadSplit(hp, None, None)
    h_loc, g = cfg.n_heads // hp, cfg.n_heads // cfg.n_kv_heads
    first = tp.rank() * h_loc
    heads = [(first + i) // g for i in range(h_loc)]
    kv0, n_kv = heads[0], heads[-1] - heads[0] + 1
    index = tuple(hh - kv0 for hh in heads)
    uniform = h_loc % n_kv == 0 and index == tuple(i // (h_loc // n_kv) for i in range(h_loc))
    return HeadSplit(hp, slice(kv0, kv0 + n_kv), None if uniform else index)


def _kv_weights(params, split: HeadSplit, whole: bool = False):
    """(wk, wv, bk, bv) of the KV heads the program computes: every head
    when ``whole`` (a cache that holds them all), else ``split.kv``'s.
    Whole KV weights read by a device's heads enter its split region: each
    position's gradient holds its query heads' part of theirs."""
    names = ("wk", "wv", "bk", "bv") if "bk" in params else ("wk", "wv")
    out = [params[n] for n in names]
    if split.kv is not None:
        out = [tp.enter(t) for t in out]
        if not whole:
            out = [t[:, split.kv] if t.dim() == 3 else t[split.kv] for t in out]
    return out + [None] * (4 - len(out))


def _qk_norms(params, split: HeadSplit):
    """``q_norm`` and ``k_norm`` (one weight for every head), entering a
    device's split region where its heads are a block."""
    norms = params["q_norm"], params["k_norm"]
    return tuple(tp.enter(w) for w in norms) if split.parts > 1 else norms


def select_kv(k: torch.Tensor, split: HeadSplit, whole: bool = False) -> torch.Tensor:
    """The KV heads (dim −2) of the local query heads, from ``k`` holding
    ``split.kv``'s heads (or every head when ``whole``): one per query head
    where they do not form equal groups."""
    if split.kv is not None and whole:
        k = k[..., split.kv, :]
    if split.index is not None:
        k = k[..., list(split.index), :]
    return k


def project_qkv(params, x, cfg: ModelConfig, positions: Optional[torch.Tensor],
                rope: bool = True, whole_kv: bool = False):
    """Shared q/k/v projection path (bias, qk-norm, and RoPE when ``rope``
    and ``positions`` is given).  In a device's program the query heads are
    its block, and the KV heads those it reads (every KV head with
    ``whole_kv``, where a cache keeps them all; :func:`head_split`)."""
    split = head_split(params, cfg)
    if split.parts > 1:
        x = tp.enter(x)
    wk, wv, bk, bv = _kv_weights(params, split, whole_kv)
    q = dot(x, params["wq"])
    k = dot(x, wk)
    v = dot(x, wv)
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    if "q_norm" in params:
        q_norm, k_norm = _qk_norms(params, split)
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params, out: torch.Tensor, split: HeadSplit) -> torch.Tensor:
    """The output projection; a partial sum over split heads is summed."""
    y = dot(out, params["wo"], contract=2)
    return tp.reduce(y) if split.parts > 1 else y


def self_attention(params, x: torch.Tensor, cfg: ModelConfig,
                   positions: Optional[torch.Tensor], *, causal: bool = True,
                   rope: bool = True, cache_kv: bool = False):
    """Self-attention of ``x`` (B, S, D), causal unless ``causal=False``:
    (y, k, v), the layer's k and v being what prefill keeps as its cache
    (the reference recomputes them from the same input: the same values).
    ``cache_kv``: k and v are kept, so a device's program computes every KV
    head its cache holds."""
    split = head_split(params, cfg)
    q, k, v = project_qkv(params, x, cfg, positions, rope=rope, whole_kv=cache_kv)
    out = flash_attention(q, select_kv(k, split, cache_kv), select_kv(v, split, cache_kv),
                          causal=causal, window=cfg.window, chunk=cfg.attn_chunk,
                          q_chunk=cfg.q_chunk)
    return _out_proj(params, out, split), k, v


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
    split = head_split(params, cfg)
    q, k_new, v_new = project_qkv(params, x_step, cfg, pos, rope=rope)
    blocks = tp.seq_blocks()
    s_ctx, window = cache_k.shape[1] * blocks, cfg.window
    if window is not None and s_ctx == window:
        # Ring-buffer cache for sliding-window attention: positions rotate;
        # every slot is valid once the cache is full (mask via valid_len).
        slot, valid = index % window, min(index + 1, window)
    else:
        slot, valid = index, index + 1
    ck, cv = cache_k, cache_v
    if split.kv is not None:  # a cache of every KV head: this program's heads
        ck, cv = cache_k[:, :, split.kv], cache_v[:, :, split.kv]
    if blocks > 1:
        out = _decode_attention_blocks(q, ck, cv, k_new, v_new, slot, valid, split)
    else:
        ck[:, slot] = k_new[:, 0]
        cv[:, slot] = v_new[:, 0]
        out = flash_attention(
            q, select_kv(ck, split), select_kv(cv, split), causal=False, q_offset=index,
            kv_valid_len=valid, chunk=cfg.attn_chunk,
        )
    return _out_proj(params, out, split), cache_k, cache_v


def _decode_attention_blocks(q, ck, cv, k_new, v_new, slot: int, valid: int,
                             split: HeadSplit) -> torch.Tensor:
    """One query against a cache whose slots are split over the ``kv_seq``
    axes (a device's program): the block that holds ``slot`` writes the new
    key, each block scores its own slots, and the blocks' softmax maxima
    (gathered), normalizers and weighted values (summed) combine as one
    softmax over every slot (float32, as :func:`flash_attention`)."""
    b, _, h, hd = q.shape
    n = ck.shape[1]
    first = tp.rank("kv_seq") * n
    if first <= slot < first + n:
        ck[:, slot - first] = k_new[:, 0]
        cv[:, slot - first] = v_new[:, 0]
    k, v = select_kv(ck, split), select_kv(cv, split)
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, hd).permute(0, 2, 3, 1, 4).float()  # (B, KV, G, 1, hd)
    s = torch.matmul(qg, k.permute(0, 2, 3, 1)[:, :, None].float()) / math.sqrt(hd)
    mask = (first + torch.arange(n, device=q.device)) < valid  # (n,)
    s = torch.where(mask, s, _NEG_INF)
    m = tp.gather(s.amax(dim=-1)[None], 0, "kv_seq").amax(dim=0)  # (B, KV, G, 1)
    p = torch.exp(s - m[..., None]) * mask
    l = tp.reduce(p.sum(dim=-1), "kv_seq")  # noqa: E741
    acc = torch.matmul(p.to(v.dtype).float(), v.permute(0, 2, 1, 3)[:, :, None].float())
    out = tp.reduce(acc, "kv_seq") / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)


def _gated(params, y: torch.Tensor) -> torch.Tensor:
    if "gate" in params:
        y = torch.tanh(params["gate"].float()).to(y.dtype) * y
    return y


def cross_attention(params, x: torch.Tensor, kv_feats: torch.Tensor, cfg: ModelConfig):
    """Gated cross-attention of ``x`` (B, S, D) on ``kv_feats`` (B, Nv, D)
    (the VLM's image layers, ungated in the enc-dec decoder), non-causal,
    with ``q_norm``/``k_norm`` when the config has them."""
    split = head_split(params, cfg)
    if split.parts > 1:
        x, kv_feats = tp.enter(x), tp.enter(kv_feats)
    wk, wv, _, _ = _kv_weights(params, split)
    q = dot(x, params["wq"])
    k = dot(kv_feats, wk)
    v = dot(kv_feats, wv)
    if "q_norm" in params:
        q_norm, k_norm = _qk_norms(params, split)
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    out = flash_attention(q, select_kv(k, split), select_kv(v, split), causal=False,
                          chunk=cfg.attn_chunk, q_chunk=cfg.q_chunk)
    return _gated(params, _out_proj(params, out, split))


def cross_attention_cached(params, x_step: torch.Tensor, cross_k, cross_v, cfg: ModelConfig):
    """Decode-time cross-attention against the prefill's (B, Nv, KV, hd)
    K/V.  As in the reference, neither ``q_norm`` here nor ``k_norm`` in
    the prefill's K is applied (reference fault 6, ROADMAP.md section 3)."""
    split = head_split(params, cfg)
    q = dot(x_step, params["wq"])
    out = flash_attention(q, select_kv(cross_k, split, True), select_kv(cross_v, split, True),
                          causal=False, chunk=cfg.attn_chunk)
    return _gated(params, _out_proj(params, out, split))


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
    parts = tp.parts(params, "wg", 1)
    if parts > 1:
        x = tp.enter(x)
    g = dot(x, params["wg"])
    u = dot(x, params["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    y = dot(h, params["wd"])
    return tp.reduce(y) if parts > 1 else y


def gelu_mlp_specs(d: int, f: int) -> Dict[str, ParamSpec]:
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp")),
        "b1": ParamSpec((f,), ("mlp",), init="zeros"),
        "w2": ParamSpec((f, d), ("mlp", "embed")),
        "b2": ParamSpec((d,), ("embed",), init="zeros"),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """Biased two-layer MLP with the tanh-approximated GELU in float32."""
    parts = tp.parts(params, "w1", 1)
    if parts > 1:
        x = tp.enter(x)
    h = dot(x, params["w1"]) + params["b1"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = dot(h, params["w2"])
    return (tp.reduce(y) if parts > 1 else y) + params["b2"].to(x.dtype)


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
    return _route(torch.matmul(x.float(), router.float()), cfg)


def _route(logits: torch.Tensor, cfg: ModelConfig) -> Routing:
    """:func:`moe_route` from the router's float32 logits (B, S, E)."""
    b, s, _ = logits.shape
    e, k = cfg.n_experts, cfg.top_k
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


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` (B, S, E) over its tokens.  In a data-parallel
    train program (``models/tp.py``) the batch is the replica's share, so
    the replicas' sums are joined over the ``"batch"`` axes; a forward
    without autograd (prefill, serving) discards the balance loss."""
    lay = tp.current()
    n = 1 if lay is None else lay.size("batch")
    if n == 1 or not torch.is_grad_enabled():
        return x.mean(dim=(0, 1))
    return tp.join(x.sum(dim=(0, 1))) / (x.shape[0] * x.shape[1] * n)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-dispatch MoE on ``x`` (B, S, D); returns (output,
    load-balance aux loss).  Dispatch is per example: each sequence fills
    its own C slots per expert, in token order, and pairs past them are
    dropped.  Every expert computes all of its C slots."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    # A device's program (models/tp.py): its block of the experts (the
    # router's logits gathered, the dispatch and combine over its experts'
    # slots) or of every expert's hidden width; its outputs are summed.
    # The routing is whole on every position (a split router's logits are
    # gathered) and the gates enter the split region with the tokens, so
    # the gradients of the logits are whole too.
    pe, pf = tp.parts(params, "router", 1), tp.parts(params, "wg", 2)
    xm = tp.enter(x) if pe > 1 or pf > 1 else x  # the dense residual enters on its own
    logits = torch.matmul((xm if pe > 1 else x).float(), params["router"].float())
    r = _route(tp.gather(logits, -1) if pe > 1 else logits, cfg)
    capacity = r.capacity

    # Load-balance aux (Switch): E · Σ_e fraction_e · prob_e.
    me = _batch_mean(r.probs)
    ce = _batch_mean(_one_hot(r.idx, e).float().sum(dim=2))
    aux = e * torch.sum(me * ce)

    dst, keep = r.dst, r.keep
    if pe > 1:  # this device's experts [e0, e0 + e): the others' pairs to the sink
        e_flat, e = r.idx.reshape(b, s * k), e // pe
        mine = (e_flat >= tp.rank() * e) & (e_flat < (tp.rank() + 1) * e)
        keep = keep & mine
        dst = torch.where(keep, (e_flat - tp.rank() * e) * capacity + r.pos, e * capacity)
    x_rep = torch.repeat_interleave(xm, k, dim=1)  # (B, S·k, D)
    bidx = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e * capacity + 1, d))
    buf[bidx, dst] = x_rep  # duplicates only at the sink row, sliced off
    h = buf[:, : e * capacity].reshape(b, e, capacity, d).transpose(0, 1)
    h = h.reshape(e, b * capacity, d)  # (E, B·C, D): one product per expert
    g = torch.bmm(h, params["wg"].to(x.dtype))
    u = torch.bmm(h, params["wu"].to(x.dtype))
    y = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(y, params["wd"].to(x.dtype))  # (E, B·C, D)
    y = y.reshape(e, b, capacity, d).transpose(0, 1).reshape(b, e * capacity, d)
    yf = torch.cat([y, y.new_zeros((b, 1, d))], dim=1)
    gates = tp.enter(r.gates) if pe > 1 or pf > 1 else r.gates
    weight = (gates.reshape(b, s * k, 1) * keep[..., None]).to(x.dtype)
    out = (yf[bidx, dst] * weight).reshape(b, s, k, d).sum(dim=2)
    if pe > 1 or pf > 1:
        out = tp.reduce(out)
    if "dense" in params:
        out = out + swiglu(params["dense"], x)
    return out, aux
