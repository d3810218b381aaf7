"""xLSTM blocks: the chunkwise mLSTM (matrix memory) and the recurrent sLSTM
(the port of ``repro.models.xlstm``).

The mLSTM runs in its chunkwise linear-attention form, the chunk skeleton of
``ssm.py``: per-head scalar forget-gate decays, input-gated keys, and a ones
column appended to V that carries the normalizer n, so numerator and
denominator share one state (B, H, qk, vd + 1) float32.  Its input gate is a
sigmoid, and the output divides by max(|den|, 1), as in the reference.  The
sLSTM has block-diagonal recurrent gate weights, so its forward is a
sequential loop over time (the reference's ``lax.scan``); its cell starts at
c = h = 0, n = 1.  Decode updates each cache's tensors in place.

Rounding order as in the reference: the conv and its SiLU in float32,
rounded to the activations' dtype; the gates, the states and the chunk
contractions in float32 (model-dtype operands upcast exactly); the mLSTM's
output rounded to the activations' dtype before ``_head_norm`` (float32,
rounded back), then multiplied by SiLU(gate) rounded to that dtype; the
sLSTM's FFN with the tanh-approximated GELU in float32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import _causal_conv, _conv_step, _decays, check_chunks


class MLSTMCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_w − 1, d_inner): the pre-conv inputs (``up``)
    state: torch.Tensor  # (B, H, qk, v + 1) float32, the last column the normalizer n


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, hd) float32
    n: torch.Tensor  # (B, H, hd) float32
    h: torch.Tensor  # (B, H, hd) float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, h, qk = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.mlstm_qk_dim
    vd = di // h
    return {
        "w_up": ParamSpec((d, di), ("embed", "mlp")),
        "w_gate": ParamSpec((d, di), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, di), (None, "mlp")),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros"),
        "wq": ParamSpec((di, h, qk), ("mlp", "heads", None)),
        "wk": ParamSpec((di, h, qk), ("mlp", "heads", None)),
        "wv": ParamSpec((di, h, vd), ("mlp", "heads", None)),
        "w_if": ParamSpec((di, 2, h), ("mlp", None, "heads"), dtype=torch.float32),
        "b_if": ParamSpec((2, h), (None, "heads"), dtype=torch.float32, init="zeros"),
        "norm": ParamSpec((h, vd), ("heads", None), init="ones"),
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _head_norm(y: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm in float32, rounded back: y (B, T, H, vd), w (H, vd)."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


def _ones_column(v: torch.Tensor) -> torch.Tensor:
    """``v`` in float32 with a column of ones appended (the normalizer)."""
    return torch.cat([v.float(), v.new_ones((*v.shape[:-1], 1), dtype=torch.float32)], dim=-1)


def _mlstm_out(params, y_all: torch.Tensor, gate: torch.Tensor, cfg: ModelConfig,
               dtype) -> torch.Tensor:
    """num / max(|den|, 1), head-normed, times SiLU(gate), then ``w_down``:
    y_all (B, T, H, vd + 1) float32 → (B, T, D)."""
    b, t, h, vd = y_all.shape[0], y_all.shape[1], y_all.shape[2], y_all.shape[3] - 1
    y = y_all[..., :vd] / torch.clamp(y_all[..., vd:].abs(), min=1.0)
    y = _head_norm(y.to(dtype), params["norm"], cfg.norm_eps)
    parts = tp.parts(params, "w_down", 0)
    y = y.reshape(b, t, h * vd)
    if parts > 1:  # the whole cell's output enters the split down projection
        y = tp.chunk(tp.enter(y), -1, parts)
    y = y * F.silu(gate.float()).to(dtype)
    out = L.dot(y, params["w_down"])
    return tp.reduce(out) if parts > 1 else out


def _mlstm_in(params, x: torch.Tensor, conv_of):
    """(up, gate, conv, q, k, v, if-gates) of the mLSTM's input ``x``: in a
    device's program (``models/tp.py``) up, gate and the conv are its block
    of d_inner, and the head projections (contracting d_inner) are summed,
    so that the cell runs on every head.  ``conv_of(up)`` is the causal
    conv of the sequence or the decode step's."""
    parts = tp.parts(params, "w_up", 1)
    if tp.parts(params, "norm", 0) > 1:
        raise ValueError("the mLSTM's heads split over 'model' is not a layout its "
                         "per-device program runs (the xLSTM configs replicate them)")
    if parts > 1:
        x = tp.enter(x)
    up = L.dot(x, params["w_up"])
    gate = L.dot(x, params["w_gate"])
    conv = conv_of(up)

    def summed(y):
        return tp.reduce(y) if parts > 1 else y

    q = summed(L.dot(conv, params["wq"]))
    k = summed(L.dot(conv, params["wk"]))
    v = summed(L.dot(up, params["wv"]))
    if_gates = summed(L.dot(conv.float(), params["w_if"])) + params["b_if"]
    return up, gate, conv, q, k, v, if_gates


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence chunkwise mLSTM of x (B, T, D), T a multiple of
    ``ssm_chunk`` (else ``ValueError``).  With ``return_cache`` also the
    :class:`MLSTMCache` after the last token."""
    b, t, _ = x.shape
    h, qkd, di, q_len = cfg.n_heads, cfg.mlstm_qk_dim, cfg.d_inner, cfg.ssm_chunk
    vd = di // h
    check_chunks(t, cfg)

    up, gate, conv, q, k, v, if_gates = _mlstm_in(
        params, x, lambda u: _causal_conv(u, params["conv_w"], params["conv_b"]))
    scale = 1.0 / math.sqrt(qkd)
    q, k = q.float(), k.float()  # (B, T, H, qk): exact upcasts
    v_aug = _ones_column(v)  # (B, T, H, vd + 1)
    # if_gates: (B, T, 2, H)
    i_g = torch.sigmoid(if_gates[:, :, 0])  # (B, T, H)
    log_f = F.logsigmoid(if_gates[:, :, 1])  # ≤ 0

    above = torch.ones((q_len, q_len), dtype=torch.bool, device=x.device).triu(1)
    state = torch.zeros((b, h, qkd, vd + 1), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(t // q_len):
        sl = slice(c * q_len, (c + 1) * q_len)
        q_k, k_k, v_k, i_k = q[:, sl], k[:, sl], v_aug[:, sl], i_g[:, sl]
        cum = torch.cumsum(log_f[:, sl], dim=1)  # (B, Q, H)
        att = torch.matmul(q_k.transpose(1, 2), k_k.permute(0, 2, 3, 1)) * scale  # (B, H, Qt, Qs)
        # the decays, then the input gate at the source position
        decays, i_src = _decays(cum, above), i_k.transpose(1, 2)[:, :, None, :]
        if torch.is_grad_enabled():
            scores = att * decays * i_src
        else:
            scores = att.mul_(decays).mul_(i_src)
        y_intra = torch.matmul(scores, v_k.transpose(1, 2)).transpose(1, 2)  # (B, Qt, H, V)
        y_inter = torch.einsum("bqhn,bhnv->bqhv", q_k * scale, state) * torch.exp(cum)[..., None]
        decay_end = torch.exp(cum[:, -1:, :] - cum) * i_k  # (B, Q, H)
        state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bshn,bshv->bhnv", k_k, v_k * decay_end[..., None])
        ys.append(y_intra + y_inter)
    out = _mlstm_out(params, torch.cat(ys, dim=1), gate, cfg, x.dtype)
    if return_cache:
        return out, MLSTMCache(conv=up[:, t - (cfg.ssm_conv - 1) :], state=state)
    return out


def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> MLSTMCache:
    h, qk, vd = cfg.n_heads, cfg.mlstm_qk_dim, cfg.d_inner // cfg.n_heads
    return MLSTMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        state=torch.zeros((batch, h, qk, vd + 1), dtype=torch.float32, device=device),
    )


def mlstm_decode_step(
    params, x_step: torch.Tensor, cache: MLSTMCache, cfg: ModelConfig
) -> Tuple[torch.Tensor, MLSTMCache]:
    """One token x_step (B, 1, D).  Updates ``cache.conv`` and ``cache.state``
    in place and returns (out, cache)."""
    def conv_of(up):
        window = torch.cat([cache.conv, up], dim=1)
        conv = _conv_step(window, params["conv_w"], params["conv_b"], x_step.dtype)
        cache.conv.copy_(window[:, 1:])
        return conv

    up, gate, conv, q, k, v, if_g = _mlstm_in(params, x_step, conv_of)
    q, k = q[:, 0].float(), k[:, 0].float()  # (B, H, qk)
    v_aug = _ones_column(v[:, 0])  # (B, H, vd + 1)
    if_g = if_g[:, 0]  # (B, 2, H)
    i_g = torch.sigmoid(if_g[:, 0])  # (B, H)
    f_g = torch.exp(F.logsigmoid(if_g[:, 1]))
    state = cache.state
    outer = k[..., :, None] * v_aug[..., None, :]  # (B, H, qk, vd + 1)
    state.mul_(f_g[..., None, None]).add_(i_g[..., None, None] * outer)
    scale = 1.0 / math.sqrt(cfg.mlstm_qk_dim)
    y_all = torch.matmul((q * scale)[:, :, None, :], state)[:, None, :, 0]  # (B, 1, H, vd + 1)
    return _mlstm_out(params, y_all, gate, cfg, x_step.dtype), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    ff = ((int(math.ceil(4 * d / 3)) + 127) // 128) * 128
    return {
        "conv_w": ParamSpec((cfg.ssm_conv, d), (None, "embed")),
        "conv_b": ParamSpec((d,), ("embed",), init="zeros"),
        # 4 gates (z, i, f, o): input weights and per-head recurrent weights
        "w_gates": ParamSpec((d, 4, h, hd), ("embed", None, "heads", None)),
        "r_gates": ParamSpec((4, h, hd, hd), (None, "heads", None, None)),
        "b_gates": ParamSpec((4, h, hd), (None, "heads", None), init="zeros"),
        "norm": ParamSpec((h, hd), ("heads", None), init="ones"),
        # the post-cell gated FFN (factor 4/3 GLU)
        "w_ff_up": ParamSpec((d, 2, ff), ("embed", None, "mlp")),
        "w_ff_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def _slstm_cell(params, gates_x: torch.Tensor,
                state: SLSTMCache) -> Tuple[SLSTMCache, torch.Tensor]:
    """One time step; gates_x (B, 4, H, hd) the input contributions."""
    rec = torch.einsum("bhd,ghde->bghe", state.h, params["r_gates"].float())  # (B, 4, H, hd)
    pre = gates_x.float() + rec + params["b_gates"].float()
    z = torch.tanh(pre[:, 0])
    i = torch.sigmoid(pre[:, 1])
    f = torch.sigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    c = f * state.c + i * z
    n = f * state.n + i
    h_new = o * c / torch.clamp(n, min=1.0)
    return SLSTMCache(c=c, n=n, h=h_new), h_new


def _slstm_ffn(params, h_out: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """The head norm and the GELU GLU on the cell outputs (B, T, H, hd)
    float32 → (B, T, D)."""
    b, t, h, hd = h_out.shape
    y = _head_norm(h_out.to(dtype), params["norm"], cfg.norm_eps).reshape(b, t, h * hd)
    parts = tp.parts(params, "w_ff_up", 2)  # a device's block of the GLU's width
    if parts > 1:
        y = tp.enter(y)
    up = L.dot(y, params["w_ff_up"])  # (B, T, 2, ff)
    ff = F.gelu(up[:, :, 0].float(), approximate="tanh").to(dtype) * up[:, :, 1]
    out = L.dot(ff, params["w_ff_down"])
    return tp.reduce(out) if parts > 1 else out


def _slstm_heads_whole(params) -> None:
    if tp.parts(params, "w_gates", 2) > 1:
        raise ValueError("the sLSTM's heads split over 'model' is not a layout its "
                         "per-device program runs (the xLSTM configs replicate them)")


def slstm_init_cell(cfg: ModelConfig, batch: int, device=None) -> SLSTMCache:
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMCache(c=zeros, n=torch.ones_like(zeros), h=zeros.clone())


def slstm_forward(params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """The sLSTM over x (B, T, D), one time step after another.  With
    ``return_cache`` also (the last K − 1 inputs, the cell after the last
    step)."""
    b, t, _ = x.shape
    _slstm_heads_whole(params)
    conv = _causal_conv(x, params["conv_w"], params["conv_b"])
    gates_x = L.dot(conv, params["w_gates"])  # (B, T, 4, H, hd)
    state = slstm_init_cell(cfg, b, x.device)
    hs = []
    for i in range(t):
        state, h_out = _slstm_cell(params, gates_x[:, i], state)
        hs.append(h_out)
    out = _slstm_ffn(params, torch.stack(hs, dim=1), cfg, x.dtype)
    if return_cache:
        return out, (x[:, t - (cfg.ssm_conv - 1) :], state)
    return out


def slstm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None):
    conv = torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_model), dtype=dtype, device=device)
    return conv, slstm_init_cell(cfg, batch, device)


def slstm_decode_step(params, x_step: torch.Tensor, cache, cfg: ModelConfig):
    """One token x_step (B, 1, D) against ``cache`` = (conv buffer,
    :class:`SLSTMCache`), whose tensors it updates in place; returns (out,
    cache)."""
    conv_buf, cell = cache
    _slstm_heads_whole(params)
    window = torch.cat([conv_buf, x_step], dim=1)
    conv = _conv_step(window, params["conv_w"], params["conv_b"], x_step.dtype)
    conv_buf.copy_(window[:, 1:])
    gx = L.dot(conv, params["w_gates"])[:, 0]  # (B, 4, H, hd)
    new_cell, h_out = _slstm_cell(params, gx, cell)
    for dst, src in zip(cell, new_cell):
        dst.copy_(src)
    return _slstm_ffn(params, h_out[:, None], cfg, x_step.dtype), cache
