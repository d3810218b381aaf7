"""Mamba2 (SSD) blocks for the zamba2 hybrid (the port of
``repro.models.ssm``).

The full-sequence forward is the chunked SSD (Dao & Gu 2024): within a chunk
of ``ssm_chunk`` steps the recurrence is a masked attention-like contraction;
across chunks a (B, H, P, N) float32 state is carried, here by a Python loop
in place of the reference's ``lax.scan``.  Decode is the exact O(1)
recurrence, updating the cache's conv buffer and state in place.

Rounding order as in the reference: the conv and its SiLU in float32,
rounded to the activations' dtype; ``dt``, the decays and the state in
float32, the products of model-dtype operands exact in float32 (their
``preferred_element_type``); each chunk's output rounded to the activations'
dtype before the skip connection; ``_gated_norm`` in float32.  The
intra-chunk decays are one (B, H, Q, Q) buffer, made in place and masked by
a select (above the diagonal ``exp`` may overflow to inf, which a product
with a 0/1 mask would turn into NaN).  Under autograd (the loss's
backward) the decays and scores are made out of place, the entries above
the diagonal set to −inf before the ``exp`` so that their gradient is 0.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_w − 1, d_conv_channels): the pre-conv inputs
    state: torch.Tensor  # (B, H, P, N) float32


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n  # conv over [x, B, C]
    proj_out = 2 * di + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), (None, "mlp")),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), init="zeros"),
        "a_log": ParamSpec((h,), (None,), dtype=torch.float32, init="zeros"),
        "d_skip": ParamSpec((h,), (None,), dtype=torch.float32, init="ones"),
        "dt_bias": ParamSpec((h,), (None,), dtype=torch.float32, init="zeros"),
        "norm": ParamSpec((di,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di : 2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n :]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time with SiLU: xbc (B, T, C), w (K, C);
    the taps summed in float32 in order, the result rounded to xbc's
    dtype."""
    k, t = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i : i + t].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The causal conv with SiLU at the last step of ``window`` (B, K, C),
    in float32: (B, 1, C) rounded to ``dtype``."""
    out = (window.float() * w.float()).sum(dim=1) + b.float()
    return F.silu(out).to(dtype)[:, None]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float,
                parts: int = 1) -> torch.Tensor:
    """RMS norm of y · SiLU(z) over the last dim; with ``parts`` > 1 ``y``,
    ``z`` and ``w`` are this device's block of it, and the blocks' sums of
    squares are summed."""
    gated = y.float() * F.silu(z.float())
    if parts > 1:  # every block's norm reads the sum: its gradient sums theirs
        ss = tp.join((gated * gated).sum(dim=-1, keepdim=True), "model")
        var = ss / (gated.shape[-1] * parts)
    else:
        var = torch.mean(gated * gated, dim=-1, keepdim=True)
    return (gated * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


class _Split(NamedTuple):
    """How a device's program holds a Mamba2 block (``models/tp.py``): the
    blocks of the in-projection's output (gathered), of the conv's
    channels (conv'd locally, gathered), of the out-projection's input, and
    of the heads the SSD runs on (the out-projection's blocks when they are
    whole heads, else 1: the SSD whole, its output cut for the
    out-projection).  A whole tensor that a block-wise part reads enters
    the split region (``tp.enter``), so that its gradient is whole."""

    proj: int
    conv: int
    out: int
    heads: int


def _split(params, cfg: ModelConfig) -> _Split:
    out = tp.parts(params, "out_proj", 0)
    heads = out if out > 1 and cfg.ssm_heads % out == 0 else 1
    return _Split(tp.parts(params, "in_proj", 1), tp.parts(params, "conv_w", 1), out, heads)


def _in_proj(params, x: torch.Tensor, sp: _Split):
    """(z, xbc, dt) of ``x``, whole; each enters the split region where a
    block-wise part reads it: the heads' (all three) or the conv's
    channels' (xbc)."""
    if sp.proj > 1:
        zxbcdt = tp.gather(L.dot(tp.enter(x), params["in_proj"]), -1)
    else:
        zxbcdt = L.dot(x, params["in_proj"])
    if sp.heads > 1:
        zxbcdt = tp.enter(zxbcdt)
    return zxbcdt


def _of_heads(params, name: str, sp: _Split) -> torch.Tensor:
    """This device's heads' block of a per-head parameter (whole on every
    device)."""
    w = params[name]
    return tp.chunk(tp.enter(w), 0, sp.heads) if sp.heads > 1 else w


def _out(params, y: torch.Tensor, z: torch.Tensor, sp: _Split, cfg: ModelConfig) -> torch.Tensor:
    """The gated norm and the out-projection of the SSD's output ``y``
    (B, T, di, or this device's heads' block of it)."""
    if sp.heads > 1:  # y is this device's block: the norm's sums combine
        y = _gated_norm(y, tp.chunk(z, -1, sp.heads), params["norm"], cfg.norm_eps, sp.heads)
    else:
        w = params["norm"]
        y = _gated_norm(y, z, tp.gather(w, 0) if tp.parts(params, "norm", 0) > 1 else w,
                        cfg.norm_eps)
        y = tp.chunk(tp.enter(y) if sp.out > 1 else y, -1, sp.out)
    out = L.dot(y, params["out_proj"])
    return tp.reduce(out) if sp.out > 1 else out


def _decays(cum: torch.Tensor, above: torch.Tensor) -> torch.Tensor:
    """exp(cum_t − cum_s) for s ≤ t, else 0: cum (B, Q, H) → (B, H, Qt, Qs)
    float32, made in place unless autograd records the forward."""
    cum_h = cum.transpose(1, 2)
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    if torch.is_grad_enabled():
        return diff.masked_fill(above, float("-inf")).exp()
    return diff.exp_().masked_fill_(above, 0.0)


def check_chunks(t: int, cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``t`` is a whole number of SSD chunks."""
    if t % cfg.ssm_chunk:
        raise ValueError(f"T={t} must be a multiple of ssm_chunk={cfg.ssm_chunk}")


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence SSD forward of x (B, T, D), T a multiple of
    ``ssm_chunk`` (else ``ValueError``).  With ``return_cache`` also the
    :class:`MambaCache` after the last token: the final state and the conv's
    last K − 1 pre-conv inputs."""
    b, t, _ = x.shape
    di, n, h, p, q = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
    check_chunks(t, cfg)

    sp = _split(params, cfg)
    z, xbc, dt_raw = _split_proj(cfg, _in_proj(params, x, sp))
    # the conv's channels (and the decode cache's) in this device's block
    if sp.conv > 1 and sp.heads == 1:
        xbc = tp.enter(xbc)
    xbc = tp.chunk(xbc, -1, sp.conv)
    conv_tail = xbc[:, t - (cfg.ssm_conv - 1) :]  # pre-conv inputs for decode
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    if sp.conv > 1:
        xbc = tp.gather(xbc, -1)
        if sp.heads > 1:
            xbc = tp.enter(xbc)
    h = h // sp.heads
    xs = tp.chunk(xbc[..., :di].reshape(b, t, -1, p), 2, sp.heads)
    bmat = xbc[..., di : di + n].float()  # (B, T, N): exact upcasts
    cmat = xbc[..., di + n :].float()
    dt = F.softplus(tp.chunk(dt_raw.float(), -1, sp.heads)
                    + _of_heads(params, "dt_bias", sp))  # (B, T, H)
    a_log_step = dt * -torch.exp(_of_heads(params, "a_log", sp))  # ≤ 0: per-step log decay
    xdt = xs.float() * dt[..., None]  # (B, T, H, P)

    above = torch.ones((q, q), dtype=torch.bool, device=x.device).triu(1)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(t // q):
        sl = slice(c * q, (c + 1) * q)
        b_k, c_k, xdt_k = bmat[:, sl], cmat[:, sl], xdt[:, sl]
        cum = torch.cumsum(a_log_step[:, sl], dim=1)  # (B, Q, H) inclusive
        # intra-chunk: y_t += C_t · Σ_{s≤t} exp(cum_t − cum_s) dt_s B_s x_s
        scores = _decays(cum, above)  # (B, H, Qt, Qs)
        cb = torch.matmul(c_k, b_k.transpose(1, 2))[:, None]  # · C_t B_s
        scores = scores * cb if torch.is_grad_enabled() else scores.mul_(cb)
        y_intra = torch.matmul(scores, xdt_k.transpose(1, 2)).transpose(1, 2)  # (B, Qt, H, P)
        # inter-chunk: y_t += C_t · exp(cum_t) · h_prev
        y_inter = torch.einsum("bqn,bhpn->bqhp", c_k, state) * torch.exp(cum)[..., None]
        # state: h' = exp(cum_Q) h + Σ_s exp(cum_Q − cum_s) dt_s B_s x_s
        decay_end = torch.exp(cum[:, -1:, :] - cum)  # (B, Q, H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bsn,bshp->bhpn", b_k, xdt_k * decay_end[..., None])
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)  # (B, T, H, P)
    y = y + xs * _of_heads(params, "d_skip", sp).to(y.dtype)[None, None, :, None]
    out = _out(params, y.reshape(b, t, h * p), z, sp, cfg)
    if return_cache:
        return out, MambaCache(conv=conv_tail, state=state)
    return out


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> MambaCache:
    di, n = cfg.d_inner, cfg.ssm_state
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                          device=device),
    )


def mamba_decode_step(
    params, x_step: torch.Tensor, cache: MambaCache, cfg: ModelConfig
) -> Tuple[torch.Tensor, MambaCache]:
    """The exact O(1) recurrence for one token x_step (B, 1, D).  Updates
    ``cache.conv`` (shifted by one) and ``cache.state`` in place and returns
    (out, cache)."""
    b = x_step.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    sp = _split(params, cfg)
    z, xbc_new, dt_raw = _split_proj(cfg, _in_proj(params, x_step, sp))
    window = torch.cat([cache.conv, tp.chunk(xbc_new, -1, sp.conv)], dim=1)  # (B, K, C)
    xbc = _conv_step(window, params["conv_w"], params["conv_b"], x_step.dtype)
    cache.conv.copy_(window[:, 1:])
    if sp.conv > 1:
        xbc = tp.gather(xbc, -1)

    h = h // sp.heads
    xs = tp.chunk(xbc[..., :di].reshape(b, -1, p), 1, sp.heads)
    bvec = xbc[..., di : di + n].reshape(b, n).float()
    cvec = xbc[..., di + n :].reshape(b, n).float()
    dt = F.softplus(tp.chunk(dt_raw[:, 0].float(), -1, sp.heads)
                    + _of_heads(params, "dt_bias", sp))  # (B, H)
    decay = torch.exp(dt * -torch.exp(_of_heads(params, "a_log", sp)))
    xdt = xs.float() * dt[..., None]  # (B, H, P)
    state = cache.state
    state.mul_(decay[..., None, None]).add_(xdt[..., None] * bvec[:, None, None, :])
    y = torch.matmul(state, cvec[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + xs.float() * _of_heads(params, "d_skip", sp)[None, :, None]
    y = y.reshape(b, 1, h * p).to(x_step.dtype)
    return _out(params, y, z, sp, cfg), cache
