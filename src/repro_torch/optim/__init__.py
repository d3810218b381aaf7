"""Optimizers: AdamW and Adafactor, their schedules and global-norm
clipping (the port of ``repro.optim``), beside :mod:`repro_torch.optim.compress`
(the int8 wire of the model-parallel combine and the error-feedback
gradient mean).

Both optimizers expose the reference's triple:

* ``init(params) → state``
* ``update(grads, state, params) → (new_params, new_state, metrics)``
* ``state_specs(param_specs) → ParamSpec tree``

A tree is a nested dict of tensors (the reference's parameter tree, layers
stacked on leading axes); its leaves are taken in the reference's flatten
order (dict keys sorted).  Updates are out of place, under
``torch.no_grad()``, and keep the reference's float32 order: the gradients
are clipped by their global norm (the leaves' float32 sums of squares added
in flatten order), the schedule is evaluated at ``count + 1``, each leaf is
updated in float32 and cast back to its dtype once, and weight decay applies
to every leaf, norms and biases included.  A mean is a sum divided by the
element count, as ``jnp.mean`` computes it.

Adafactor factors the second moment of a leaf whose last two dims are both
at least ``_FACTOR_MIN_SIZE``; on a stacked leaf (L, R, C) it keeps (L, R)
row and (L, C) column statistics, and its update clip takes one RMS over the
whole stacked leaf, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.params import ParamSpec, leaves, map_tree

Schedule = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def constant(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_warmup(peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr`` then cosine decay to ``floor``·peak, in
    float32."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, peak_lr * cos)

    return fn


# ---------------------------------------------------------------------------
# Shared utilities
# ---------------------------------------------------------------------------


def _tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The sum divided by the element count (``jnp.mean``)."""
    if dim is None:
        return torch.sum(x) / x.numel()
    return torch.sum(x, dim=dim, keepdim=keepdim) / x.shape[dim]


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves, in flatten order, of their float32 sums of
    squares)."""
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2) for _, leaf in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(every leaf in float32 times min(1, max_norm / norm), the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda g: g.to(torch.float32) * scale, tree), norm


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any, Dict[str, torch.Tensor]]]
    state_specs: Callable[[Any], Any]


def _like_specs(param_specs, dtype=torch.float32):
    return map_tree(lambda s: ParamSpec(s.shape, s.axes, dtype=dtype, init="zeros"), param_specs)


def _count_spec() -> ParamSpec:
    return ParamSpec((), (), dtype=torch.int32, init="zeros")


def _device_of(tree) -> torch.device:
    return next(leaf for _, leaf in leaves(tree)).device


def _zeros32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=torch.float32, device=p.device)


def _unzip(out, n: int):
    """A tree of n-tuples → n trees."""
    if isinstance(out, dict):
        parts = {k: _unzip(v, n) for k, v in out.items()}
        return tuple({k: parts[k][i] for k in out} for i in range(n))
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        return {"m": map_tree(_zeros32, params), "v": map_tree(_zeros32, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(count)
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)

        def upd(g, m, v, p):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

        new_params, new_m, new_v = _unzip(
            _tree_map(upd, grads, state["m"], state["v"], params), 3)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, {"m": new_m, "v": new_v, "count": count}, metrics

    def state_specs(param_specs):
        return {"m": _like_specs(param_specs), "v": _like_specs(param_specs),
                "count": _count_spec()}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) — factored second moments
# ---------------------------------------------------------------------------

_FACTOR_MIN_SIZE = 128  # don't factor tiny tensors


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= _FACTOR_MIN_SIZE and shape[-2] >= _FACTOR_MIN_SIZE


def adafactor(
    schedule: Schedule,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    clip_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        def one(p):
            if _factorable(p.shape):
                return {"vr": _zeros32(p, p.shape[:-1]),
                        "vc": _zeros32(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros32(p)}

        return {"stats": map_tree(one, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(count)
        beta = 1.0 - count.to(torch.float32) ** (-decay)  # increasing decay

        def upd(g, st, p):
            g2 = g * g + eps
            if "vr" in st:
                vr = beta * st["vr"] + (1 - beta) * _mean(g2, -1)
                vc = beta * st["vc"] + (1 - beta) * _mean(g2, -2)
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / torch.clamp(
                    _mean(vr, -1, keepdim=True)[..., None], min=eps))
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                new_st = {"v": v}
            u = g / torch.clamp(denom, min=eps)
            # update clipping (RMS ≤ clip_threshold), one RMS over the leaf
            rms = torch.sqrt(_mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            step = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype), new_st

        # the stats hold one dict per leaf: walk the grads' tree
        def walk(g, st, p):
            if isinstance(g, dict):
                return {k: walk(g[k], st[k], p[k]) for k in g}
            return upd(g, st, p)

        new_params, new_stats = _unzip(walk(grads, state["stats"], params), 2)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, {"stats": new_stats, "count": count}, metrics

    def state_specs(param_specs):
        def one(s):
            if _factorable(s.shape):
                return {
                    "vr": ParamSpec(s.shape[:-1], s.axes[:-1], torch.float32, init="zeros"),
                    "vc": ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:],
                                    torch.float32, init="zeros"),
                }
            return {"v": ParamSpec(s.shape, s.axes, torch.float32, init="zeros")}

        return {"stats": map_tree(one, param_specs), "count": _count_spec()}

    return Optimizer(init, update, state_specs)


def get_optimizer(name: str, schedule: Schedule, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "adafactor":
        return adafactor(schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")

