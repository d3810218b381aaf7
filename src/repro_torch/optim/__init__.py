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

In one device's program (``models/tp.py``) each leaf is the device's block
and ``splits`` (``tp.splits`` of the whole leaves) says which mesh axes cut
each of its dims.  Every statistic of a leaf is then the whole leaf's: the
global norm sums each leaf's squares and joins the sums over the axes that
cut the leaf (one ``tp.psum`` per set of axes; a replicated leaf is summed
once), Adafactor's row and column means join over the axes that cut the
dim they average and divide by the whole dim, and its RMS joins over every
axis of the leaf; whether a leaf is factored follows its whole shape.  The
update itself is elementwise on the blocks.  Outside a device's program
(``splits`` None) the trees are whole.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import tp
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


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False,
          split: Optional[tp.Split] = None, split_dim: Optional[int] = None) -> torch.Tensor:
    """The sum divided by the element count (``jnp.mean``); over a block
    (``split``: the leaf's, ``split_dim``: the leaf's dim that ``dim`` of
    ``x`` is), the blocks' sums joined and divided by the whole count."""
    if dim is None:
        total, n, axes = torch.sum(x), x.numel(), ()
        if split is not None:
            n, axes = n * math.prod(map(math.prod, split.sizes)), split.over()
    else:
        total, n, axes = torch.sum(x, dim=dim, keepdim=keepdim), x.shape[dim], ()
        if split is not None:
            n, axes = n * split.parts(split_dim), split.over([split_dim])
    return tp.psum(total, axes) / n


def global_norm(tree, splits=None) -> torch.Tensor:
    """√(Σ over the leaves, in flatten order, of their float32 sums of
    squares); with ``splits`` each leaf's sum joined over the axes that cut
    it (module docstring)."""
    sums = {path: torch.sum(leaf.to(torch.float32) ** 2) for path, leaf in leaves(tree)}
    if splits is not None:
        groups: Dict[Tuple[str, ...], List[str]] = {}
        for path, sp in leaves(splits):
            if sp.over():
                groups.setdefault(sp.over(), []).append(path)
        for axes, paths in groups.items():
            joined = tp.psum(torch.stack([sums[p] for p in paths]), axes)
            sums.update(zip(paths, joined.unbind(0)))
    return torch.sqrt(sum(sums[path] for path, _ in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, splits=None) -> Tuple[Any, torch.Tensor]:
    """(every leaf in float32 times min(1, max_norm / norm), the norm)."""
    norm = global_norm(tree, splits)
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


def _or_none(splits, tree):
    """``splits``, or a tree of Nones shaped like ``tree``."""
    return map_tree(lambda _: None, tree) if splits is None else splits


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
    splits=None,
) -> Optimizer:
    """AdamW; ``splits``: one device's program (module docstring)."""

    def init(params):
        return {"m": map_tree(_zeros32, params), "v": map_tree(_zeros32, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        grads, gnorm = clip_by_global_norm(grads, clip_norm, splits)
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
    splits=None,
) -> Optimizer:
    """Adafactor; ``splits``: one device's program (module docstring)."""

    def whole(p, sp):
        return p.shape if sp is None else sp.full(p.shape)

    def init(params):
        def one(p, sp):
            if _factorable(whole(p, sp)):
                return {"vr": _zeros32(p, p.shape[:-1]),
                        "vc": _zeros32(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros32(p)}

        return {"stats": _tree_map(one, params, _or_none(splits, params)),
                "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        grads, gnorm = clip_by_global_norm(grads, clip_norm, splits)
        lr = schedule(count)
        beta = 1.0 - count.to(torch.float32) ** (-decay)  # increasing decay

        def upd(g, st, p, sp):
            g2 = g * g + eps
            if "vr" in st:
                rows, cols = g.dim() - 2, g.dim() - 1  # the leaf's dims the means run over
                vr = beta * st["vr"] + (1 - beta) * _mean(g2, -1, split=sp, split_dim=cols)
                vc = beta * st["vc"] + (1 - beta) * _mean(g2, -2, split=sp, split_dim=rows)
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / torch.clamp(
                    _mean(vr, -1, keepdim=True, split=sp, split_dim=rows)[..., None], min=eps))
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                new_st = {"v": v}
            u = g / torch.clamp(denom, min=eps)
            # update clipping (RMS ≤ clip_threshold), one RMS over the leaf
            rms = torch.sqrt(_mean(u * u, split=sp))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            step = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype), new_st

        # the stats hold one dict per leaf: walk the grads' tree
        def walk(g, st, p, sp):
            if isinstance(g, dict):
                return {k: walk(g[k], st[k], p[k], None if sp is None else sp[k]) for k in g}
            return upd(g, st, p, sp)

        new_params, new_stats = _unzip(walk(grads, state["stats"], params, splits), 2)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, {"stats": new_stats, "count": count}, metrics

    def state_specs(param_specs):
        """The state of the whole leaves (``param_specs``: whole)."""

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

