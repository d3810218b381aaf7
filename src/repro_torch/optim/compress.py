"""int8 wire formats for the port's collectives (the port of
``repro.optim.compress``).

Push a sum through a narrower wire (int8, 4× fewer bytes than int32/f32)
and keep what makes it exact or unbiased:

* ``quantize``/``dequantize`` — symmetric per-tensor int8.
* ``ef_init``/``ef_compress`` — the error-feedback residual (Seide et al.
  2014 / Karimireddy et al. 2019): the quantization error is carried to the
  next step, so the accumulated update is unbiased.
* ``compressed_psum_mean`` — the error-feedback int8 all-reduce-mean.
* ``compressed_psum_scatter`` — the inference sibling: the disjoint
  row-block partials of the model-parallel ``weighted_sum`` combined on an
  int8 wire.

The collectives are ``shard_map`` 's semantics written out: they take the
list of per-shard tensors in mesh order and return the per-shard results.
The float32 arithmetic is the reference's as XLA compiles it in its
solves and collectives: a division by the constant 127 is a multiplication
by its float32 reciprocal, a division by a traced value (a scale, the shard
count) is a true division, a residual ``corrected − q · scale`` is one fused
multiply-subtract (one rounding: computed in float64, where it is exact,
then rounded), and rounding is half to even (``torch.round`` as
``jnp.round``).  Every operand is a tensor, so no backend swaps a division
for a reciprocal on its own.

* ``compressed_grads`` — the gradient tree's mean over a :class:`Mesh`'s
  data axis on the error-feedback wire, each leaf split into its shards by
  its spec (the reference's ``shard_map`` wrapper).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: float32(1 / 127): XLA folds ``x / 127.0`` into ``x * RECIP_127``.
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def _recip_127(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(RECIP_127, dtype=torch.float32, device=like.device)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale) with x ≈ q · scale."""
    absmax = torch.max(torch.abs(x)).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax * _recip_127(x), one)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params: Any) -> Any:
    """Error-feedback residual buffers, one per tensor of a tensor, a
    sequence of tensors or a dict of them."""
    if isinstance(params, torch.Tensor):
        return torch.zeros(params.shape, dtype=torch.float32, device=params.device)
    if isinstance(params, dict):
        return {k: ef_init(v) for k, v in params.items()}
    return type(params)(ef_init(p) for p in params)


def _residual(corrected: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``corrected − q · scale`` rounded once to float32 (a fused
    multiply-subtract): q · scale has at most 32 significant bits, so the
    float64 difference is exact."""
    exact = corrected.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)
    return exact.to(torch.float32)


def ef_compress(
    grad: torch.Tensor, err: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compress (grad + residual); return (q, scale, new_residual)."""
    corrected = grad.to(torch.float32) + err
    q, scale = quantize(corrected)
    return q, scale, _residual(corrected, q, scale)


def compressed_psum_mean(
    xs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 all-reduce-mean over the shards ``xs``.

    Each shard quantizes its (x + residual) against the largest of the
    shards' scales, the int8 payloads are summed in int32 (exact) and the
    sum is dequantized with that shared scale: ``total · scale_max / n``, in
    that order.  Returns (the mean on every shard's device, the new
    residuals).
    """
    n = len(xs)
    home = xs[0].device
    scales = [ef_compress(x, e)[1] for x, e in zip(xs, errs)]
    scale_max = torch.max(torch.stack([s.to(home) for s in scales]))
    count = torch.tensor(float(n), dtype=torch.float32, device=home)
    total = None
    new_errs = []
    for x, e in zip(xs, errs):
        s = scale_max.to(x.device)
        corrected = x.to(torch.float32) + e
        q_shared = torch.clamp(torch.round(corrected / s), -127, 127).to(torch.int8)
        new_errs.append(_residual(corrected, q_shared, s))
        q32 = q_shared.to(torch.int32).to(home)
        total = q32 if total is None else total + q32
    mean = total.to(torch.float32) * scale_max / count
    return [mean.to(x.device) for x in xs], new_errs


def wire_quantize(part: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 wire of one row-block partial: (q, scale) with the scale
    ``max(absmax / 127, 1)`` and ``q = clip(round(part / scale))``."""
    absmax = torch.max(torch.abs(part)).to(torch.float32)
    scale = torch.clamp(absmax * _recip_127(part), min=1.0)
    q = torch.clamp(torch.round(part.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_scatter(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Combine disjoint row-block partials on an int8 wire.

    ``parts[j]`` holds the int32 partial fields (..., blk_j) of row block j
    of the coupling matrix, on its device.  The blocks are disjoint, so the
    reference's psum of zero-filled buffers is a concatenation: per element
    there is exactly ONE contributor.  Each shard quantizes its partial with
    a scalar scale ``max(absmax / 127, 1)`` (:func:`wire_quantize`); the
    combine dequantizes each column with the scale of the shard that
    produced it.  A short last block (M not divisible by the model degree)
    stands for the reference's zero-padded one: its padded columns would be
    zeros, which change neither its absmax nor the sliced result.

    Exactness: the scale floors at 1, so whenever every local field fits
    int8 (|S| ≤ 127 — e.g. low weight_bits or small N) the round trip is the
    identity and the solve equals the int32 combine.  Beyond that it is a
    documented approximation (the phase dynamics consume ``sign(S)``, so
    only near-zero fields can flip) — which is why the compressed wire is
    opt-in (``ShardPlan(compressed=True)``).  No error feedback: an
    inference collective has no iteration-coupled state to carry a residual
    through.  Returns the combined int32 fields (..., Σ blk_j) on every
    shard's device.
    """
    home = parts[0].device
    wired = [wire_quantize(p) for p in parts]
    q_sum = torch.cat([q.to(home).to(torch.int32) for q, _ in wired], dim=-1)
    s_sum = torch.cat([
        s.to(home).expand(p.shape[-1]) for (_, s), p in zip(wired, parts)
    ])
    out = torch.round(q_sum.to(torch.float32) * s_sum).to(torch.int32)
    return [out.to(p.device) for p in parts]


def _blocks(shape: Sequence[int], spec: Sequence[Optional[str]], mesh) -> dict:
    """Mesh position (d, m) → the index (a tuple of slices) of the block a
    leaf of ``shape`` under ``spec`` holds there: a dim named by a mesh axis
    is split evenly over it, every other dim is whole."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = {}
    for pos in np.ndindex(mesh.devices.shape):
        idx = []
        for dim, axis in zip(shape, spec):
            if axis is None:
                idx.append(slice(None))
                continue
            k = mesh.axis_names.index(axis)
            n = mesh.devices.shape[k]
            if dim % n:
                raise ValueError(f"dim {dim} does not split over {n} {axis!r} shards")
            step = dim // n
            idx.append(slice(pos[k] * step, (pos[k] + 1) * step))
        out[pos] = tuple(idx)
    return out


def compressed_grads(local_grads, errors, mesh, axis_name: str = "data", grad_specs=None):
    """Synchronize per-shard gradients with int8 error-feedback compression.

    ``local_grads`` and ``errors``: trees (nested dicts) of tensors, each
    leaf the global array whose blocks the mesh's devices hold under its
    spec.  ``grad_specs``: a matching tree of specs, one mesh axis name or
    None per dim (the reference's ``PartitionSpec``); None means every leaf
    is replicated.  For each position along the other axis, the blocks
    along ``axis_name`` are reduced by :func:`compressed_psum_mean` (a
    block that does not split over ``axis_name`` is the same on every
    shard).  Returns (mean_grads, new_errors), the per-device results put
    back at their blocks, on each leaf's device.
    """
    reduce_axis = mesh.axis_names.index(axis_name)

    def one(g: torch.Tensor, e: torch.Tensor, spec) -> Tuple[torch.Tensor, torch.Tensor]:
        blocks = _blocks(g.shape, () if spec is None else spec, mesh)
        mean = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        groups = {}
        for pos in blocks:
            groups.setdefault(pos[:reduce_axis] + pos[reduce_axis + 1:], []).append(pos)
        for members in groups.values():
            devs = [mesh.devices[pos] for pos in members]
            means, errs = compressed_psum_mean(
                [g[blocks[pos]].to(d) for pos, d in zip(members, devs)],
                [e[blocks[pos]].to(d) for pos, d in zip(members, devs)])
            for pos, mg, ne in zip(members, means, errs):
                mean[blocks[pos]] = mg.to(g.device)
                err[blocks[pos]] = ne.to(g.device)
        return mean, err

    def walk(g, e, spec):
        if isinstance(g, dict):
            parts = {k: walk(g[k], e[k], None if spec is None else spec[k]) for k in g}
            return ({k: v[0] for k, v in parts.items()}, {k: v[1] for k, v in parts.items()})
        return one(g, e, spec)

    return walk(local_grads, errors, grad_specs)
