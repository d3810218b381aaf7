"""Parameter specification trees (the port of ``repro.models.params``).

Models declare their parameters as trees (nested dicts) of
:class:`ParamSpec`: shape, logical axis names and init recipe.  One tree
gives the materialized parameters or a zeroed buffer such as the decode
cache (:func:`materialize`) and the parameter count and bytes.

Randomness: :func:`materialize` draws from one CPU ``torch.Generator``,
one float32 ``torch.randn`` per normal leaf, in the reference's flatten
order (dict keys sorted), moves the draw to its device and there scales
and rounds it (one IEEE product and one round-to-nearest cast, the same
bits on the CPU and on the card), so a seed gives the same weights on
both; zeros and ones are made on the device.  The reference's threefry draws are not reimplemented:
tests carry its weights across
(``repro_torch.convert.lm_params_from_reference``).

``abstract``, ``logical_to_pspec``, ``pspecs`` and ``shardings`` wait for
the LM sharding rules (ROADMAP.md, section 1, item 5); the logical axis
names are kept on every spec for them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch.core.checks import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 0.02  # stddev for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of every leaf in the reference's flatten order:
    dict keys sorted, depth first."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def map_tree(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, value) for key, value in tree.items()}
    return fn(tree)


def _init_one(
    spec: ParamSpec, generator: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if generator is None:
        raise ValueError("a normal-init ParamSpec needs a torch.Generator to draw from")
    std = spec.scale if spec.init == "normal" else 1.0
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32).to(device)
    return draw.mul_(std).to(spec.dtype)  # the same IEEE product and rounding on any device


def materialize(tree, generator: Optional[torch.Generator], device=None):
    """Every ParamSpec in ``tree`` as a tensor on ``device`` (the GPU unless
    ``"cpu"``): normal leaves drawn from the CPU ``generator`` in flatten
    order (float32 normals times the scale, rounded to the spec's dtype on
    ``device``),
    zeros and ones filled.  ``generator`` may be None for a tree without
    normal leaves."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("materialize draws on the host: pass a CPU torch.Generator")
    dev = resolve_device(device)
    values = {path: _init_one(spec, generator, dev) for path, spec in leaves(tree)}
    return _rebuild(tree, values)


def _rebuild(tree, values, prefix: str = ""):
    if isinstance(tree, dict):
        return {key: _rebuild(value, values, f"{prefix}{key}.") for key, value in tree.items()}
    return values[prefix[:-1]]


def count_params(tree) -> int:
    """Total parameter count of a spec tree."""
    total = 0
    for _, leaf in leaves(tree):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
    return total


def param_bytes(tree) -> int:
    total = 0
    for _, leaf in leaves(tree):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n * leaf.dtype.itemsize
    return total
