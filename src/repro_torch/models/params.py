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

The same tree gives the dry run's stand-ins: :func:`abstract` makes every
spec an empty tensor on the meta device (no allocation), and
:func:`pspecs` maps each spec's logical axis names to mesh axes through a
rule table (``repro_torch.distributed.sharding``).  A spec is the port's
plain tuple of mesh axis names (``("data", None, "model")``), standing in
for ``PartitionSpec``: trailing ``None`` s are dropped, as ``P(*entries)``
drops them, and an entry over several mesh axes is a tuple of them.
:func:`shardings` pairs each spec with its mesh, the stand-in for
``NamedSharding``, and :func:`local_shape` gives the block of a leaf one
device holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch


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
    # Imported here: ``repro_torch.core`` imports the optimizers, which
    # import this module.
    from repro_torch.core.checks import resolve_device

    if generator is not None and generator.device.type != "cpu":
        raise ValueError("materialize draws on the host: pass a CPU torch.Generator")
    dev = resolve_device(device)
    values = {path: _init_one(spec, generator, dev) for path, spec in leaves(tree)}
    return _rebuild(tree, values)


def _rebuild(tree, values, prefix: str = ""):
    if isinstance(tree, dict):
        return {key: _rebuild(value, values, f"{prefix}{key}.") for key, value in tree.items()}
    return values[prefix[:-1]]


def abstract(tree):
    """Every ParamSpec of ``tree`` as an empty tensor of its shape and dtype
    on the meta device: the dry run's stand-ins, which allocate nothing."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


Spec = Tuple[Any, ...]  # one entry per dim: None, a mesh axis name, or a tuple of them


def logical_to_pspec(
    axes: Tuple[Optional[str], ...],
    rules: Dict[str, Any],
    shape: Optional[Tuple[int, ...]] = None,
    axis_sizes: Optional[Dict[str, int]] = None,
) -> Spec:
    """Map logical axis names to a spec using the rule table.

    With ``shape`` + ``axis_sizes`` (mesh axis → size), mesh axes whose size
    does not divide the tensor dim are dropped, trailing ones first
    (divisibility-aware fallback: 8 KV heads over a 16-way model axis are
    replicated).  Two tensor dims never map onto the same mesh axis.
    """
    entries = []
    used: set = set()

    def _flat(v):
        return v if isinstance(v, tuple) else (v,)

    for i, name in enumerate(axes):
        target = rules.get(name) if name else None
        if target is None:
            entries.append(None)
            continue
        taken = tuple(a for a in _flat(target) if a not in used)
        if taken and shape is not None and axis_sizes is not None:
            dim = shape[i]
            while taken:
                prod = 1
                for a in taken:
                    prod *= axis_sizes.get(a, 1)
                if prod and dim % prod == 0:
                    break
                taken = taken[:-1]
        if not taken:
            entries.append(None)
            continue
        used.update(taken)
        entries.append(taken if len(taken) > 1 else taken[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name → size (a ``repro_torch.distributed.Mesh``)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def pspecs(tree, rules: Dict[str, Any], axis_sizes: Optional[Dict[str, int]] = None):
    """Spec tree from a ParamSpec tree + rule table."""
    return map_tree(lambda s: logical_to_pspec(s.axes, rules, s.shape, axis_sizes), tree)


def shardings(tree, rules: Dict[str, Any], mesh):
    """A ``distributed.sharding.NamedSharding`` (a ``(mesh, spec)`` pair)
    per leaf: the stand-in for a ``NamedSharding`` tree, which
    ``checkpoint.restore(..., shardings=)`` places leaves by."""
    # Imported here: ``distributed.sharding`` imports this module.
    from repro_torch.distributed.sharding import NamedSharding

    sizes = mesh_axis_sizes(mesh)
    return map_tree(
        lambda s: NamedSharding(mesh, logical_to_pspec(s.axes, rules, s.shape, sizes)), tree)


def local_shape(shape: Tuple[int, ...], spec: Spec, axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The block of a ``shape`` leaf one device holds under ``spec``: each
    dim divided by the product of the sizes of the mesh axes its entry
    names (rounded up, as an uneven split's largest block)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        parts = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                parts *= axis_sizes.get(a, 1)
        out.append(-(-dim // parts))
    return tuple(out)


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
