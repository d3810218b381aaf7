"""Carry configurations and weights over from the JAX package.

The port never imports ``repro``; these functions read a reference
``ONNConfig`` or ``MaxCutSolver`` (or its ``dataclasses.asdict`` form, as
checkpoint headers store a config) by field name, and take weights as numpy
arrays (an LM's as its parameter tree of them,
:func:`lm_params_from_reference`).  The reference's kernel route is named
``"pallas"``; the port's is ``"kernel"``.  :func:`config_to_reference` goes the other way, for the
checkpoint headers the port writes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.checks import resolve_device
from repro_torch.core.dynamics import ONNConfig, OnnParams, make_params

_ROUTE_NAMES = {"pallas": "kernel"}
_REFERENCE_ROUTE_NAMES = {v: k for k, v in _ROUTE_NAMES.items()}


def _fields_from_reference(cls, obj_or_dict: Any) -> dict:
    """The init fields of the port's dataclass ``cls`` that a reference
    object or dict carries, read by name, with ``"pallas"`` mapped to
    ``"kernel"`` for both ``backend`` and ``hybrid_impl``."""
    names = [f.name for f in dataclasses.fields(cls) if f.init]
    if isinstance(obj_or_dict, Mapping):
        values = {k: obj_or_dict[k] for k in names if k in obj_or_dict}
    else:
        values = {k: getattr(obj_or_dict, k) for k in names if hasattr(obj_or_dict, k)}
    for key in ("backend", "hybrid_impl"):
        if key in values:
            values[key] = _ROUTE_NAMES.get(values[key], values[key])
    return values


def config_from_reference(obj_or_dict: Any) -> ONNConfig:
    """The port's ``ONNConfig`` for a reference config object or dict.
    Validation is the port's own."""
    return ONNConfig(**_fields_from_reference(ONNConfig, obj_or_dict))


def config_to_reference(cfg: ONNConfig) -> dict:
    """Every field of a port ``ONNConfig`` as the reference names it: the
    inverse of :func:`config_from_reference`, with ``"kernel"`` mapped to
    ``"pallas"`` for both ``backend`` and ``hybrid_impl``."""
    values = dataclasses.asdict(cfg)
    for key in ("backend", "hybrid_impl"):
        values[key] = _REFERENCE_ROUTE_NAMES.get(values[key], values[key])
    return values


def maxcut_solver_from_reference(obj_or_dict: Any, device=None):
    """The port's ``MaxCutSolver`` for a reference ``MaxCutSolver`` (or its
    fields as a dict), placing its solves on ``device`` (the GPU unless
    ``"cpu"``)."""
    from repro_torch.api import MaxCutSolver

    values = _fields_from_reference(MaxCutSolver, obj_or_dict)
    values["device"] = device
    return MaxCutSolver(**values)


def _tensor_from_reference(a: np.ndarray) -> torch.Tensor:
    """A reference array as a CPU tensor; bf16 (``ml_dtypes``, detected by
    name) passes through its 16-bit pattern, so every bit is kept."""
    a = np.array(a)  # a contiguous copy that keeps a 0-d leaf 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_reference(cfg, tree: Mapping[str, Any], device=None):
    """The port's LM module (``DenseLM``, ``VisionLM``, ``EncDecLM``,
    ``ZambaLM`` or ``XLSTMLM``, as ``get_model(cfg).build_params`` builds
    it) on ``device`` (the GPU unless ``"cpu"``) holding the reference's LM
    parameter tree (nested dicts of numpy arrays, layers stacked on a leading
    axis — the VLM's ``blocks``, Zamba's ``blocks`` and xLSTM's ``mblocks``
    on two — as ``repro.models.params.materialize`` makes it): the stacking
    axes are unstacked, the names and dtypes stay (a MoE router, the SSM's
    ``a_log``, ``d_skip`` and ``dt_bias`` and the mLSTM's gate weights are
    float32).  Every leaf's path and shape must match ``cfg``'s spec
    tree."""
    from repro_torch.models import params as P
    from repro_torch.models.model import get_model

    model = get_model(cfg)
    want = {path: tuple(spec.shape) for path, spec in P.leaves(model.param_specs)}
    got = {path: tuple(np.shape(a)) for path, a in P.leaves(dict(tree))}
    if got != want:
        raise ValueError(f"{cfg.name}: the reference tree does not match the spec tree: "
                         f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
    dev = resolve_device(device)
    return model.build_params(P.map_tree(lambda a: _tensor_from_reference(a).to(dev), dict(tree)))


def params_from_reference(
    cfg: ONNConfig,
    weights: np.ndarray,
    bias: Optional[np.ndarray] = None,
    device=None,
) -> OnnParams:
    """The port's ``OnnParams`` from numpy weights (and bias) on ``device``."""
    w = np.asarray(weights)
    b = None if bias is None else np.asarray(bias)
    return make_params(cfg, w, b, device=device)
