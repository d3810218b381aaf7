"""Carry configurations and weights over from the JAX package.

The port never imports ``repro``; these functions read a reference
``ONNConfig`` (or its ``dataclasses.asdict`` form, as checkpoint headers
store it) by field name, and take weights as numpy arrays.  The reference's
kernel route is named ``"pallas"``; the port's is ``"kernel"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np

from repro_torch.core.dynamics import ONNConfig, OnnParams, make_params

_ROUTE_NAMES = {"pallas": "kernel"}


def config_from_reference(obj_or_dict: Any) -> ONNConfig:
    """The port's ``ONNConfig`` for a reference config object or dict.

    Every init field is read by name; ``"pallas"`` maps to ``"kernel"`` for
    both ``backend`` and ``hybrid_impl``.  Validation is the port's own.
    """
    names = [f.name for f in dataclasses.fields(ONNConfig) if f.init]
    if isinstance(obj_or_dict, Mapping):
        values = {k: obj_or_dict[k] for k in names if k in obj_or_dict}
    else:
        values = {k: getattr(obj_or_dict, k) for k in names if hasattr(obj_or_dict, k)}
    for key in ("backend", "hybrid_impl"):
        if key in values:
            values[key] = _ROUTE_NAMES.get(values[key], values[key])
    return ONNConfig(**values)


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
