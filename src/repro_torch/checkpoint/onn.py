"""ONN checkpoints: persist/restore a quantized coupling matrix.

The reference's format (``repro.checkpoint.onn``): one directory holding
``onn.npz`` (int8 weight values, int32 bias, float32 quantization scale) and
``onn.json`` (every ``ONNConfig`` field, the quantization width and caller
metadata).  A directory written by the JAX package loads here, and one
written here loads there: the header names routes as the reference does
(``"pallas"``), and loading maps them back to ``"kernel"``.  Written
atomically (tmp directory + ``os.replace``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.convert import config_from_reference, config_to_reference
from repro_torch.core import dynamics, quantization
from repro_torch.core.checks import resolve_device

_ARRAYS = "onn.npz"
_HEADER = "onn.json"
_FORMAT = 1


class OnnCheckpoint(NamedTuple):
    """A restored ONN: ready-to-serve params plus their provenance."""

    config: dynamics.ONNConfig
    params: dynamics.OnnParams
    quantized: quantization.QuantizedWeights
    meta: Dict[str, Any]


def save_onn(
    path: str,
    config: dynamics.ONNConfig,
    quantized: quantization.QuantizedWeights,
    bias: Optional[Any] = None,
    *,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write one ONN checkpoint atomically to directory ``path``."""
    values = torch.as_tensor(quantized.values).cpu().numpy()
    if values.shape != (config.n, config.n):
        raise ValueError(f"weights {values.shape} != ({config.n}, {config.n})")
    if quantized.bits != config.weight_bits:
        raise ValueError(
            f"{quantized.bits}-bit weights for a {config.weight_bits}-bit config"
        )
    if bias is None:
        bias_arr = np.zeros((config.n,), np.int32)
    else:
        bias_arr = torch.as_tensor(bias).cpu().numpy().astype(np.int32)
    tmp = path.rstrip(os.sep) + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(
        os.path.join(tmp, _ARRAYS),
        values=values.astype(np.int8),
        bias=bias_arr,
        scale=np.float32(torch.as_tensor(quantized.scale).cpu().item()),
    )
    header = {
        "format": _FORMAT,
        "config": config_to_reference(config),
        "weight_bits": int(quantized.bits),
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, _HEADER), "w") as f:
        json.dump(header, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)  # atomic commit
    return path


def load_onn(path: str, device=None) -> OnnCheckpoint:
    """Restore an ONN checkpoint onto ``device`` (the GPU unless "cpu")."""
    dev = resolve_device(device)
    with open(os.path.join(path, _HEADER)) as f:
        header = json.load(f)
    if header.get("format") != _FORMAT:
        raise ValueError(f"unknown ONN checkpoint format: {header.get('format')!r}")
    config = config_from_reference(header["config"])
    with np.load(os.path.join(path, _ARRAYS)) as data:
        values, bias, scale = data["values"], data["bias"], data["scale"]
    quantized = quantization.QuantizedWeights(
        values=torch.as_tensor(values, dtype=torch.int8, device=dev),
        scale=torch.as_tensor(scale, dtype=torch.float32, device=dev),
        bits=int(header["weight_bits"]),
    )
    params = dynamics.make_params(config, values.astype(np.int8), bias, device=dev)
    return OnnCheckpoint(
        config=config, params=params, quantized=quantized, meta=header.get("meta", {})
    )
