"""Config registry: the 10 assigned LM architectures (the port of
``repro.configs``) beside the port's ONN design points (``configs.onn``).

``--arch <id>`` everywhere resolves through :func:`get_config`; every
config, reduced config, shape and cell equals the reference's.  The port
serves every one (``repro_torch.models.model.get_model``).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig, cells_for

# arch id → module name
_MODULES: Dict[str, str] = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen3-4b": "qwen3_4b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-large-v3": "whisper_large_v3",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "arctic-480b": "arctic_480b",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def sharding_overrides(arch: str) -> Dict[str, Any]:
    return dict(getattr(_module(arch), "SHARDING_OVERRIDES", {}))


def all_cells() -> List[tuple]:
    """Every applicable (arch, shape) pair — the dry-run/roofline matrix."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in cells_for(cfg):
            cells.append((arch, shape_name))
    return cells


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
