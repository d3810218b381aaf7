"""Mesh construction for the launchers (the port of ``repro.launch.mesh``).

Functions, never module-level constants, so importing this module touches
no device.  A :class:`repro_torch.distributed.Mesh` has axes
``("data", "model")``: ``"model"`` row-shards the coupling matrix,
``"data"`` splits request lanes.

The production mesh of the LM dry run (``repro_torch.launch.dryrun``):
  single-pod:  (16, 16)        axes ("data", "model")   — 256 devices
  multi-pod:   (2, 16, 16)     axes ("pod", "data", "model") — 512 devices
every position the meta device, so building it touches no card.  "model"
is the tensor-parallel axis (heads / mlp / vocab / experts), "data"
carries batch + FSDP weight sharding, "pod" composes with "data" for
cross-pod data parallelism.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.plan import DeviceLike, Mesh, ShardPlan, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(shape, dtype=object)
    grid.fill(torch.device("meta"))
    return Mesh(grid, axes)


def make_host_mesh(
    data: int = 1,
    model: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """A small (data, model) mesh over local devices, or over ``devices``
    (repeats allowed: ``["cpu"] * 8`` in tests)."""
    return make_mesh((data, model), devices, device)


def mesh_devices(mesh: Mesh) -> int:
    """The number of positions in the mesh (repeated devices count each)."""
    return mesh.size


def build_shard_plan(spec: str = "auto", device: Optional[DeviceLike] = None) -> ShardPlan:
    """The launcher-facing :class:`ShardPlan`: ``"BxM"`` (data × model
    degrees) or ``"auto"`` (``ft.propose_mesh`` over the local devices of
    ``device``'s type, the CUDA cards unless ``"cpu"``).  Every launcher's
    ``--mesh`` flag reaches it through
    ``repro_torch.launch.retrieve.resolve_plan_args``."""
    return ShardPlan.parse(spec, device=device)


def make_plan_mesh(
    plan: ShardPlan,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """The (batch, model) mesh for a ShardPlan."""
    return plan.make_mesh(devices, device)
