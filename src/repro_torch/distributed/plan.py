"""`ShardPlan` and `Mesh`: how one ONN solve spreads over several devices
(the port of ``repro.distributed.plan``).

A :class:`ShardPlan` says how a solve parallelizes:

* ``batch`` — data-parallel degree: request lanes split over the ``"data"``
  mesh axis (the old ``--shard-batch`` behaviour is ``ShardPlan(batch=ndev)``).
* ``model`` — model-parallel degree: the (N, N) coupling matrix is
  row-sharded over the ``"model"`` mesh axis and every ``weighted_sum``
  becomes a collective (each device's backend on its row block, then an
  exact combine) — see ``repro_torch.core.dynamics._model_sharded_sum``.
* ``layout`` — coupling-matrix placement: ``"row"`` (sharded, the default)
  or ``"replicated"`` (W on every device; the model axis is declared but the
  collective is skipped — batch parallelism only).
* ``compressed`` — combine row-block partials over an int8 wire
  (``repro_torch.optim.compress.compressed_psum_scatter``) instead of the
  exact int32 combine.  Exact whenever every local partial fits int8 (the
  quantizer's scale floors at 1); an opt-in approximation beyond that.

The port is single-controller, as the reference is: one Python process
drives a :class:`Mesh`, a grid of ``torch.device`` with named axes:
``("data", "model")`` for a plan (2-D), ``("pod", "data", "model")`` for
the dry run's production mesh of meta devices
(``repro_torch.launch.mesh.make_production_mesh``).  :func:`make_mesh` defaults to every local device of
the requested type (``torch.cuda.device_count()`` cards, or the one CPU).
A mesh names a device more than once only when the caller passes
``devices=[...]`` explicitly — ``["cpu"] * 8`` in tests, ``["cuda:0"] * 4``
on a one-card machine — the counterpart of the reference's
``--xla_force_host_platform_device_count``.

Usage::

    plan = ShardPlan.parse("2x4")          # or ShardPlan(batch=2, model=4)
    mesh = plan.make_mesh()                # or make_mesh(plan, devices=[...])
    params = sharding.shard_onn_params(params, plan, mesh)
    with plan.context(mesh):
        result = dynamics.retrieve(cfg, params, sigma0)
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_LAYOUTS = ("row", "replicated")
AXES = ("data", "model")

DeviceLike = Union[str, torch.device]


def _normalize(device: DeviceLike) -> torch.device:
    """A ``torch.device`` with an explicit index for CUDA (``"cuda"`` is the
    current card), so mesh devices compare equal to tensors' devices."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # repro-lint: disable=RPL008
    return dev


def local_device_count(device: Optional[DeviceLike] = None) -> int:
    """How many local devices a plan may use: the CUDA cards
    (``torch.cuda.device_count()``, 0 without CUDA) unless ``device`` is
    the CPU, which counts as one."""
    if device is not None and torch.device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


class Mesh:
    """A grid of ``torch.device`` s with named axes, ``("data", "model")``
    unless ``axis_names`` says otherwise (the production mesh's
    ``("pod", "data", "model")``).

    ``devices`` is a numpy object array with one dimension per axis;
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does.
    """

    def __init__(self, devices, axis_names: Tuple[str, ...] = AXES) -> None:
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(axis_names) or src.size == 0:
            raise ValueError(
                f"a mesh needs a non-empty {len(axis_names)}-D device grid for axes "
                f"{tuple(axis_names)}, got {src.shape}")
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = _normalize(src[idx])
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device that holds the solve's own tensors and the combine."""
        return self.devices.flat[0]

    def key(self) -> Tuple[str, ...]:
        """A hashable identity of the grid (its devices in order)."""
        return tuple(str(d) for d in self.devices.flat)


def make_mesh(
    shape: Tuple[int, int],
    devices: Optional[Sequence[DeviceLike]] = None,
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """A ``(data, model)`` mesh of ``shape``.

    ``devices``: the grid's devices in data-major order, repeats allowed
    (a one-card machine or the CPU standing in for several).  Without it the
    mesh takes the first ``data · model`` local devices of ``device``'s type
    (the GPU unless ``"cpu"``) and raises if there are fewer.
    """
    data, model = shape
    need = data * model
    if devices is None:
        avail = local_device_count(device)
        if need > avail:
            raise ValueError(f"mesh {data}x{model} needs {need} devices, only {avail} available")
        if device is not None and torch.device(device).type == "cpu":
            devices = ["cpu"]
        else:
            devices = [torch.device("cuda", i) for i in range(need)]
    devices = list(devices)
    if len(devices) != need:
        raise ValueError(f"mesh {data}x{model} needs {need} devices, got {len(devices)}")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices):
        grid[i // model, i % model] = d
    return Mesh(grid)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one solve spreads over a (batch × model) device mesh."""

    batch: int = 1  # data-parallel degree (request lanes over "data")
    model: int = 1  # model-parallel degree (W rows over "model")
    layout: str = "row"  # coupling-matrix placement: "row" | "replicated"
    compressed: bool = False  # int8 wire format for the row-block combine

    def __post_init__(self) -> None:
        if self.batch < 1 or self.model < 1:
            raise ValueError(
                f"ShardPlan axes must be >= 1, got batch={self.batch} "
                f"model={self.model}"
            )
        if self.layout not in _LAYOUTS:
            raise ValueError(
                f"unknown ShardPlan layout {self.layout!r}; expected one of "
                f"{_LAYOUTS}"
            )

    @property
    def devices(self) -> int:
        return self.batch * self.model

    @property
    def model_sharded(self) -> bool:
        """Whether the weighted-sum collective is active (W actually split)."""
        return self.model > 1 and self.layout == "row"

    @classmethod
    def parse(
        cls, spec: str, n_devices: Optional[int] = None, device: Optional[DeviceLike] = None
    ) -> "ShardPlan":
        """Parse a ``--mesh`` spec: ``"BxM"`` (e.g. ``"2x4"``) or ``"auto"``.

        ``n_devices`` defaults to :func:`local_device_count` of ``device``
        (the CUDA cards unless ``"cpu"``).  ``"auto"`` delegates to
        :func:`repro_torch.distributed.ft.propose_mesh` over that count.
        """
        spec = spec.strip().lower()
        if spec == "auto":
            return cls.auto(n_devices, device)
        m = re.fullmatch(r"(\d+)x(\d+)", spec)
        if not m:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'BxM' (e.g. '2x4') or 'auto'"
            )
        plan = cls(batch=int(m.group(1)), model=int(m.group(2)))
        avail = local_device_count(device) if n_devices is None else n_devices
        if plan.devices > avail:
            raise ValueError(
                f"mesh {spec!r} needs {plan.devices} devices, "
                f"only {avail} available"
            )
        return plan

    @classmethod
    def auto(
        cls, n_devices: Optional[int] = None, device: Optional[DeviceLike] = None
    ) -> "ShardPlan":
        """Propose a plan for the surviving device count (ft policy)."""
        from repro_torch.distributed import ft

        avail = local_device_count(device) if n_devices is None else n_devices
        data, model = ft.propose_mesh(avail, prefer_model=min(avail, 16))
        return cls(batch=data, model=model)

    def make_mesh(
        self, devices: Optional[Sequence[DeviceLike]] = None,
        device: Optional[DeviceLike] = None,
    ) -> Mesh:
        """A ``(batch, model)`` mesh with axes ``("data", "model")``
        (:func:`make_mesh`)."""
        return make_mesh((self.batch, self.model), devices, device)

    @contextlib.contextmanager
    def context(self, mesh: Optional[Mesh] = None):
        """Activate this plan (and mesh) for every solve run inside.

        Yields the mesh so call sites can ``with plan.context() as mesh:``.
        """
        from repro_torch.distributed import sharding

        if mesh is None:
            mesh = self.make_mesh()
        shape = mesh.shape
        if shape.get("data", 1) < self.batch or shape.get("model", 1) < self.model:
            raise ValueError(
                f"mesh {shape} too small for plan (batch={self.batch}, "
                f"model={self.model})"
            )
        with sharding.use_plan(self, mesh):
            yield mesh


def plan_of_legacy_shard_batch(
    n_devices: Optional[int] = None, device: Optional[DeviceLike] = None
) -> ShardPlan:
    """The plan equivalent of the retired per-launcher ``--shard-batch``."""
    avail = local_device_count(device) if n_devices is None else n_devices
    return ShardPlan(batch=avail, model=1, layout="replicated")
