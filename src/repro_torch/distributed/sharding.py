"""Logical-axis rule tables, the active sharding context and the ONN
coupling matrix's placement (the port of ``repro.distributed.sharding``).

Rule tables map logical axis names → mesh axis (or tuple of mesh axes, or
None for replication); ``repro_torch.models.params.logical_to_pspec`` turns
a leaf's names into a spec through one.  The LM dry run
(``repro_torch.launch.dryrun``) reads them:
  * batch        → all data-parallel axes ("pod", "data")
  * embed (fsdp) → "data"      — ZeRO-style weight sharding within a pod
  * heads/mlp/vocab/experts → "model"  — tensor parallelism
  * kv sequence (decode caches) → "data" for batch=1 long-context cells

The reference turns logical axis names into ``with_sharding_constraint``
calls and lets GSPMD split the work.  The port has no compiler to hand that
to: the work is split where it is computed —
``repro_torch.core.dynamics._model_sharded_sum`` runs the weighted sum per
row block and ``_advance_chunk_batched`` per lane shard — so
:func:`shard` and :func:`constrain_onn` are identities kept for the
reference's call shapes, and the context below only tells those functions
which plan and mesh are active.  Specs are plain tuples of axis names
(``("model", None)``), standing in for ``PartitionSpec``.

:func:`shard_onn_params` places W at rest for a plan: its row blocks on
the model-axis devices when N divides the model degree, otherwise one full
copy per device with the blocks as views of it (the reference's rule: uneven
named shardings do not exist, so only the compute is split).  The blocks are
held by the params it returns (``OnnParams.placement``, a
:class:`Placement`), and the solve reads them from there: W is never copied
per cycle.  A block on the device W already lies on is a view, so a mesh
that repeats one device copies nothing.  Tensors with no placement (the
Max-Cut windows, made anew each sweep; the engine's padded params) get their
blocks from :func:`weight_blocks` at each call: views on W's device, copies
on any other.  Every mesh measured so far repeats one card, so that copy has
never run on hardware.

The context is thread-local, as in the reference; the scheduler that solves
under it is single-threaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import TYPE_CHECKING, Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import logical_to_pspec

if TYPE_CHECKING:  # pragma: no cover — annotation only (no import cycle)
    from repro_torch.distributed.plan import Mesh, ShardPlan

_state = threading.local()

Spec = Tuple[Optional[str], ...]


def single_pod_rules() -> Dict[str, Any]:
    return {
        "batch": "data",
        "embed": "data",  # FSDP / ZeRO-3 over the data axis
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "experts": "model",
        "expert_embed": "data",  # FSDP over expert d-dims (see moe_specs)
        "expert_mlp": None,
        "kv_seq": None,
        "seq_act": None,  # sequence-parallel attention (override → "model")
        "state": None,
        "qk_dim": None,
        "head_dim": None,
        "vision": None,
    }


def multi_pod_rules() -> Dict[str, Any]:
    r = single_pod_rules()
    r["batch"] = ("pod", "data")  # DP across pods; FSDP stays intra-pod
    return r


def long_context_rules(multi_pod: bool = False) -> Dict[str, Any]:
    """batch=1 decode: shard the KV/scan sequence dim instead of batch."""
    r = multi_pod_rules() if multi_pod else single_pod_rules()
    r["batch"] = None
    r["kv_seq"] = ("pod", "data") if multi_pod else "data"
    return r


def data_spec(rules: Dict[str, Any], *axes: Optional[str]) -> Spec:
    """The spec of a model input (tokens, frames, caches)."""
    return logical_to_pspec(tuple(axes), rules)


@contextlib.contextmanager
def use_rules(
    rules: Optional[Dict[str, Any]],
    mesh: Optional["Mesh"] = None,
    plan: Optional["ShardPlan"] = None,
):
    """Activate a rule table (and optionally a mesh + ShardPlan)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (rules, mesh, plan)
    try:
        yield
    finally:
        _state.ctx = prev


def use_plan(plan: "ShardPlan", mesh: "Mesh"):
    """Activate a :class:`repro_torch.distributed.plan.ShardPlan` over
    ``mesh``, with the reference's minimal rule table (lanes → the
    ``"data"`` axis when the plan data-parallelizes).  Prefer
    ``plan.context(mesh)``, which wraps this."""
    rules = {"batch": "data" if plan.batch > 1 else None}
    return use_rules(rules, mesh, plan)


def current_rules() -> Optional[Dict[str, Any]]:
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def current_mesh() -> Optional["Mesh"]:
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


def current_plan() -> Optional["ShardPlan"]:
    ctx = getattr(_state, "ctx", None)
    return ctx[2] if ctx else None


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The identity: the port splits work where it is computed, not by
    constraining a tensor's layout (see the module docstring)."""
    return x


# ---------------------------------------------------------------------------
# ONN parameter placement
# ---------------------------------------------------------------------------


def onn_weight_spec(
    multi_pod: bool = False,
    layout: str = "row",
    plan: Optional["ShardPlan"] = None,
) -> Spec:
    """The spec of the (N, N) coupling matrix.

    Under a :class:`ShardPlan` (``plan`` given): rows over the ``"model"``
    axis (replicated across ``"data"``) when the plan model-parallelizes,
    else replicated.  Without a plan, the production mesh's layouts (the ONN
    dry run, ``repro_torch.launch.dryrun.run_onn_cell``):

      * ``"row"``        — rows over ALL mesh axes (no contraction sum; the
        σ' all-gather is the only collective);
      * ``"2d"``         — rows over ``"model"``, columns over ``"data"``
        (each cycle sums the partial fields over ``"data"``);
      * ``"replicated"`` — W on every device (parallel over the batch).
    """
    if plan is not None:
        return ("model", None) if plan.model_sharded else (None, None)
    all_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if layout == "row":
        return (all_axes, None)
    if layout == "2d":
        return ("model", "data")
    if layout == "replicated":
        return (None, None)
    raise ValueError(f"unknown ONN weight layout {layout!r}")


def at_rest_spec(n: int, plan: "ShardPlan") -> Spec:
    """The spec W actually rests in: :func:`onn_weight_spec`, replicated
    when N does not divide the model degree."""
    if plan.model_sharded and n % plan.model == 0:
        return ("model", None)
    return (None, None)


def onn_param_shardings(
    multi_pod: bool = False,
    layout: str = "row",
    plan: Optional["ShardPlan"] = None,
):
    """``OnnParams``-shaped specs: W per :func:`onn_weight_spec`, the bias
    replicated."""
    from repro_torch.core.dynamics import OnnParams

    return OnnParams(weights=onn_weight_spec(multi_pod, layout, plan), bias=(None,))


def constrain_onn(params, layout: Optional[str] = None):
    """The identity (see the module docstring): placement is
    :func:`shard_onn_params`' job, and the split happens in the solve."""
    return params


class Placement(NamedTuple):
    """W's row blocks placed for one plan on one mesh (:func:`shard_onn_params`)."""

    weights: torch.Tensor  # the W the blocks were cut from
    key: tuple  # (model parts, mesh key)
    blocks: List[List[torch.Tensor]]  # blocks[i][j] on mesh.devices[i, j]


def weight_blocks(
    w: torch.Tensor,
    plan: "ShardPlan",
    mesh: "Mesh",
    data: Optional[int] = None,
    placement: Optional[Placement] = None,
) -> List[List[torch.Tensor]]:
    """W's row blocks where the solve computes them: ``blocks[i][j]`` is
    row block j (of ``ceil(M / model)`` rows; the last one shorter when M
    does not divide) on ``mesh.devices[i, j]``, for the ``data`` lane
    shards (default ``plan.batch``) and the model degree (1 when the plan
    does not model-shard: the whole of W).

    Rows are W's axis −2, so a stack of per-instance matrices (I, M, N)
    splits the same way.  ``placement``, when it was made for this W, plan
    and mesh, is returned as it is (no copy).  Otherwise each block is a
    view of W on W's own device, a row slice of one copy per device when W
    rests replicated (:func:`at_rest_spec`), or its own copy on its device
    when W rests row-sharded.
    """
    parts = plan.model if plan.model_sharded else 1
    data = plan.batch if data is None else data
    if (placement is not None and placement.weights is w
            and placement.key == (parts, mesh.key()) and data <= len(placement.blocks)):
        return placement.blocks[:data]
    m = w.shape[-2]
    blk = -(-m // parts)
    row_sharded = at_rest_spec(m, plan) == ("model", None)
    full: Dict[torch.device, torch.Tensor] = {}
    own: Dict[Tuple[torch.device, int], torch.Tensor] = {}
    blocks = []
    for i in range(data):
        row = []
        for j in range(parts):
            dev = mesh.devices[i, j]
            lo, hi = min(j * blk, m), min((j + 1) * blk, m)
            if dev == w.device:
                b = w[..., lo:hi, :]
            elif row_sharded:
                if (dev, j) not in own:
                    own[(dev, j)] = w[..., lo:hi, :].to(dev)
                b = own[(dev, j)]
            else:
                if dev not in full:
                    full[dev] = w.to(dev)
                b = full[dev][..., lo:hi, :]
            row.append(b)
        blocks.append(row)
    return blocks


def shard_onn_params(params, plan: "ShardPlan", mesh: "Mesh"):
    """Place live ``OnnParams`` for a plan: W and the bias on the mesh's
    first device (where the solve's own tensors live and the combine runs),
    and W's row blocks on the model-axis devices (:func:`weight_blocks`),
    row-sharded at rest when N divides the model degree, else replicated.
    Returns the params the solve should be given, with the blocks as their
    ``placement``.
    """
    from repro_torch.core.dynamics import OnnParams

    w = params.weights.to(mesh.first)
    parts = plan.model if plan.model_sharded else 1
    placement = Placement(w, (parts, mesh.key()), weight_blocks(w, plan, mesh))
    return OnnParams(weights=w, bias=params.bias.to(mesh.first), placement=placement)


# ---------------------------------------------------------------------------
# Leaves placed on a mesh (the elastic restore, ``checkpoint.restore``)
# ---------------------------------------------------------------------------


class NamedSharding(NamedTuple):
    """The port's counterpart of ``jax.sharding.NamedSharding``: a
    :class:`~repro_torch.distributed.plan.Mesh` and a spec (a tuple of mesh
    axis names per dim, ``None`` replicated, a tuple of names split over
    several axes, major first)."""

    mesh: "Mesh"
    spec: Spec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(shape: Tuple[int, ...], sharding: NamedSharding, position) -> Tuple[slice, ...]:
    """The slice of a ``shape`` array that mesh ``position`` (an index into
    ``mesh.devices``) holds, as ``jax.Array.addressable_shards`` gives it:
    a dim split over axes (a1, a2, …) is cut into ∏ sizes equal blocks,
    block ravel(position along a1, a2, …); replicated dims are whole.
    Raises ``ValueError`` where a split does not divide its dim, with the
    words ``jax.device_put`` uses."""
    mesh, spec = sharding
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    where = dict(zip(mesh.axis_names, position))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the array's {len(shape)} dims")
    out = []
    for i, dim in enumerate(shape):
        axes = _entry_axes(spec[i] if i < len(spec) else None)
        parts, idx = 1, 0
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of {mesh.axis_names}")
            parts *= sizes[a]
            idx = idx * sizes[a] + where[a]
        if dim % parts:
            raise ValueError(
                f"Sharding spec {spec} implies that array axis {i} is partitioned {parts} "
                f"times, but does not evenly divide the dimension size {dim}. Got shape: "
                f"{tuple(shape)} and sharding {sharding}")
        blk = dim // parts
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


@dataclasses.dataclass(eq=False)
class ShardedTensor:
    """One leaf placed per a :class:`NamedSharding`: ``blocks[position]`` is
    the block that mesh position holds (``params.local_shape`` of the leaf),
    on that position's device.  A replicated dim repeats whole on every
    position along the axes that do not split it."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    blocks: np.ndarray  # object array of the mesh's shape


def place(array: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``array`` (on the host) placed per ``sharding``: each mesh position
    receives its own slice, copied to its device (``jax.device_put`` with a
    ``NamedSharding``); no device receives more than its block."""
    mesh = sharding.mesh
    shape = tuple(array.shape)
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(blocks.shape):
        blocks[pos] = array[block_index(shape, sharding, pos)].to(mesh.devices[pos], copy=True)
    return ShardedTensor(shape, array.dtype, sharding, blocks)
