"""The dry run on the meta device (the port of ``repro.launch.dryrun``).

Counts every (architecture × input shape) cell against the production mesh
(``launch.mesh.make_production_mesh``) WITHOUT allocating anything: the
cell's step (``models.steps.build_cell``) runs on meta tensors under one
dispatch mode that counts what each op does.  The port has no partitioner,
so a cell measures **one device's program** (``models/tp.py``;
``build_cell(per_device=True)``): the ``global_batch / dp_size`` examples
one data-parallel replica takes, in the cell's ``auto_microbatches``, where
``dp_size`` is the product of the mesh axes the batch rule names, through
that device's blocks of every leaf as ``params.pspecs`` splits it (local
heads, MLP width, vocab, experts over ``"model"``; the FSDP ``embed`` and
``expert_embed`` dims over ``"data"``; a ``kv_seq``-split cache at its
block), whole where the specs replicate.  The program gathers an FSDP
block where a layer reads it and reduce-scatters its gradient there, once
a microbatch; it makes the tensor-parallel collectives where a split
contraction leaves a partial sum or a split result, and a train step's
optimizer and replicas join their statistics and gradients over the
blocks.  From it the cell records, into
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<tag>].json``:

* **FLOPs and bytes accessed** (``cost_analysis``), per device.  FLOPs
  come from ``torch.utils.flop_counter``'s formulas; bytes accessed are the
  sum of each op's tensor inputs and outputs (views move nothing), what
  XLA's ``bytes accessed`` sums.  Both are extrapolated from probes at 1
  and 2 layer groups × 2 and 3 examples (one microbatch's count when it
  holds fewer: a batch of one is a degenerate point of torch's bytes) with
  the reference's algebra (``_layer_points``, the enc-dec's three depth
  points, ``_solve_linear``), then scaled by the microbatches.
* **Memory per device** (``memory_analysis``).  Argument bytes are exact:
  each leaf's per-device block (``params.local_shape``) under the cell's
  specs and the mesh sizes, the program's own arguments; the donated
  arguments are the alias bytes; output bytes are those plus the program's
  other outputs.  Temporary bytes are the peak of live storage the
  device's program makes above its arguments (its outputs, the gathered
  FSDP blocks and its float32 gradient accumulators at its blocks
  included), counted by this module's own tracker over probes of the
  whole step at 1 and 2 layer groups and extrapolated the same way;
  ``peak_segment`` names the stretch that holds it.  ``fits``: arguments
  plus temporaries within one H100's 80 GB.
* **Collective bytes per device** (``collectives``), with the reference's
  ring wire factors (``hlo_analysis.WIRE_FACTOR``), the sum of two sides,
  both counted by the program's hooks (``tp.CountHook``) on the memory
  probes' whole steps (the replica's batch and microbatches, the
  optimizer's statistics once a step) at 1 and 2 layer groups,
  extrapolated to the depth.  The parameter side (``collectives_params``):
  an FSDP block's all-gather at each read and at remat's recompute of it
  and its gradient's reduce-scatter at each read, per microbatch; a
  gradient's all-reduce over the batch axes that do not cut its leaf, the
  global norm's and Adafactor's statistics, once a step.  The activation
  side (``collectives_tp``): the layers' tensor-parallel and ``kv_seq``
  collectives in the forward, remat's recompute and the backward, the MoE
  balance statistic and the loss joined over the replicas.  At a data and
  a model axis of 1 (and no ``kv_seq`` split) the program is the replica's
  step and counts none.

The reference's HLO parser has no counterpart (``launch.hlo_analysis``);
its ``_accounting_cfg`` is not needed (the probes count the cell's own
chunk sizes).

The ONN cells (:func:`run_onn_cell`; ``configs.onn.ONN_CELLS``, B = 1024
lanes, 32 cycles of σ ← sign(σ Wᵀ), ties keeping σ) count one device's
program of the batched retrieval sweep in one of four layouts
(:func:`onn_program`):

* ``baseline2d``: W's block with rows over ``"model"`` and columns over
  ``"data"``; each cycle kernel 1 on σ's column block, the partial field
  all-reduced over ``"data"``, the sign update on σ's row block, σ'
  all-gathered as int8 over ``"model"``.  Where N does not divide the
  axes (``onn_506``), W is replicated and the lanes split over the batch
  axes: one kernel-2 launch a cycle, no collective.
* ``rowpar``: W's rows over every device; kernel 1 on the (N/S, N) block,
  then σ' all-gathered over all S devices.
* ``rowpar_bitpack``: σ' packed 8 spins a byte for the gather.
* ``rowpar_bp_int4``: as ``rowpar_bitpack``, W stored two weights a byte and
  unpacked each cycle.

The port has no partitioner, so each program is written out with its
collectives explicit (:class:`Launch`, :class:`Collective`) and driven
three ways: counted on the meta device (:func:`count_onn_sweep`, each
launch by :meth:`CountMode.kernel` at its int8 operands' and output's
bytes, never through the plain version, which computes in float64), alone
on one device (:func:`run_onn_share`: no peers, each collective the
identity) and composed on a mesh (:func:`run_onn_composed`).  Every tensor
counted is int8, uint8, bool or int32: the peak per device is an int8
program's.  Three figures differ from the reference's on purpose: FLOPs
are the products' alone (XLA also counts the elementwise ops); the
all-gather moves σ' once a cycle as int8, half the reference's bytes (its
HLO gathers the two ``pred`` masks of ``sign_update``'s ``where``);
temporaries and bytes accessed are this module's own count, op by op, not
XLA's buffer plan.  The compute term takes the card's int8 peak (kernels 1
and 2 multiply int8 on the tensor cores).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --onn onn_131072 --mesh both
  ... knobs: --microbatches 4 --no-remat --rule heads= --tag v2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.onn import ONN_CELLS
from repro_torch.core.dynamics import sign_update
from repro_torch.core.quantization import pack_int4, unpack_int4
from repro_torch.distributed import sharding as shrules
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.models import params as PM
from repro_torch.models import steps as steps_lib
from repro_torch.models import tp
from repro_torch.models.config import SHAPES
from repro_torch.models.model import get_model

ARTIFACT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch"))

#: What an LM cell's per-device fields count (its ``per_device`` entry).
PER_DEVICE = ("one device's program (models/tp.py): its blocks of every split leaf "
              "(model and FSDP axes), whole where the specs replicate; FLOPs, bytes and "
              "temporaries its own; collectives counted by its hooks: the parameter side "
              "(FSDP gathers and reduce-scatters, the gradients' and the optimizer's sums) "
              "and the activation side (tensor-parallel and kv_seq collectives in forward, "
              "remat's recompute and backward; the replicas' loss and MoE balance)")



# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


_ENTER = torch.ops.profiler._record_function_enter_new.default
_EXIT = torch.ops.profiler._record_function_exit._RecordFunction


class CountMode(TorchDispatchMode):
    """One pass over the dispatched ops: FLOPs (``flop_counter``'s
    formulas), bytes accessed (each non-view op's tensor inputs and outputs)
    and the peak of live storage made inside the mode, in all and per
    segment: each ``torch.profiler.record_function`` range the step opens
    (a train cell's ``steps.UPDATE_RANGE``) and each stretch around them.
    Inside a range the live bytes are also kept op by op (the segment's
    third entry), since there the op that holds the peak changes with the
    depth.

    A storage an op makes is live until its last tensor dies (a weak
    reference to the storage, which the tensors, autograd's saved tensors
    and views keep alive).  Storages that existed before the mode (the
    step's arguments, a KV cache written in place) are never counted: an
    output whose storage is one of the op's inputs' and was not made inside
    the mode is the input's own memory.  Works on any device, the meta
    device included."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.segments: List[List[Any]] = [["step", 0]]  # [name, peak(, live by op)] in order
        self.dtypes: set = set()  # of every non-view op's tensor inputs and outputs
        self._seen: Dict[int, Any] = {}

    def _freed(self, key: int, nbytes: int) -> None:
        self._seen.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func is _ENTER:
            self.segments.append([args[0], self.live, []])
        elif func is _EXIT:
            self.segments.append(["step", self.live])
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view:
            return out
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        self.dtypes.update(t.dtype for t in ins + outs)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in in_keys:
                continue
            n = st.nbytes()
            self._seen[key] = weakref.ref(st, lambda _, k=key, n=n: self._freed(k, n))
            self.live += n
        self.peak = max(self.peak, self.live)
        seg = self.segments[-1]
        seg[1] = max(seg[1], self.live)
        if len(seg) == 3:
            seg[2].append(self.live)
        return out

    def kernel(self, flops: int, operands, shape, dtype) -> torch.Tensor:
        """Count one launch of a hand-written kernel as the card runs it,
        never through its plain version: ``flops``, its operands' bytes,
        and its output (``shape``, ``dtype``), made here while the mode is
        active, so that the output's bytes and storage count as an op's.
        Returns the output (on the operands' device: meta in a dry run)."""
        self.flops += flops
        self.bytes += sum(t.nbytes for t in operands)
        self.dtypes.update(t.dtype for t in operands)
        return torch.empty(shape, dtype=dtype, device=operands[0].device)


def count_step(step_fn, args) -> Dict[str, Any]:
    """Run ``step_fn(*args)`` under a :class:`CountMode`: ``flops``,
    ``bytes``, ``peak`` (live storage above the arguments), ``ops``,
    ``segments``, ``seconds`` and ``outputs`` (the step's result)."""
    t0 = time.perf_counter()
    with CountMode() as mode:
        out = step_fn(*args)
    return {"flops": mode.flops, "bytes": mode.bytes, "peak": mode.peak, "ops": mode.ops,
            "segments": mode.segments, "seconds": time.perf_counter() - t0, "outputs": out}


def _pairs(abstract, specs):
    """(tensor, spec) of every leaf of ``abstract`` and the spec tree of
    the same structure (dicts, tuples, a ``TrainState``)."""
    if isinstance(abstract, torch.Tensor):
        yield abstract, specs
    elif isinstance(abstract, dict):
        for k in sorted(abstract):
            yield from _pairs(abstract[k], specs[k])
    elif isinstance(abstract, (tuple, list)):
        if len(abstract) != len(specs):
            raise ValueError(f"{len(abstract)} arguments against {len(specs)} specs")
        for a, sp in zip(abstract, specs):
            yield from _pairs(a, sp)


def _local_numel(t: torch.Tensor, spec, axis_sizes: Dict[str, int]) -> int:
    n = 1
    for d in PM.local_shape(tuple(t.shape), spec, axis_sizes):
        n *= d
    return n


def device_bytes(abstract, specs, axis_sizes: Dict[str, int]) -> int:
    """Bytes one device holds of the meta tensors ``abstract`` under the
    matching spec tree ``specs`` (each leaf's :func:`params.local_shape`)."""
    return sum(_local_numel(t, spec, axis_sizes) * t.element_size()
               for t, spec in _pairs(abstract, specs))


# ---------------------------------------------------------------------------
# The reference's helpers
# ---------------------------------------------------------------------------


def _active_fraction_flops(cfg) -> float:
    """N_active/N_total for MoE archs (expert FLOPs scale by top_k/E)."""
    if cfg.family != "moe" or not cfg.n_experts:
        return 1.0
    # expert params per layer: 3 matrices (wg, wu, wd) of d_model×d_ff each
    expert = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    model = get_model(cfg)
    total = PM.count_params(model.param_specs)
    active = total - expert * (1.0 - cfg.top_k / cfg.n_experts)
    return active / total


def rules_for(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    if shape_name == "long_500k":
        rules = shrules.long_context_rules(multi_pod)
    elif multi_pod:
        rules = shrules.multi_pod_rules()
    else:
        rules = shrules.single_pod_rules()
    rules.update(configs.sharding_overrides(arch))
    return rules


def _layer_points(cfg):
    """(group_count, cfg_kwargs(k)) for the cost-extrapolation probes.

    Layer stacks are homogeneous, so every cost is affine in the number of
    layer groups:  C(k) = base + k·group.  Two probes (k=1, 2) recover base
    and group exactly; the full-depth cost is base + G·group.
    """
    fam = cfg.family
    if fam in ("dense", "moe"):
        return cfg.n_layers, lambda k: {"n_layers": k}
    if fam == "vlm":
        g = cfg.n_layers // cfg.cross_every
        return g, lambda k: {"n_layers": k * cfg.cross_every}
    if fam == "zamba":
        g = cfg.n_layers // cfg.shared_attn_every
        return g, lambda k: {"n_layers": k * cfg.shared_attn_every}
    if fam == "xlstm":
        g = cfg.n_layers // cfg.slstm_every
        return g, lambda k: {"n_layers": k * cfg.slstm_every}
    raise ValueError(fam)


def _affine_combine(c1: Dict, c2: Dict, k1: int, k2: int, full: int, scale: float) -> Dict:
    """C(full) = C(k1) + (full−k1)/(k2−k1) · (C(k2)−C(k1)), then × scale."""
    f = (full - k1) / (k2 - k1)

    def ext(a, b):
        return max(0.0, (a + f * (b - a))) * scale

    keys = set(c1["coll_bytes"]) | set(c2["coll_bytes"])
    return {
        "flops": ext(c1["flops"], c2["flops"]),
        "bytes": ext(c1["bytes"], c2["bytes"]),
        "coll_counts": {
            k: int(ext(c1["coll_counts"].get(k, 0), c2["coll_counts"].get(k, 0)))
            for k in keys
        },
        "coll_bytes": {
            k: ext(c1["coll_bytes"].get(k, 0.0), c2["coll_bytes"].get(k, 0.0))
            for k in keys
        },
    }


def _solve_linear(points, features_full) -> Dict[str, Any]:
    """Least-squares fit of cost = Σ coef·feature over probe points, then
    evaluate at the full-size feature vector.  Exact when the model spans the
    true affine structure (homogeneous stacks × per-example batch work)."""
    feats = np.array([p[0] for p in points], dtype=float)  # (n_pts, n_feat)
    keys = set()
    for _, m in points:
        keys |= set(m["coll_bytes"])

    def fit(getter) -> float:
        ys = np.array([getter(m) for _, m in points], dtype=float)
        coef, *_ = np.linalg.lstsq(feats, ys, rcond=None)
        return float(max(0.0, np.dot(coef, features_full)))

    return {
        "flops": fit(lambda m: m["flops"]),
        "bytes": fit(lambda m: m["bytes"]),
        "coll_counts": {
            k: int(fit(lambda m, k=k: m["coll_counts"].get(k, 0))) for k in keys
        },
        "coll_bytes": {
            k: fit(lambda m, k=k: m["coll_bytes"].get(k, 0.0)) for k in keys
        },
    }


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

class Split(NamedTuple):
    """Where one device's program sits: the rule table and the mesh's axis
    sizes (``models.tp``; a model axis of 1 is the replica's own step)."""

    rules: Dict[str, Any]
    sizes: Dict[str, int]

    def key(self) -> tuple:
        return (tuple(sorted((k, str(v)) for k, v in self.rules.items())),
                tuple(sorted(self.sizes.items())))


def _probe(cfg, shape, probes, *, optimizer, microbatches, accum_dtype,
           split: Split) -> Dict[str, Any]:
    """The counts of one probe's step: one device's program
    (``build_cell(per_device=True)``) under a :class:`models.tp.CountHook`,
    whose collectives by side are the probe's ``sides``; ``probes`` holds
    those a cell has made already (its cost and memory probes meet when the
    replica takes one microbatch of 3 examples or fewer)."""
    key = (cfg, shape, microbatches, optimizer, accum_dtype, split.key())
    if key not in probes:
        cell = steps_lib.build_cell(cfg, shape, split.rules, optimizer_name=optimizer,
                                    microbatches=microbatches, accum_dtype=accum_dtype,
                                    axis_sizes=split.sizes, per_device=True)
        hook = tp.CountHook(cell.sizes)
        with tp.use(cell.layout(hook), shared=True):
            got = count_step(cell.step_fn, cell.abstract_args)
        out = got.pop("outputs")
        # the outputs that do not take a donated argument's place: a train
        # step's metrics, a serve step's token and logits, all of a prefill's
        kept = {"train": out[1:], "decode": out[:2]}.get(cell.kind, out)
        got["other_output_bytes"] = sum(
            t.nbytes for t in pytree.tree_leaves(kept) if isinstance(t, torch.Tensor))
        got["sides"] = hook.sides
        probes[key] = got
    return probes[key]


def _depth_points(cfg):
    """[(features, cfg_k)] at 1 and 2 layer groups (the enc-dec: (1, 1),
    (2, 1), (1, 2) encoder and decoder layers), and the full depth's
    features."""
    if cfg.family == "encdec":
        pts = [([1.0, e, d], dataclasses.replace(cfg, n_encoder_layers=e, n_layers=d))
               for e, d in ((1, 1), (2, 1), (1, 2))]
        return pts, [1.0, cfg.n_encoder_layers, cfg.n_layers]
    full, kw = _layer_points(cfg)
    ks = (1, 2) if full >= 2 else (full,)
    return [([1.0, k], dataclasses.replace(cfg, **kw(k))) for k in ks], [1.0, full]


def _drop_degenerate(points, full_feats):
    fmat = np.array([p[0] for p in points])
    keep = [i for i in range(fmat.shape[1]) if len(set(fmat[:, i])) > 1 or i == 0]
    return [([p[0][i] for i in keep], p[1]) for p in points], [full_feats[i] for i in keep]


def _cost_by_extrapolation(cfg, shape, *, optimizer, replica_batch, mb,
                           accum_dtype=torch.float32, probes=None,
                           split: Split = Split({}, {})) -> Dict[str, Any]:
    """One replica's full-depth FLOPs and bytes from probes at 1 and 2
    layer groups × 2 and 3 examples (one microbatch's when it holds fewer),
    fitted to cost = a + k·c + b·d + k·b·e and scaled by the microbatches,
    as the reference's ``_cost_by_extrapolation`` does."""
    scale = 1.0
    b_full = replica_batch
    if shape.kind == "train" and mb > 1:
        b_full = replica_batch // mb
        scale = float(mb)
    # One example is a degenerate point for the bytes: torch's matmul folds
    # a batch of one without the copy it makes of a larger one, so the
    # probes take 2 and 3 examples (or the microbatch itself when it holds
    # fewer than 3).
    batches = (b_full,) if b_full < 3 else (2, 3)
    t0 = time.perf_counter()
    probes = {} if probes is None else probes
    depth, depth_full = _depth_points(cfg)
    points = []
    for dfeats, cfg_k in depth:
        for b in batches:
            m = _probe(cfg_k, dataclasses.replace(shape, global_batch=b), probes,
                       optimizer=optimizer, microbatches=1, accum_dtype=accum_dtype,
                       split=split)
            feats = dfeats + [b] + [f * b for f in dfeats[1:]]
            # the collectives are counted on the memory probes' whole steps
            points.append((feats, {"flops": m["flops"], "bytes": m["bytes"],
                                   "coll_counts": {}, "coll_bytes": {}}))
    full_feats = depth_full + [b_full] + [f * b_full for f in depth_full[1:]]
    points, full_feats = _drop_degenerate(points, full_feats)
    out = _solve_linear(points, full_feats)
    for key in ("flops", "bytes"):
        out[key] *= scale
    del out["coll_counts"], out["coll_bytes"]
    out["probe_s"] = round(time.perf_counter() - t0, 2)
    out["cost_scale"] = scale
    out["n_probes"] = len(points)
    return out


def _memory_by_extrapolation(cfg, shape, *, optimizer, replica_batch, mb,
                             accum_dtype=torch.float32, probes=None,
                             split: Split = Split({}, {})) -> Dict[str, Any]:
    """The replica's whole step (its batch, its microbatches) probed at 1
    and 2 layer groups: the peak of live storage above the arguments and
    the non-donated outputs' bytes, each extrapolated affinely to the full
    depth.  The peak is extrapolated segment by segment: the stretch
    before a train step's update as one peak (in it the live bytes grow by
    the same amount a layer), the update op by op (the same ops at every
    depth, one leaf after another; the leaf that holds its peak changes
    with the depth), then the stretch after it.  The segment that holds
    the step's peak changes with the depth too: at 1 or 2 layers the
    loss's logits, at 28 the optimizer's new state.  The probes' hooks'
    collectives by side (``collectives``) are extrapolated the same way,
    each count rounded to a whole number."""
    t0 = time.perf_counter()
    probes = {} if probes is None else probes
    depth, depth_full = _depth_points(cfg)
    shp = dataclasses.replace(shape, global_batch=replica_batch)
    runs = [_probe(cfg_k, shp, probes, optimizer=optimizer, microbatches=mb,
                   accum_dtype=accum_dtype, split=split) for _, cfg_k in depth]
    layouts = {tuple((seg[0], len(seg[2]) if len(seg) == 3 else None) for seg in m["segments"])
               for m in runs}
    if len(layouts) != 1:
        raise RuntimeError(f"the step's segments change with the depth: {layouts}")
    points, full_feats = _drop_degenerate([(f, None) for f, _ in depth], depth_full)
    feats = np.array([f for f, _ in points], dtype=float)

    def at_full(values) -> np.ndarray:
        """Each column of ``values`` (one row a probe) at the full depth."""
        coef, *_ = np.linalg.lstsq(feats, np.array(values, dtype=float), rcond=None)
        return np.dot(full_feats, coef)

    seg_peaks = [float(np.max(at_full([m["segments"][i][-1] for m in runs])))
                 if len(seg) == 3 and seg[2] else float(at_full([m["segments"][i][1] for m in runs]))
                 for i, seg in enumerate(runs[0]["segments"])]
    top = int(np.argmax(seg_peaks))
    collectives = {}
    for side in tp.SIDES:
        got = [m["sides"][side] for m in runs]
        ops = sorted({op for g in got for op in g["counts"]})
        counts = at_full([[g["counts"].get(op, 0) for op in ops] for g in got]) if ops else []
        byts = at_full([[g["bytes"].get(op, 0.0) for op in ops] for g in got]) if ops else []
        collectives[side] = hlo.CollectiveStats(
            counts={op: max(0, int(round(float(c)))) for op, c in zip(ops, counts)},
            bytes={op: max(0.0, float(b)) for op, b in zip(ops, byts)})
    return {"temp": int(round(seg_peaks[top])), "peak_segment": runs[0]["segments"][top][0],
            "other_outputs": int(round(float(at_full([m["other_output_bytes"] for m in runs])))),
            "collectives": collectives,
            "probe_s": round(time.perf_counter() - t0, 2), "n_probes": len(runs)}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _axes_of(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    microbatches: int = 0,
    remat: Optional[bool] = None,
    rule_overrides: Optional[Dict[str, Any]] = None,
    optimizer: Optional[str] = None,
    tag: str = "",
    outdir: str = ARTIFACT_DIR,
    verbose: bool = True,
    accum_dtype=torch.float32,
    mesh=None,
    shape=None,
) -> Dict[str, Any]:
    """One dry-run cell (module docstring): the replica's costs by
    extrapolation, its memory and its program's collectives per device,
    the roofline; written to ``outdir`` and returned.

    ``mesh`` replaces the production mesh and ``shape`` the named shape
    (the train step of one card, ``chip_smoke.py``'s ``dryrun_train_full``).
    """
    t_cell = time.perf_counter()
    cfg = configs.get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name] if shape is None else shape
    mesh_name = "multi" if multi_pod else "single"
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh_name = "x".join(str(n) for n in mesh.devices.shape)
    rules = rules_for(arch, shape_name, multi_pod)
    if rule_overrides:
        rules.update(rule_overrides)
    sizes = PM.mesh_axis_sizes(mesh)

    # data-parallel degree = product of mesh axes carrying the batch rule
    dp_size = 1
    for a in _axes_of(rules.get("batch")):
        dp_size *= sizes.get(a, 1)
    mb = microbatches or steps_lib.auto_microbatches(shape, dp_size)
    replica_batch = max(1, shape.global_batch // dp_size)

    with shrules.use_rules(rules, mesh):
        cell = steps_lib.build_cell(
            cfg, shape, rules, optimizer_name=optimizer, microbatches=mb, dp_size=dp_size,
            axis_sizes=sizes, accum_dtype=accum_dtype,
        )
    args_b = device_bytes(cell.abstract_args, cell.in_specs, sizes)
    alias_b = sum(device_bytes(cell.abstract_args[i], cell.in_specs[i], sizes)
                  for i in cell.donate)
    opt_name = optimizer
    if shape.kind == "train" and opt_name is None:
        opt_name = "adafactor" if cfg.family == "moe" else "adamw"

    probes: Dict[tuple, Dict[str, Any]] = {}
    split = Split(rules, sizes)
    cost = _cost_by_extrapolation(cfg, shape, optimizer=optimizer, replica_batch=replica_batch,
                                  mb=mb, accum_dtype=accum_dtype, probes=probes, split=split)
    memory = _memory_by_extrapolation(cfg, shape, optimizer=optimizer,
                                      replica_batch=replica_batch, mb=mb,
                                      accum_dtype=accum_dtype, probes=probes, split=split)
    params_coll, tp_coll = memory["collectives"]["params"], memory["collectives"]["tp"]
    coll = hlo.CollectiveStats(
        counts={k: params_coll.counts.get(k, 0) + tp_coll.counts.get(k, 0)
                for k in set(params_coll.counts) | set(tp_coll.counts)},
        bytes={k: params_coll.bytes.get(k, 0.0) + tp_coll.bytes.get(k, 0.0)
               for k in set(params_coll.bytes) | set(tp_coll.bytes)})
    mem = {
        "argument_size_in_bytes": args_b,
        "output_size_in_bytes": alias_b + memory["other_outputs"],
        "temp_size_in_bytes": memory["temp"],
        "alias_size_in_bytes": alias_b,
    }
    return _analyze(
        mesh,
        name=cell.name,
        kind=shape.kind,
        # processed tokens per step: full sequence for train/prefill, one new
        # token per request for decode
        tokens=shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len),
        cfg=cfg,
        mesh_name=mesh_name,
        mem=mem,
        flops=cost["flops"],
        byts=cost["bytes"],
        coll=coll,
        tag=tag,
        outdir=outdir,
        verbose=verbose,
        extra={
            "dp_size": dp_size,
            "replica_batch": replica_batch,
            "model_axis": sizes.get("model", 1),
            "per_device": PER_DEVICE,
            "peak_segment": memory["peak_segment"],
            "collectives_params": {"counts": params_coll.counts, "bytes": params_coll.bytes},
            "collectives_tp": {"counts": tp_coll.counts, "bytes": tp_coll.bytes},
            "cost_probe_s": cost["probe_s"],
            "cost_scale": cost["cost_scale"],
            "n_probes": cost["n_probes"],
            "memory_probe_s": memory["probe_s"],
            "microbatches": mb,
            "remat": cfg.remat,
            "optimizer": opt_name,
            "rule_overrides": {k: str(v) for k, v in (rule_overrides or {}).items()},
        },
        t_start=t_cell,
    )


def _analyze(
    mesh,
    *,
    name: str,
    kind: str,
    tokens: int,
    cfg,
    mesh_name: str,
    mem: Dict[str, int],
    flops: float,
    byts: float,
    coll: hlo.CollectiveStats,
    tag: str,
    outdir: str,
    verbose: bool,
    extra: Dict[str, Any],
    t_start: float,
    peak_flops: float = hlo.H100_BF16_FLOPS_PER_S,
) -> Dict[str, Any]:
    ndev = mesh_devices(mesh)
    roof = hlo.Roofline(
        flops_per_device=flops,
        hbm_bytes_per_device=byts,
        collective_bytes_per_device=coll.total_bytes,
        n_devices=ndev,
        peak_flops=peak_flops,
    )
    needed = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    result: Dict[str, Any] = {
        "cell": name,
        "kind": kind,
        "mesh": mesh_name,
        "n_devices": ndev,
        "memory_analysis": mem,
        "cost_analysis": {"flops": flops, "bytes_accessed": byts},
        "collectives": {"counts": coll.counts, "bytes": coll.bytes},
        "roofline": roof.to_dict(),
        "roofline_peaks": {"flops_per_s": roof.peak_flops, "hbm_bytes_per_s": roof.hbm_bw,
                           "link_bytes_per_s": roof.link_bw},
        "fits": needed <= hlo.H100_HBM_BYTES,
        "hbm_bytes": hlo.H100_HBM_BYTES,
        **extra,
    }
    if cfg is not None:
        model = get_model(cfg)
        n_params = PM.count_params(model.param_specs)
        frac = _active_fraction_flops(cfg)
        useful = hlo.model_flops(kind, int(n_params * frac), tokens)
        result["n_params"] = n_params
    else:
        # an ONN sweep: 2·N²·B MACs a cycle (the coupling weighted sums)
        n = extra["n_oscillators"]
        useful = 2.0 * n * n * extra["batch"] * extra["cycles"]
    result["model_flops_global"] = useful
    # flops are per device; the global count is n_devices times that
    flops_global = flops * ndev
    result["useful_flops_ratio"] = useful / flops_global if flops_global else 0.0
    result["seconds"] = round(time.perf_counter() - t_start, 2)

    os.makedirs(outdir, exist_ok=True)
    fname = name.replace(":", "__").replace("/", "_") + f"__{mesh_name}"
    if tag:
        fname += f"__{tag}"
    path = os.path.join(outdir, fname + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        r = result["roofline"]
        print(
            f"[dryrun] {name} ({mesh_name}) {result['seconds']}s | compute "
            f"{r['compute_s']:.3e}s memory {r['memory_s']:.3e}s collective "
            f"{r['collective_s']:.3e}s → {r['dominant']}-bound | per device: args "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB fits {result['fits']}",
            flush=True,
        )
        print(f"[dryrun] wrote {path}", flush=True)
    return result


# ---------------------------------------------------------------------------
# ONN cells: one device's program of the batched retrieval sweep
# ---------------------------------------------------------------------------

ONN_VARIANTS = ("baseline2d", "rowpar", "rowpar_bitpack", "rowpar_bp_int4")


def _pack_bits(s: torch.Tensor) -> torch.Tensor:
    """±1 int8 spins (B, N) → bit-packed uint8 (B, N/8), LSB first."""
    b, n = s.shape
    bits = (s > 0).to(torch.uint8).reshape(b, n // 8, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=s.device)
    return (bits << shifts).sum(-1, dtype=torch.uint8)


def _unpack_bits(p: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits`: uint8 (B, N/8) → ±1 int8 spins (B, N)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=p.device)
    bits = (p[..., None] >> shifts) & 1
    return (2 * bits.to(torch.int8) - 1).reshape(p.shape[0], n)


class Launch(NamedTuple):
    """A program's launch of kernel 1 (``"coupling_sum"``: σ Wᵀ, int32) or
    kernel 2 (``"onn_step"``: sign(σ Wᵀ) as int8, ties keep σ)."""

    kernel: str
    w: torch.Tensor
    sigma: torch.Tensor


class Collective(NamedTuple):
    """A program's collective over the mesh ``axes``, in place: an
    ``"all-reduce"`` sums ``block`` over the group into ``block``; an
    ``"all-gather"`` writes each member's ``block`` into ``dest`` at its
    slot of the last axis (member ``index`` at ``index`` block widths)."""

    op: str
    axes: Tuple[str, ...]
    block: torch.Tensor
    dest: Optional[torch.Tensor] = None
    index: int = 0


def _slot(dest: torch.Tensor, block: torch.Tensor, index: int) -> torch.Tensor:
    width = block.shape[-1]
    return dest[..., index * width:(index + 1) * width]


def _launch(req: Launch) -> torch.Tensor:
    """The launch on the request's tensors (the plain version on the CPU)."""
    return getattr(ops, req.kernel)(req.w, req.sigma)


def _drive(gen, step):
    """Run a program to its end, each request answered by ``step``."""
    reply = None
    while True:
        try:
            req = gen.send(reply)
        except StopIteration as stop:
            return stop.value
        reply = step(req)


@dataclasses.dataclass(frozen=True)
class OnnProgram:
    """One device's program of an ONN sweep (``cycles`` of σ ← sign(σ Wᵀ),
    ties keeping σ, on ``batch`` lanes of N oscillators) on a mesh of
    ``axes`` and ``sizes``: W's layout, the arguments each device holds, and
    :meth:`sweep`, which yields each kernel launch and collective."""

    variant: str
    layout: str  # "2d", "row" or "replicated"
    n: int
    batch: int
    cycles: int
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def w_spec(self) -> tuple:
        return shrules.onn_weight_spec("pod" in self.axes, self.layout)

    def group_size(self, axes) -> int:
        """The devices of a group over ``axes`` (1 for none)."""
        size = dict(zip(self.axes, self.sizes))
        return int(np.prod([size[a] for a in axes], dtype=np.int64))

    def _rank(self, pos, axes) -> int:
        """``pos``'s index in the group over ``axes``, row-major in their order."""
        r = 0
        for a in axes:
            i = self.axes.index(a)
            r = r * self.sizes[i] + pos[i]
        return r

    @property
    def row_axes(self) -> Tuple[str, ...]:
        return _axes_of(self.w_spec[0])

    @property
    def col_axes(self) -> Tuple[str, ...]:
        return _axes_of(self.w_spec[1])

    @property
    def lane_axes(self) -> Tuple[str, ...]:
        """The axes σ's lanes split over: the batch axes when W is
        replicated, none otherwise (σ replicated)."""
        if self.layout != "replicated":
            return ()
        return ("pod", "data") if "pod" in self.axes else ("data",)

    @property
    def block(self) -> Tuple[int, int]:
        """(rows, columns) of W a device holds, unpacked."""
        return self.n // self.group_size(self.row_axes), self.n // self.group_size(self.col_axes)

    def argument_shapes(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of one device's W block and σ."""
        rows, cols = self.block
        w = (((rows, cols // 2), torch.uint8) if self.variant == "rowpar_bp_int4"
             else ((rows, cols), torch.int8))
        return [w, ((self.batch // self.group_size(self.lane_axes), self.n), torch.int8)]

    def lanes(self, pos) -> slice:
        """The lanes of the global σ that position ``pos`` holds."""
        k = self.batch // self.group_size(self.lane_axes)
        r = self._rank(pos, self.lane_axes)
        return slice(r * k, (r + 1) * k)

    def arguments(self, pos, w: torch.Tensor, sigma: torch.Tensor):
        """Position ``pos``'s W block and σ, cut from the global W (N, N)
        int8 and σ (batch, N) int8 (the int4 variant packs its block)."""
        rows, cols = self.block
        r, c = self._rank(pos, self.row_axes), self._rank(pos, self.col_axes)
        blk = w[r * rows:(r + 1) * rows, c * cols:(c + 1) * cols]
        blk = pack_int4(blk) if self.variant == "rowpar_bp_int4" else blk.contiguous()
        return blk, sigma[self.lanes(pos)]

    def sweep(self, pos, w: torch.Tensor, sigma: torch.Tensor):
        """Position ``pos``'s sweep on its arguments: a generator that
        yields each :class:`Launch` (answered by the launch's output) and
        each :class:`Collective` (done in place), and returns its σ."""
        if self.layout == "replicated":
            s = sigma
            for _ in range(self.cycles):
                s = yield Launch("onn_step", w, s)
            return s
        rows, cols = self.block
        r = self._rank(pos, self.row_axes)
        own = slice(r * rows, (r + 1) * rows)
        if self.variant in ("baseline2d", "rowpar"):
            c = self._rank(pos, self.col_axes)
            s = sigma.clone()  # the sweep's σ and its output: each gather writes into it
            for _ in range(self.cycles):
                x = s[:, c * cols:(c + 1) * cols].contiguous() if self.col_axes else s
                field = yield Launch("coupling_sum", w, x)
                if self.col_axes:
                    yield Collective("all-reduce", self.col_axes, field)
                yield Collective("all-gather", self.row_axes, sign_update(field, s[:, own]), s, r)
            return s
        packed = _pack_bits(sigma)  # the sweep's σ, 8 spins a byte
        for _ in range(self.cycles):
            s = _unpack_bits(packed, self.n)
            wf = unpack_int4(w) if self.variant == "rowpar_bp_int4" else w
            field = yield Launch("coupling_sum", wf, s)
            new = _pack_bits(sign_update(field, s[:, own]))
            yield Collective("all-gather", self.row_axes, new, packed, r)
        return _unpack_bits(packed, self.n)


def onn_program(variant: str, n: int, batch: int, cycles: int,
                axis_sizes: Dict[str, int]) -> OnnProgram:
    """The per-device program of ``variant`` on a mesh of ``axis_sizes``
    (``{"data": 16, "model": 16}``; ``"pod"`` first when present).

    ``baseline2d`` takes the ``"2d"`` layout when N divides both the
    ``"model"`` and ``"data"`` axes, else ``"replicated"`` (W on every
    device, the lanes over the batch axes); the ``rowpar`` variants take
    ``"row"``, which needs N to divide over every device (and, packed, 8 to
    divide each device's rows).  GSPMD's padding is not imitated."""
    axes, sizes = tuple(axis_sizes), tuple(axis_sizes.values())
    devices = int(np.prod(sizes, dtype=np.int64))
    if variant == "baseline2d":
        layout = ("2d" if n % axis_sizes["model"] == 0 and n % axis_sizes["data"] == 0
                  else "replicated")
    elif variant in ONN_VARIANTS:
        layout = "row"
        if n % devices:
            raise ValueError(f"ONN variant {variant!r}: N = {n} rows do not divide over the "
                             f"S = {devices} devices of the row layout")
        if variant != "rowpar" and (n // devices) % 8:
            raise ValueError(f"ONN variant {variant!r}: {n // devices} rows a device (N = {n}, "
                             f"S = {devices}) do not pack 8 spins a byte")
    else:
        raise ValueError(f"unknown ONN variant {variant!r}")
    prog = OnnProgram(variant, layout, n, batch, cycles, axes, sizes)
    if batch % prog.group_size(prog.lane_axes):
        raise ValueError(f"ONN variant {variant!r}: {batch} lanes do not divide over the "
                         f"{prog.group_size(prog.lane_axes)} devices of the batch axes")
    return prog


def onn_cell_program(cell_name: str, multi_pod: bool, variant: str = "baseline2d") -> OnnProgram:
    """The per-device program of an ``ONN_CELLS`` cell on a production mesh."""
    spec = ONN_CELLS[cell_name]
    sizes = PM.mesh_axis_sizes(make_production_mesh(multi_pod=multi_pod))
    return onn_program(variant, spec["n"], spec["batch"], spec["cycles"], sizes)


def count_onn_sweep(prog: OnnProgram) -> Dict[str, Any]:
    """Device 0's sweep of ``prog`` counted on the meta device: each
    launch by :meth:`CountMode.kernel`, each collective's wire bytes with
    :data:`hlo_analysis.WIRE_FACTOR` and its operand's and result's bytes
    as bytes accessed.  Returns ``flops``, ``bytes``, ``peak`` (live
    storage above the arguments, the output included), ``argument_bytes``,
    ``output_bytes``, ``collectives`` and ``dtypes`` (every dtype the count
    saw)."""
    args = [torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in prog.argument_shapes()]
    counts: Dict[str, int] = {}
    wire: Dict[str, float] = {}

    def step(req):
        if isinstance(req, Launch):
            (b, k), m = req.sigma.shape, req.w.shape[0]
            dtype = torch.int32 if req.kernel == "coupling_sum" else torch.int8
            return mode.kernel(2 * b * m * k, (req.w, req.sigma), (b, m), dtype)
        size = prog.group_size(req.axes)
        if size > 1:
            result = req.block.nbytes * (size if req.op == "all-gather" else 1)
            counts[req.op] = counts.get(req.op, 0) + 1
            wire[req.op] = wire.get(req.op, 0.0) + hlo.WIRE_FACTOR[req.op](size) * result
            mode.bytes += req.block.nbytes + result
        return None

    with CountMode() as mode:
        out = _drive(prog.sweep((0,) * len(prog.axes), *args), step)
    return {"flops": mode.flops, "bytes": mode.bytes, "peak": mode.peak,
            "argument_bytes": sum(t.nbytes for t in args), "output_bytes": out.nbytes,
            "collectives": hlo.CollectiveStats(counts=counts, bytes=wire),
            "dtypes": sorted(str(d).replace("torch.", "") for d in mode.dtypes)}


def run_onn_share(prog: OnnProgram, pos, w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Position ``pos``'s sweep alone on its own W block and σ (on any
    device): the kernels launched; with no peers each collective is the
    identity on the device's own block (the all-reduce adds nothing, the
    gather writes σ' into the device's own slot).  Returns its σ."""

    def step(req):
        if isinstance(req, Launch):
            return _launch(req)
        if req.op == "all-gather":
            _slot(req.dest, req.block, req.index).copy_(req.block)
        return None

    return _drive(prog.sweep(pos, w, sigma), step)


def run_onn_composed(prog: OnnProgram, mesh, w: torch.Tensor,
                     sigma: torch.Tensor) -> Dict[tuple, torch.Tensor]:
    """Every position's program in lock step on ``mesh`` (its shape
    ``prog``'s), each on its device's arguments cut from the global W (N, N)
    int8 and σ (batch, N) int8: the kernels launched, each collective done
    for real (a sum over the group; copies into every member's slot).
    Returns each position's σ."""
    if tuple(mesh.devices.shape) != prog.sizes:
        raise ValueError(f"mesh {mesh.shape} is not the program's {prog.sizes}")
    gens, replies, outs = {}, {}, {}
    for pos in np.ndindex(*prog.sizes):
        dev = mesh.devices[pos]
        gens[pos] = prog.sweep(pos, *(t.to(dev) for t in prog.arguments(pos, w, sigma)))
        replies[pos] = None
    while gens:
        groups: Dict[tuple, List[Collective]] = {}
        for pos in list(gens):
            try:
                req = gens[pos].send(replies[pos])
            except StopIteration as stop:
                outs[pos] = stop.value
                del gens[pos]
                continue
            replies[pos] = _launch(req) if isinstance(req, Launch) else None
            if isinstance(req, Collective):
                rest = tuple(i for a, i in zip(prog.axes, pos) if a not in req.axes)
                groups.setdefault((req.op, req.axes, rest), []).append(req)
        for (op, axes, _), reqs in groups.items():
            if len(reqs) != prog.group_size(axes):
                raise RuntimeError(f"{op} over {axes}: {len(reqs)} of "
                                   f"{prog.group_size(axes)} members in step")
            if op == "all-reduce":
                total = reqs[0].block.clone()
                for q in reqs[1:]:
                    total += q.block.to(total.device)
                for q in reqs:
                    q.block.copy_(total)
            else:
                for q in reqs:
                    for peer in reqs:
                        _slot(q.dest, peer.block, peer.index).copy_(peer.block)
    return outs


def run_onn_cell(
    cell_name: str,
    multi_pod: bool,
    *,
    tag: str = "",
    outdir: str = ARTIFACT_DIR,
    verbose: bool = True,
    variant: str = "baseline2d",
) -> Dict[str, Any]:
    """One ONN dry-run cell (module docstring): device 0's program of
    ``variant`` on the production mesh counted on the meta device, the
    roofline at the card's int8 peak; written to ``outdir`` and returned."""
    t_cell = time.perf_counter()
    prog = onn_cell_program(cell_name, multi_pod, variant)
    got = count_onn_sweep(prog)
    mem = {
        "argument_size_in_bytes": got["argument_bytes"],
        "output_size_in_bytes": got["output_bytes"],
        "temp_size_in_bytes": got["peak"],
        "alias_size_in_bytes": 0,
    }
    return _analyze(
        make_production_mesh(multi_pod=multi_pod),
        name=f"onn:{cell_name}",
        kind="onn-sweep",
        tokens=prog.batch * prog.cycles,
        cfg=None,
        mesh_name="multi" if multi_pod else "single",
        mem=mem,
        flops=got["flops"],
        byts=got["bytes"],
        coll=got["collectives"],
        tag=tag or (variant if variant != "baseline2d" else ""),
        outdir=outdir,
        verbose=verbose,
        extra={"n_oscillators": prog.n, "batch": prog.batch, "cycles": prog.cycles,
               "variant": variant, "layout": prog.layout, "w_spec": prog.w_spec,
               "w_block": prog.argument_shapes()[0][0], "dtypes_counted": got["dtypes"]},
        t_start=t_cell,
        peak_flops=hlo.H100_INT8_OPS_PER_S,
    )


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--onn", type=str, default=None, choices=list(ONN_CELLS))
    ap.add_argument("--all", action="store_true", help="run every LM cell, then the ONN cells")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--microbatches", type=int, default=0, help="0 = auto")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--opt", type=str, default=None)
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding rule override key=axis ('' = replicate)")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--out", type=str, default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides: Dict[str, Any] = {}
    for kv in args.rule:
        k, _, v = kv.partition("=")
        if v == "":
            overrides[k] = None
        elif "," in v:
            overrides[k] = tuple(v.split(","))
        else:
            overrides[k] = v

    if args.onn:
        jobs = [("onn", args.onn, None)]
    elif args.all:
        jobs = [("lm", a, s) for a, s in configs.all_cells()]
        jobs += [("onn", c, None) for c in ONN_CELLS]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape, --onn or --all required")
        jobs = [("lm", args.arch, args.shape)]

    failures = []
    for kind, a, s in jobs:
        for mp in meshes:
            try:
                if kind == "onn":
                    run_onn_cell(a, mp, tag=args.tag, outdir=args.out)
                    continue
                run_cell(
                    a, s, mp,
                    microbatches=args.microbatches,
                    remat=False if args.no_remat else None,
                    rule_overrides=overrides or None,
                    optimizer=args.opt,
                    tag=args.tag,
                    outdir=args.out,
                )
            except Exception as e:  # noqa: BLE001 — surface per-cell failures
                failures.append((a, s, mp, repr(e)))
                print(f"[dryrun] FAILED {a} {s} multi_pod={mp}: {e!r}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")


if __name__ == "__main__":
    main()
