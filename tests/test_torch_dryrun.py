"""The LM dry run of the port (``repro_torch.launch.dryrun`` and what it
reads) against ``repro``'s.

The pure functions are held with ``==``: the rule tables,
``logical_to_pspec`` on the reference's own cases, ``pspecs`` of every leaf
of the ten full configs under the single-pod, multi-pod and long-context
rules at the production mesh's sizes (specs only, nothing allocated),
``abstract``, ``build_cell``'s specs and abstract arguments, ``Roofline``
on the reference's v5e constants, ``model_flops``, the extrapolation's
algebra, ``rules_for``, ``_active_fraction_flops`` and the production
mesh.  The reference's own dry run cannot lower here (reference fault 4,
ROADMAP.md section 3), so the port's counts are held by their own
consistency: on reduced archs the depth-extrapolated FLOPs, bytes and peak
equal a full-depth count, and a count on the meta device equals the same
step's count on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sharding
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import mesh as ref_mesh
from repro.models import params as ref_params
from repro.models import steps as ref_steps
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.model import get_model as ref_get_model
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.models import params as PM
from repro_torch.models import steps
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.model import get_model

# The reference's dry-run module forces 512 host devices at import; the
# flag is read when JAX's backend starts, so it is put back at once.
_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


def ref_leaves(tree):
    """The reference's spec / abstract leaves in JAX's flatten order."""
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def port_leaves(tree):
    """The port's leaves in the same order: named tuples by field, dicts
    by sorted key; a spec (a plain tuple) or a tensor is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k])]
    if isinstance(tree, tuple) and (hasattr(tree, "_fields") or (
            tree and isinstance(tree[0], (dict, tuple)) and not isinstance(tree[0], str))):
        return [x for v in tree for x in port_leaves(v)]
    return [tree]


def dtype_name(d) -> str:
    return str(d).replace("torch.", "")


# ---------------------------------------------------------------------------
# Rule tables, specs, abstract stand-ins
# ---------------------------------------------------------------------------


def test_rule_tables_equal_reference():
    assert sharding.single_pod_rules() == ref_sharding.single_pod_rules()
    assert sharding.multi_pod_rules() == ref_sharding.multi_pod_rules()
    for mp in (False, True):
        assert sharding.long_context_rules(mp) == ref_sharding.long_context_rules(mp)
    rules = sharding.single_pod_rules()
    assert sharding.data_spec(rules, "batch", None) == tuple(
        ref_sharding.data_spec(rules, "batch", None))


LOGICAL_CASES = [
    (("embed", "mlp"), "single", None, None),
    ((None, "heads"), "single", None, None),
    (("batch",), {"batch": ("pod", "data")}, None, None),
    (("a", "b"), {"a": "model", "b": "model"}, None, None),
    (("embed", "kv_heads", None), "single", (2560, 8, 128), SINGLE),
    (("embed", "heads", None), "single", (2560, 32, 128), SINGLE),
    (("batch", None), "multi", (256, 4096), MULTI),
    (("batch", None), "multi", (24, 4096), MULTI),
    ((), "single", (), SINGLE),
]


@pytest.mark.parametrize("axes,rules,shape,sizes", LOGICAL_CASES)
def test_logical_to_pspec_equals_reference(axes, rules, shape, sizes):
    """The reference's own cases (``tests/test_sharding.py``): the
    divisibility fallback, no mesh axis used twice, trailing ``None`` s
    dropped, a tuple entry for composed axes."""
    table = {"single": sharding.single_pod_rules(), "multi": sharding.multi_pod_rules()}.get(
        rules, rules) if isinstance(rules, str) else rules
    got = PM.logical_to_pspec(axes, table, shape, sizes)
    want = ref_params.logical_to_pspec(axes, table, shape, sizes)
    assert got == tuple(want)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_full_config_pspecs_and_abstract_equal_reference(arch):
    """Every leaf of the full config's parameter specs under the three rule
    sets at the production mesh's sizes, with the arch's overrides; and
    ``abstract``'s shapes and dtypes.  Specs only: nothing is allocated
    (``abstract`` makes meta tensors)."""
    specs = get_model(configs.get_config(arch)).param_specs
    ref_specs = ref_get_model(ref_configs.get_config(arch)).param_specs
    for shape_name, multi, sizes in (("train_4k", False, SINGLE), ("train_4k", True, MULTI),
                                     ("long_500k", False, SINGLE)):
        rules = dryrun.rules_for(arch, shape_name, multi)
        assert rules == ref_dryrun.rules_for(arch, shape_name, multi)
        got = dict(PM.leaves(PM.pspecs(specs, rules, sizes)))
        want = dict(PM.leaves(ref_params.pspecs(ref_specs, rules, sizes)))
        assert got.keys() == want.keys()
        assert all(got[k] == tuple(want[k]) for k in want), arch
    got = dict(PM.leaves(PM.abstract(specs)))
    want = dict(PM.leaves(ref_params.abstract(ref_specs)))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.is_meta and tuple(t.shape) == tuple(want[k].shape)
        assert dtype_name(t.dtype) == dtype_name(want[k].dtype)


def test_shardings_local_shape_and_mesh():
    """``shardings`` pairs each spec with its mesh; ``local_shape`` divides
    each dim by the sizes its entry names; the production meshes have the
    reference's shapes and axes and hold only the meta device."""
    mesh = make_production_mesh(multi_pod=True)
    tree = {"w": PM.ParamSpec((64, 128), ("embed", "mlp")), "b": PM.ParamSpec((3,), (None,))}
    got = PM.shardings(tree, sharding.multi_pod_rules(), mesh)
    assert got["w"] == (mesh, ("data", "model")) and got["b"] == (mesh, ())
    assert PM.mesh_axis_sizes(mesh) == MULTI and mesh_devices(mesh) == 512
    assert PM.local_shape((256, 4096, 7), (("pod", "data"), "model"), MULTI) == (8, 256, 7)
    assert PM.local_shape((24, 3), ("pod",), MULTI) == (12, 3)
    assert all(d == torch.device("meta") for d in mesh.devices.flat)

    calls = []

    def fake_make_mesh(shape, axes):
        calls.append((tuple(shape), tuple(axes)))

    jax_make_mesh = ref_mesh.jax.make_mesh
    ref_mesh.jax.make_mesh = fake_make_mesh
    try:
        for mp in (False, True):
            ref_mesh.make_production_mesh(multi_pod=mp)
            m = make_production_mesh(multi_pod=mp)
            assert (m.devices.shape, m.axis_names) == calls[-1]
    finally:
        ref_mesh.jax.make_mesh = jax_make_mesh


CELL_ARCHS = ("qwen3-4b", "granite-moe-3b-a800m", "zamba2-2.7b", "whisper-large-v3")


@pytest.mark.parametrize("arch", CELL_ARCHS)
@pytest.mark.parametrize("shape_name", ("train_4k", "prefill_32k", "decode_32k"))
def test_build_cell_specs_and_abstract_args_equal_reference(arch, shape_name):
    """The reduced arch's cell: name, kind, donation, every ``in_specs``
    leaf ``==`` the reference's ``PartitionSpec`` and every abstract
    argument's shape and dtype, at the full shape (stand-ins only)."""
    rules = dryrun.rules_for(arch, shape_name, False)
    dp = 16
    cell = steps.build_cell(configs.get_reduced(arch), SHAPES[shape_name], rules,
                            dp_size=dp, axis_sizes=SINGLE)
    ref = ref_steps.build_cell(ref_configs.get_reduced(arch), REF_SHAPES[shape_name], rules,
                               dp_size=dp, axis_sizes=SINGLE)
    assert (cell.name, cell.kind, cell.donate) == (ref.name, ref.kind, ref.donate)
    got, want = port_leaves(cell.in_specs), ref_leaves(ref.in_specs)
    assert len(got) == len(want) and all(g == tuple(w) for g, w in zip(got, want))
    got, want = port_leaves(cell.abstract_args), ref_leaves(ref.abstract_args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape)
        assert dtype_name(g.dtype) == dtype_name(w.dtype)


# ---------------------------------------------------------------------------
# Roofline, model FLOPs, the extrapolation's algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("terms", [(1e15, 1e11, 1e9, 256), (3e12, 8e12, 0.0, 512),
                                   (1e10, 1e6, 5e11, 1)])
def test_roofline_on_v5e_constants_equals_reference(terms):
    v5e = dict(peak_flops=ref_hlo.PEAK_FLOPS, hbm_bw=ref_hlo.HBM_BW, link_bw=ref_hlo.ICI_BW)
    got = hlo.Roofline(*terms, **v5e)
    want = ref_hlo.Roofline(*terms)
    assert got.to_dict() == want.to_dict() and got.bound_s == want.bound_s
    h100 = hlo.Roofline(*terms)
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12, 450e9)
    for kind in ("train", "prefill", "decode"):
        assert hlo.model_flops(kind, 1_777_088_000, 4096) == ref_hlo.model_flops(
            kind, 1_777_088_000, 4096)
        assert hlo.model_flops(kind, 10, 7, n_active=3) == ref_hlo.model_flops(
            kind, 10, 7, n_active=3)
    for op, factor in hlo.WIRE_FACTOR.items():
        assert factor(16) == ref_hlo._WIRE_FACTOR[op](16)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_layer_points_rules_and_active_fraction_equal_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert dryrun._active_fraction_flops(cfg) == ref_dryrun._active_fraction_flops(ref_cfg)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for mp in (False, True):
            assert dryrun.rules_for(arch, shape_name, mp) == ref_dryrun.rules_for(
                arch, shape_name, mp)
    if cfg.family == "encdec":
        with pytest.raises(ValueError):
            dryrun._layer_points(cfg)
        return
    full, kw = dryrun._layer_points(cfg)
    ref_full, ref_kw = ref_dryrun._layer_points(ref_cfg)
    assert full == ref_full and all(kw(k) == ref_kw(k) for k in (1, 2, full))


def test_affine_combine_and_solve_linear_equal_reference():
    rng = np.random.default_rng(3)

    def measures():
        return {"flops": float(rng.integers(1, 10**12)), "bytes": float(rng.integers(1, 10**12)),
                "coll_counts": {"all-gather": int(rng.integers(0, 50))},
                "coll_bytes": {"all-gather": float(rng.integers(0, 10**9)),
                               "all-reduce": float(rng.integers(0, 10**9))}}

    c1, c2 = measures(), measures()
    for args in ((1, 2, 28, 1.0), (1, 2, 40, 4.0), (2, 4, 3, 0.5)):
        assert dryrun._affine_combine(c1, c2, *args) == ref_dryrun._affine_combine(c1, c2, *args)
    points = [([1.0, k, b, k * b], measures()) for k in (1, 2) for b in (1, 2)]
    for full in ([1.0, 28, 4, 112], [1.0, 3, 1, 3]):
        assert dryrun._solve_linear(points, full) == ref_dryrun._solve_linear(points, full)


# ---------------------------------------------------------------------------
# The counts, held by their own consistency
# ---------------------------------------------------------------------------

SMALL_TRAIN = ShapeConfig("train_4k", 64, 3, "train")
SMALL_PREFILL = ShapeConfig("prefill_32k", 64, 3, "prefill")
SMALL_DECODE = ShapeConfig("decode_32k", 64, 3, "decode")


@pytest.mark.parametrize("arch,depth,shape", [
    ("qwen2-1.5b", {"n_layers": 5}, SMALL_TRAIN),
    ("qwen2-1.5b", {"n_layers": 5}, SMALL_PREFILL),
    ("qwen2-1.5b", {"n_layers": 5}, SMALL_DECODE),
    ("zamba2-2.7b", {"n_layers": 6}, SMALL_TRAIN),
    ("zamba2-2.7b", {"n_layers": 6}, SMALL_DECODE),
    ("whisper-large-v3", {"n_layers": 3, "n_encoder_layers": 4}, SMALL_TRAIN),
])
def test_extrapolation_equals_full_depth_count(arch, depth, shape):
    """FLOPs and bytes extrapolated from probes at 1 and 2 layer groups × 2
    and 3 examples equal one count of the full-depth step at 5 examples
    (exact: the fit's result rounded to the nearest integer); the peak
    extrapolated segment by segment from 1 and 2 layer groups equals the
    full-depth peak, at 2 microbatches for the train step.  A serve step
    writes its cache in place, which neither peak counts."""
    cfg = dataclasses.replace(configs.get_reduced(arch), **depth)
    full = steps.build_cell(cfg, dataclasses.replace(shape, global_batch=5), {}, microbatches=1)
    got = dryrun.count_step(full.step_fn, full.abstract_args)
    cost = dryrun._cost_by_extrapolation(cfg, shape, optimizer=None, replica_batch=5, mb=1)
    assert (round(cost["flops"]), round(cost["bytes"])) == (got["flops"], got["bytes"])
    assert cost["n_probes"] == (6 if cfg.family == "encdec" else 4)
    mb = 2 if shape.kind == "train" else 1
    b = 4 if mb == 2 else 3
    whole = steps.build_cell(cfg, dataclasses.replace(shape, global_batch=b), {},
                             microbatches=mb)
    peak = dryrun.count_step(whole.step_fn, whole.abstract_args)["peak"]
    memory = dryrun._memory_by_extrapolation(cfg, shape, optimizer=None, replica_batch=b, mb=mb)
    assert memory["temp"] == peak


def _real_args(cell, cfg, last: int, seed: int = 0):
    """The cell's arguments as CPU tensors: seeded weights, zero optimizer
    state and caches, tokens drawn within the vocabulary, frames drawn, and
    a serve step's index at the last position (where the meta count takes
    it)."""
    gen = torch.Generator().manual_seed(seed)

    def one(t):
        if t.dtype in (torch.int32, torch.int64):
            if t.dim() == 0:
                return torch.tensor(last, dtype=t.dtype)
            return torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen, dtype=t.dtype)
        return (torch.randn(tuple(t.shape), generator=gen) * 0.02).to(t.dtype)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return one(x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        return tuple(walk(v) for v in x)

    return walk(cell.abstract_args)


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", SMALL_TRAIN), ("qwen2-1.5b", SMALL_DECODE),
    ("granite-moe-3b-a800m", SMALL_TRAIN), ("xlstm-1.3b", SMALL_PREFILL),
])
def test_meta_count_equals_cpu_count(arch, shape):
    """The same step counted on meta tensors and on CPU tensors: the same
    FLOPs, bytes accessed and peak of live storage (the tracker's), so the
    meta device stands in for the card's inputs."""
    cfg = configs.get_reduced(arch)
    cell = steps.build_cell(cfg, shape, {}, microbatches=1)
    meta = dryrun.count_step(cell.step_fn, cell.abstract_args)
    args = _real_args(cell, cfg, shape.seq_len - 1)
    if cell.kind == "decode":  # the position the meta count takes, without a host read
        args = args[:3] + (shape.seq_len - 1,)
    cpu = dryrun.count_step(cell.step_fn, args)
    assert meta["flops"] > 0 and meta["bytes"] > 0 and meta["peak"] > 0
    assert (meta["flops"], meta["bytes"], meta["peak"], meta["ops"]) == (
        cpu["flops"], cpu["bytes"], cpu["peak"], cpu["ops"])


def test_count_mode_counts_flops_bytes_and_live_storage():
    """A matmul's 2·M·N·K FLOPs and its three operands' bytes; a view moves
    nothing; a storage stays live while a view of it does."""
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 16), device="meta")

    def step(a, b):
        c = a @ b          # 4·16 floats, live
        d = c.t()          # a view: no bytes, no storage
        e = d * 2.0        # 16·4 floats, live at the peak
        del c, e
        return d

    got = dryrun.count_step(step, (a, b))
    assert got["flops"] == 2 * 4 * 8 * 16
    assert got["bytes"] == 4 * (32 + 128 + 64) + 4 * (64 + 64)
    assert got["peak"] == 4 * 64 * 2 and tuple(got["outputs"].shape) == (16, 4)


def test_count_mode_skips_storage_written_in_place():
    """An op that writes an argument in place (a KV cache's ``copy_``) and
    an in-place op on an argument's view make no new storage: the peak
    counts only what the step makes."""
    cache = torch.empty((2, 64, 8), device="meta")
    x = torch.empty((2, 8), device="meta")

    def step(cache, x):
        cache[:, 3] = x          # copy_ into the argument's storage
        cache[:, 4].mul_(2.0)    # in place on a view of it
        y = x + 1.0              # 2·8 floats, the only new storage
        return cache, y

    got = dryrun.count_step(step, (cache, x))
    assert got["peak"] == 4 * 16
    assert got["outputs"][0] is cache


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b"])
def test_decode_temporaries_exclude_the_cache(arch):
    """A serve step over a long cache: the cache is a donated argument,
    written in place, so the step's temporaries (its peak of live storage)
    stay below the cache's own bytes."""
    cfg = configs.get_reduced(arch)
    cell = steps.build_cell(cfg, ShapeConfig("decode_32k", 4096, 2, "decode"), {})
    cache_bytes = sum(t.nbytes for t in port_leaves(cell.abstract_args[1]))
    got = dryrun.count_step(cell.step_fn, cell.abstract_args)
    assert 0 < got["peak"] < cache_bytes


def test_run_cell_writes_one_json(tmp_path, monkeypatch):
    """``run_cell`` on a reduced config at a small train shape, on the
    single-pod mesh: one JSON with the fields of a cell, the argument bytes
    the specs give, and a roofline of the H100's peaks."""
    shape = ShapeConfig("train_4k", 64, 32, "train")
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_reduced)
    res = dryrun.run_cell("qwen2-1.5b", "train_4k", False, shape=shape,
                          outdir=str(tmp_path), verbose=False)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith("__train_4k__single.json")
    with open(tmp_path / files[0]) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    for key in ("memory_analysis", "cost_analysis", "collectives", "roofline", "fits",
                "n_params", "model_flops_global", "useful_flops_ratio", "cost_probe_s",
                "memory_probe_s", "per_device", "peak_segment", "collectives_params",
                "collectives_tp"):
        assert key in res
    for gone in ("per_device_split", "collectives_counted", "temp_bound", "replica_cost"):
        assert gone not in res
    assert res["dp_size"] == 16 and res["replica_batch"] == 2 and res["n_devices"] == 256
    mem = res["memory_analysis"]
    cell = steps.build_cell(configs.get_reduced("qwen2-1.5b"), shape,
                            dryrun.rules_for("qwen2-1.5b", "train_4k", False), dp_size=16,
                            axis_sizes=SINGLE)
    assert mem["argument_size_in_bytes"] == dryrun.device_bytes(
        cell.abstract_args, cell.in_specs, SINGLE)
    assert mem["alias_size_in_bytes"] == dryrun.device_bytes(
        cell.abstract_args[0], cell.in_specs[0], SINGLE)
    assert res["roofline_peaks"]["flops_per_s"] == 989e12 and res["fits"] is True
    assert res["collectives"]["counts"]  # FSDP gathers and the gradient's sync


def test_main_parses_the_reference_flags(monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: seen.append((a, k)))
    monkeypatch.setattr(dryrun, "run_onn_cell", lambda *a, **k: None)  # --all's ONN cells
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", "both",
                 "--microbatches", "4", "--no-remat", "--opt", "adafactor",
                 "--rule", "heads=", "--rule", "batch=pod,data", "--tag", "v2"])
    assert [a for a, _ in seen] == [("qwen2-1.5b", "train_4k", False),
                                    ("qwen2-1.5b", "train_4k", True)]
    k = seen[0][1]
    assert (k["microbatches"], k["remat"], k["optimizer"], k["tag"]) == (4, False, "adafactor",
                                                                         "v2")
    assert k["rule_overrides"] == {"heads": None, "batch": ("pod", "data")}
    seen.clear()
    dryrun.main(["--all", "--mesh", "single"])
    assert len(seen) == len(configs.all_cells()) == 33
