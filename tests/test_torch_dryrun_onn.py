"""The ONN dry-run cells of the port (``repro_torch.launch.dryrun.run_onn_cell``
and what it reads) against ``repro``'s.

Held with ``==``: ``onn_weight_spec`` / ``onn_param_shardings`` for every
layout and plan, ``ONN_CELLS``, the bit packing and ``unpack_int4``; each
variant's per-device programs composed on a small mesh (collectives done
as sums and copies on the CPU) against the reference's unsharded 32-cycle
scan of ``weighted_sum`` and ``sign_update``; the meta count of every cell
against its closed form.  The reference's own ``run_onn_cell`` lowers only
``onn_131072`` ``baseline2d`` (every other cell raises reference fault 4,
ROADMAP.md section 3); that cell is held in a subprocess with 512 forced
host devices: argument, output and all-reduce figures equal, the
all-gather half the reference's (the port gathers σ' once as int8, the
reference's HLO the two masks of ``sign_update``), FLOPs within 0.3 %
(XLA also counts the elementwise ops).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.onn import ONN_CELLS as REF_ONN_CELLS
from repro.core import dynamics as ref_dyn
from repro.core import quantization as ref_quant
from repro.distributed import sharding as ref_sharding
from repro.distributed.plan import ShardPlan as RefShardPlan
from repro_torch.configs.onn import ONN_CELLS
from repro_torch.core import dynamics as dyn
from repro_torch.core.quantization import pack_int4, unpack_int4
from repro_torch.distributed import Mesh, ShardPlan, sharding
from repro_torch.kernels import ref as plain
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo

# The reference's dry-run module forces 512 host devices at import; the
# flag is read when JAX's backend starts, so it is put back at once.
_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}

# Per device, B = 1024, 32 cycles: (cell, multi_pod, variant) → argument
# bytes, FLOPs, {collective: (count, wire bytes)}, useful-FLOPs ratio.
_AG_INT8 = {False: 4_278_190_080, True: 4_286_578_688}
_AG_PACKED = {False: 534_773_760, True: 535_822_336}
CLOSED_FORMS = {
    ("onn_131072", False, "baseline2d"): (
        201_326_592, 4_398_046_511_104,
        {"all-reduce": (32, 2_013_265_920), "all-gather": (32, 4_026_531_840)}, 1.0),
    ("onn_131072", True, "baseline2d"): (
        201_326_592, 4_398_046_511_104,
        {"all-reduce": (32, 2_013_265_920), "all-gather": (32, 4_026_531_840)}, 0.5),
    ("onn_131072", False, "rowpar"): (
        201_326_592, 4_398_046_511_104, {"all-gather": (32, _AG_INT8[False])}, 1.0),
    ("onn_131072", True, "rowpar"): (
        167_772_160, 2_199_023_255_552, {"all-gather": (32, _AG_INT8[True])}, 1.0),
    ("onn_131072", False, "rowpar_bitpack"): (
        201_326_592, 4_398_046_511_104, {"all-gather": (32, _AG_PACKED[False])}, 1.0),
    ("onn_131072", True, "rowpar_bitpack"): (
        167_772_160, 2_199_023_255_552, {"all-gather": (32, _AG_PACKED[True])}, 1.0),
    ("onn_131072", False, "rowpar_bp_int4"): (
        167_772_160, 4_398_046_511_104, {"all-gather": (32, _AG_PACKED[False])}, 1.0),
    ("onn_131072", True, "rowpar_bp_int4"): (
        150_994_944, 2_199_023_255_552, {"all-gather": (32, _AG_PACKED[True])}, 1.0),
    ("onn_506", False, "baseline2d"): (288_420, 1_048_723_456, {}, 0.0625),
    ("onn_506", True, "baseline2d"): (272_228, 524_361_728, {}, 0.0625),
}
CELL_IDS = [f"{c}-{'multi' if mp else 'single'}-{v}" for c, mp, v in CLOSED_FORMS]


def seeded(seed: int, n: int, batch: int, int4: bool = False):
    """W (N, N) int8, 5-bit ([-15, 15]) or 4-bit ([-8, 7]) values, and ±1 σ
    (batch, N), from numpy."""
    rng = np.random.default_rng(seed)
    lo, hi = (-8, 7) if int4 else (-15, 15)
    w = rng.integers(lo, hi + 1, size=(n, n)).astype(np.int8)
    sigma = np.where(rng.random((batch, n)) < 0.5, -1, 1).astype(np.int8)
    return w, sigma


def reference_scan(w: np.ndarray, sigma: np.ndarray, cycles: int = 32) -> np.ndarray:
    """The reference's unsharded sweep: ``weighted_sum`` then ``sign_update``."""
    cfg = ref_dyn.ONNConfig(n=w.shape[0], max_cycles=cycles, backend="parallel")
    s, wj = jnp.asarray(sigma), jnp.asarray(w)
    for _ in range(cycles):
        s = ref_dyn.sign_update(ref_dyn.weighted_sum(cfg, wj, s), s)
    return np.asarray(s)


# ---------------------------------------------------------------------------
# Layouts, cells and packing against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("layout", ["row", "2d", "replicated"])
def test_onn_weight_spec_equals_reference(multi_pod, layout):
    want = tuple(ref_sharding.onn_weight_spec(multi_pod, layout))
    assert sharding.onn_weight_spec(multi_pod, layout) == want
    specs = sharding.onn_param_shardings(multi_pod, layout)
    assert specs.weights == want and specs.bias == (None,)


@pytest.mark.parametrize("batch,model", [(1, 8), (2, 4), (4, 1)])
def test_onn_weight_spec_under_a_plan_equals_reference(batch, model):
    """A plan decides the spec whatever ``multi_pod`` and ``layout`` say."""
    want = tuple(ref_sharding.onn_weight_spec(True, "2d", RefShardPlan(batch, model)))
    plan = ShardPlan(batch, model)
    assert sharding.onn_weight_spec(True, "2d", plan) == want
    assert sharding.onn_param_shardings(plan=plan).weights == want


def test_unknown_layout_raises_as_the_reference():
    with pytest.raises(ValueError) as want:
        ref_sharding.onn_weight_spec(False, "diagonal")
    with pytest.raises(ValueError) as got:
        sharding.onn_weight_spec(False, "diagonal")
    assert str(got.value) == str(want.value)


def test_onn_cells_equal_reference():
    assert ONN_CELLS == REF_ONN_CELLS


@pytest.mark.parametrize("batch,n", [(3, 8), (16, 1024)])
def test_pack_and_unpack_bits_equal_reference(batch, n):
    _, sigma = seeded(batch + n, n, batch)
    want = np.asarray(ref_dryrun._pack_bits(jnp.asarray(sigma)))
    got = dryrun._pack_bits(torch.as_tensor(sigma))
    assert got.dtype == torch.uint8 and got.shape == (batch, n // 8)
    np.testing.assert_array_equal(got.numpy(), want)
    back = dryrun._unpack_bits(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_dryrun._unpack_bits(jnp.asarray(want), n)))
    np.testing.assert_array_equal(back.numpy(), sigma)


def test_unpack_int4_equals_reference():
    w, _ = seeded(4, 64, 1, int4=True)
    packed = np.array(ref_quant.pack_int4(jnp.asarray(w)))
    np.testing.assert_array_equal(pack_int4(torch.as_tensor(w)).numpy(), packed)
    got = unpack_int4(torch.as_tensor(packed))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_quant.unpack_int4(packed)))


# ---------------------------------------------------------------------------
# The per-device programs, composed, against the reference's unsharded scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("variant,n,layout", [
    ("baseline2d", 64, "2d"), ("baseline2d", 63, "replicated"), ("rowpar", 64, "row"),
    ("rowpar_bitpack", 64, "row"), ("rowpar_bp_int4", 64, "row"),
])
def test_composed_programs_equal_reference_scan(mesh_name, variant, n, layout):
    """Every position's program on the CPU in lock step, the collectives
    simulated, equals the reference's unsharded sweep on the same numpy
    inputs, every position its lanes (4-bit weights for the int4
    variant)."""
    sizes = MESHES[mesh_name]
    w, sigma = seeded(len(sizes) * 100 + n, n, 8, int4=variant.endswith("int4"))
    want = reference_scan(w, sigma)
    prog = dryrun.onn_program(variant, n, 8, 32, sizes)
    assert prog.layout == layout
    grid = np.empty(tuple(sizes.values()), dtype=object)
    grid.fill(torch.device("cpu"))
    outs = dryrun.run_onn_composed(prog, Mesh(grid, tuple(sizes)), torch.as_tensor(w),
                                   torch.as_tensor(sigma))
    assert len(outs) == grid.size
    for pos, got in outs.items():
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want[prog.lanes(pos)], err_msg=str(pos))
    moved = int(np.sum(want != sigma))
    assert moved > 0  # the sweep changes spins: the check is not of a fixed point


def test_one_device_share_computes_its_own_block():
    """``run_onn_share``: with no peers the all-reduce adds nothing and the
    gather writes σ' into the device's own slot, so after one cycle the
    device's block is sign(its partial field) and every other column is
    σ's; the counted arguments are the live tensors' bytes."""
    prog = dryrun.onn_program("baseline2d", 64, 8, 32, {"data": 2, "model": 2})
    pos = (1, 0)  # data block 1, model block 0
    (wshape, _), (sshape, _) = prog.argument_shapes()
    w, sigma = seeded(7, 64, 8)
    w_blk, s = prog.arguments(pos, torch.as_tensor(w), torch.as_tensor(sigma))
    assert tuple(w_blk.shape) == wshape == (32, 32) and tuple(s.shape) == sshape
    got = dryrun.run_onn_share(dataclasses.replace(prog, cycles=1), pos, w_blk, s)
    field = plain.coupling_sum_ref(w_blk, s[:, 32:])
    np.testing.assert_array_equal(got[:, :32].numpy(),
                                  dyn.sign_update(field, s[:, :32]).numpy())
    np.testing.assert_array_equal(got[:, 32:].numpy(), sigma[:, 32:])
    assert torch.equal(s, torch.as_tensor(sigma))  # the argument is not written
    count = dryrun.count_onn_sweep(prog)
    assert count["argument_bytes"] == w_blk.nbytes + s.nbytes
    assert count["output_bytes"] == dryrun.run_onn_share(prog, pos, w_blk, s).nbytes


@pytest.mark.parametrize("variant", ["rowpar", "rowpar_bitpack", "rowpar_bp_int4"])
def test_row_layouts_refuse_onn_506(variant):
    for multi_pod, devices in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"N = 506 .* S = {devices} devices"):
            dryrun.run_onn_cell("onn_506", multi_pod, variant=variant, verbose=False)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown ONN variant 'diagonal'"):
        dryrun.onn_cell_program("onn_131072", False, "diagonal")


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", list(CLOSED_FORMS), ids=CELL_IDS)
def test_meta_count_equals_closed_form(key, tmp_path):
    cell, multi_pod, variant = key
    args, flops, colls, ratio = CLOSED_FORMS[key]
    res = dryrun.run_onn_cell(cell, multi_pod, variant=variant, outdir=str(tmp_path),
                              verbose=False)
    spec = ONN_CELLS[cell]
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] == args
    assert mem["output_size_in_bytes"] == spec["n"] * spec["batch"] // (
        1 if cell == "onn_131072" else 16 * (2 if multi_pod else 1))
    assert res["cost_analysis"]["flops"] == flops
    assert res["collectives"] == {"counts": {k: c for k, (c, _) in colls.items()},
                                  "bytes": {k: b for k, (_, b) in colls.items()}}
    assert res["useful_flops_ratio"] == ratio
    assert res["model_flops_global"] == 2 * spec["n"] ** 2 * spec["batch"] * spec["cycles"]
    assert res["n_devices"] == (512 if multi_pod else 256) and "n_params" not in res
    assert (res["n_oscillators"], res["batch"], res["cycles"], res["variant"]) == (
        spec["n"], spec["batch"], spec["cycles"], variant)
    assert res["roofline_peaks"]["flops_per_s"] == hlo.H100_INT8_OPS_PER_S
    assert res["roofline"]["compute_s"] == flops / hlo.H100_INT8_OPS_PER_S
    assert mem["temp_size_in_bytes"] > 0 and res["fits"] is True
    mesh = "multi" if multi_pod else "single"
    name = f"onn__{cell}__{mesh}" + ("" if variant == "baseline2d" else f"__{variant}")
    with open(tmp_path / f"{name}.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))


@pytest.mark.parametrize("key", list(CLOSED_FORMS), ids=CELL_IDS)
def test_no_float_tensor_in_any_onn_count(key, monkeypatch):
    """The count never takes a kernel's plain route (a float64 product past
    K = 1024) and sees no float tensor at all."""

    def refuse(*args, **kwargs):
        raise AssertionError("the count reached a kernel's wrapper or plain version")

    for name in ("coupling_sum", "onn_step"):
        monkeypatch.setattr(dryrun.ops, name, refuse)
    monkeypatch.setattr(plain, "coupling_sum_ref", refuse)
    cell, multi_pod, variant = key
    got = dryrun.count_onn_sweep(dryrun.onn_cell_program(cell, multi_pod, variant))
    assert got["dtypes"] and not [d for d in got["dtypes"] if "float" in d], got["dtypes"]
    assert set(got["dtypes"]) <= {"int8", "uint8", "int32", "bool"}


_REFERENCE_SCRIPT = r"""
import json, os, sys, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch import dryrun
out, d = {}, tempfile.mkdtemp()
for mp in (False, True):
    r = dryrun.run_onn_cell("onn_131072", mp, outdir=d, verbose=False)
    out["multi" if mp else "single"] = {k: r[k] for k in (
        "memory_analysis", "cost_analysis", "collectives", "n_devices")}
print(json.dumps(out))
"""


def test_onn_131072_baseline2d_against_reference_dryrun(tmp_path):
    """The one reference cell that lowers, both meshes in one process."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for mp in (False, True):
        want = ref["multi" if mp else "single"]
        got = dryrun.run_onn_cell("onn_131072", mp, outdir=str(tmp_path), verbose=False)
        assert got["n_devices"] == want["n_devices"]
        for k in ("argument_size_in_bytes", "output_size_in_bytes"):
            assert got["memory_analysis"][k] == want["memory_analysis"][k], k
        gc, wc = got["collectives"], want["collectives"]
        assert gc["counts"]["all-reduce"] == wc["counts"]["all-reduce"] == 32
        assert gc["bytes"]["all-reduce"] == wc["bytes"]["all-reduce"]
        assert 2 * gc["counts"]["all-gather"] == wc["counts"]["all-gather"]
        assert 2 * gc["bytes"]["all-gather"] == wc["bytes"]["all-gather"]
        ratio = got["cost_analysis"]["flops"] / want["cost_analysis"]["flops"]
        assert 0.997 <= ratio <= 1.0, ratio


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_main_onn_writes_both_meshes(tmp_path):
    dryrun.main(["--onn", "onn_506", "--mesh", "both", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["onn__onn_506__multi.json",
                                            "onn__onn_506__single.json"]
    with pytest.raises(SystemExit):
        dryrun.main(["--onn", "onn_1"])


def test_main_all_appends_the_onn_cells(monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: seen.append(("lm",) + a))
    monkeypatch.setattr(dryrun, "run_onn_cell", lambda *a, **k: seen.append(("onn",) + a))
    dryrun.main(["--all", "--mesh", "both"])
    assert len(seen) == 2 * (33 + 2)
    assert seen[-4:] == [("onn", "onn_506", False), ("onn", "onn_506", True),
                         ("onn", "onn_131072", False), ("onn", "onn_131072", True)]
    assert all(s[0] == "lm" for s in seen[:-4])
