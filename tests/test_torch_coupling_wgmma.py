"""Kernels 1 and 2's wgmma regime (``csrc/coupling_wgmma.cu``) on the CPU.

The regime runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  What surrounds it is Python and is held here:

* ``autotune.coupling_route``: the wgmma regime at the large shapes (the ONN
  dry run's ``onn_131072`` shares, kernels 1 and 2 past the grid's edge)
  and the plans of every other shape unchanged: the main path's, Max-Cut's
  instance axis, rtl's, the hybrid kernels' and the phase modes';
* ``autotune.wgmma_plan``: its units cover every output element and every
  K-step once, its K slices partition K;
* an emulation of the kernel's walk in plain torch (persistent blocks, the
  units' tiles and K slices, TMA's zero fill past the operands, the split
  sums added, STEP's tie rule), equal to the plain versions and to the JAX
  package's Pallas kernels in interpret mode on the same numpy inputs;
* the wrapper's copy of operands TMA cannot read;
* ``analysis/vmem.py``'s static budget over the regime's plans.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.analysis import vmem
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import ref as plain

BM, BN, BK = autotune.WGMMA_BM, autotune.WGMMA_BN, autotune.WGMMA_BK
MODES = ("coupling_sum", "onn_step", "phase_step", "phase_step_packed")

#: (mode, B, M, N) of the shapes the regime was built for (PERF.md's rows):
#: the ``baseline2d`` and ``rowpar`` shares, 1e at N = 506 and 640, 2e.
LARGE = [("coupling_sum", 1024, 8192, 8192), ("coupling_sum", 1024, 512, 131072),
         ("coupling_sum", 4_194_341, 506, 506), ("coupling_sum", 4_194_341, 640, 640),
         ("onn_step", 4_194_341, 506, 506)]


@pytest.mark.parametrize("mode,b,m,n", LARGE)
def test_route_takes_the_wgmma_regime_at_the_large_shapes(mode, b, m, n):
    plan = autotune.coupling_route(mode, 1, b, m, n)
    assert isinstance(plan, autotune.WgmmaPlan) and plan.regime == "wgmma"
    assert (plan.mode, plan.b, plan.m, plan.n) == (mode, b, m, n)
    assert len(plan.launches) == 1 and plan.grid[0] <= autotune.NUM_SMS
    assert plan.smem_bytes == autotune.WGMMA_SMEM <= autotune.SMEM_PER_BLOCK


def test_wgmma_plans_at_the_large_shapes():
    base = autotune.coupling_route("coupling_sum", 1, 1024, 8192, 8192)
    # 256 tiles: no split, one W panel's 8 lane tiles at a time, 132 blocks
    assert (base.tiles, base.splits, base.k_chunk, base.grid_blocks, base.lanes_fastest) == (
        256, 1, 64, 132, True)
    row = autotune.coupling_route("coupling_sum", 1, 1024, 512, 131072)
    # 16 tiles: 8 slices of 128 K-steps (16,384 columns), one unit a block
    assert (row.tiles, row.splits, row.k_chunk, row.units, row.grid_blocks) == (
        16, 8, 128, 128, 128)
    edge = autotune.coupling_route("onn_step", 1, 4_194_341, 506, 506)
    # rows copied to 512 bytes, 2 row tiles of one σ panel at a time
    assert (edge.padded, edge.k_pitch, edge.k_steps, edge.splits, edge.lanes_fastest) == (
        True, 512, 4, 1, False)
    assert edge.units == 32_769 * 2
    assert not autotune.coupling_route("coupling_sum", 1, 4_194_341, 640, 640).padded


#: Shapes whose plans must not change: the main path (B = 1024, N = 506),
#: the serving slab, the rtl edge loop's, the sharded row blocks of
#: N = 4096 under 1x8, the ONN dry run's composed sweeps and ``onn_506``
#: share, and the grid-edge stand-ins of ``test_torch_launch_edges.py``:
#: (inst, b, m, n).
KEPT = [(1, 1024, 506, 506), (1, 64, 506, 506), (1, 1024, 484, 484), (1, 1024, 512, 4096),
        (1, 256, 4096, 4096), (1, 4_194_341, 48, 48), (1, 391, 37, 37),
        (1, 391, 21, 37), (16, 64, 32, 506), (32, 64, 32, 512), (65_539, 64, 32, 64)]


@pytest.mark.parametrize("inst,b,m,n", KEPT)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parallel", [None, 1, 32])
def test_route_keeps_every_other_plan(mode, inst, b, m, n, parallel):
    plan = autotune.coupling_route(mode, inst, b, m, n, parallel)
    assert plan == autotune.coupling_plan(inst, b, m, n, parallel)


def test_main_path_plans_unchanged():
    for mode in MODES:
        plan = autotune.coupling_route(mode, 1, 1024, 506, 506)
        assert (plan.tile.name, plan.grid, plan.args) == ("wide", (16, 16, 1), (0, 64, 32, 128))
    mc = autotune.coupling_route("coupling_sum", 16, 64, 32, 506)
    assert (mc.tile.name, mc.grid, mc.args) == ("split", (2, 4, 16), (1, 16, 16, 128))
    for mode in ("coupling_sum", "phase_step"):  # kernels 6 and 7 at the auto width
        hyb = autotune.coupling_route(mode, 1, 1024, 506, 506, 32)
        assert (hyb.tile.name, hyb.span) == ("wide", 128)


def test_route_never_takes_the_phase_modes_or_a_mac_width():
    for mode in ("phase_step", "phase_step_packed", "hybrid_coupling_sum"):
        assert isinstance(autotune.coupling_route(mode, 1, 4_194_341, 506, 506),
                          autotune.CouplingPlan)
    for p in (1, 32, 506):
        assert isinstance(autotune.coupling_route("coupling_sum", 1, 4_194_341, 506, 506, p),
                          autotune.CouplingPlan)
    # the instance axis keeps the grid's z, whatever the work
    assert isinstance(autotune.coupling_route("coupling_sum", 2, 1024, 8192, 8192),
                      autotune.CouplingPlan)


def test_route_thresholds():
    # the work threshold: 2^34 at B = 1024, N = 4096 exactly; one less lane stays
    assert isinstance(autotune.coupling_route("onn_step", 1, 1024, 4096, 4096),
                      autotune.WgmmaPlan)
    assert isinstance(autotune.coupling_route("onn_step", 1, 1023, 4096, 4096),
                      autotune.CouplingPlan)
    # the wide grid's blocks: 131 row tiles of one lane tile is too few
    assert isinstance(autotune.coupling_route("coupling_sum", 1, 64, 131 * 32, 2**24),
                      autotune.CouplingPlan)
    assert isinstance(autotune.coupling_route("coupling_sum", 1, 64, 132 * 32, 2**24),
                      autotune.WgmmaPlan)


def test_wgmma_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="mode"):
        autotune.wgmma_plan("phase_step", 1024, 506, 506)
    with pytest.raises(ValueError, match="bad shape"):
        autotune.wgmma_plan("onn_step", 1024, 512, 506)
    with pytest.raises(ValueError, match="bad shape"):
        autotune.wgmma_plan("coupling_sum", 0, 512, 506)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

#: (mode, B, M, N): ragged against the 128 x 256 tile and the 128-byte
#: K-step, N off 16 bytes (506, 1000: rows copied), one K-step, and the
#: split-K rule's cases (few tiles: several slices).
WALKS = [("coupling_sum", 300, 200, 1000), ("coupling_sum", 130, 506, 506),
         ("coupling_sum", 1, 1, 1), ("coupling_sum", 129, 257, 8208),
         ("coupling_sum", 1024, 512, 131072), ("coupling_sum", 4096, 8192, 8192),
         ("onn_step", 300, 640, 640), ("onn_step", 130, 506, 506), ("onn_step", 77, 33, 33)]


def _split(plan, splits):
    """``plan`` with K cut into ``splits`` slices (as near as whole K-steps allow)."""
    k_chunk = -(-plan.k_steps // splits)
    splits = -(-plan.k_steps // k_chunk)
    return dataclasses.replace(plan, k_chunk=k_chunk, splits=splits,
                               grid_blocks=min(plan.tiles * splits, autotune.NUM_SMS))


def _coverage(plan) -> np.ndarray:
    """How often each (lane tile, row tile, K-step) is reached by the
    persistent blocks' units."""
    seen = np.zeros((plan.lane_tiles, plan.row_tiles, plan.k_steps), dtype=np.int64)
    for x in range(plan.grid_blocks):
        for u in range(x, plan.units, plan.grid_blocks):
            lt, rt, k0, nk = plan.unit(u)
            assert nk >= 1
            seen[lt, rt, k0:k0 + nk] += 1
    return seen


@pytest.mark.parametrize("mode,b,m,n", WALKS)
@pytest.mark.parametrize("splits", [None, 2, 5])
def test_units_cover_every_output_and_k_step_once(mode, b, m, n, splits):
    plan = autotune.wgmma_plan(mode, b, m, n)
    if splits is not None and mode == "coupling_sum":
        plan = _split(plan, splits)
    assert (_coverage(plan) == 1).all()
    # the tiles cover every output element once
    lanes = np.zeros(plan.lane_tiles * BM, dtype=np.int64)
    rows = np.zeros(plan.row_tiles * BN, dtype=np.int64)
    for lt in range(plan.lane_tiles):
        lanes[lt * BM:(lt + 1) * BM] += 1
    for rt in range(plan.row_tiles):
        rows[rt * BN:(rt + 1) * BN] += 1
    assert (lanes[:b] == 1).all() and (rows[:m] == 1).all()
    assert plan.lane_tiles * BM - b < BM and plan.row_tiles * BN - m < BN


@pytest.mark.parametrize("mode,b,m,n", WALKS)
def test_k_slices_partition_k(mode, b, m, n):
    plan = autotune.wgmma_plan(mode, b, m, n)
    if mode == "onn_step":
        assert plan.splits == 1
    slices = sorted({plan.unit(u)[2:] for u in range(plan.units)})
    assert len(slices) == plan.splits
    assert slices[0][0] == 0
    for (k0, nk), (k1, _) in zip(slices, slices[1:]):
        assert k0 + nk == k1  # no gap, no overlap
    assert sum(nk for _, nk in slices) == plan.k_steps == -(-n // BK)
    # the kernel's own refusal: slices that leave K-steps out or run empty
    assert (plan.splits - 1) * plan.k_chunk < plan.k_steps <= plan.splits * plan.k_chunk


def test_split_k_only_where_the_tiles_are_few():
    for b, m, splits in ((1024, 512, 8), (128, 256, 128), (640, 4096, 1), (1024, 1024, 4)):
        plan = autotune.wgmma_plan("coupling_sum", b, m, 65536)
        # NUM_SMS // tiles slices where the tiles are at most half the SMs
        # (132 slices of 512 K-steps round to 128 of 4)
        assert plan.splits == splits and plan.units <= autotune.NUM_SMS or splits == 1
        assert autotune.wgmma_plan("onn_step", b, b, b).splits == 1


def emulate(plan, w: torch.Tensor, sigma: torch.Tensor, bias=None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, unit by unit as the blocks
    of ``plan`` walk them: operands as TMA reads them (the wrapper's rows of
    ``k_pitch`` bytes, whose columns past N are never read; boxes past the
    operand zero), each unit's 128 x 256 tile over its K slice added into a
    zeroed int64 output; then SUM's int32 or STEP's sign, ties keeping σ
    read from the copied rows."""
    b, m, n = plan.b, plan.m, plan.n
    s_rows = ops._tma_rows(sigma.contiguous(), n)
    w_rows = ops._tma_rows(w.contiguous(), n)
    assert s_rows.stride(0) % autotune.TMA_ALIGN == 0 and s_rows.stride(0) >= n
    kk = plan.k_steps * BK
    a_all = torch.zeros((plan.lane_tiles * BM, kk), dtype=torch.float64)
    b_all = torch.zeros((plan.row_tiles * BN, kk), dtype=torch.float64)
    a_all[:b, :n] = s_rows[:, :n].double()  # the tensor map ends at column N
    b_all[:m, :n] = w_rows[:, :n].double()
    acc = torch.zeros((plan.lane_tiles * BM, plan.row_tiles * BN), dtype=torch.int64)
    for x in range(plan.grid_blocks):
        for u in range(x, plan.units, plan.grid_blocks):
            lt, rt, k0, nk = plan.unit(u)
            ks = slice(k0 * BK, (k0 + nk) * BK)
            part = a_all[lt * BM:(lt + 1) * BM, ks] @ b_all[rt * BN:(rt + 1) * BN, ks].T
            acc[lt * BM:(lt + 1) * BM, rt * BN:(rt + 1) * BN] += part.to(torch.int64)
    s = acc[:b, :m]
    if plan.mode == "coupling_sum":
        return s.to(torch.int32)
    s = s + bias.to(torch.int64)[None, :]
    keep = s_rows[:, :m].to(torch.int64)
    return torch.where(s > 0, 1, torch.where(s < 0, -1, keep)).to(torch.int8)


def _numpy_inputs(b, m, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-15, 16, size=(m, n)).astype(np.int8)
    w[:, : n // 3] = 0  # many exact ties
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    bias = rng.integers(-2, 3, size=m).astype(np.int32)
    return w, sigma, bias


#: Small ragged shapes held to the JAX package too (its Pallas kernels in
#: interpret mode): B 300, M 200, N 1000 (rows copied to 1008), N 506
#: (copied to 512), with split-K on and off.
EMULATED = [("coupling_sum", 300, 200, 1000, None), ("coupling_sum", 300, 200, 1000, 3),
            ("coupling_sum", 130, 506, 506, None), ("coupling_sum", 130, 506, 506, 4),
            ("onn_step", 130, 506, 506, None), ("onn_step", 70, 300, 300, None)]


@pytest.mark.parametrize("mode,b,m,n,splits", EMULATED)
def test_emulated_walk_equals_plain_and_pallas(mode, b, m, n, splits):
    w, sigma, bias = _numpy_inputs(b, m, n, seed=b + m + n)
    plan = autotune.wgmma_plan(mode, b, m, n)
    if splits is not None:
        plan = _split(plan, splits)
        assert plan.splits == splits
    wt, st, ht = torch.as_tensor(w), torch.as_tensor(sigma), torch.as_tensor(bias)
    got = emulate(plan, wt, st, ht)
    if mode == "coupling_sum":
        want = plain.coupling_sum_ref(wt, st)
        jax_out = ref_ops.coupling_sum(jnp.asarray(w), jnp.asarray(sigma), use_pallas=True)
    else:
        want = plain.onn_step_ref(wt, st, ht)
        jax_out = ref_ops.onn_step(jnp.asarray(w), jnp.asarray(sigma), jnp.asarray(bias),
                                   use_pallas=True)
        assert bool((want == st).any())  # ties occurred and kept σ
    assert got.dtype == want.dtype and torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(jax_out).astype(np.int64))


def test_tma_rows_copies_only_what_tma_cannot_read():
    x = torch.randint(-15, 16, (7, 512), dtype=torch.int8)
    assert x.data_ptr() % 16 == 0 and ops._tma_rows(x, 512) is x
    odd = torch.randint(-15, 16, (7, 506), dtype=torch.int8)
    copy = ops._tma_rows(odd, 506)
    assert copy.shape == (7, 512) and torch.equal(copy[:, :506], odd)
    buf = torch.empty(7 * 512 + 1, dtype=torch.int8)
    off = buf[1:].view(7, 512)
    off.copy_(x)
    moved = ops._tma_rows(off, 512)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x)


# ---------------------------------------------------------------------------
# The budget
# ---------------------------------------------------------------------------


def test_vmem_static_check_covers_the_wgmma_plans():
    reports = vmem.check_all()
    assert all(r.ok for r in reports), [r.render() for r in reports if not r.ok]
    plans = [(r, p) for r in reports for p in r.plans if p.kernel.startswith("coupling_wgmma/")]
    assert {p.kernel for _, p in plans} == {"coupling_wgmma/coupling_sum",
                                            "coupling_wgmma/onn_step"}
    for r, p in plans:
        assert r.kind == "step"
        assert (p.smem, p.static, p.threads, p.blocks_per_sm) == (
            autotune.WGMMA_SMEM, 0, autotune.WGMMA_THREADS, 1)
        assert p.sm_bytes <= vmem.SMEM_PER_SM and p.grid[0] <= autotune.NUM_SMS
        assert p.plan.endswith(" launches=1")
    # the edge buckets: kernels 1 and 2 in one launch, kernels 3 and 4 keep
    # the wide tile's two
    edge = [r for r in reports if (r.kind, r.n, r.batch) == ("step", 506, 4_194_341)][0]
    kernels = [p.kernel for p in edge.plans]
    assert kernels[:3] == ["coupling_wgmma/coupling_sum", "coupling_wgmma/onn_step",
                           "coupling_gemm/wide"]
    assert "launches=2" in edge.plans[2].plan


def test_vmem_groups_the_entries_that_share_a_plan():
    plans = list(vmem.bucket_plans("step", 506, 1024))
    assert [modes for _, modes in plans][0] == vmem.STEP_MODES  # one plan, as before
    routed = list(vmem.bucket_plans("step", 8192, 1024))
    assert [modes for _, modes in routed][:3] == [
        ("coupling_sum",), ("onn_step",), ("phase_step", "phase_step_packed")]
    names = {name for plan, modes in routed for name, _ in vmem._instantiations(plan, modes)}
    assert {"coupling_wgmma<coupling_sum>", "coupling_wgmma<onn_step>"} <= names
