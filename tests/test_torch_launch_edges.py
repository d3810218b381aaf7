"""Port fault 9: launches past CUDA's 65,535 grid tiles on y and z.

The planners (``autotune.coupling_plan``, ``autotune.qmv_plan``) cut a plan
whose lane tiles or instances pass the grid's y or z into several launches
(``launches``), and the wrappers issue them in order with the operands'
pointers offset to each launch's first lane and instance.  Here, on the CPU:

* every plan at and past each edge has every launch within 65,535 tiles on
  y and z, and its launches cover every lane of every instance once;
* ``vmem.check_all`` meets the edge buckets with nothing over a limit;
* the wrappers' pointer arithmetic, with the grid limit lowered so that
  small shapes split: each C entry point is replaced by a stand-in that
  reads and writes the memory at the pointers it is given (these are CPU
  tensors, so the addresses are real) and computes its launch's lanes by
  the plain version; every output equals the plain version of the whole
  batch, and the reference's (``repro.kernels.ref``) on the same inputs.

The kernels themselves at the edge run on the card (``test_torch_cuda.py``,
``chip_smoke.py``'s ``launch_edges``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.analysis import vmem
from repro_torch.core.quantization import unpack_phases
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import ref as plain

EDGE = autotune.MAX_GRID_YZ
HALF = 8


def _covers_once(plan) -> None:
    """Every (instance, lane) pair of the plan in exactly one launch, each
    launch's grid within the limit, a lane run on one instance."""
    seen = np.zeros((plan.inst, plan.b), dtype=np.int64)
    for i0, ni, b0, nb in plan.launches:
        assert ni <= EDGE and -(-nb // plan.tile.bm) <= EDGE
        assert ni == 1 or nb == plan.b
        seen[i0:i0 + ni, b0:b0 + nb] += 1
    assert (seen == 1).all()
    gx, gy, gz = plan.grid
    assert gy <= EDGE and gz <= EDGE


@pytest.mark.parametrize("b", [1, 4_194_240, 4_194_241, 4_194_341, 9_000_000])
@pytest.mark.parametrize("parallel", [None, 1, 32])
def test_coupling_plan_lane_split_within_the_grid(b, parallel):
    plan = autotune.coupling_plan.__wrapped__(1, b, 506, 506, parallel)
    tiles = -(-b // plan.tile.bm)
    assert len(plan.launches) == -(-tiles // EDGE)
    # below the edge, one launch: today's grid exactly
    if tiles <= EDGE:
        assert plan.launches == ((0, 1, 0, b),)
        assert plan.grid == (-(-506 // plan.tile.bn), tiles, 1)
    else:
        assert all(nb % plan.tile.bm == 0 for *_, nb in plan.launches[:-1])
    _covers_once(plan)


@pytest.mark.parametrize("inst", [1, 16, 65_535, 65_536, 65_539, 140_000])
def test_coupling_plan_instance_split_within_the_grid(inst):
    plan = autotune.coupling_plan.__wrapped__(inst, 64, 32, 506)
    assert len(plan.launches) == -(-inst // EDGE)
    _covers_once(plan)


def test_coupling_plan_both_axes_past_the_edge():
    plan = autotune.coupling_plan.__wrapped__(3, 4_194_341, 8, 8)
    assert len(plan.launches) == 6 and {ni for _, ni, _, _ in plan.launches} == {1}
    _covers_once(plan)


@pytest.mark.parametrize("b", [17, 1024, 8_388_480, 8_388_481, 8_388_557, 20_000_000])
def test_qmv_plan_lane_split_within_the_grid(b):
    plan = autotune.qmv_plan(b, 506, 506)
    runs = plan.launches
    assert runs[0][0] == 0 and sum(nb for _, nb in runs) == b
    assert all(lo + nb == nxt for (lo, nb), (nxt, _) in zip(runs, runs[1:]))
    assert all(-(-nb // autotune.QMV_GEMM_TILE) <= EDGE for _, nb in runs)
    assert all(lo % (EDGE * autotune.QMV_GEMM_TILE) == 0 for lo, _ in runs)
    gx, gy, gz = plan.grid
    assert gy <= EDGE and gz <= EDGE
    assert len(runs) == -(-(-(-b // autotune.QMV_GEMM_TILE)) // EDGE)
    if plan.splits > 1:
        assert plan.workspace == plan.splits * runs[0][1] * 506


def test_vmem_edge_buckets_within_budget():
    reports = vmem.check_all()
    edges = [r for r in reports if (r.kind, r.n, r.batch) in set(autotune.EDGE_BUCKETS)]
    assert len(edges) == len(autotune.EDGE_BUCKETS) == 9
    assert all(r.ok for r in reports), [r.render() for r in reports if not r.ok]
    past = [p for r in edges for p in r.plans if not p.plan.endswith(" launches=1")]
    # one lane past the edge: each of the 4 hybrid plans and kernel 8's in two
    # launches, and each of the 4 step plans (1, 16, 32 and 65,539 instances)
    # in two a lane run per instance; at the edge only the 65,539 instances
    assert len(past) == 2 * 4 + 2 + 2 * 4 + 1
    # the instance axis past its edge in every step bucket
    inst = [p for r in reports if r.kind == "step" and r.batch in autotune.BATCH_BUCKETS
            for p in r.plans if p.plan.startswith(f"inst={vmem.STEP_INSTANCES[-1]} ")]
    assert inst and all(p.ok and "launches=2" in p.plan and p.grid[2] == EDGE for p in inst)


# ---------------------------------------------------------------------------
# The wrappers' launches, on a lowered grid limit
# ---------------------------------------------------------------------------


def _view(ptr: int, dtype: torch.dtype, shape) -> torch.Tensor:
    """The memory at ``ptr`` as a tensor of ``shape`` (no copy)."""
    count = int(np.prod(shape)) if len(shape) else 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    raw = (ctypes.c_uint8 * (count * itemsize)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


class FakeCard:
    """Stands in for the C entry points: checks each launch's grid against
    the lowered limit and computes its lanes by the plain version, reading
    and writing the memory at its pointers."""

    def __init__(self, limit: int) -> None:
        self.limit = limit
        self.calls = []

    def __call__(self, stem, name, device, *args):
        self.calls.append(name)
        if stem == "coupling_gemm":
            tile, bm, bn, span = args[-4:]
            args = args[:-4]
        if name == "onn_coupling_sum":
            sig, w, out, i, b, m, n = args
            assert i <= self.limit and -(-b // bm) <= self.limit
            s = _view(sig, torch.int8, (i, b, n))
            _view(out, torch.int32, (i, b, m)).copy_(
                plain.coupling_sum_ref(_view(w, torch.int8, (i, m, n)), s))
        elif name == "onn_step":
            sig, w, h, out, b, n = args
            assert -(-b // bm) <= self.limit
            _view(out, torch.int8, (b, n)).copy_(plain.onn_step_ref(
                _view(w, torch.int8, (n, n)), _view(sig, torch.int8, (b, n)),
                _view(h, torch.int32, (n,))))
        elif name == "onn_phase_step":
            sig, w, h, ph, out, b, n, half = args
            assert -(-b // bm) <= self.limit
            _view(out, torch.int32, (b, n)).copy_(plain.phase_step_ref(
                _view(w, torch.int8, (n, n)), _view(sig, torch.int8, (b, n)),
                _view(h, torch.int32, (n,)), _view(ph, torch.int32, (b, n)), half))
        elif name == "onn_phase_step_packed":
            packed, w, h, out, b, n, half = args
            assert -(-b // bm) <= self.limit
            theta = unpack_phases(_view(packed, torch.uint8, (b, (n + 1) // 2)), n)
            _view(out, torch.int32, (b, n)).copy_(plain.phase_step_packed_ref(
                _view(w, torch.int8, (n, n)), _view(h, torch.int32, (n,)), theta, half))
        elif name == "onn_quantized_matvec":
            x, w, s, out, _partial, _counters, b, m, k, lanes, _kc, _splits, _vec = args
            assert lanes == 0 and -(-b // autotune.QMV_GEMM_TILE) <= self.limit
            _view(out, torch.float32, (b, m)).copy_(plain.quantized_matvec_ref(
                _view(w, torch.int8, (m, k)), _view(s, torch.float32, (m,)),
                _view(x, torch.float32, (b, k))))
        else:
            raise AssertionError(name)


@pytest.fixture
def card(monkeypatch):
    limit = 3
    fake = FakeCard(limit)
    monkeypatch.setattr(autotune, "MAX_GRID_YZ", limit)
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ops, "_launch", fake)
    autotune.coupling_plan.cache_clear()
    ops.reset_launches()
    yield fake
    autotune.coupling_plan.cache_clear()
    ops.reset_launches()


def _spins(rng, shape):
    return torch.from_numpy(np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8))


def test_wrappers_issue_every_launch_at_its_offsets(card):
    rng = np.random.default_rng(9)
    n, m = 37, 21
    # The split tile (16 lanes) below 132 blocks, the wide one (64) above.
    for b in (16 * 3 + 5, 64 * 3 * 2 + 7):
        w = torch.from_numpy(rng.integers(-15, 16, (n, n), dtype=np.int8))
        slab = torch.from_numpy(rng.integers(-15, 16, (m, n), dtype=np.int8))
        sigma = _spins(rng, (b, n))
        h = torch.from_numpy(rng.integers(-40, 41, n).astype(np.int32))
        theta = torch.from_numpy(rng.integers(0, 2 * HALF, (b, n)).astype(np.int32))
        plans = {autotune.coupling_plan(1, b, n, n), autotune.coupling_plan(1, b, m, n)}
        assert all(len(p.launches) > 1 for p in plans)
        before = len(card.calls)
        got = ops.coupling_sum(slab, sigma)
        assert torch.equal(got, plain.coupling_sum_ref(slab, sigma))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_ref.coupling_sum_ref(slab.numpy(), sigma.numpy())))
        assert torch.equal(ops.hybrid_coupling_sum(slab, sigma, parallel=5),
                           plain.coupling_sum_ref(slab, sigma))
        assert torch.equal(ops.onn_step(w, sigma, h), plain.onn_step_ref(w, sigma, h))
        want = plain.phase_step_ref(w, sigma, h, theta, HALF)
        assert torch.equal(ops.phase_step(w, sigma, h, theta, half=HALF), want)
        assert torch.equal(ops.hybrid_phase_step(w, sigma, h, theta, half=HALF, parallel=7),
                           plain.hybrid_phase_step_ref(w, sigma, h, theta, HALF, 7))
        spins = torch.where(theta < HALF, 1, -1).to(torch.int8)
        assert torch.equal(ops.phase_step_packed(w, h, theta, half=HALF),
                           plain.phase_step_ref(w, spins, h, theta, HALF))
        per_call = len(autotune.coupling_plan(1, b, n, n).launches)
        assert len(card.calls) - before == 6 * per_call
    assert ops.LAUNCHES["coupling_sum"] == sum(
        len(autotune.coupling_plan(1, b, m, n).launches) for b in (53, 391))


def test_instance_axis_issues_every_launch_at_its_offsets(card):
    rng = np.random.default_rng(10)
    launches = 0
    for inst, b in ((7, 5), (2, 64 * 3 * 3 + 1)):
        w = torch.from_numpy(rng.integers(-15, 16, (inst, 9, 33), dtype=np.int8))
        sigma = _spins(rng, (inst, b, 33))
        plan = autotune.coupling_plan(inst, b, 9, 33)
        assert len(plan.launches) > 1
        launches += len(plan.launches)
        got = ops.coupling_sum(w, sigma)
        assert torch.equal(got, plain.coupling_sum_ref(w, sigma))
        assert torch.equal(ops.hybrid_coupling_sum(w, sigma, parallel=3), got)
    assert ops.LAUNCHES["coupling_sum_batched"] == launches == 3 + 2 * 13


def test_quantized_matvec_issues_every_launch_at_its_offsets(card):
    rng = np.random.default_rng(11)
    b, m, k = 128 * 3 * 2 + 9, 19, 48
    w_q = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    scale = torch.from_numpy(rng.random(m).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    plan = autotune.qmv_plan(b, m, k)
    assert len(plan.launches) == 3
    got = ops.quantized_matvec(w_q, scale, x)
    assert torch.equal(got, plain.quantized_matvec_ref(w_q, scale, x))
    assert ops.LAUNCHES["quantized_matvec"] == 3
