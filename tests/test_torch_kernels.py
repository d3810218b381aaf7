"""The port's kernel wrappers against ``repro.kernels.ops`` (Pallas in
interpret mode on the CPU) and ``repro.kernels.ref``, on the same numpy
inputs.  Every integer output must be exactly equal; kernel 8's float32
output must lie within the bound of float32 summation of the exact value.

On the CPU the wrappers run the plain versions (``repro_torch.kernels.ref``).
The hand-written CUDA kernels are held against those plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as port_kernels
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import autotune
from repro_torch.kernels import ops

HALF = 8
SIZES = [(n, b) for n in (47, 48, 129) for b in (1, 3, 8)]


def same(port, ref) -> None:
    p = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


def _spins(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)


def _inputs(n, b, seed, m=None):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    w = rng.integers(-15, 16, size=(m, n)).astype(np.int8)
    bias = rng.integers(-2, 3, size=m).astype(np.int32)
    # Non-canonical phases in [0, 16): ties (S + h == 0) must keep them.
    phase = rng.integers(0, 16, size=(b, n)).astype(np.int32)
    w[:, : n // 3] = 0  # many exact ties
    return w, bias, phase, _spins(rng, (b, n))


@pytest.mark.parametrize("n,b", SIZES)
def test_coupling_sum_matches_pallas(n, b):
    w, _, _, sigma = _inputs(n, b, seed=n * 7 + b)
    got = ops.coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma))
    same(got, ref_ops.coupling_sum(jnp.asarray(w), jnp.asarray(sigma), use_pallas=True))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n,m", [(47, 13), (129, 64)])
def test_coupling_sum_row_slab_and_vector(n, m):
    w, _, _, sigma = _inputs(n, 3, seed=m, m=m)
    same(
        ops.coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma)),
        ref_ops.coupling_sum(jnp.asarray(w), jnp.asarray(sigma), use_pallas=True),
    )
    same(
        ops.coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma[0])),
        ref_ops.coupling_sum(jnp.asarray(w), jnp.asarray(sigma[0]), use_pallas=True),
    )


@pytest.mark.parametrize("n,b", SIZES)
def test_phase_step_matches_pallas(n, b):
    w, bias, phase, sigma = _inputs(n, b, seed=n * 11 + b)
    got = ops.phase_step(
        torch.as_tensor(w), torch.as_tensor(sigma), torch.as_tensor(bias),
        torch.as_tensor(phase.astype(np.uint8)), half=HALF,
    )
    want = ref_ops.phase_step(
        jnp.asarray(w), jnp.asarray(sigma), jnp.asarray(bias),
        jnp.asarray(phase.astype(np.uint8)), half=HALF, use_pallas=True,
    )
    same(got, want)
    assert got.dtype == torch.uint8  # returned in the phase's dtype


@pytest.mark.parametrize("n,b", SIZES)
def test_phase_step_packed_matches_pallas(n, b):
    w, bias, phase, _ = _inputs(n, b, seed=n * 13 + b)
    got = ops.phase_step_packed(
        torch.as_tensor(w), torch.as_tensor(bias), torch.as_tensor(phase), half=HALF
    )
    want = ref_ops.phase_step_packed(
        jnp.asarray(w), jnp.asarray(bias), jnp.asarray(phase), half=HALF, use_pallas=True
    )
    same(got, want)
    # Bit-exact with phase_step fed spin(phase).
    sigma = np.where(phase < HALF, 1, -1).astype(np.int8)
    same(got, ops.phase_step(torch.as_tensor(w), torch.as_tensor(sigma), torch.as_tensor(bias), torch.as_tensor(phase), half=HALF))


def test_phase_step_packed_rejects_slab_and_mixed_devices():
    w, bias, phase, _ = _inputs(12, 2, seed=1, m=6)
    with pytest.raises(ValueError, match="square"):
        ops.phase_step_packed(torch.as_tensor(w), torch.as_tensor(bias), torch.as_tensor(phase), half=HALF)
    with pytest.raises(ValueError, match="chunk"):
        sq = torch.zeros((4, 4), dtype=torch.int8)
        col = torch.zeros(2, dtype=torch.int32)
        ops.phase_step_multi(sq, None, torch.zeros((2, 4)), torch.zeros((2, 4)), *[col] * 7,
                             half=HALF, chunk=0, max_cycles=5)


def _multi_state(n, b, seed, max_cycles, symmetric=False):
    """Mixed lanes: some already frozen, some near their budget, some fresh."""
    rng = np.random.default_rng(seed)
    if symmetric:
        a = rng.integers(-15, 16, size=(n, n))
        w = np.clip(np.tril(a) + np.tril(a, -1).T, -15, 15).astype(np.int8)
    else:
        w = rng.integers(-15, 16, size=(n, n)).astype(np.int8)
    bias = rng.integers(-1, 2, size=n).astype(np.int32)
    phase = np.where(rng.random((b, n)) < 0.5, 0, HALF).astype(np.int32)
    prev = np.where(rng.random((b, n)) < 0.5, 0, HALF).astype(np.int32)
    t = rng.integers(0, max_cycles + 1, size=b).astype(np.int32)
    t[: b // 2] = max_cycles - rng.integers(1, 4, size=b // 2)  # budget expiry mid-chunk
    t[-1] = 0
    prev[-1] = phase[-1]
    frozen = rng.random(b) < 0.25
    frozen[-1] = False
    full = np.full((b,), max_cycles, np.int32)
    cols = dict(
        t=t, settle_cycle=full, settled=np.zeros(b, bool), cycled=np.zeros(b, bool),
        frozen=frozen, frozen_p2=frozen & (rng.random(b) < 0.5),
        freeze_cycle=np.where(frozen, t, full).astype(np.int32),
    )
    return w, bias, phase, prev, cols


_COLS = ("t", "settle_cycle", "settled", "cycled", "frozen", "frozen_p2", "freeze_cycle")
_OUT = ("phase", "prev_phase", "settle_cycle", "settled", "cycled", "frozen",
        "frozen_p2", "freeze_cycle", "t")


#: The serving slab at the configured width (64 lanes, and a part-filled one).
SERVING_SIZES = [(506, 64), (506, 9)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,b", SIZES + SERVING_SIZES)
def test_phase_step_multi_matches_pallas(n, b, packed):
    max_cycles, chunk = 20, 6
    w, bias, phase, prev, cols = _multi_state(n, b, seed=n * 3 + b, max_cycles=max_cycles)
    got = ops.phase_step_multi(
        torch.as_tensor(w), torch.as_tensor(bias), torch.as_tensor(phase.astype(np.uint8)),
        torch.as_tensor(prev.astype(np.uint8)), *(torch.as_tensor(cols[c]) for c in _COLS),
        half=HALF, chunk=chunk, max_cycles=max_cycles, packed=packed,
    )
    want = ref_ops.phase_step_multi(
        jnp.asarray(w), jnp.asarray(bias), jnp.asarray(phase.astype(np.uint8)),
        jnp.asarray(prev.astype(np.uint8)), *(jnp.asarray(cols[c]) for c in _COLS),
        half=HALF, chunk=chunk, max_cycles=max_cycles, packed=packed, use_pallas=True,
    )
    for name, g, r in zip(_OUT, got, want):
        same(g, r)
    assert got[0].dtype == torch.uint8 and got[3].dtype == torch.bool


@pytest.mark.parametrize("packed", [False, True])
def test_phase_step_multi_period2_orbits(packed):
    """Random symmetric W drives lanes into period-2 orbits; the p2 events,
    freeze cycles and flags must match the reference exactly."""
    n, b, max_cycles, chunk = 129, 8, 30, 8
    w, bias, phase, _, _ = _multi_state(n, b, seed=77, max_cycles=max_cycles, symmetric=True)
    bias[:] = 0
    full = np.full((b,), max_cycles, np.int32)
    cols = dict(t=np.zeros(b, np.int32), settle_cycle=full, settled=np.zeros(b, bool),
                cycled=np.zeros(b, bool), frozen=np.zeros(b, bool),
                frozen_p2=np.zeros(b, bool), freeze_cycle=full)
    state_p = [torch.as_tensor(phase), torch.as_tensor(phase)] + [torch.as_tensor(cols[c]) for c in _COLS]
    state_r = [jnp.asarray(phase), jnp.asarray(phase)] + [jnp.asarray(cols[c]) for c in _COLS]
    for _ in range(3):  # three chunks: orbits form and freeze along the way
        got = ops.phase_step_multi(torch.as_tensor(w), torch.as_tensor(bias), *state_p,
                                   half=HALF, chunk=chunk, max_cycles=max_cycles, packed=packed)
        want = ref_ops.phase_step_multi(jnp.asarray(w), jnp.asarray(bias), *state_r, half=HALF,
                                        chunk=chunk, max_cycles=max_cycles, packed=packed,
                                        use_pallas=True)
        for g, r in zip(got, want):
            same(g, r)
        # 9-tuple order → the input order (phase, prev, t, sc, sd, cy, fz, fp2, fc).
        state_p = [got[0], got[1], got[8], *got[2:8]]
        state_r = [want[0], want[1], want[8], *want[2:8]]
    assert bool(got[4].any()), "expected at least one period-2 lane"


#: Kernel 5's launch plans: (B, N) and the expected (regime, cluster, lanes,
#: grid).  The main path (1024, 506), the serving slab (64, 506), the
#: smallest shape, N off 16 · C with B off L, the cluster regime's ceiling,
#: one past it (the stream regime), the stream regime's ceiling, and two
#: shapes that take 32 lanes.
MULTI_PLANS = [
    ((1024, 506), ("cluster", 2, 16, 128)),
    ((64, 506), ("cluster", 8, 8, 64)),
    ((1, 1), ("cluster", 2, 8, 2)),
    ((9, 47), ("cluster", 4, 8, 8)),
    ((65, 129), ("cluster", 8, 8, 72)),
    ((1024, autotune.MULTI_CLUSTER_MAX_N), ("cluster", 8, 8, 1024)),
    ((1024, autotune.MULTI_CLUSTER_MAX_N + 1), ("stream", 1, 8, 128)),
    ((16, autotune.MULTI_KERNEL_MAX_N), ("stream", 1, 1, 16)),
    ((1024, 800), ("cluster", 4, 32, 128)),
    ((1024, 1000), ("cluster", 8, 32, 256)),
]


@pytest.mark.parametrize("shape,want", MULTI_PLANS)
def test_multi_plan(shape, want):
    b, n = shape
    plan = autotune.multi_plan(b, n)
    assert (plan.regime, plan.cluster, plan.lanes, plan.grid) == want
    assert plan.smem_bytes <= autotune.SMEM_PER_BLOCK
    assert plan.grid % plan.cluster == 0
    assert plan.rows % 16 == 0 and plan.cluster * plan.rows >= n
    assert plan.args == ({"cluster": 0, "stream": 1}[plan.regime], plan.cluster, plan.lanes,
                         plan.rows, plan.smem_bytes)
    if plan.regime == "cluster":
        assert n <= autotune.MULTI_CLUSTER_MAX_N
        assert plan.lanes % 8 == 0 and plan.lanes in autotune.MULTI_CLUSTER_LANES
        assert plan.cluster in autotune.MULTI_CLUSTERS
        assert plan.rows <= autotune.MULTI_CLUSTER_MAX_ROWS
        assert plan.grid == plan.cluster * -(-b // plan.lanes)
        assert plan.smem_bytes == autotune.multi_cluster_smem_bytes(n, plan.cluster, plan.lanes)
    else:
        # The stream body holds whole lanes per block; at its ceiling one fits.
        assert n > autotune.MULTI_CLUSTER_MAX_N
        assert plan.lanes in (1, 2, 4, 8) and plan.grid == -(-b // plan.lanes)
        assert plan.smem_bytes + autotune.MULTI_STATIC_SMEM <= autotune.SMEM_PER_BLOCK
    assert autotune.multi_plan(b, n) is plan  # looked up, not planned again


def test_multi_ceilings():
    cmax, kmax = autotune.MULTI_CLUSTER_MAX_N, autotune.MULTI_KERNEL_MAX_N
    assert (cmax, kmax) == (1280, 17801)
    assert autotune.multi_cluster_smem_bytes(cmax, 8, 8) <= autotune.SMEM_PER_BLOCK
    assert autotune.multi_cluster_smem_bytes(cmax + 1, 8, 8) > autotune.SMEM_PER_BLOCK
    budget = autotune.SMEM_PER_BLOCK - autotune.MULTI_STATIC_SMEM
    assert autotune.multi_stream_smem_bytes(1, kmax) <= budget
    assert autotune.multi_stream_smem_bytes(1, kmax + 1) > budget
    with pytest.raises(ValueError):
        autotune.multi_plan(8, kmax + 1)
    with pytest.raises(ValueError):
        autotune.multi_plan(8, 0)
    assert autotune.padded_k(506) == 512 and autotune.padded_k(16) == 16
    assert autotune.multi_cluster_pitch(506) == 528 and autotune.multi_cluster_pitch(47) == 80


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    w, bias, phase, sigma = _inputs(20, 4, seed=3)
    ops.coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma))
    ops.phase_step(torch.as_tensor(w), torch.as_tensor(sigma), torch.as_tensor(bias), torch.as_tensor(phase), half=HALF)
    ops.phase_step_packed(torch.as_tensor(w), torch.as_tensor(bias), torch.as_tensor(phase), half=HALF)
    ops.onn_step(torch.as_tensor(w), torch.as_tensor(sigma), torch.as_tensor(bias))
    ops.quantized_matvec(torch.as_tensor(w), 0.5, torch.as_tensor(phase).float())
    ops.coupling_sum(torch.as_tensor(w)[None], torch.as_tensor(sigma)[None])
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# Kernel 2: onn_step, σ' = sign(σWᵀ + h), ties keep σ (exact)
# ---------------------------------------------------------------------------

#: (B, N) shapes of the reference's own kernel tests (tests/test_kernels.py).
SHAPES_BN = [(1, 9), (4, 48), (8, 128), (3, 506), (16, 512), (100, 484), (257, 130)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b,n", SHAPES_BN)
def test_onn_step_matches_pallas_and_ref(b, n, with_bias):
    rng = np.random.default_rng(b * 7 + n)
    w = rng.integers(-15, 16, (n, n)).astype(np.int8)
    w[:, : n // 3] = 0  # many exact ties: S + h == 0 keeps σ
    sig = rng.choice([-1, 1], (b, n)).astype(np.int8)
    bias = rng.integers(-2, 3, (n,)).astype(np.int32) if with_bias else None
    got = port_kernels.onn_step(
        torch.as_tensor(w), torch.as_tensor(sig), None if bias is None else torch.as_tensor(bias))
    jb = None if bias is None else jnp.asarray(bias)
    same(got, ref_ops.onn_step(jnp.asarray(w), jnp.asarray(sig), jb, use_pallas=True))
    same(got, ref_ref.onn_step_ref(jnp.asarray(w), jnp.asarray(sig), jb))
    assert got.dtype == torch.int8
    same(ops.onn_step(torch.as_tensor(w), torch.as_tensor(sig[0])),
         ref_ops.onn_step(jnp.asarray(w), jnp.asarray(sig[0]), use_pallas=True))


def test_onn_step_zero_weights_keep_every_spin():
    n = 16
    sig = np.random.default_rng(0).choice([-1, 1], (4, n)).astype(np.int8)
    w = np.zeros((n, n), np.int8)
    got = ops.onn_step(torch.as_tensor(w), torch.as_tensor(sig))
    same(got, sig)
    same(got, ref_ops.onn_step(jnp.asarray(w), jnp.asarray(sig), use_pallas=True))
    with pytest.raises(ValueError, match="square"):
        ops.onn_step(torch.zeros((4, 6), dtype=torch.int8), torch.ones((2, 6), dtype=torch.int8))
    with pytest.raises(TypeError):
        ops.onn_step(torch.zeros((4, 4)), torch.ones((2, 4), dtype=torch.int8))


# ---------------------------------------------------------------------------
# Kernel 8: quantized_matvec, within the float32 summation bound
# ---------------------------------------------------------------------------


def within_fp32_bound(got, x, wq, scale) -> float:
    """Assert |got − exact| ≤ K · 2⁻²⁴ · |scale_m| · Σ_k |x_bk w_mk| for
    every element (the bound of K float32 roundings, in any order); return
    the largest ratio of error to bound."""
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    x64, w64 = np.asarray(x, np.float64), np.asarray(wq, np.float64)
    s64 = np.broadcast_to(np.asarray(scale, np.float64), (w64.shape[0],))
    exact = (x64 @ w64.T) * s64
    bound = x64.shape[-1] * 2.0**-24 * np.abs(s64) * (np.abs(x64) @ np.abs(w64).T)
    err = np.abs(g.astype(np.float64) - exact)
    assert np.all(err <= bound), float(np.max(err - bound))
    return float(np.max(err / np.where(bound > 0, bound, 1.0)))


@pytest.mark.parametrize("b,m,k", [(1, 256, 512), (4, 100, 300), (8, 512, 1024), (2, 384, 640)])
def test_quantized_matvec_within_fp32_bound(b, m, k):
    rng = np.random.default_rng(m + k)
    wq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    scale = (rng.random((m,)) * 0.01 + 1e-4).astype(np.float32)
    x = rng.standard_normal((b, k)).astype(np.float32)
    got = port_kernels.quantized_matvec(torch.as_tensor(wq), torch.as_tensor(scale), torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    within_fp32_bound(got, x, wq, scale)
    for want in (
        ref_ops.quantized_matvec(jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(x), use_pallas=True),
        ref_ref.quantized_matvec_ref(jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(x)),
    ):
        within_fp32_bound(want, x, wq, scale)  # both sides hold the same bound
    one = ops.quantized_matvec(torch.as_tensor(wq), torch.as_tensor(scale), torch.as_tensor(x[0]))
    assert tuple(one.shape) == (m,)
    within_fp32_bound(one[None], x[:1], wq, scale)


def test_quantized_matvec_scalar_scale():
    rng = np.random.default_rng(3)
    wq = rng.integers(-127, 128, (128, 256)).astype(np.int8)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    for scale in (0.5, torch.tensor(0.5)):
        got = ops.quantized_matvec(torch.as_tensor(wq), scale, torch.as_tensor(x))
        within_fp32_bound(got, x, wq, 0.5)
    want = ref_ops.quantized_matvec(jnp.asarray(wq), jnp.float32(0.5), jnp.asarray(x), use_pallas=True)
    within_fp32_bound(want, x, wq, 0.5)
    with pytest.raises(ValueError, match="does not fit"):
        ops.quantized_matvec(torch.as_tensor(wq), 0.5, torch.as_tensor(x[:, :100]))


#: Kernel 8's planner shapes, one or more per branch: GEMV with K ragged,
#: aligned and at the regime's edge (B = 16); GEMM just past it, ragged, and
#: at the main path's shape.
QMV_PLAN_SHAPES = [(1, 3, 40), (8, 4096, 4096), (16, 506, 506), (17, 506, 506),
                   (65, 100, 333), (1024, 506, 506)]


@pytest.mark.parametrize("b,m,k", QMV_PLAN_SHAPES)
def test_qmv_tile_choice_fits_shared_memory(b, m, k):
    """Kernel 8's launch planner (pure Python; the kernel takes its plan):
    the regime, K chunks that cover K exactly once, shared memory within a
    block's budget, a GEMV grid of at least one block per SM where the
    shape allows it, split-K in the GEMM regime only for a grid smaller than
    the card, and the 16-byte vector path only where K and the alignment
    allow it."""
    for aligned in (True, False):
        plan = autotune.qmv_plan(b, m, k, aligned=aligned)
        gemv = b <= autotune.QMV_GEMV_MAX_B
        assert plan.regime == ("gemv" if gemv else "gemm")
        chunks = [(s * plan.k_chunk, min(k, (s + 1) * plan.k_chunk)) for s in range(plan.splits)]
        assert chunks[0][0] == 0 and chunks[-1][1] == k
        assert all(end == nxt for (_, end), (nxt, _) in zip(chunks, chunks[1:]))
        assert all(end > start for start, end in chunks)
        assert plan.splits == len(chunks) == plan.grid[1]
        assert plan.smem_bytes <= autotune.QMV_STATIC_SMEM <= autotune.SMEM_PER_BLOCK
        assert plan.workspace == (plan.splits * b * m if plan.splits > 1 else 0)
        gx, _, gz = plan.grid
        assert plan.counters == (gx * gz if plan.splits > 1 else 0)
        if gemv:
            assert plan.lanes in autotune.QMV_GEMV_LANES and b <= plan.lanes < max(2 * b, 2)
            assert plan.k_chunk % autotune.QMV_GEMV_KSTEP == 0
            assert gx * autotune.QMV_GEMV_ROWS >= m and gz == 1
            # At least one block per SM, or chunks already one step wide.
            assert plan.blocks >= autotune.NUM_SMS or plan.k_chunk == autotune.QMV_GEMV_KSTEP
        else:
            assert plan.lanes == 0 and plan.k_chunk % autotune.QMV_GEMM_BK == 0
            assert gx * autotune.QMV_GEMM_TILE >= m and gz * autotune.QMV_GEMM_TILE >= b
            if gx * gz >= autotune.NUM_SMS:
                assert plan.splits == 1
            else:
                assert plan.k_chunk >= min(autotune.QMV_GEMM_MIN_K_CHUNK, -(-k // 32) * 32)
        assert plan.vector == (aligned and k % 16 == 0)
    assert autotune.qmv_plan(8, 4096, 4096).blocks >= autotune.NUM_SMS
    assert autotune.qmv_plan(1024, 506, 506).blocks >= autotune.NUM_SMS // 2


@pytest.mark.parametrize("b,m,k", QMV_PLAN_SHAPES)
def test_quantized_matvec_plain_matches_pallas_at_plan_shapes(b, m, k):
    """The wrapper's CPU route (the plain version) and ``repro``'s Pallas
    kernel (interpret mode) at the planner's shapes, full int8 range and a
    per-row scale: each element of both within K · 2⁻²⁴ · |scale_m| ·
    Σ_k |x_bk w_mk| of the exact value."""
    rng = np.random.default_rng(b * 31 + m + k)
    wq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    scale = (rng.random((m,)) * 0.01 + 1e-4).astype(np.float32)
    x = rng.standard_normal((b, k)).astype(np.float32)
    got = ops.quantized_matvec(torch.as_tensor(wq), torch.as_tensor(scale), torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    within_fp32_bound(got, x, wq, scale)
    want = ref_ops.quantized_matvec(jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(x),
                                    use_pallas=True)
    within_fp32_bound(want, x, wq, scale)


# ---------------------------------------------------------------------------
# Kernels 1 and 6 with an instance axis: one W per instance (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parallel", [None, 1, 5, 32])
@pytest.mark.parametrize("inst,b,m,n", [(1, 3, 12, 12), (3, 4, 7, 33), (16, 5, 32, 129)])
def test_batched_coupling_sums_match_per_instance_pallas(inst, b, m, n, parallel):
    rng = np.random.default_rng(inst * 100 + m + n)
    w = rng.integers(-15, 16, (inst, m, n)).astype(np.int8)
    sig = rng.choice([-1, 1], (inst, b, n)).astype(np.int8)
    if parallel is None:
        got = ops.coupling_sum(torch.as_tensor(w), torch.as_tensor(sig))
        wants = [ref_ops.coupling_sum(jnp.asarray(w[i]), jnp.asarray(sig[i]), use_pallas=True)
                 for i in range(inst)]
    else:
        got = ops.hybrid_coupling_sum(torch.as_tensor(w), torch.as_tensor(sig), parallel=parallel)
        wants = [ref_ops.hybrid_coupling_sum(jnp.asarray(w[i]), jnp.asarray(sig[i]),
                                             parallel=parallel, use_pallas=True)
                 for i in range(inst)]
    assert tuple(got.shape) == (inst, b, m) and got.dtype == torch.int32
    same(got, np.stack([np.asarray(x) for x in wants]))


def test_batched_coupling_sum_rejects_mismatched_instances():
    w = torch.zeros((3, 4, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not fit"):
        ops.coupling_sum(w, torch.ones((2, 5, 6), dtype=torch.int8))
    with pytest.raises(ValueError, match="do not fit"):
        ops.hybrid_coupling_sum(w, torch.ones((3, 5, 7), dtype=torch.int8), parallel=2)
    with pytest.raises(ValueError, match="weights must be"):
        ops.coupling_sum(torch.zeros((1, 3, 4, 6), dtype=torch.int8), torch.ones((6,), dtype=torch.int8))


# ---------------------------------------------------------------------------
# Kernels 1-4, 6, 7: the coupling GEMM's launch planner (pure Python; the
# kernel takes its plan from the wrapper) and the CPU route at its shapes
# ---------------------------------------------------------------------------

#: (inst, b, m, n): tiny and ragged shapes, the main path's (1024, 506, 506),
#: the Max-Cut instance shape (16 × σ (64, 506) · W slab (32, 506)), and
#: N = 512 (rows on 16 bytes) and N = 1000 (16 ∤ N).
GEMM_PLAN_SHAPES = [(1, 1, 1, 1), (1, 3, 47, 47), (1, 65, 129, 129), (1, 1024, 506, 506),
                    (3, 5, 13, 47), (16, 64, 32, 506), (1, 16, 512, 512), (1, 4, 1000, 1000)]
#: MAC widths of the hybrid kernels' walk: several passes per K-step, one
#: pass per step, passes wider than a step, one pass for all of N = 506.
GEMM_PARALLEL = [1, 5, 32, 64, 65, 506]


@pytest.mark.parametrize("inst,b,m,n", GEMM_PLAN_SHAPES)
def test_coupling_plan_fits_the_block_and_fills_the_card(inst, b, m, n):
    """Every plan's tile fits a block's thread and shared-memory budget, its
    grid covers the output once, the wide tile runs only where its grid
    alone fills the card, and the kernel's arguments are the tile's index
    and shape and the K walk's unit."""
    wide, split = autotune.GEMM_TILES
    for parallel in [None, *GEMM_PARALLEL]:
        plan = autotune.coupling_plan(inst, b, m, n, parallel)
        tile = plan.tile
        assert tile.threads % 32 == 0 and tile.threads <= 1024
        assert plan.smem_bytes <= autotune.SMEM_PER_BLOCK
        assert 2 * plan.smem_bytes <= autotune.SMEM_PER_SM  # two blocks per SM
        assert tile.bm == 16 * tile.fm * tile.wm and tile.bn == 8 * tile.fn * tile.wn
        assert tile.ks * tile.wm * tile.wn * 32 == tile.threads and tile.stages >= 2
        gx, gy, gz = plan.grid
        assert (gx - 1) * tile.bn < m <= gx * tile.bn
        assert (gy - 1) * tile.bm < b <= gy * tile.bm
        assert gz == inst and gy <= 65_535
        wide_blocks = inst * -(-b // wide.bm) * -(-m // wide.bn)
        assert tile is (wide if wide_blocks >= autotune.NUM_SMS else split)
        assert plan.blocks >= min(wide_blocks, autotune.NUM_SMS)
        assert plan.parallel == (autotune.GEMM_GROUP_TILE if parallel is None else parallel)
        span = plan.span  # the K walk's unit: one K-step, or one group
        assert span in (autotune.GEMM_BK, plan.group_width) and span > 0
        assert span == autotune.gemm_walk_span(plan.parallel, n)
        assert plan.args == (tile.index, tile.bm, tile.bn, span)
        assert autotune.GEMM_TILES[tile.index] is tile
        if parallel is None:  # kernel 4 reads two spins a byte: steps start on even columns
            assert span % 2 == 0 or span >= n


def test_coupling_plan_at_the_main_path_shapes():
    """At (1024, 506, 506) the grid fills the card; at the Max-Cut instance
    shape it has at least 4× the 16 blocks of the fixed 64 × 64 tile, on
    both of its routes (kernel 1, and kernel 6 at P = 32, which walks
    128-byte steps like kernel 1)."""
    main = autotune.coupling_plan(1, 1024, 506, 506)
    assert main.blocks >= autotune.NUM_SMS and main.tile.name == "wide"
    assert main.span == autotune.GEMM_BK
    for parallel in (None, 32):
        mc = autotune.coupling_plan(16, 64, 32, 506, parallel)
        assert mc.blocks >= 4 * 16 and mc.tile.name == "split" and mc.tile.ks > 1
        assert mc.span == autotune.GEMM_BK
    assert autotune.coupling_plan(1, 1024, 506, 506, 5).span == 60  # twelve 5-wide passes


@pytest.mark.parametrize("parallel", GEMM_PARALLEL)
@pytest.mark.parametrize("n", [1, 47, 506, 512, 1000])
def test_coupling_k_walk_covers_each_column_once_in_whole_passes(n, parallel):
    """The kernel's K walk, group by group: every column of N in exactly one
    K-step, every group a run of whole passes from a pass boundary (the last
    one ragged at N), every k32 step of a K-step inside one group, and each
    K-step zero-padded to whole k32 steps; groups of whole k32 steps share
    K-steps, any other group has its own."""
    g = autotune.gemm_group_width(parallel, n)
    assert g == n or g % parallel == 0
    assert g == n or g >= min(parallel, autotune.GEMM_GROUP_TILE)
    cover = np.zeros(n, np.int64)
    for k0, width in autotune.coupling_k_steps(n, parallel):
        assert width <= autotune.GEMM_BK
        if width <= 0:
            continue
        assert 0 <= k0 and k0 + width <= n
        cover[k0:k0 + width] += 1
        pad = -(-width // autotune.GEMM_MMA_K) * autotune.GEMM_MMA_K
        assert width <= pad <= autotune.GEMM_BK
        for c in range(k0, k0 + width, autotune.GEMM_MMA_K):
            last = min(c + autotune.GEMM_MMA_K, k0 + width) - 1
            assert c // g == last // g  # one k32 step, one group
        if g % autotune.GEMM_MMA_K:
            assert k0 // g == (k0 + width - 1) // g  # a group alone
    assert (cover == 1).all()
    assert all(start % parallel == 0 for start in range(0, n, g))


@pytest.mark.parametrize("inst,b,m,n", GEMM_PLAN_SHAPES)
def test_coupling_sum_and_onn_step_plain_match_pallas_at_plan_shapes(inst, b, m, n):
    """The wrappers' CPU route (the plain versions) against ``repro``'s
    Pallas kernels in interpret mode at the planner's shapes: kernel 1 with
    the instance axis where inst > 1, kernel 2 on the square (n, n) of the
    same width; exact."""
    rng = np.random.default_rng(inst * 1000 + b * 7 + m + n)
    w = rng.integers(-15, 16, (inst, m, n)).astype(np.int8)
    sig = _spins(rng, (inst, b, n))
    got = ops.coupling_sum(torch.as_tensor(w if inst > 1 else w[0]),
                           torch.as_tensor(sig if inst > 1 else sig[0]))
    want = np.stack([np.asarray(ref_ops.coupling_sum(jnp.asarray(w[i]), jnp.asarray(sig[i]),
                                                     use_pallas=True)) for i in range(inst)])
    same(got, want if inst > 1 else want[0])
    w2 = rng.integers(-15, 16, (n, n)).astype(np.int8)
    w2[:, : n // 3] = 0  # exact ties keep σ
    bias = rng.integers(-2, 3, n).astype(np.int32)
    step = ops.onn_step(torch.as_tensor(w2), torch.as_tensor(sig[0]), torch.as_tensor(bias))
    same(step, ref_ops.onn_step(jnp.asarray(w2), jnp.asarray(sig[0]), jnp.asarray(bias),
                                use_pallas=True))
    assert step.dtype == torch.int8
