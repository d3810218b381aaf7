"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Needs a CUDA device and ``nvcc``; every test takes the ``cuda``
fixture and skips without a GPU.  It imports neither ``jax`` nor ``repro``,
so it runs on the GPU machine as it is::

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Every integer output must be exactly equal (tolerance 0); kernel 8's float32
output must lie within K · 2⁻²⁴ · |scale_m| · Σ_k |x_bk w_mk| of the exact
value, element by element (the bound of K float32 roundings).  DO-I training
on the card is held to the CPU by the DO-I rule of ``tests/doi_rule.py``
(exact where no stability check ties the threshold within the float32
summation bound), and the serve daemon's scheduler on the card serves every
request and counts every tick as on the CPU.  The dense LM on the card is
held to the CPU by the LM rule of ``tests/lm_rule.py`` (logits under teacher
forcing within its τ), the MoE by the MoE rule of ``tests/moe_rule.py``
(the routings it calls decided equal, the LM rule before a sequence's first
tie-bound routing), the enc-dec, Zamba and xLSTM families by the LM rule at
``lm_rule.depth``, and a served LM request (a whisper request with its
frames) equals ``make_generate`` of its batch bucket exactly.  A train
step of every reduced arch on the card is held to the CPU by the training
rule of ``tests/train_rule.py`` (loss, every gradient leaf, AdamW on
identical gradients), and a checkpoint written from the card restores on
the CPU bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from doi_rule import hold, replay
from repro_torch import api, serving, train
from repro_torch.core import dynamics as dyn
from repro_torch.core import energy
from repro_torch.core import quantization
from repro_torch.engine import Request
from repro_torch.core import ising
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import ref as plain

HALF = 8
COLS = ("t", "settle_cycle", "settled", "cycled", "frozen", "frozen_p2", "freeze_cycle")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(n, b, seed, device):
    rng = np.random.default_rng(seed)
    w = rng.integers(-15, 16, size=(n, n)).astype(np.int8)
    w[:, : n // 3] = 0  # many exact ties: S + h == 0 keeps θ
    bias = rng.integers(-2, 3, size=n).astype(np.int32)
    phase = rng.integers(0, 16, size=(b, n)).astype(np.int32)
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    return tuple(torch.as_tensor(x, device=device) for x in (w, bias, phase, sigma))


@pytest.mark.parametrize("n,b", [(1, 1), (47, 3), (129, 65), (506, 1024)])
def test_gemm_kernels_match_plain(cuda, n, b):
    w, bias, phase, sigma = _inputs(n, b, seed=n + b, device=cuda)
    ops.reset_launches()
    m = max(1, n // 2)
    assert torch.equal(ops.coupling_sum(w, sigma), plain.coupling_sum_ref(w, sigma))
    assert torch.equal(ops.coupling_sum(w[:m], sigma), plain.coupling_sum_ref(w[:m], sigma))
    assert torch.equal(
        ops.phase_step(w, sigma, bias, phase, half=HALF),
        plain.phase_step_ref(w, sigma, bias, phase, HALF),
    )
    assert torch.equal(
        ops.phase_step_packed(w, bias, phase, half=HALF),
        plain.phase_step_packed_ref(w, bias, phase, HALF),
    )
    torch.cuda.synchronize()
    assert ops.LAUNCHES["coupling_sum"] == 2
    assert ops.LAUNCHES["phase_step"] == ops.LAUNCHES["phase_step_packed"] == 1


#: Kernel 5 at one (N, B) per branch of ``autotune.multi_plan``: clusters of
#: 2 (N = 1; the main path, 16 lanes), 4 (N = 47 off 16 · C, B = 9 off L;
#: N = 800, 32 lanes) and 8 (N = 129 odd, B = 65; the serving slab), and the
#: stream regime (N = 1281, odd).
MULTI_SHAPES = [(1, 2), (47, 9), (129, 65), (506, 64), (506, 1024), (800, 1024), (1281, 37)]


def _multi_operands(n, b, device, max_cycles, frozen_all=False):
    rng = np.random.default_rng(n * b)
    w, bias, _, _ = _inputs(n, b, seed=n * b + 1, device=device)
    phase = torch.as_tensor(np.where(rng.random((b, n)) < 0.5, 0, HALF), device=device)
    prev = torch.as_tensor(np.where(rng.random((b, n)) < 0.5, 0, HALF), device=device)
    t = rng.integers(0, max_cycles + 1, size=b).astype(np.int32)
    t[: b // 2] = max_cycles - rng.integers(1, 4, size=b // 2)  # budget expiry mid-chunk
    frozen = np.ones(b, bool) if frozen_all else rng.random(b) < 0.25
    full = np.full((b,), max_cycles, np.int32)
    cols = dict(t=t, settle_cycle=full, settled=np.zeros(b, bool), cycled=np.zeros(b, bool),
                frozen=frozen, frozen_p2=frozen & (rng.random(b) < 0.5),
                freeze_cycle=np.where(frozen, t, full).astype(np.int32))
    flags = [torch.as_tensor(cols[c], device=device) for c in COLS]
    return w, bias, phase, prev, flags


def _multi_check(w, bias, phase, prev, flags, packed, chunk, max_cycles):
    got = ops.phase_step_multi(w, bias, phase, prev, *flags, half=HALF, chunk=chunk,
                               max_cycles=max_cycles, packed=packed)
    want = plain.phase_step_multi_ref(
        w, bias, phase, prev, *(f.to(torch.int32)[:, None] for f in flags),
        half=HALF, chunk=chunk, max_cycles=max_cycles,
    )
    for g, r in zip(got, want):
        assert torch.equal(g.to(torch.int32).reshape(-1), r.reshape(-1))
    return got


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,b", MULTI_SHAPES)
def test_multi_kernel_matches_plain(cuda, n, b, packed):
    max_cycles, chunk = 20, 8
    ops.reset_launches()
    _multi_check(*_multi_operands(n, b, cuda, max_cycles), packed, chunk, max_cycles)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["phase_step_multi_packed" if packed else "phase_step_multi"] == 1


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", ["all_frozen", "chunk_1"])
@pytest.mark.parametrize("n,b", [(506, 64), (506, 1024), (1281, 37)])
def test_multi_kernel_edge_cases(cuda, n, b, case, packed):
    """Every lane frozen at entry (the kernel leaves at its first cycle and
    must return the state as it came), and a chunk of one cycle."""
    max_cycles = 20
    ops_in = _multi_operands(n, b, cuda, max_cycles, frozen_all=case == "all_frozen")
    got = _multi_check(*ops_in, packed, 1 if case == "chunk_1" else 8, max_cycles)
    if case == "all_frozen":
        assert torch.equal(got[0], ops_in[2]) and torch.equal(got[1], ops_in[3])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,b", [(506, 1024), (129, 65), (1281, 37)])
def test_multi_kernel_two_calls_bit_identical(cuda, n, b, packed):
    max_cycles = 20
    w, bias, phase, prev, flags = _multi_operands(n, b, cuda, max_cycles)
    first = ops.phase_step_multi(w, bias, phase, prev, *flags, half=HALF, chunk=8,
                                 max_cycles=max_cycles, packed=packed)
    again = ops.phase_step_multi(w, bias, phase, prev, *flags, half=HALF, chunk=8,
                                 max_cycles=max_cycles, packed=packed)
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,b", [(n, b) for n, b in MULTI_SHAPES if n <= 1280])
def test_multi_cluster_plan_fits_the_card(cuda, n, b, packed):
    """Each planned cluster (C CTAs of the plan's shared memory and 2 · rows
    threads) can be resident on the card, and a plan the source does not
    instantiate is refused, not run another way."""
    plan = autotune.multi_plan(b, n)
    assert plan.regime == "cluster"
    assert ops.multi_cluster_occupancy(plan, packed) >= 1
    bad = dataclasses.replace(plan, lanes=24, smem_bytes=autotune.multi_cluster_smem_bytes(
        n, plan.cluster, 24))
    w, bias, phase, prev, flags = _multi_operands(n, b, cuda, 20)
    w8 = torch.nn.functional.pad(w, (0, autotune.padded_k(n) - n)).contiguous()
    cols = torch.stack([f.to(torch.int32) for f in flags]).contiguous()
    ph, pv = phase.to(torch.int32).contiguous(), prev.to(torch.int32).contiguous()
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops._launch("phase_step_multi", "onn_phase_step_multi", cuda, w8.data_ptr(),
                    bias.data_ptr(), ph.data_ptr(), pv.data_ptr(), cols.data_ptr(),
                    torch.empty_like(ph).data_ptr(), torch.empty_like(pv).data_ptr(),
                    torch.empty_like(cols).data_ptr(), b, n, autotune.padded_k(n), HALF, 8, 20,
                    int(packed), *bad.args)


@pytest.mark.parametrize("phase_pack", [False, True])
def test_retrieve_on_card_equals_cpu(cuda, phase_pack):
    n, b = 129, 64
    rng = np.random.default_rng(3)
    a = rng.integers(-15, 16, size=(n, n))
    w = np.clip(np.tril(a) + np.tril(a, -1).T, -15, 15).astype(np.int8)  # period-2 orbits
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    cfg = dyn.ONNConfig(n=n, backend="kernel", max_cycles=40, phase_pack=phase_pack)
    ops.reset_launches()
    got = api.RetrievalSolver(cfg, api.make_params(cfg, w)).solve(sigma)
    want = api.RetrievalSolver(cfg, api.make_params(cfg, w, device="cpu")).solve(sigma)
    for f in dyn.ONNResult._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    key = "phase_step_multi_packed" if phase_pack else "phase_step_multi"
    assert ops.LAUNCHES[key] > 0
    per_cycle = dataclasses.replace(cfg, settle_chunk=1)
    state = dyn.init_batch_state(per_cycle, dyn.initial_phase(per_cycle, got.final_sigma))
    fused = dyn._chunk_fused(per_cycle, api.make_params(cfg, w), state, 3)
    multi = dyn._chunk_multi(per_cycle, api.make_params(cfg, w), state, 3)
    for a_, b_ in zip(fused, multi):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("p", [1, 5, 32, 64, 65, 506])
@pytest.mark.parametrize("n,b", [(1, 1), (47, 3), (129, 65), (506, 1024)])
def test_hybrid_kernels_match_plain(cuda, n, b, p):
    """Kernels 6 and 7 at every tile case: groups of several passes (P < 64),
    one pass per tile (P = 64), passes walked in sub-tiles (P > 64), ragged
    last passes, and P wider than N."""
    w, bias, phase, sigma = _inputs(n, b, seed=n + b + p, device=cuda)
    ops.reset_launches()
    m = max(1, n // 2)
    assert torch.equal(ops.hybrid_coupling_sum(w, sigma, parallel=p),
                       plain.hybrid_coupling_sum_ref(w, sigma, p))
    assert torch.equal(ops.hybrid_coupling_sum(w[:m], sigma, parallel=p),
                       plain.coupling_sum_ref(w[:m], sigma))
    assert torch.equal(ops.hybrid_phase_step(w, sigma, bias, phase, half=HALF, parallel=p),
                       plain.hybrid_phase_step_ref(w, sigma, bias, phase, HALF, p))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hybrid_coupling_sum"] == 2
    assert ops.LAUNCHES["hybrid_phase_step"] == 1


@pytest.mark.parametrize("route", ["hybrid", "recurrent"])
def test_rtl_on_card_equals_cpu(cuda, route):
    """rtl with jitter on the card, through kernel 6 (hybrid architecture,
    hybrid backend) or kernel 1 (recurrent architecture, kernel backend)."""
    n, b = 129, 32
    rng = np.random.default_rng(5)
    w = rng.integers(-15, 16, size=(n, n)).astype(np.int8)
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    kw = (dict(architecture="hybrid", backend="hybrid", hybrid_impl="kernel")
          if route == "hybrid" else dict(architecture="recurrent", backend="kernel"))
    cfg = dyn.ONNConfig(n=n, mode="rtl", sync_jitter=True, max_cycles=12, **kw)
    ops.reset_launches()
    got = api.RetrievalSolver(cfg, api.make_params(cfg, w)).solve(
        sigma, key=torch.Generator(device="cuda").manual_seed(1))
    t0 = torch.randint(0, cfg.clocks_per_cycle, (b,),
                       generator=torch.Generator(device="cuda").manual_seed(1),
                       device="cuda", dtype=torch.int32)
    want = dyn.retrieve(cfg, api.make_params(cfg, w, device="cpu"), torch.as_tensor(sigma),
                        t0=t0.cpu())
    for f in dyn.ONNResult._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    key = "hybrid_coupling_sum" if route == "hybrid" else "coupling_sum"
    assert ops.LAUNCHES[key] > 0 and ops.LAUNCHES[key] % cfg.clocks_per_cycle == 0


def test_mixed_devices_raise(cuda):
    w, bias, phase, sigma = _inputs(8, 2, seed=0, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        ops.coupling_sum(w, sigma.cpu())


@pytest.mark.parametrize("b", [1, 63, 1024])
@pytest.mark.parametrize("n", [1, 47, 129, 506])
def test_onn_step_kernel_matches_plain(cuda, n, b):
    """Kernel 2, ragged B and N, with and without a bias; a third of W's
    columns zero so that ties (S + h == 0 keeps σ) occur."""
    w, bias, _, sigma = _inputs(n, b, seed=3 * n + b, device=cuda)
    ops.reset_launches()
    for h in (bias, None):
        hh = torch.zeros(n, dtype=torch.int32, device=cuda) if h is None else h
        got = ops.onn_step(w, sigma, h)
        assert got.dtype == torch.int8
        assert torch.equal(got, plain.onn_step_ref(w, sigma, hh))
    zero = torch.zeros_like(w)
    assert torch.equal(ops.onn_step(zero, sigma), sigma)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["onn_step"] == 3


def _qmv_error_ratio(got, x, wq, scale) -> float:
    """Largest |got − exact| / bound over the elements; asserts ≤ 1."""
    x64, w64, s64 = x.double(), wq.double(), scale.double()
    exact = (x64 @ w64.T) * s64
    bound = x.shape[-1] * 2.0**-24 * s64.abs() * (x64.abs() @ w64.abs().T)
    err = (got.double() - exact).abs()
    assert bool(torch.all(err <= bound)), float((err - bound).max())
    return float((err / bound.clamp_min(1e-300)).max())


#: Kernel 8's shapes on the card, one or more per branch of its planner
#: (``autotune.qmv_plan``): the two chip_smoke shapes (GEMM split-K with
#: K = 506 unaligned, GEMV split-K on the vector path), ragged ones, the
#: GEMV edge B = 16 and the GEMM edge B = 17 with unaligned K, GEMV and GEMM
#: split-K on the vector path, and GEMM grids of at least 132 tiles (no
#: split) on both load paths.
QMV_SHAPES = [(1024, 506, 506), (8, 4096, 4096), (65, 100, 333), (1, 3, 40), (16, 506, 506),
              (17, 506, 506), (3, 300, 1024), (40, 200, 256), (1408, 1536, 64), (1536, 1536, 40)]


def _qmv_inputs(b, m, k, device):
    g = torch.Generator(device=device).manual_seed(b + m + k)
    wq = torch.randint(-15, 16, (m, k), generator=g, device=device, dtype=torch.int8)
    scale = torch.rand((m,), generator=g, device=device) * 0.01 + 1e-4
    x = torch.randn((b, k), generator=g, device=device)
    return wq, scale, x


@pytest.mark.parametrize("b,m,k", QMV_SHAPES)
def test_quantized_matvec_kernel_within_fp32_bound(cuda, b, m, k):
    """Kernel 8 at one shape per planner branch, per-row and scalar scale;
    TF32 stays off for the plain version, as PyTorch's default."""
    assert not torch.backends.cuda.matmul.allow_tf32
    wq, scale, x = _qmv_inputs(b, m, k, cuda)
    ops.reset_launches()
    got = ops.quantized_matvec(wq, scale, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    _qmv_error_ratio(got, x, wq, scale)
    _qmv_error_ratio(plain.quantized_matvec_ref(wq, scale, x), x, wq, scale)
    got = ops.quantized_matvec(wq, 0.5, x)
    _qmv_error_ratio(got, x, wq, torch.full((m,), 0.5, device=cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quantized_matvec"] == 2


@pytest.mark.parametrize("b,m,k", QMV_SHAPES)
def test_quantized_matvec_kernel_two_calls_bit_identical(cuda, b, m, k):
    """Two calls on the same inputs give the same bits (split-K partials are
    summed in chunk order, never by float atomics), also with x and W at
    addresses that are not 16-byte aligned (the scalar load path)."""
    wq, scale, x = _qmv_inputs(b, m, k, cuda)
    first = ops.quantized_matvec(wq, scale, x)
    second = ops.quantized_matvec(wq, scale, x)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    x_off = torch.empty(b * k + 1, device=cuda)[1:].view(b, k)
    w_off = torch.empty(m * k + 1, device=cuda, dtype=torch.int8)[1:].view(m, k)
    x_off.copy_(x)
    w_off.copy_(wq)
    shifted = ops.quantized_matvec(w_off, scale, x_off)
    _qmv_error_ratio(shifted, x, wq, scale)
    assert torch.equal(shifted.view(torch.int32), ops.quantized_matvec(w_off, scale, x_off).view(torch.int32))


@pytest.mark.parametrize("p", [None, 1, 5, 32, 506])
@pytest.mark.parametrize("inst,b,m,n", [(3, 5, 13, 47), (3, 64, 32, 506), (16, 64, 32, 506)])
def test_batched_coupling_sums_match_plain(cuda, inst, b, m, n, p):
    """Kernels 1 and 6 with an instance axis (M < 64, the Max-Cut slabs)
    against the plain version and against one 2-d launch per instance."""
    g = torch.Generator(device=cuda).manual_seed(inst + b + m + n)
    w = torch.randint(-15, 16, (inst, m, n), generator=g, device=cuda, dtype=torch.int8)
    sigma = torch.randint(0, 2, (inst, b, n), generator=g, device=cuda, dtype=torch.int8) * 2 - 1
    ops.reset_launches()
    if p is None:
        got, want = ops.coupling_sum(w, sigma), plain.coupling_sum_ref(w, sigma)
        each = [ops.coupling_sum(w[i], sigma[i]) for i in range(inst)]
        key = "coupling_sum"
    else:
        got = ops.hybrid_coupling_sum(w, sigma, parallel=p)
        want = plain.hybrid_coupling_sum_ref(w, sigma, p)
        each = [ops.hybrid_coupling_sum(w[i], sigma[i], parallel=p) for i in range(inst)]
        key = "hybrid_coupling_sum"
    assert torch.equal(got, want)
    assert torch.equal(got, torch.stack(each))
    torch.cuda.synchronize()
    assert ops.LAUNCHES[f"{key}_batched"] == 1 and ops.LAUNCHES[key] == inst


@pytest.mark.parametrize("route", [dict(backend="kernel"),
                                   dict(backend="hybrid", hybrid_impl="kernel")])
def test_maxcut_on_card_equals_cpu(cuda, route):
    """One Max-Cut solve through MaxCutSolver on the card (kernel 1 or 6 with
    the instance axis, one launch per group) equals the CPU on every field;
    the uniforms come from one CPU generator seed for both."""
    n, inst = 129, 4
    adj = torch.stack([ising.random_graph(torch.Generator().manual_seed(i), n) for i in range(inst)])
    kw = dict(sweeps=12, replicas=8, stagnation=3, settle_chunk=4, **route)
    ops.reset_launches()
    got = api.MaxCutSolver(**kw).solve(adj, key=torch.Generator().manual_seed(7))
    want = api.MaxCutSolver(**kw, device="cpu").solve(adj, key=torch.Generator().manual_seed(7))
    for f in ising.MaxCutResult._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    key = "hybrid_coupling_sum_batched" if route["backend"] == "hybrid" else "coupling_sum_batched"
    assert ops.LAUNCHES[key] > 0 and ops.LAUNCHES[key] % 16 == 0
    w = ising.maxcut_couplings(adj[0].to(cuda)).values
    sig = got.sigma[0]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    assert torch.equal(dyn.async_sweep(w, sig, order).cpu(),
                       dyn.async_sweep(w.cpu(), sig.cpu(), order))


# ---------------------------------------------------------------------------
# The coupling GEMM (kernels 1-4, 6, 7) on the int8 tensor cores: operands
# off any alignment, and every branch of its planner
# ---------------------------------------------------------------------------


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view one element past the start of its
    allocation: rows off every 4- and 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _gemm_mode(mode, w, sigma, bias, phase):
    """(kernel output, plain output) of one coupling-GEMM entry point."""
    calls = {
        "sum": (lambda: ops.coupling_sum(w, sigma), lambda: plain.coupling_sum_ref(w, sigma)),
        "step": (lambda: ops.onn_step(w, sigma, bias), lambda: plain.onn_step_ref(w, sigma, bias)),
        "phase": (lambda: ops.phase_step(w, sigma, bias, phase, half=HALF),
                  lambda: plain.phase_step_ref(w, sigma, bias, phase, HALF)),
        "packed": (lambda: ops.phase_step_packed(w, bias, phase, half=HALF),
                   lambda: plain.phase_step_packed_ref(w, bias, phase, HALF)),
        "hybrid_sum": (lambda: ops.hybrid_coupling_sum(w, sigma, parallel=5),
                       lambda: plain.hybrid_coupling_sum_ref(w, sigma, 5)),
        "hybrid_phase": (
            lambda: ops.hybrid_phase_step(w, sigma, bias, phase, half=HALF, parallel=5),
            lambda: plain.hybrid_phase_step_ref(w, sigma, bias, phase, HALF, 5)),
    }
    kernel, ref_fn = calls[mode]
    return kernel(), ref_fn()


GEMM_MODES = ["sum", "step", "phase", "packed", "hybrid_sum", "hybrid_phase"]


@pytest.mark.parametrize("mode", GEMM_MODES)
@pytest.mark.parametrize("n", [32, 64, 506, 512, 1000])
def test_gemm_kernels_on_offset_operands(cuda, n, mode):
    """Every mode with σ and W (and θ) one element past an aligned base, so
    that every row starts off a word: the realigning loads, and the partial
    words at both ends of each tensor; exact."""
    b = 67
    w, bias, phase, sigma = _inputs(n, b, seed=n + len(mode), device=cuda)
    w_o, sigma_o, phase_o = _offset(w), _offset(sigma), _offset(phase)
    assert w_o.data_ptr() % 4 and sigma_o.data_ptr() % 4
    got, want = _gemm_mode(mode, w_o, sigma_o, bias, phase_o)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got, _gemm_mode(mode, w, sigma, bias, phase)[1])


#: Each tile of ``autotune.coupling_plan`` at N = 506 (rows 2 bytes off a
#: word) and N = 512 (rows on 16 bytes): (inst, b, n, tile); and the wgmma
#: regime that ``autotune.coupling_route`` gives kernels 1 and 2 at large
#: shapes, with rows on 16 bytes, a 16-byte K tail, and rows copied to 16
#: bytes (N = 4100).
GEMM_BRANCHES = [(1, 1024, 512, "wide"), (1, 1024, 506, "wide"),
                 (1, 16, 512, "split"), (1, 16, 506, "split"),
                 (16, 64, 506, "split"), (16, 64, 512, "split"),
                 (1, 1024, 8192, "wgmma"), (1, 1000, 8208, "wgmma"), (1, 2000, 4100, "wgmma")]


@pytest.mark.parametrize("inst,b,n,tile", GEMM_BRANCHES)
def test_gemm_kernels_at_every_plan_branch(cuda, inst, b, n, tile):
    """Each tile at both row alignments, every mode (with the instance axis,
    kernels 1 and 6, at the Max-Cut slab width M = 32); the wgmma regime on
    the two entries it serves, each launched once there; exact."""
    m = 32 if inst > 1 else n
    w, bias, phase, sigma = _inputs(n, b, seed=inst + b + n, device=cuda)
    if tile == "wgmma":
        ops.reset_launches()
        for mode, entry in (("sum", "coupling_sum"), ("step", "onn_step")):
            assert autotune.coupling_route(entry, 1, b, n, n).regime == "wgmma"
            got, want = _gemm_mode(mode, w, sigma, bias, phase)
            torch.cuda.synchronize()
            assert torch.equal(got, want), mode
        assert ops.REGIME_LAUNCHES == {"coupling_sum/wgmma": 1, "onn_step/wgmma": 1}
        return
    if inst > 1:
        g = torch.Generator(device=cuda).manual_seed(n)
        slabs = torch.randint(-15, 16, (inst, m, n), generator=g, device=cuda, dtype=torch.int8)
        reps = torch.randint(0, 2, (inst, b, n), generator=g, device=cuda, dtype=torch.int8) * 2 - 1
        plan = autotune.coupling_plan(inst, b, m, n, 32)
        assert plan.tile.name == tile
        assert plan.blocks >= 64
        assert torch.equal(ops.coupling_sum(slabs, reps), plain.coupling_sum_ref(slabs, reps))
        assert torch.equal(ops.hybrid_coupling_sum(slabs, reps, parallel=32),
                           plain.coupling_sum_ref(slabs, reps))
        torch.cuda.synchronize()
        return
    assert autotune.coupling_plan(1, b, n, n).tile.name == tile
    for mode in GEMM_MODES:
        got, want = _gemm_mode(mode, w, sigma, bias, phase)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode


def test_gemm_refuses_a_plan_it_cannot_run(cuda):
    """An unknown tile, a tile shape other than the source's, a walk unit
    of no columns, or an odd one for the packed operand is refused with an
    error, not run wrong."""
    from repro_torch.kernels import build

    n, b = 512, 16
    w, bias, _, sigma = _inputs(n, b, seed=1, device=cuda)
    out = torch.empty((b, n), dtype=torch.int32, device=cuda)
    lib = build.library("coupling_gemm")
    stream = torch.cuda.current_stream().cuda_stream
    plan = autotune.coupling_plan(1, b, n, n)
    idx, bm, bn, span = plan.args
    ptrs = (sigma.data_ptr(), w.data_ptr(), out.data_ptr(), 1, b, n, n)
    assert lib.onn_coupling_sum(*ptrs, 2, bm, bn, span, stream) != 0
    assert lib.onn_coupling_sum(*ptrs, idx, bm + 16, bn, span, stream) != 0
    assert lib.onn_coupling_sum(*ptrs, idx, bm, bn, 0, stream) != 0
    packed = torch.zeros((b, n // 2), dtype=torch.uint8, device=cuda)
    assert lib.onn_phase_step_packed(packed.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                     out.data_ptr(), b, n, HALF, idx, bm, bn, 33, stream) != 0
    assert lib.onn_coupling_sum(*ptrs, *plan.args, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, plain.coupling_sum_ref(w, sigma))


# ---------------------------------------------------------------------------
# Kernels 1 and 2 in the wgmma regime (csrc/coupling_wgmma.cu)
# ---------------------------------------------------------------------------


def _wgmma_inputs(b, m, k, device):
    """Seeded 5-bit W (m, k) and spins (b, k); for kernel 2 (m == k) the
    first 8 lanes repeat lane 0 and h = −(σ₀ Wᵀ), so every element of those
    lanes is a tie (S + h == 0 keeps σ)."""
    g = torch.Generator(device=device).manual_seed(b + m + k)
    w = torch.randint(-15, 16, (m, k), generator=g, device=device, dtype=torch.int8)
    sigma = torch.randint(0, 2, (b, k), generator=g, device=device, dtype=torch.int8) * 2 - 1
    sigma[:8] = sigma[0]
    h = -plain.coupling_sum_ref(w, sigma[:1])[0] if m == k else None
    return w, sigma, h


def _wgmma_run(mode, plan, w, sigma, h):
    """(kernel output, plain output) of one launch of ``plan`` through
    ``ops._wgmma``."""
    b, m = sigma.shape[0], w.shape[0]
    if mode == "coupling_sum":
        out = (torch.zeros if plan.splits > 1 else torch.empty)(
            (b, m), dtype=torch.int32, device=w.device)
        want = plain.coupling_sum_ref(w, sigma)
    else:
        out = torch.empty((b, m), dtype=torch.int8, device=w.device)
        want = plain.onn_step_ref(w, sigma, h)
        assert torch.equal(want[:8], sigma[:8])  # the forced ties keep σ
    ops._wgmma(mode, plan, sigma.contiguous(), w.contiguous(), h, out)
    torch.cuda.synchronize()
    return out, want


def _split(plan, splits):
    """``plan`` with K cut into ``splits`` slices (as near as whole K-steps allow)."""
    k_chunk = -(-plan.k_steps // splits)
    splits = -(-plan.k_steps // k_chunk)
    return dataclasses.replace(plan, k_chunk=k_chunk, splits=splits,
                               grid_blocks=min(plan.tiles * splits, autotune.NUM_SMS))


#: (mode, B, M, K, slices): B and M off the 128 x 256 tile, K off 128 and
#: off 16 (rows copied to 16 bytes: 1000, 506), split-K forced on and off
#: (None: the planner's; 8208: 16 tiles, so the planner cuts 8 slices),
#: and operands far smaller than a TMA box (B 1 and 5, K 40 and 33).
WGMMA_CASES = [
    ("coupling_sum", 1, 3, 40, None), ("onn_step", 5, 33, 33, None),
    ("coupling_sum", 300, 200, 1000, None), ("coupling_sum", 300, 200, 1000, 3),
    ("coupling_sum", 1024, 512, 8208, None), ("coupling_sum", 1024, 512, 8208, 1),
    ("coupling_sum", 257, 506, 506, None), ("coupling_sum", 257, 506, 506, 4),
    ("onn_step", 257, 506, 506, None), ("onn_step", 300, 640, 640, None),
    ("onn_step", 129, 8208, 8208, None),
]


@pytest.mark.parametrize("mode,b,m,k,splits", WGMMA_CASES)
def test_wgmma_regime_matches_plain(cuda, mode, b, m, k, splits):
    """Kernel 1 (SUM) and kernel 2 (STEP, ties forced) in the wgmma regime on
    ragged shapes, split-K on and off; exact."""
    w, sigma, h = _wgmma_inputs(b, m, k, cuda)
    plan = autotune.wgmma_plan(mode, b, m, k)
    if splits is not None:
        plan = _split(plan, splits)
        assert plan.splits == splits
    ops.reset_launches()
    got, want = _wgmma_run(mode, plan, w, sigma, h)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert ops.REGIME_LAUNCHES == {f"{mode}/wgmma": 1} and ops.LAUNCHES == {mode: 1}


#: The shapes the route sends to the wgmma regime through the public
#: entries: the ONN dry run's two ``onn_131072`` shares (``rowpar`` split
#: into 8 slices) and kernel 2 at a square W with a K tail and rows copied.
WGMMA_ROUTED = [("coupling_sum", 1024, 8192, 8192), ("coupling_sum", 1024, 512, 131072),
                ("onn_step", 1000, 8208, 8208), ("onn_step", 2000, 4100, 4100)]


@pytest.mark.parametrize("mode,b,m,k", WGMMA_ROUTED)
def test_wgmma_route_at_large_shapes(cuda, mode, b, m, k):
    """``ops.coupling_sum`` and ``ops.onn_step`` launch the wgmma regime
    once at large shapes, counted under their kernel and the regime; exact."""
    w, sigma, h = _wgmma_inputs(b, m, k, cuda)
    plan = autotune.coupling_route(mode, 1, b, m, k)
    assert plan.regime == "wgmma"
    ops.reset_launches()
    if mode == "coupling_sum":
        assert plan.splits == (8 if m == 512 else 1)
        got, want = ops.coupling_sum(w, sigma), plain.coupling_sum_ref(w, sigma)
    else:
        got, want = ops.onn_step(w, sigma, h), plain.onn_step_ref(w, sigma, h)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.REGIME_LAUNCHES == {f"{mode}/wgmma": 1} and ops.LAUNCHES == {mode: 1}


@pytest.mark.parametrize("mode", ["coupling_sum", "onn_step"])
def test_wgmma_on_offset_operands(cuda, mode):
    """σ and W one element past an aligned base (rows on 16 bytes, bases
    off): the wrapper copies them for TMA; exact."""
    b, m, k = 333, 512, 512
    w, sigma, h = _wgmma_inputs(b, m, k, cuda)
    w_o, sigma_o = _offset(w), _offset(sigma)
    assert w_o.data_ptr() % 16 and sigma_o.data_ptr() % 16
    got, want = _wgmma_run(mode, autotune.wgmma_plan(mode, b, m, k), w_o, sigma_o, h)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 15), (257, 17), (70_000, 506), (5, 1000),
                                    (2, 8200), (33, 512)])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_wgmma_row_copy_matches_plain(cuda, rows, n, offset):
    """The wgmma regime's copy of an operand TMA cannot read (rows of N
    bytes into zero-padded rows of N rounded up to 16), at bases off 16
    bytes and both ends of the source: equal to the CPU's copy."""
    g = torch.Generator(device=cuda).manual_seed(rows + n + offset)
    buf = torch.randint(-128, 128, (rows * n + offset,), generator=g, device=cuda,
                        dtype=torch.int8)
    x = buf[offset:].view(rows, n)
    got = ops._tma_rows(x, n)
    want = ops._tma_rows(x.cpu(), n)
    if offset == 0 and n % 16 == 0:
        assert got is x and want.shape == x.shape
    assert got.data_ptr() % 16 == 0 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_wgmma_refuses_a_plan_it_cannot_run(cuda):
    """A tile or ring other than the source's, slices that leave K-steps out
    or run empty, split-K in STEP, a mode it has not, a base or pitch TMA
    cannot read: refused with an error, not run wrong."""
    from repro_torch.kernels import build

    b, m, k = 256, 512, 512
    w, sigma, h = _wgmma_inputs(b, m, k, cuda)
    out = torch.zeros((b, m), dtype=torch.int32, device=cuda)
    fn = build.library("coupling_wgmma").onn_coupling_wgmma
    stream = torch.cuda.current_stream().cuda_stream
    plan = autotune.wgmma_plan("coupling_sum", b, m, k)
    bm, bn, stages, k_chunk, splits, grid, order = plan.args
    assert (k_chunk, splits) == (1, 4)  # 4 tiles: one slice a K-step

    def call(mode=0, s=sigma.data_ptr(), lds=k, ldw=k, args=plan.args, bias=None, kk=k):
        return fn(mode, s, lds, w.data_ptr(), ldw, bias, out.data_ptr(), b, m, kk, *args,
                  stream)

    assert call(args=(64, bn, stages, k_chunk, splits, grid, order)) != 0
    assert call(args=(bm, bn, 3, k_chunk, splits, grid, order)) != 0
    assert call(args=(bm, bn, stages, 1, 1, grid, order)) != 0   # K-steps left out
    assert call(args=(bm, bn, stages, 2, 3, grid, order)) != 0   # an empty slice
    assert call(args=(bm, bn, stages, 0, 1, grid, order)) != 0
    assert call(mode=3, bias=h.data_ptr(), args=(bm, bn, stages, 2, 2, grid, order)) != 0
    assert call(mode=1) != 0
    assert call(s=sigma.data_ptr() + 1) != 0
    assert call(lds=k - 16) != 0 and call(ldw=k + 8) != 0
    assert call() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, plain.coupling_sum_ref(w, sigma))


@pytest.mark.parametrize("n,p,qat", [(33, 6, 0), (33, 6, 5), (505, 40, 0)])
def test_train_doi_on_card_follows_the_rule(cuda, n, p, qat):
    """With self-coupling off and N odd no check ties, so the card's run must
    equal the CPU's exactly, weights and quantized weights included."""
    rng = np.random.default_rng(n + qat)
    xi = np.where(rng.random((p, n)) < 0.5, 1, -1).astype(np.int8)
    cfg = train.TrainConfig(qat_bits=qat)
    card = train.train_doi(xi, cfg, device=cuda)
    cpu = train.train_doi(xi, cfg, device="cpu")
    rp = replay(xi, **dataclasses.asdict(cfg), fake_quantize=quantization.fake_quantize)
    kind = hold(card, cpu, rp, quantize=lambda w: api.quantize_weights(w.cpu()).values,
                ports=("got", "want"))
    if not qat:
        assert kind == "tie_free"


def test_continuous_engine_on_card_equals_cpu(cuda):
    """A ticked stream of retrieval (kernel backend) and Max-Cut requests
    through the daemon on the card and on the CPU: every result and every
    scheduler counter equal."""
    n = 64
    rng = np.random.default_rng(3)
    xi = np.where(rng.random((4, n)) < 0.5, 1, -1).astype(np.int8)
    probes = xi[rng.integers(0, 4, 96)].copy()
    probes[rng.random((96, n)) < 0.2] *= -1
    graphs = []
    for m in (40, 64):
        u = np.triu(rng.random((m, m)) < 0.5, 1)
        graphs.append(torch.as_tensor((u + u.T).astype(np.int8)))
    trained = api.RetrievalSolver.from_patterns(xi, device="cpu", backend="kernel",
                                                settle_chunk=2)
    reports, results = [], []
    for dev in (cuda, torch.device("cpu")):
        eng = serving.ContinuousEngine(torch.Generator().manual_seed(0), device=dev,
                                       slab_lanes=32)
        eng.install("mem", "retrieval", solver=api.RetrievalSolver(
            trained.config, api.make_params(trained.config, trained.params.weights, device=dev)))
        eng.install("cuts", "maxcut", sweeps=12, replicas=8, stagnation=4, backend="kernel",
                    device=dev)
        reqs = [Request("mem", probes[i:i + 1 + i % 3]) for i in range(0, 90, 3)]
        reqs[7:7] = [Request("cuts", g, key=torch.Generator().manual_seed(9 + i))
                     for i, g in enumerate(graphs)]
        futs, submit = [], eng.submit
        eng.submit = lambda r: futs.append(submit(r)) or futs[-1]
        report = serving.ServeDaemon(eng, signals=()).run(serving.ticked_source(reqs, per_tick=3))
        reports.append({k: report[k] for k in ("ticks", "completed", "failed")} | {
            k: report["stats"]["serving"][k] for k in ("chunks", "mid_flight_joins",
                                                       "slabs_opened", "slabs_retired")})
        results.append([f.result() for f in futs])
    assert reports[0] == reports[1] and reports[0]["completed"] == 32
    assert reports[0]["mid_flight_joins"] > 0
    for got, want in zip(*results):
        for f in got._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


def test_energy_on_card_equals_cpu(cuda):
    """``hamiltonian`` (with and without a field), ``energy_trace`` and
    ``is_local_minimum`` on the card equal the CPU exactly at N = 506 on
    5-bit couplings, and ``is_local_minimum`` also on int32 J up to 2^20."""
    rng = np.random.default_rng(506)
    n = 506
    a = rng.integers(-15, 16, (n, n))
    w = np.triu(a, 1) + np.triu(a, 1).T
    sigma = np.where(rng.random((64, n)) < 0.5, 1, -1).astype(np.int8)
    h = rng.integers(-3, 4, n).astype(np.int32)
    for j in (w.astype(np.int8), (w * 2**16).astype(np.int32)):
        jc, sc = torch.as_tensor(j), torch.as_tensor(sigma)
        jg, sg = jc.to(cuda), sc.to(cuda)
        for args in ((), (torch.as_tensor(h), 0.5)):
            gpu_args = tuple(x.to(cuda) if isinstance(x, torch.Tensor) else x for x in args)
            assert torch.equal(energy.hamiltonian(jg, sg, *gpu_args).cpu(),
                               energy.hamiltonian(jc, sc, *args))
        assert torch.equal(energy.energy_trace(jg, sg.reshape(8, 8, n)).cpu(),
                           energy.energy_trace(jc, sc.reshape(8, 8, n)))
        for lane in range(sigma.shape[0]):
            assert bool(energy.is_local_minimum(jg, sg[lane])) == bool(
                energy.is_local_minimum(jc, sc[lane]))
        settled, prev = sc[0].clone(), None
        while prev is None or not torch.equal(settled, prev):  # Hopfield: converges
            settled, prev = dyn.async_sweep(jc, settled, range(n)), settled
        assert bool(energy.is_local_minimum(jg, settled.to(cuda)))
        assert bool(energy.is_local_minimum(jc, settled))


# ---------------------------------------------------------------------------
# Row-sharded solves on a mesh that repeats the card
# ---------------------------------------------------------------------------


def _card_mesh(cuda, batch, model):
    from repro_torch.distributed import make_mesh

    return make_mesh((batch, model), devices=[cuda] * (batch * model))


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)])
@pytest.mark.parametrize("route", [dict(backend="kernel"),
                                   dict(backend="hybrid", hybrid_impl="kernel")])
@pytest.mark.parametrize("n", [48, 506])
def test_sharded_weighted_sum_on_card_equals_cpu(cuda, n, route, shape):
    """Kernel 1 (or 6) per row block on the card == the CPU's unsharded
    sum, with one launch per block and lane shard."""
    from repro_torch.distributed import ShardPlan

    rng = np.random.default_rng(n)
    w = torch.as_tensor(rng.integers(-15, 16, (n, n)).astype(np.int8))
    sigma = torch.as_tensor(np.where(rng.random((64, n)) < 0.5, 1, -1).astype(np.int8))
    cfg = dyn.ONNConfig(n=n, **route)
    want = dyn.weighted_sum(cfg, w, sigma)
    ops.reset_launches()
    with ShardPlan(*shape).context(_card_mesh(cuda, *shape)):
        got = dyn.weighted_sum(cfg, w.to(cuda), sigma.to(cuda))
    assert torch.equal(got.cpu(), want)
    name = "coupling_sum" if route["backend"] == "kernel" else "hybrid_coupling_sum"
    blocks = sum(1 for j in range(shape[1]) if j * -(-n // shape[1]) < n)
    assert ops.LAUNCHES[name] == shape[0] * blocks


@pytest.mark.parametrize("shape,multi", [((1, 4), 0), ((2, 2), 0), ((4, 1), 4)])
def test_sharded_retrieve_on_card_equals_cpu(cuda, shape, multi):
    """retrieve at N = 506 under model and data plans on the card == the CPU
    unsharded; kernel 5 runs once per lane shard and chunk under 4x1 and
    never under a model plan."""
    from repro_torch.distributed import ShardPlan, sharding

    rng = np.random.default_rng(7)
    n = 506
    xi = np.where(rng.random((20, n)) < 0.5, 1, -1).astype(np.int8)
    w = quantization.quantize_weights(torch.as_tensor(xi.T.astype(np.float32) @ xi / n)).values
    probes = xi[rng.integers(0, 20, 256)].copy()
    probes[rng.random((256, n)) < 0.2] *= -1
    cfg = dyn.ONNConfig(n=n, backend="kernel")
    want = dyn.retrieve(cfg, dyn.make_params(cfg, w, device="cpu"), torch.as_tensor(probes))
    plan, mesh = ShardPlan(*shape), _card_mesh(cuda, *shape)
    params = sharding.shard_onn_params(dyn.make_params(cfg, w, device=cuda), plan, mesh)
    ops.reset_launches()
    with plan.context(mesh):
        got = dyn.retrieve(cfg, params, torch.as_tensor(probes, device=cuda))
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    if multi:
        assert ops.LAUNCHES["phase_step_multi"] % multi == 0 and ops.LAUNCHES["phase_step_multi"]
        assert ops.LAUNCHES["coupling_sum"] == 0
    else:
        assert ops.LAUNCHES["phase_step_multi"] == 0 and ops.LAUNCHES["phase_step"] == 0
        assert ops.LAUNCHES["coupling_sum"] > 0


@pytest.mark.parametrize("shape,lanes,n", [((1, 4), 1024, 506), ((2, 4), 1024, 506),
                                           ((1, 2), 64, 506), ((1, 8), 64, 4096)])
@pytest.mark.parametrize("route", ["kernel", "hybrid"])
def test_row_block_partials_on_card_equal_plain(cuda, shape, lanes, n, route):
    """Kernels 1 and 6 on the ragged row blocks a sharded solve gives them
    (127 and 125 rows of 506 under 1x4, 253 under 1x2, 512 of 4096 under
    1x8), and kernel 1i on 8-way window blocks, == their plain versions."""
    from repro_torch.distributed import ShardPlan, sharding

    rng = np.random.default_rng([n, *shape])
    w = rng.integers(-15, 16, (n, n)).astype(np.int8)
    hybrid = {"hybrid_impl": "kernel", "parallel_factor": 32} if route == "hybrid" else {}
    cfg = dyn.ONNConfig(n=n, backend=route, **hybrid)
    plan, mesh = ShardPlan(*shape), _card_mesh(cuda, *shape)
    params = sharding.shard_onn_params(dyn.make_params(cfg, w, device=cuda), plan, mesh)
    sig = torch.as_tensor(rng.choice([-1, 1], (lanes, n)).astype(np.int8), device=cuda)
    win = torch.as_tensor(rng.integers(-15, 16, (16, 32, n)).astype(np.int8), device=cuda)
    reps = torch.as_tensor(rng.choice([-1, 1], (16, 64, n)).astype(np.int8), device=cuda)
    for w_, s_, pl in ((params.weights, sig, params.placement), (win, reps, None)):
        ops.reset_launches()
        parts = dyn.row_block_partials(cfg, w_, s_, plan, mesh, pl)
        got = torch.cat([torch.cat(ps, dim=-1) for ps in parts])
        want = (plain.hybrid_coupling_sum_ref(w_, s_, 32) if route == "hybrid"
                else plain.coupling_sum_ref(w_, s_))
        assert torch.equal(got, want)
        name = "hybrid_coupling_sum" if route == "hybrid" else "coupling_sum"
        name += "_batched" if w_.dim() == 3 else ""
        assert ops.LAUNCHES[name] == sum(len(ps) for ps in parts)


def test_sharded_maxcut_and_compressed_on_card_equal_cpu(cuda):
    """Max-Cut under 2x4 (kernel 1i per block) and the compressed wire under
    1x4 on the card == the same plans on the CPU."""
    from repro_torch.distributed import ShardPlan

    rng = np.random.default_rng(11)
    n = 64
    adj = np.triu(rng.random((4, n, n)) < 0.5, 1)
    adj = torch.as_tensor((adj + adj.transpose(0, 2, 1)).astype(np.int8))
    init = torch.as_tensor(rng.random((4, 8, n)).astype(np.float32))
    sweeps = torch.as_tensor(rng.random((4, 10, n)).astype(np.float32))
    cfg = dyn.ONNConfig(n=n, backend="kernel", max_cycles=10)
    want = ising.solve_maxcut_batch(cfg, adj, init, sweeps)
    with ShardPlan(2, 4).context(_card_mesh(cuda, 2, 4)):
        got = ising.solve_maxcut_batch(cfg, adj.to(cuda), init.to(cuda), sweeps.to(cuda))
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    w = torch.as_tensor(rng.integers(-15, 16, (n, n)).astype(np.int8))
    sig0 = torch.as_tensor(np.where(rng.random((32, n)) < 0.5, 1, -1).astype(np.int8))
    cfg = dyn.ONNConfig(n=n, backend="kernel", max_cycles=20)
    plan = ShardPlan(1, 4, compressed=True)
    from repro_torch.distributed import make_mesh

    with plan.context(make_mesh((1, 4), devices=["cpu"] * 4)):
        want = dyn.retrieve(cfg, dyn.make_params(cfg, w, device="cpu"), sig0)
    with plan.context(_card_mesh(cuda, 1, 4)):
        got = dyn.retrieve(cfg, dyn.make_params(cfg, w, device=cuda), sig0.to(cuda))
    for f in got._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


# ---------------------------------------------------------------------------
# the dense LM: card against CPU by the LM rule (tests/lm_rule.py)
# ---------------------------------------------------------------------------

LM_DENSE = ("qwen2-1.5b", "codeqwen1.5-7b", "h2o-danube-1.8b", "qwen3-4b")


def _lm_tree(model, seed):
    """Seeded weights with non-trivial biases and norm weights (CPU), and a
    VLM's gates (zero when materialized) set to ±(0.5-1.5)."""
    from repro_torch.models import params as PM

    tree = PM.materialize(model.param_specs, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        attn = tree["blocks"]["attn"]
        if name in attn:
            noise = 0.05 * torch.randn(attn[name].shape, generator=gen)
            attn[name] = (attn[name].float() + noise).to(attn[name].dtype)
    if "cross_blocks" in tree:
        cross = tree["cross_blocks"]
        for parent, name in ((cross["attn"], "gate"), (cross, "mlp_gate")):
            size = 0.5 + torch.rand(parent[name].shape, generator=gen)
            sign = torch.randint(0, 2, parent[name].shape, generator=gen) * 2 - 1
            parent[name] = (size * sign).to(parent[name].dtype)
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_DENSE)
def test_dense_lm_on_card_held_to_cpu(cuda, arch, dtype):
    """Each reduced dense arch on the card against the same weights on the
    CPU: the card's greedy stream (32-token prompts, 16 new tokens; the
    ring buffer for h2o-danube) by the LM rule."""
    from lm_rule import hold as lm_hold
    from lm_rule import stream_logits
    from repro_torch import configs as lm_configs
    from repro_torch.models import params as PM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import make_generate

    cfg = dataclasses.replace(lm_configs.get_reduced(arch), dtype=dtype)
    model = get_model(cfg)
    tree = _lm_tree(model, seed=LM_DENSE.index(arch))
    cpu = model.build_params(tree)
    card = model.build_params(PM.map_tree(lambda t: t.to(cuda), tree))
    prompts = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(7))
    stream, _ = make_generate(model)(card, {"tokens": prompts}, 16)
    lm_hold(stream, stream_logits(model, card, prompts, stream),
            stream_logits(model, cpu, prompts, stream), dtype, cfg.n_layers, f"{arch} {dtype}")


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
def test_served_lm_request_equals_make_generate_of_its_bucket_on_card(cuda, once):
    from repro_torch.engine.adapters import LMEngineSolver
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.steps import make_generate

    gen = torch.Generator().manual_seed(0)
    lm = LMEngineSolver("qwen2-1.5b", gen, device=cuda)
    assert lm.device.type == "cuda"
    prompts = launch_serve.draw_prompts(lm.cfg.vocab, 3, 32, gen)
    report, tokens = launch_serve.serve_prompts(lm, prompts, 16, gen, once=once)
    assert report["engine"] == {"slabs": 1, "pad_fraction": 0.25}
    padded = torch.cat([prompts, torch.zeros((1, 32), dtype=torch.int32)])
    direct, _ = make_generate(lm.model)(lm.params, {"tokens": padded}, 16)
    assert torch.equal(tokens, direct[:3])


LM_FAMILIES = ("granite-moe-3b-a800m", "arctic-480b", "llama-3.2-vision-11b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_moe_and_vlm_on_card_held_to_cpu(cuda, arch, dtype):
    """Each reduced MoE and VLM arch on the card against the same weights
    on the CPU (the VLM gated, with seeded vision rows): the card's greedy
    stream (32-token prompts, 16 new tokens) by the MoE rule or the LM rule;
    in float32 every MoE routing is decided."""
    import moe_rule
    from repro_torch import configs as lm_configs
    from repro_torch.models import params as PM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import make_generate

    cfg = dataclasses.replace(lm_configs.get_reduced(arch), dtype=dtype)
    model = get_model(cfg)
    tree = _lm_tree(model, seed=10 + LM_FAMILIES.index(arch))
    cpu = model.build_params(tree)
    card = model.build_params(PM.map_tree(lambda t: t.to(cuda), tree))
    prompts = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(7))
    batch = {"tokens": prompts}
    vision = None
    if cfg.family == "vlm":
        vision = torch.randn((2, cfg.n_vision_tokens, cfg.vision_dim),
                             generator=torch.Generator().manual_seed(8)).to(torch.bfloat16)
        batch["vision"] = vision
    stream, _ = make_generate(model)(card, batch, 16)
    summary = moe_rule.hold_streams(model, card, cpu, prompts, stream, vision=vision,
                                    what=f"{arch} {dtype}")
    if cfg.family == "moe" and dtype == "float32":
        assert summary["route_bound"] == 0 and summary["steps_held"] == summary["steps"]


LM_LAST_FAMILIES = ("whisper-large-v3", "zamba2-2.7b", "xlstm-1.3b")


def _seeded_lm_tree(model, seed):
    """Seeded weights (CPU) with every zeros- or ones-initialized leaf (norms,
    biases, ``a_log``, ``d_skip``, ``dt_bias``, gate biases) moved by 0.1 ·
    N(0, 1)."""
    from repro_torch.models import params as PM

    tree = PM.materialize(model.param_specs, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def seed_leaves(level, specs):
        for name, leaf in level.items():
            if isinstance(leaf, dict):
                seed_leaves(leaf, specs[name])
            elif specs[name].init != "normal":
                noise = 0.1 * torch.randn(leaf.shape, generator=gen)
                level[name] = (leaf.float() + noise).to(leaf.dtype)

    seed_leaves(tree, model.param_specs)
    return tree


def test_materialize_on_card_equals_cpu_bit_for_bit(cuda):
    """The draws are scaled and rounded on the device they land on: every
    leaf (bf16 and float32) of a tree materialized on the card has the CPU
    tree's bits."""
    from repro_torch import configs as lm_configs
    from repro_torch.models import params as PM
    from repro_torch.models.model import get_model

    specs = get_model(lm_configs.get_reduced("xlstm-1.3b")).param_specs
    on_card = PM.materialize(specs, torch.Generator().manual_seed(3), device=cuda)
    on_cpu = PM.materialize(specs, torch.Generator().manual_seed(3), device="cpu")
    for (path, a), (_, b) in zip(PM.leaves(on_card), PM.leaves(on_cpu)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, path
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_LAST_FAMILIES)
def test_encdec_zamba_and_xlstm_on_card_held_to_cpu(cuda, arch, dtype):
    """Each reduced enc-dec, Zamba and xLSTM arch on the card against the
    same weights on the CPU (whisper with 32 seeded frames): the card's greedy
    stream (32-token prompts, two SSD chunks; 16 new tokens) by the LM rule
    at ``depth(cfg)``."""
    import moe_rule
    from repro_torch import configs as lm_configs
    from repro_torch.models import params as PM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import make_generate

    cfg = dataclasses.replace(lm_configs.get_reduced(arch), dtype=dtype)
    model = get_model(cfg)
    tree = _seeded_lm_tree(model, seed=20 + LM_LAST_FAMILIES.index(arch))
    cpu = model.build_params(tree)
    card = model.build_params(PM.map_tree(lambda t: t.to(cuda), tree))
    prompts = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(7))
    batch = {"tokens": prompts}
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((2, 32, cfg.d_model),
                             generator=torch.Generator().manual_seed(8)).to(torch.bfloat16)
        batch["frames"] = frames
    stream, _ = make_generate(model)(card, batch, 16)
    moe_rule.hold_streams(model, card, cpu, prompts, stream, frames=frames, what=f"{arch} {dtype}")


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
def test_served_encdec_request_equals_make_generate_of_its_bucket_on_card(cuda, once):
    """Three whisper requests with their frames in one 4-lane slab, the
    padded lane's tokens and frames zero: each equals its rows of a direct
    ``make_generate`` of the bucket."""
    from repro_torch.engine.adapters import LMEngineSolver
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.steps import make_generate

    gen = torch.Generator().manual_seed(0)
    lm = LMEngineSolver("whisper-large-v3", gen, device=cuda)
    prompts = launch_serve.draw_prompts(lm.cfg.vocab, 3, 32, gen)
    frames = launch_serve.draw_frames(32, lm.cfg.d_model, 3, gen)
    report, tokens = launch_serve.serve_prompts(lm, prompts, 16, gen, frames=frames, once=once)
    assert report["engine"] == {"slabs": 1, "pad_fraction": 0.25}
    batch = {"tokens": torch.cat([prompts, torch.zeros((1, 32), dtype=torch.int32)]),
             "frames": torch.cat([frames, torch.zeros_like(frames[:1])])}
    direct, _ = make_generate(lm.model)(lm.params, batch, 16)
    assert torch.equal(tokens, direct[:3])


# ---------------------------------------------------------------------------
# LM training: a train step and a checkpoint, card against CPU
# ---------------------------------------------------------------------------

LM_ARCHS = LM_DENSE + LM_FAMILIES + LM_LAST_FAMILIES


def _train_batch(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32, generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((2, cfg.n_vision_tokens, cfg.vision_dim), generator=gen)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 32, cfg.d_model), generator=gen)
    return batch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_on_card_held_to_cpu(cuda, arch):
    """Every reduced arch, float32 activations: the loss and every gradient
    leaf on the card held to the CPU by ``tests/train_rule.py``, AdamW's
    update on identical gradients by its optimizer rule, and one
    ``make_train_step`` on the card (Adafactor for the MoE family, as
    ``build_cell`` picks it), its loss ``value_and_grad``'s by the loss
    rule."""
    from train_rule import hold_adamw_identical, hold_loss, hold_step
    from repro_torch import configs as lm_configs
    from repro_torch import optim
    from repro_torch.models import params as PM
    from repro_torch.models import steps
    from repro_torch.models.model import get_model

    cfg = dataclasses.replace(lm_configs.get_reduced(arch), dtype="float32")
    model = get_model(cfg)
    tree = _seeded_lm_tree(model, seed=40 + LM_ARCHS.index(arch))
    card = PM.map_tree(lambda t: t.to(cuda), tree)
    batch = _train_batch(cfg, 50 + LM_ARCHS.index(arch))
    summary, _, g_cpu = hold_step(model, card, tree, batch, f"{arch} train step")
    hold_adamw_identical(card, tree, g_cpu, f"{arch} adamw")
    name = "adafactor" if cfg.family == "moe" else "adamw"
    opt = optim.get_optimizer(name, optim.cosine_warmup(3e-4, 2000, 100_000))
    state = steps.TrainState(torch.zeros((), dtype=torch.int32, device=cuda), card,
                             opt.init(card))
    new, metrics = steps.make_train_step(model, opt)(state, batch)
    hold_loss(float(metrics["loss"]), summary["loss_card"], "float32", 0, arch)
    assert int(new.step) == 1 and all(
        torch.isfinite(v).all() for _, v in PM.leaves(new.params))


def test_checkpoint_from_card_restores_on_cpu_bit_for_bit(cuda, tmp_path):
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs as lm_configs
    from repro_torch import optim
    from repro_torch.models import params as PM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import TrainState

    model = get_model(lm_configs.get_reduced("qwen2-1.5b"))
    params = PM.materialize(model.param_specs, torch.Generator().manual_seed(3), cuda)
    opt = optim.adamw(optim.constant(1e-3))
    state = TrainState(torch.tensor(5, dtype=torch.int32, device=cuda), params, opt.init(params))
    state.opt["m"]["embed"].normal_()
    ckpt.save(str(tmp_path), 5, state, extra_meta={"data_state": {"cursor": 5, "seed": 0}})
    got = ckpt.restore(str(tmp_path), 5, state, device="cpu")
    for (k, a), (_, b) in zip(PM.leaves(got._asdict()), PM.leaves(state._asdict())):
        assert a.device.type == "cpu" and a.dtype == b.dtype, k
        assert torch.equal(a, b.cpu()), k


def test_compiled_kernels_meet_the_planners_constants(cuda):
    """Every instantiation the launch plans reach, as compiled: its static
    shared memory is the constant its planner assumes and it takes the
    plan's threads (``analysis/vmem.py``'s compiled layer)."""
    from repro_torch.analysis import vmem

    rows = vmem.check_compiled(cuda)
    assert len(rows) == 36
    assert all(r.constants_ok for r in rows), [r.render() for r in rows if not r.constants_ok]


def test_tracegate_passes_against_the_committed_budget(cuda):
    """The gate in a fresh process (its warm counts are a fresh process's)
    against ``TRACE_BUDGET_TORCH.json``, warm and steady."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.tracegate"],
                          capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Port fault 9: launches past CUDA's 65,535 grid tiles on y and z
# ---------------------------------------------------------------------------

#: Lanes past the wide tile's 65,535 × 64 = 4,194,240 lanes a launch (kernels
#: 1-4, 6, 7), instances past 65,535 (1i, 6i), kernel 8's GEMM lanes past
#: 65,535 × 128.  N is small: the grid's y and z do not depend on it.
EDGE_LANES, EDGE_INSTANCES, EDGE_QMV_LANES = 4_194_341, 65_539, 8_388_557


def _edge_windows(total, run, rows=4):
    return [(b - rows, min(total, b + rows)) for b in range(run, total, run)] + [
        (total - rows, total)]


@pytest.mark.parametrize("kernel", ["coupling_sum", "hybrid_coupling_sum", "onn_step",
                                    "phase_step", "phase_step_packed", "hybrid_phase_step"])
def test_lane_split_past_the_grid_edge(cuda, kernel):
    """Kernels 1-4, 6 and 7 over 4,194,341 lanes: two launches, each grid
    within 65,535 lane tiles; the rows on both sides of the boundary and the
    last rows equal the plain version of those rows."""
    n = 48
    gen = torch.Generator(device=cuda).manual_seed(31)
    w = torch.randint(-15, 16, (n, n), generator=gen, device=cuda, dtype=torch.int8)
    bias = torch.randint(-9, 10, (n,), generator=gen, device=cuda, dtype=torch.int32)
    sigma = torch.randint(0, 2, (EDGE_LANES, n), generator=gen, device=cuda,
                          dtype=torch.int8) * 2 - 1
    phase = torch.randint(0, 2 * HALF, (EDGE_LANES, n), generator=gen, device=cuda,
                          dtype=torch.int32)
    calls = {
        "coupling_sum": (lambda: ops.coupling_sum(w, sigma),
                         lambda s, p: plain.coupling_sum_ref(w, s), None),
        "hybrid_coupling_sum": (lambda: ops.hybrid_coupling_sum(w, sigma, parallel=32),
                                lambda s, p: plain.coupling_sum_ref(w, s), 32),
        "onn_step": (lambda: ops.onn_step(w, sigma, bias),
                     lambda s, p: plain.onn_step_ref(w, s, bias), None),
        "phase_step": (lambda: ops.phase_step(w, sigma, bias, phase, half=HALF),
                       lambda s, p: plain.phase_step_ref(w, s, bias, p, HALF), None),
        "phase_step_packed": (lambda: ops.phase_step_packed(w, bias, phase, half=HALF),
                              lambda s, p: plain.phase_step_packed_ref(w, bias, p, HALF), None),
        "hybrid_phase_step": (
            lambda: ops.hybrid_phase_step(w, sigma, bias, phase, half=HALF, parallel=32),
            lambda s, p: plain.hybrid_phase_step_ref(w, s, bias, p, HALF, 32), 32),
    }
    call, want, parallel = calls[kernel]
    plan = autotune.coupling_plan(1, EDGE_LANES, n, n, parallel)
    assert len(plan.launches) == 2 and plan.grid[1] <= autotune.MAX_GRID_YZ
    ops.reset_launches()
    got = call()
    assert sum(ops.LAUNCHES.values()) == 2
    run = autotune.MAX_GRID_YZ * plan.tile.bm
    for lo, hi in _edge_windows(EDGE_LANES, run):
        assert torch.equal(got[lo:hi], want(sigma[lo:hi], phase[lo:hi])), (kernel, lo, hi)


@pytest.mark.parametrize("parallel", [None, 32])
def test_instance_split_past_the_grid_edge(cuda, parallel):
    """Kernels 1i and 6i over 65,539 instances: two launches on the grid's
    z; the instances on both sides of the boundary equal the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    w = torch.randint(-15, 16, (EDGE_INSTANCES, 16, 40), generator=gen, device=cuda,
                      dtype=torch.int8)
    sigma = torch.randint(0, 2, (EDGE_INSTANCES, 8, 40), generator=gen, device=cuda,
                          dtype=torch.int8) * 2 - 1
    ops.reset_launches()
    got = (ops.coupling_sum(w, sigma) if parallel is None
           else ops.hybrid_coupling_sum(w, sigma, parallel=parallel))
    assert sum(ops.LAUNCHES.values()) == 2
    for lo, hi in _edge_windows(EDGE_INSTANCES, autotune.MAX_GRID_YZ):
        assert torch.equal(got[lo:hi], plain.coupling_sum_ref(w[lo:hi], sigma[lo:hi]))


def test_qmv_gemm_split_past_the_grid_edge(cuda):
    """Kernel 8's GEMM over 8,388,557 lanes: two launches on the grid's z;
    the rows on both sides of the boundary within the float32 bound of the
    plain version's exact value."""
    gen = torch.Generator(device=cuda).manual_seed(33)
    m, k = 24, 64
    wq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda, dtype=torch.int8)
    scale = torch.rand((m,), generator=gen, device=cuda)
    x = torch.randn((EDGE_QMV_LANES, k), generator=gen, device=cuda)
    ops.reset_launches()
    got = ops.quantized_matvec(wq, scale, x)
    assert ops.LAUNCHES["quantized_matvec"] == 2
    for lo, hi in _edge_windows(EDGE_QMV_LANES, autotune.MAX_GRID_YZ * autotune.QMV_GEMM_TILE):
        x64, w64 = x[lo:hi].double(), wq.double()
        exact = (x64 @ w64.T) * scale.double()
        bound = k * 2.0**-24 * scale.double() * (x64.abs() @ w64.abs().T)
        assert bool(((got[lo:hi].double() - exact).abs() <= bound).all()), (lo, hi)
