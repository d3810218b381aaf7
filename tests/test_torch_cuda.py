"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Needs a CUDA device and ``nvcc``; every test takes the ``cuda``
fixture and skips without a GPU.  It imports neither ``jax`` nor ``repro``,
so it runs on the GPU machine as it is::

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Every output is an integer and must be exactly equal (tolerance 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import dynamics as dyn
from repro_torch.kernels import ops
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


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,b", [(1, 2), (47, 9), (506, 1024)])
def test_multi_kernel_matches_plain(cuda, n, b, packed):
    max_cycles, chunk = 20, 8
    rng = np.random.default_rng(n * b)
    w, bias, _, _ = _inputs(n, b, seed=n * b + 1, device=cuda)
    phase = torch.as_tensor(np.where(rng.random((b, n)) < 0.5, 0, HALF), device=cuda)
    prev = torch.as_tensor(np.where(rng.random((b, n)) < 0.5, 0, HALF), device=cuda)
    t = rng.integers(0, max_cycles + 1, size=b).astype(np.int32)
    t[: b // 2] = max_cycles - rng.integers(1, 4, size=b // 2)  # budget expiry mid-chunk
    frozen = rng.random(b) < 0.25
    full = np.full((b,), max_cycles, np.int32)
    cols = dict(t=t, settle_cycle=full, settled=np.zeros(b, bool), cycled=np.zeros(b, bool),
                frozen=frozen, frozen_p2=frozen & (rng.random(b) < 0.5),
                freeze_cycle=np.where(frozen, t, full).astype(np.int32))
    flags = [torch.as_tensor(cols[c], device=cuda) for c in COLS]
    got = ops.phase_step_multi(w, bias, phase, prev, *flags, half=HALF, chunk=chunk,
                               max_cycles=max_cycles, packed=packed)
    want = plain.phase_step_multi_ref(
        w, bias, phase, prev, *(f.to(torch.int32)[:, None] for f in flags),
        half=HALF, chunk=chunk, max_cycles=max_cycles,
    )
    for g, r in zip(got, want):
        assert torch.equal(g.to(torch.int32).reshape(-1), r.reshape(-1))


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
