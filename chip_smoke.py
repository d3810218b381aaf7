#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--seed 0]

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and prints one JSON line per phase:

1. ``environment``: Python, torch, CUDA and nvcc versions, the card's name
   and power limit (also printed as ``nvidia-smi`` gives them);
2. ``build``: the kernels' build time (one nvcc per source, in parallel);
3. ``kernels``: each kernel against its plain PyTorch version on the card at
   the main path's shapes (B = 1024, N = 506, chunk = 8, some lanes frozen or
   near their budget), exact equality required, with CUDA-event times of the
   kernel's wrapper, the plain version and, for the coupling sums, the
   ``torch._int_mm`` yardstick; the hybrid serialized-MAC kernels at MAC
   widths P = 1, 32 (the auto width, the row's times) and 506;
4. ``retrieve`` (twice, ``phase_pack`` off and on): ``RetrievalSolver`` at
   ``ONN_HYBRID_506`` on the kernel backend, 1024 corrupted requests on
   Hebbian 5-bit weights; the card's results must equal the CPU's lane for
   lane; then the retrieved states are checked as fixed points through the
   kernel backend's ``weighted_sum``; requests/s of a warm solve (median of
   five), and the device's busy time and idle share in one warm solve from a
   ``torch.profiler`` trace;
5. ``retrieve_hybrid``: the solver at ``ONN_HYBRID_506`` on the hybrid
   backend's kernel route (one kernel-7 launch per cycle); equal to the CPU
   lane for lane and to phase 4's kernel-backend result; requests/s, device
   busy time and idle share;
6. ``rtl`` (twice): ``ONN_HYBRID_506`` in clock-accurate rtl mode with
   ``sync_jitter``, 1024 requests, enable offsets from a seeded
   ``torch.Generator`` — the hybrid architecture on the hybrid backend
   (kernel 6 once per slow-clock edge) and the recurrent architecture on the
   kernel backend (kernel 1 once per edge); 64 lanes equal to the CPU;
   requests/s, idle share, launches per cycle; then 1024 lanes of a
   wandering problem (many chunks, period-2 orbits), every lane equal to
   the CPU;
7. ``serving``: a 64-lane slab driven by ``advance_chunk`` /
   ``install_lanes``, functional and rtl with jitter; every harvested lane
   must equal its isolated solve;
8. ``per_cycle``: ``run`` on a few lanes through the fused per-cycle kernels
   and, in rtl, with each lane's ``t0``, equal to the batched lanes, and one
   ``_chunk_fused`` settle-chunk equal to the multi-cycle kernel's.

Launch counts are set to 0 before each main-path phase (4-8) and read after
it; every kernel must have launched on a main path.  The line before the last
is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.  Any
mismatch, build failure or launch error exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

TPU_KERNELS = "src/repro/kernels/coupling_kernel.py"
ROWS = {
    # name: (source, replaces)
    "coupling_sum": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:100"),
    "phase_step": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:236"),
    "phase_step_packed": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:348"),
    "phase_step_multi": ("src/repro_torch/kernels/csrc/phase_step_multi.cu", f"{TPU_KERNELS}:520"),
    "phase_step_multi_packed": (
        "src/repro_torch/kernels/csrc/phase_step_multi.cu", f"{TPU_KERNELS}:520"
    ),
    "hybrid_coupling_sum": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:697"),
    "hybrid_phase_step": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:724"),
}

B, N, CHUNK, HALF = 1024, 506, 8, 8
#: MAC widths the hybrid kernels are held and timed at: the paper's single
#: MAC, the auto width (the row's times), one pass.
HYBRID_P, AUTO_P = (1, 32, 506), 32
#: Lanes of the rtl solves of Hebbian probes checked against the CPU (lanes
#: never read each other's rows, so a subset is an exact check); the rtl
#: solves of ``make_wandering_problem`` are checked on every lane.
RTL_CHECK_LANES = 64
#: Seeds of the wandering rtl problem's data and of its enable offsets (drawn
#: by the solver from a CPU ``torch.Generator``).
WANDER_SEED, WANDER_KEY = 7, 0
FIELDS = ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: How each kernel's device name reads in a profiler trace: (demangled,
#: mangled) fragments of its template instantiation (the hybrid kernels are
#: instantiations of the coupling GEMM; each trace holds one kernel's calls).
SYMBOLS = {
    "coupling_sum": ("coupling_gemm_kernel<0>", "coupling_gemm_kernelILi0E"),
    "phase_step": ("coupling_gemm_kernel<1>", "coupling_gemm_kernelILi1E"),
    "phase_step_packed": ("coupling_gemm_kernel<2>", "coupling_gemm_kernelILi2E"),
    "phase_step_multi": ("phase_step_multi_kernel<false", "phase_step_multi_kernelILb0E"),
    "phase_step_multi_packed": ("phase_step_multi_kernel<true", "phase_step_multi_kernelILb1E"),
    "hybrid_coupling_sum": ("coupling_gemm_kernel<0>", "coupling_gemm_kernelILi0E"),
    "hybrid_phase_step": ("coupling_gemm_kernel<1>", "coupling_gemm_kernelILi1E"),
}


def device_ms(fn, name: str, iters: int = 20):
    """Device time per call of the named hand-written kernel alone, from a
    ``torch.profiler`` trace of ``iters`` calls, each of which launches it
    once; a trace that holds fewer launches (the profiler now and then drops
    some or all) is taken again, up to three times, then None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if any(s in evt.key for s in SYMBOLS[name]):
                total_us += evt.device_time_total
                count += evt.count
        if count == iters and total_us:
            return total_us / 1e3 / iters
    return None


def solve_seconds(solve) -> float:
    """Host-clock seconds of one warm call of ``solve``, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def warm_metrics(solve, repeats: int = 5) -> dict:
    """Requests/s of the median of ``repeats`` warm solves of B requests, and
    the device's busy time and idle share in one more (profiler trace)."""
    warm = sorted(solve_seconds(solve) for _ in range(repeats))[repeats // 2]
    busy_ms, top = device_busy(solve)
    return {
        "warm_solve_s": warm, "requests_per_s": B / warm, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (warm * 1e3), "top_device_ms": top,
    }


def require_equal(got, want, what: str, lanes=None) -> None:
    """Every result field of ``got`` (optionally its first ``lanes`` lanes)
    equals ``want``'s, shape, dtype and value."""
    for f in FIELDS:
        g, c = getattr(got, f), getattr(want, f)
        if lanes is not None:
            g = g[:lanes]
        require(g.shape == c.shape and g.dtype == c.dtype, f"{what} {f}: shape/dtype")
        require(torch.equal(g.cpu(), c.cpu()), f"{what} {f}: values differ")


def device_busy(fn) -> tuple:
    """Milliseconds during which the device ran anything in one call of
    ``fn`` (the union of the device-side events' intervals in a
    ``torch.profiler`` trace), and the five largest device events by name.
    A trace with no device event (the profiler now and then records none) is
    taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans, per_name = [], {}
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            spans.append((evt.time_range.start, evt.time_range.end))
            key = evt.name[:80]
            per_name[key] = per_name.get(key, 0.0) + (evt.time_range.end - evt.time_range.start) / 1e3
        if spans:
            break
    top = dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:5])
    return union_length(spans) / 1e3, top


def union_length(spans) -> float:
    """Total length covered by a set of (start, end) intervals."""
    total, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is not None and start <= cur[1]:
            cur[1] = max(cur[1], end)
            continue
        if cur is not None:
            total += cur[1] - cur[0]
        cur = [start, end]
    return total + (0.0 if cur is None else cur[1] - cur[0])


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        g, w = g.to(torch.int64).reshape(-1), w.to(torch.int64).reshape(-1)
        require(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g - w).abs().max().item()) if g.numel() else 0)
    return err


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[-1]


def make_problem(seed: int):
    """Hebbian 5-bit couplings of 40 seeded random patterns at N = 506 and
    1024 requests: a random stored pattern with 20 % of its pixels flipped
    (most lanes settle within a few cycles, some take two settle-chunks)."""
    from repro_torch import api

    rng = np.random.default_rng(seed)
    xi = np.where(rng.random((40, N)) < 0.5, 1, -1).astype(np.int8)
    w = api.quantize_weights(api.hebbian(torch.as_tensor(xi))).values.numpy()
    target = rng.integers(0, len(xi), size=B)
    probes = xi[target].copy()
    for row in probes:
        row[rng.choice(N, size=N // 5, replace=False)] *= -1
    return w, xi[target], probes


def make_wandering_problem():
    """Couplings under which rtl lanes do everything a solve can: three
    Hebbian patterns under a random asymmetric part, and 1024 probes with
    30 % of their pixels flipped.  Some lanes settle, some enter a period-2
    orbit, most wander to the cycle budget across many settle-chunks.  The
    seed is fixed (:data:`WANDER_SEED`): with the enable offsets of
    :data:`WANDER_KEY`, lanes of both architectures cycle."""
    rng = np.random.default_rng(WANDER_SEED)
    xi = np.where(rng.random((3, N)) < 0.5, 1, -1).astype(np.int32)
    heb = np.round(15 * (xi.T @ xi) / 3).astype(np.int32)
    w = np.clip(heb // 4 + rng.integers(-20, 21, size=(N, N)), -15, 15).astype(np.int8)
    probes = xi[rng.integers(0, 3, size=B)].astype(np.int8)
    probes[rng.random((B, N)) < 0.3] *= -1
    return w, probes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)

    from repro_torch import api
    from repro_torch.configs import onn as configs
    from repro_torch.core import dynamics as dyn
    from repro_torch.core import oscillator as osc
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as plain

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. environment -------------------------------------------------------
    smi = nvidia_smi_line()
    nvcc = build.nvcc_path()
    emit({
        "phase": "environment", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc_version(nvcc), "device": kind,
        "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
        "nvidia_smi": smi,
    })
    print(smi, flush=True)

    # 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for stem in build.SOURCES:
        build.library(stem)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": list(build.SOURCES)})

    # 3. kernels against their plain versions at the main path's shapes --------
    w_np, _, probes = make_problem(args.seed)
    rng = np.random.default_rng(args.seed + 1)
    w = torch.as_tensor(w_np, device=dev)
    bias = torch.as_tensor(rng.integers(-2, 3, size=N).astype(np.int32), device=dev)
    sigma = torch.as_tensor(probes, device=dev)
    phase = osc.phase_of_spin(sigma).to(torch.int32)
    rows = {}

    def record(name, got, want, kernel_fn, plain_fn, bytes_moved, n_ops, library_ms=None):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"{name}: kernel disagrees with its plain version (max_abs_err {err})")
        b_ms, b_by = bound(bytes_moved, n_ops)
        # ms / kernel_ms: the hand-written kernel alone (profiler device time);
        # wrapper_ms: one wrapper call, operand preparation included.
        wrapper_ms = cuda_ms(kernel_fn)
        k_ms = device_ms(kernel_fn, name)
        rows[name] = {
            "name": name, "route": "cuda", "source": ROWS[name][0], "replaces": ROWS[name][1],
            "launches": 0, "exact": True, "max_abs_err": err,
            "ms": wrapper_ms if k_ms is None else k_ms,
            "ms_of": "wrapper" if k_ms is None else "kernel",
            "kernel_ms": k_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": cuda_ms(plain_fn), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
        }

    # Kernel 1, with torch._int_mm on zero-padded operands as the yardstick
    # (also the yardstick of kernel 6, which computes the same function).
    kp = -(-N // 8) * 8
    sig_p = torch.nn.functional.pad(sigma, (0, kp - N))
    w_p = torch.nn.functional.pad(w, (0, kp - N, 0, kp - N))
    lib = torch._int_mm(sig_p, w_p.t())[:, :N]
    require(torch.equal(lib, plain.coupling_sum_ref(w, sigma)), "torch._int_mm disagrees")
    int_mm_ms = cuda_ms(lambda: torch._int_mm(sig_p, w_p.t()))
    record(
        "coupling_sum", ops.coupling_sum(w, sigma), plain.coupling_sum_ref(w, sigma),
        lambda: ops.coupling_sum(w, sigma), lambda: plain.coupling_sum_ref(w, sigma),
        B * N + N * N + 4 * B * N, 2 * B * N * N, library_ms=int_mm_ms,
    )
    record(
        "phase_step",
        ops.phase_step(w, sigma, bias, phase, half=HALF),
        plain.phase_step_ref(w, sigma, bias, phase, HALF),
        lambda: ops.phase_step(w, sigma, bias, phase, half=HALF),
        lambda: plain.phase_step_ref(w, sigma, bias, phase, HALF),
        B * N + N * N + 4 * N + 4 * B * N + 4 * B * N, 2 * B * N * N,
    )
    record(
        "phase_step_packed",
        ops.phase_step_packed(w, bias, phase, half=HALF),
        plain.phase_step_packed_ref(w, bias, phase, HALF),
        lambda: ops.phase_step_packed(w, bias, phase, half=HALF),
        lambda: plain.phase_step_packed_ref(w, bias, phase, HALF),
        B * ((N + 1) // 2) + N * N + 4 * N + 4 * B * N, 2 * B * N * N,
    )
    # Kernel 5: a quarter of the lanes frozen, a quarter near their budget.
    max_cycles = 100
    t = torch.as_tensor(rng.integers(0, 60, size=B).astype(np.int32), device=dev)
    t[B // 4: B // 2] = max_cycles - torch.as_tensor(rng.integers(1, 5, size=B // 4).astype(np.int32), device=dev)
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    frozen[: B // 4] = True
    full = torch.full((B,), max_cycles, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    cols = (t, full, false, false, frozen, false, torch.where(frozen, t, full))
    prev = osc.phase_of_spin(sigma.roll(1, 0)).to(torch.int32)
    for packed in (False, True):
        name = "phase_step_multi_packed" if packed else "phase_step_multi"
        got = ops.phase_step_multi(w, bias, phase, prev, *cols, half=HALF, chunk=CHUNK,
                                   max_cycles=max_cycles, packed=packed)
        want = plain.phase_step_multi_ref(
            w, bias, phase, prev, *(c.to(torch.int32)[:, None] for c in cols),
            half=HALF, chunk=CHUNK, max_cycles=max_cycles,
        )
        lane_cycles = int((got[8] - t).sum().item())
        state_bytes = 2 * B * (((N + 1) // 2) if packed else 4 * N) + 7 * 4 * B
        record(
            name, got, [want[0], want[1], *(x[:, 0] for x in want[2:])],
            lambda p=packed: ops.phase_step_multi(w, bias, phase, prev, *cols, half=HALF,
                                                  chunk=CHUNK, max_cycles=max_cycles, packed=p),
            lambda: plain.phase_step_multi_ref(
                w, bias, phase, prev, *(c.to(torch.int32)[:, None] for c in cols),
                half=HALF, chunk=CHUNK, max_cycles=max_cycles),
            N * N + 4 * N + 2 * state_bytes, 2 * N * N * lane_cycles,
        )
        rows[name]["lane_cycles"] = lane_cycles
    # Kernels 6 and 7, held exactly at every MAC width of HYBRID_P; the row's
    # times are at the auto width, the others in "per_parallel".
    hybrid = {
        "hybrid_coupling_sum": (
            lambda p: ops.hybrid_coupling_sum(w, sigma, parallel=p),
            lambda p: plain.hybrid_coupling_sum_ref(w, sigma, p),
            B * N + N * N + 4 * B * N, int_mm_ms,
        ),
        "hybrid_phase_step": (
            lambda p: ops.hybrid_phase_step(w, sigma, bias, phase, half=HALF, parallel=p),
            lambda p: plain.hybrid_phase_step_ref(w, sigma, bias, phase, HALF, p),
            B * N + N * N + 4 * N + 4 * B * N + 4 * B * N, None,
        ),
    }
    for name, (kern, ref_fn, n_bytes, lib_ms) in hybrid.items():
        record(name, kern(AUTO_P), ref_fn(AUTO_P), lambda: kern(AUTO_P), lambda: ref_fn(AUTO_P),
               n_bytes, 2 * B * N * N, library_ms=lib_ms)
        row = rows[name]
        per_p = {}
        for p in HYBRID_P:
            if p == AUTO_P:
                per_p[str(p)] = {k: row[k] for k in ("max_abs_err", "kernel_ms", "wrapper_ms", "plain_ms")}
                continue
            got, want = kern(p), ref_fn(p)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            require(err == 0, f"{name} at P={p}: kernel disagrees with its plain version (max_abs_err {err})")
            per_p[str(p)] = {
                "max_abs_err": err, "kernel_ms": device_ms(lambda: kern(p), name),
                "wrapper_ms": cuda_ms(lambda: kern(p)),
                "plain_ms": cuda_ms(lambda: ref_fn(p), iters=5, warmup=1),
            }
        row.update(parallel=AUTO_P, per_parallel=per_p)
    emit({"phase": "kernels", "shape": {"B": B, "N": N, "chunk": CHUNK},
          "kernels": list(rows.values())})

    # 4. main path: retrieval through the solver, pack off and on ------------------
    w_np, targets, probes = make_problem(args.seed)
    launches = {k: 0 for k in ops.KERNELS}

    def drive(solve):
        """One cold call of ``solve`` with the launch counts set to 0 just
        before and read just after; returns (result, seconds, launches)."""
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path = dict(ops.LAUNCHES)
        for k, v in path.items():
            launches[k] += v
        return res, seconds, path

    results = {}
    for pack in (False, True):
        cfg = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel", phase_pack=pack)
        solver = api.RetrievalSolver(cfg, api.make_params(cfg, w_np))  # on the GPU
        cpu_solver = api.RetrievalSolver(cfg, api.make_params(cfg, w_np, device="cpu"))

        def solve_and_check(solver=solver, cfg=cfg):
            res = solver.solve(probes)
            # The retrieved states, checked as fixed points through the kernel
            # backend's weighted sum: sign(W σ + h) keeps every settled σ.
            field = api.weighted_sum(cfg, solver.params.weights, res.final_sigma) + solver.params.bias
            keeps = torch.all(api.sign_update(field, res.final_sigma) == res.final_sigma, dim=-1)
            return res, keeps

        (res, keeps), seconds, path_launches = drive(solve_and_check)
        require(bool(torch.all(keeps[res.settled])), "a settled lane is not a fixed point")
        require_equal(res, cpu_solver.solve(probes), f"retrieve (phase_pack={pack}): card != CPU")
        multi = "phase_step_multi_packed" if pack else "phase_step_multi"
        require(path_launches.get(multi, 0) > 0, f"{multi} never launched on the main path")
        require(path_launches.get("coupling_sum", 0) > 0, "coupling_sum never launched")
        correct = torch.all(res.final_sigma.cpu() == torch.as_tensor(targets), dim=-1)
        settled = res.settled.cpu()
        emit({
            "phase": "retrieve", "config": "ONN_HYBRID_506", "backend": "kernel",
            "phase_pack": pack, "requests": B, "accuracy": float(correct.float().mean()),
            "settled": int(settled.sum()), "cycled": int(res.cycled.sum()),
            "mean_settle_cycle": (
                float(res.settle_cycle.cpu()[settled].float().mean()) if settled.any() else None
            ),
            "first_call_s": seconds, **warm_metrics(lambda s=solver: s.solve(probes)),
            "launches": path_launches, "equal_to_cpu": True,
        })
        results[pack] = res

    # 5. main path: the hybrid serialized-MAC datapath, functional mode -------------
    cfg_h = dataclasses.replace(configs.ONN_HYBRID_506, backend="hybrid", hybrid_impl="kernel")
    solver = api.RetrievalSolver(cfg_h, api.make_params(cfg_h, w_np))
    res, seconds, path_launches = drive(lambda: solver.solve(probes))
    require(path_launches.get("hybrid_phase_step", 0) > 0,
            "hybrid_phase_step never launched on the hybrid main path")
    cpu_res = api.RetrievalSolver(cfg_h, api.make_params(cfg_h, w_np, device="cpu")).solve(probes)
    require_equal(res, cpu_res, "retrieve_hybrid: card != CPU")
    require_equal(res, results[False], "retrieve_hybrid: hybrid != kernel backend")
    settled = res.settled.cpu()
    emit({
        "phase": "retrieve_hybrid", "config": "ONN_HYBRID_506", "backend": "hybrid",
        "hybrid_impl": "kernel", "parallel": cfg_h.hybrid_parallel,
        "passes": cfg_h.hybrid_passes, "requests": B,
        "accuracy": float(torch.all(res.final_sigma.cpu() == torch.as_tensor(targets), dim=-1)
                          .float().mean()),
        "settled": int(settled.sum()), "first_call_s": seconds,
        **warm_metrics(lambda: solver.solve(probes)), "launches": path_launches,
        "equal_to_cpu": True, "equal_to_kernel_backend": True,
    })

    # 6. main path: clock-accurate rtl with enable jitter, both architectures -------
    rtl = {}
    for arch, route, kernel in (
        ("hybrid", dict(backend="hybrid", hybrid_impl="kernel"), "hybrid_coupling_sum"),
        ("recurrent", dict(backend="kernel"), "coupling_sum"),
    ):
        cfg_r = dataclasses.replace(configs.ONN_HYBRID_506, mode="rtl", sync_jitter=True,
                                    architecture=arch, **route)
        solver = api.RetrievalSolver(cfg_r, api.make_params(cfg_r, w_np))

        def key():
            return torch.Generator(device=dev).manual_seed(args.seed)

        res, seconds, path_launches = drive(lambda: solver.solve(probes, key=key()))
        clocks = cfg_r.clocks_per_cycle
        per_chunk = clocks * dyn.resolve_chunk(cfg_r)
        n_launch = path_launches.get(kernel, 0)
        require(n_launch > 0, f"rtl {arch}: {kernel} never launched on the rtl path")
        require(n_launch % per_chunk == 0, f"rtl {arch}: {n_launch} launches, not whole chunks")
        # The solver's own draw, repeated: each lane's enable offset.
        t0 = torch.randint(0, clocks, (B,), generator=key(), device=dev, dtype=torch.int32)
        cpu_res = dyn.retrieve(cfg_r, api.make_params(cfg_r, w_np, device="cpu"),
                               torch.as_tensor(probes[:RTL_CHECK_LANES]),
                               t0=t0[:RTL_CHECK_LANES].cpu())
        require_equal(res, cpu_res, f"rtl {arch}: card != CPU", lanes=RTL_CHECK_LANES)
        # The wandering problem, every lane against the CPU: many chunks, and
        # lanes that settle, cycle or run out their budget.
        w_wd, probes_wd = make_wandering_problem()
        solver_wd = api.RetrievalSolver(cfg_r, api.make_params(cfg_r, w_wd))
        wd, wd_seconds, wd_launches = drive(
            lambda: solver_wd.solve(probes_wd, key=torch.Generator().manual_seed(WANDER_KEY)))
        cpu_wd = api.RetrievalSolver(cfg_r, api.make_params(cfg_r, w_wd, device="cpu")).solve(
            probes_wd, key=torch.Generator().manual_seed(WANDER_KEY))
        require_equal(wd, cpu_wd, f"rtl {arch} wandering: card != CPU")
        wd_cycles = wd_launches.get(kernel, 0) // clocks
        require(wd_cycles > dyn.resolve_chunk(cfg_r), f"rtl {arch} wandering: one chunk only")
        require(bool(wd.cycled.any()), f"rtl {arch} wandering: no lane entered a period-2 orbit")
        wandering = {
            "requests": B, "lanes_checked": B, "settled": int(wd.settled.sum()),
            "cycled": int(wd.cycled.sum()), "cycles_stepped": wd_cycles,
            "first_call_s": wd_seconds, "launches": wd_launches,
        }
        settled = res.settled.cpu()
        emit({
            "phase": "rtl", "config": "ONN_HYBRID_506", "architecture": arch, **route,
            "sync_jitter": True, "requests": B, "lanes_checked": RTL_CHECK_LANES,
            "accuracy": float(torch.all(res.final_sigma.cpu() == torch.as_tensor(targets), dim=-1)
                              .float().mean()),
            "settled": int(settled.sum()), "cycled": int(res.cycled.sum()),
            "mean_settle_cycle": (
                float(res.settle_cycle.cpu()[settled].float().mean()) if settled.any() else None
            ),
            "cycles_stepped": n_launch // clocks, "launches_per_cycle": clocks,
            "first_call_s": seconds, **warm_metrics(lambda: solver.solve(probes, key=key())),
            "launches": path_launches, "equal_to_cpu": True, "wandering": wandering,
        })
        rtl[arch] = (cfg_r, res, t0)

    # 7. serving loop: a 64-lane slab, mid-flight installs, functional and rtl -------
    def serve(cfg, params, phase0, isolated, n_req, t0=None):
        slab = 64
        state = dyn.dead_batch_state(cfg, slab)
        pending, slot_of, harvested, ticks = list(range(n_req)), {}, 0, 0
        while harvested < n_req:
            done = dyn.batch_done(cfg, state).cpu()
            busy = set(slot_of.values())
            free = [s for s in range(slab) if bool(done[s]) and s not in busy]
            if pending and free:
                take = free[: min(len(free), 16 if ticks else slab)]
                reqs, pending = pending[: len(take)], pending[len(take):]
                take = take[: len(reqs)]
                sub = dyn.init_batch_state(cfg, phase0[reqs], t0=None if t0 is None else t0[reqs])
                state = dyn.install_lanes(state, sub, take)
                slot_of.update(zip(reqs, take))
            state = dyn.advance_chunk(cfg, params, state)
            ticks += 1
            done = dyn.batch_done(cfg, state).cpu()
            res = dyn.batch_result(cfg, state)
            for req, s in list(slot_of.items()):
                if bool(done[s]):
                    for f in FIELDS:
                        require(torch.equal(getattr(res, f)[s], getattr(isolated, f)[req]),
                                f"serving: request {req} field {f} != its isolated solve")
                    del slot_of[req]
                    harvested += 1
            require(ticks < 2000, "serving loop did not drain")
        return {"slab": slab, "requests": n_req, "ticks": ticks}

    cfg = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel")
    params = api.make_params(cfg, w_np)
    phase0 = dyn.initial_phase(cfg, torch.as_tensor(probes, device=dev))
    report, _, path_launches = drive(lambda: serve(cfg, params, phase0, results[False], 256))
    require(path_launches.get("phase_step_multi", 0) > 0, "serving: multi kernel never launched")
    emit({"phase": "serving", "mode": "functional", **report, "launches": path_launches,
          "equal_to_isolated": True})
    cfg_rh, res_rh, t0_rh = rtl["hybrid"]
    params_rh = api.make_params(cfg_rh, w_np)
    report, _, path_launches = drive(lambda: serve(cfg_rh, params_rh, phase0, res_rh, 128, t0_rh))
    require(path_launches.get("hybrid_coupling_sum", 0) > 0,
            "serving rtl: hybrid_coupling_sum never launched")
    emit({"phase": "serving", "mode": "rtl", "sync_jitter": True, **report,
          "launches": path_launches, "equal_to_isolated": True})

    # 8. per-cycle route: run() through kernels 3, 4 and, in rtl, 6; one fused chunk --
    def per_cycle():
        lanes = [0, 1, 2]
        for pack in (False, True):
            cfg_p = dataclasses.replace(cfg, phase_pack=pack)
            for lane in lanes:
                one = dyn.run(cfg_p, params, phase0[lane])
                for f in FIELDS:
                    require(torch.equal(getattr(one, f), getattr(results[pack], f)[lane]),
                            f"run lane {lane} field {f} != run_batch (phase_pack={pack})")
        for lane in lanes[:2]:
            one = dyn.run(cfg_rh, params_rh, phase0[lane], t0=int(t0_rh[lane]))
            for f in FIELDS:
                require(torch.equal(getattr(one, f), getattr(res_rh, f)[lane]),
                        f"rtl run lane {lane} field {f} != the batched lane")
        state = dyn.init_batch_state(cfg, phase0)
        fused = dyn._chunk_fused(cfg, params, state, CHUNK)
        multi = dyn._chunk_multi(cfg, params, state, CHUNK)
        for a, b_ in zip(fused, multi):
            require(torch.equal(a, b_), "_chunk_fused != _chunk_multi")
        return {"lanes": len(lanes), "rtl_lanes": 2}

    report, _, path_launches = drive(per_cycle)
    for k in ("phase_step", "phase_step_packed", "hybrid_coupling_sum"):
        require(path_launches.get(k, 0) > 0, f"per-cycle route: {k} never launched")
    emit({"phase": "per_cycle", **report, "launches": path_launches, "equal_to_batch": True})

    for name, row in rows.items():
        row["launches"] = launches[name]
        require(row["launches"] > 0, f"{name} was never launched on the main path")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
