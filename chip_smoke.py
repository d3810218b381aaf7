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
   kernel's wrapper, the plain version and, for the coupling sum, the
   ``torch._int_mm`` yardstick;
4. ``retrieve`` (twice, ``phase_pack`` off and on): ``RetrievalSolver`` at
   ``ONN_HYBRID_506`` on the kernel backend, 1024 corrupted requests on
   Hebbian 5-bit weights; the card's results must equal the CPU's lane for
   lane; then the retrieved states are checked as fixed points through the
   kernel backend's ``weighted_sum``; requests/s of a warm solve (median of
   five), and the device's busy time and idle share in one warm solve from a
   ``torch.profiler`` trace;
5. ``serving``: a 64-lane slab driven by ``advance_chunk`` / ``install_lanes``;
   every harvested lane must equal its isolated ``retrieve``;
6. ``per_cycle``: ``run`` on a few lanes through the fused per-cycle kernels,
   equal to the batched lanes, and one ``_chunk_fused`` settle-chunk equal to
   the multi-cycle kernel's.

Launch counts are set to 0 before each main-path phase (4-6) and read after
it; every kernel must have launched on that path.  The line before the last
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
}

B, N, CHUNK, HALF = 1024, 506, 8, 8
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
#: mangled) fragments of its template instantiation.
SYMBOLS = {
    "coupling_sum": ("coupling_gemm_kernel<0>", "coupling_gemm_kernelILi0E"),
    "phase_step": ("coupling_gemm_kernel<1>", "coupling_gemm_kernelILi1E"),
    "phase_step_packed": ("coupling_gemm_kernel<2>", "coupling_gemm_kernelILi2E"),
    "phase_step_multi": ("phase_step_multi_kernel<false", "phase_step_multi_kernelILb0E"),
    "phase_step_multi_packed": ("phase_step_multi_kernel<true", "phase_step_multi_kernelILb1E"),
}


def device_ms(fn, name: str, iters: int = 20):
    """Device time per call of the named hand-written kernel alone, from a
    ``torch.profiler`` trace of ``iters`` calls; None if the trace holds no
    device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if any(s in evt.key for s in SYMBOLS[name]):
            total_us += evt.device_time_total
            count += evt.count
    if count == 0 or total_us == 0.0:
        return None
    return total_us / 1e3 / iters


def solve_seconds(solver, probes) -> float:
    """Host-clock seconds of one warm solve, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(probes)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_busy(fn) -> tuple:
    """Milliseconds during which the device ran anything in one call of
    ``fn`` (the union of the device-side events' intervals in a
    ``torch.profiler`` trace), and the five largest device events by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    # Kernel 1, with torch._int_mm on zero-padded operands as the yardstick.
    kp = -(-N // 8) * 8
    sig_p = torch.nn.functional.pad(sigma, (0, kp - N))
    w_p = torch.nn.functional.pad(w, (0, kp - N, 0, kp - N))
    lib = torch._int_mm(sig_p, w_p.t())[:, :N]
    require(torch.equal(lib, plain.coupling_sum_ref(w, sigma)), "torch._int_mm disagrees")
    record(
        "coupling_sum", ops.coupling_sum(w, sigma), plain.coupling_sum_ref(w, sigma),
        lambda: ops.coupling_sum(w, sigma), lambda: plain.coupling_sum_ref(w, sigma),
        B * N + N * N + 4 * B * N, 2 * B * N * N,
        library_ms=cuda_ms(lambda: torch._int_mm(sig_p, w_p.t())),
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
    emit({"phase": "kernels", "shape": {"B": B, "N": N, "chunk": CHUNK},
          "kernels": list(rows.values())})

    # 4. main path: retrieval through the solver, pack off and on ------------------
    w_np, targets, probes = make_problem(args.seed)
    launches = {k: 0 for k in ops.KERNELS}
    results = {}
    for pack in (False, True):
        cfg = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel", phase_pack=pack)
        solver = api.RetrievalSolver(cfg, api.make_params(cfg, w_np))  # on the GPU
        cpu_solver = api.RetrievalSolver(cfg, api.make_params(cfg, w_np, device="cpu"))
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(probes)
        # The retrieved states, checked as fixed points through the kernel
        # backend's weighted sum: sign(W σ + h) keeps every settled σ.
        field = api.weighted_sum(cfg, solver.params.weights, res.final_sigma) + solver.params.bias
        keeps = torch.all(api.sign_update(field, res.final_sigma) == res.final_sigma, dim=-1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path_launches = dict(ops.LAUNCHES)
        require(bool(torch.all(keeps[res.settled])), "a settled lane is not a fixed point")
        want = cpu_solver.solve(probes)
        for f in FIELDS:
            g, c = getattr(res, f), getattr(want, f)
            require(g.shape == c.shape and g.dtype == c.dtype, f"retrieve {f}: shape/dtype")
            require(torch.equal(g.cpu(), c), f"retrieve {f}: card != CPU (phase_pack={pack})")
        multi = "phase_step_multi_packed" if pack else "phase_step_multi"
        require(path_launches.get(multi, 0) > 0, f"{multi} never launched on the main path")
        require(path_launches.get("coupling_sum", 0) > 0, "coupling_sum never launched")
        for k, v in path_launches.items():
            launches[k] += v
        warm = sorted(solve_seconds(solver, probes) for _ in range(5))[2]  # median
        busy_ms, top = device_busy(lambda: solver.solve(probes))
        correct = torch.all(res.final_sigma.cpu() == torch.as_tensor(targets), dim=-1)
        settled = res.settled.cpu()
        emit({
            "phase": "retrieve", "config": "ONN_HYBRID_506", "backend": "kernel",
            "phase_pack": pack, "requests": B, "accuracy": float(correct.float().mean()),
            "settled": int(settled.sum()), "cycled": int(res.cycled.sum()),
            "mean_settle_cycle": (
                float(res.settle_cycle.cpu()[settled].float().mean()) if settled.any() else None
            ),
            "first_call_s": seconds, "warm_solve_s": warm, "requests_per_s": B / warm,
            "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (warm * 1e3),
            "top_device_ms": top, "launches": path_launches, "equal_to_cpu": True,
        })
        results[pack] = res

    # 5. serving loop: a 64-lane slab, mid-flight installs --------------------------
    cfg = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel")
    params = api.make_params(cfg, w_np)
    phase0 = dyn.initial_phase(cfg, torch.as_tensor(probes, device=dev))
    isolated = results[False]
    slab, n_req = 64, 256
    ops.reset_launches()
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
            sub = dyn.init_batch_state(cfg, phase0[reqs])
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
                            f"serving: request {req} field {f} != its isolated retrieve")
                del slot_of[req]
                harvested += 1
        require(ticks < 2000, "serving loop did not drain")
    torch.cuda.synchronize()
    path_launches = dict(ops.LAUNCHES)
    require(path_launches.get("phase_step_multi", 0) > 0, "serving: multi kernel never launched")
    for k, v in path_launches.items():
        launches[k] += v
    emit({"phase": "serving", "slab": slab, "requests": n_req, "ticks": ticks,
          "launches": path_launches, "equal_to_isolated": True})

    # 6. per-cycle route: run() through kernels 3 and 4, one fused chunk ---------------
    ops.reset_launches()
    lanes = [0, 1, 2]
    for pack in (False, True):
        cfg_p = dataclasses.replace(cfg, phase_pack=pack)
        for lane in lanes:
            one = dyn.run(cfg_p, params, phase0[lane])
            for f in FIELDS:
                require(torch.equal(getattr(one, f), getattr(results[pack], f)[lane]),
                        f"run lane {lane} field {f} != run_batch (phase_pack={pack})")
    state = dyn.init_batch_state(cfg, phase0)
    fused = dyn._chunk_fused(cfg, params, state, CHUNK)
    multi = dyn._chunk_multi(cfg, params, state, CHUNK)
    for a, b_ in zip(fused, multi):
        require(torch.equal(a, b_), "_chunk_fused != _chunk_multi")
    torch.cuda.synchronize()
    path_launches = dict(ops.LAUNCHES)
    for k in ("phase_step", "phase_step_packed"):
        require(path_launches.get(k, 0) > 0, f"per-cycle route: {k} never launched")
    for k, v in path_launches.items():
        launches[k] += v
    emit({"phase": "per_cycle", "lanes": len(lanes), "launches": path_launches,
          "equal_to_batch": True})

    for name, row in rows.items():
        row["launches"] = launches[name]
        require(row["launches"] > 0, f"{name} was never launched on the main path")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
