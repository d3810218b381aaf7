#!/usr/bin/env python3
"""Where the coupling GEMM's time goes on the card (``csrc/coupling_gemm.cu``
and, for kernels 1 and 2 at large shapes, ``csrc/coupling_wgmma.cu``).

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``::

    python3 coupling_gemm_breakdown.py [--wgmma-only]

It builds the kernel source as it is and in four variants, each with one
part of the K loop taken out (their outputs are wrong; only their time is
read), and times each through its C entry point ``onn_coupling_sum`` (kernel
1) by profiler device time:

* ``full``: the kernel as committed;
* ``no_copies``: no ``cp.async`` (the ring is never filled);
* ``no_realign``: no realigning pass (the mma reads stale tiles);
* ``no_mma``: no fragment reads or ``mma.sync``;
* ``epilogue``: no K-steps at all (launch, partial-sum exchange, stores).

at five shapes: the main path's (B, M, N) = (1024, 506, 506) (wide tile),
(1024, 512, 512) (rows on 16 bytes), the Max-Cut instance shape
16 × (64, 506) · (32, 506) (split tile), and (1024, 4096, 4096) and
(1024, 2048, 2048), at and below the work at which
``autotune.coupling_route`` hands kernels 1 and 2 to the wgmma regime.
The differences between variants say what each part adds; the parts do
not overlap in time if the differences add up to the full time.  Prints the card's name and power
limit, the registers, stack and spill bytes that ``ptxas -v`` reports for
each instantiation of the committed source (one JSON line each),
``torch._int_mm`` on the main shape as a yardstick, and one JSON line per
shape and repeat.

The wgmma regime (``coupling_wgmma.cu``, entry ``onn_coupling_wgmma``) is
built as it is and in four variants, timed the same way on its own plans
(``autotune.wgmma_plan``), operands already in rows TMA reads:

* ``full``: the kernel as committed;
* ``no_stores``: the epilogue's rounds skipped (no shared-memory pass, no
  store; its outputs are wrong);
* ``no_mma``: no ``wgmma`` (the ring still fills and empties);
* ``no_bias``, ``no_ties`` (STEP): no bias loads, no read of the kept spin
  on a tie.

at the ONN dry run's two ``onn_131072`` shares, (1024, 8192, 8192) and
(1024, 512, 131072) (split into 8 K slices), at 1,048,576 lanes of
N = 506 and 640 (a quarter of the grid-edge rows), and at the route's
threshold (1024, 4096, 4096) and a quarter of it, SUM and STEP, each
beside ``torch._int_mm`` on the same operands (K padded to 16, M to 8);
with the ``ptxas -v`` line of each instantiation, and the wrapper's row
copy of σ at N = 506 (``ops._tma_rows``) with its bytes a second.
``--wgmma-only`` skips the mma.sync variants.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Variant name -> (text in the source, its replacement).
VARIANTS = {
    "full": [],
    "no_copies": [
        ("        copy_chunk(dst, ca, q, chunks, lo, hi);\n", ""),
        ("        if (q == CHUNKS - 1) copy_chunk(dst, ca, CHUNKS, chunks, lo, hi);  // the ninth\n",
         ""),
    ],
    "no_realign": [
        ("    if (t + 1 < steps) realign(t + 1);\n", ""),
        ("    realign(0);\n", ""),
    ],
    "no_mma": [("    for (int s = 0; s < BK / 32; ++s) {", "    for (int s = 0; s < 0; ++s) {")],
    "epilogue": [("  const int steps = N > 0 ? (N + span - 1) / span * per_unit : 0;",
                  "  const int steps = 0;")],
}


def ptxas_report(log: str) -> list:
    """Per kernel in an ``nvcc -Xptxas -v`` log: its (demangled) name,
    registers per thread, stack frame and spill bytes."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append({"kernel": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and rows:
            rows[-1].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    demangler = shutil.which("c++filt")
    if demangler and rows:
        names = subprocess.run([demangler], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            for row, name in zip(rows, names):
                row["kernel"] = name
    return rows


#: The wgmma regime's variants: name -> (text in the source, its replacement).
WGMMA_VARIANTS = {
    "full": [],
    "no_stores": [("        __syncwarp();\n#pragma unroll\n        for (int jj = 0;",
                   "        if (M > 0) continue;\n#pragma unroll\n        for (int jj = 0;")],
    "no_mma": [("          wgmma_s8_n256(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);\n",
                "          ;\n")],
    # STEP's epilogue: no bias loads (h = 0), no read of the kept spin
    "no_bias": [("          h0 = live ? bias[i] : 0;\n          h1 = two ? bias[i + 1] : 0;\n",
                 "")],
    "no_ties": [("          if (ties) {\n", "          if (false) {\n")],
}


def build_variants(build, stem: str = "coupling_gemm", variants=None, entry=None) -> tuple:
    """One shared library per variant of ``stem``'s source, built in
    parallel; and the ``ptxas -v`` report of the committed source (the
    ``full`` variant)."""
    variants = VARIANTS if variants is None else variants
    entry = "onn_coupling_sum" if entry is None else entry
    src = open(os.path.join(build.CSRC, f"{stem}.cu")).read()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"coupling_gemm_breakdown: {name}: source text not found: {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        # -I: the copy includes the headers beside the committed source.
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas", "-v",
               "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, report = {}, []
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"coupling_gemm_breakdown: nvcc failed for {name}:\n{log}")
        if name == "full":
            report = ptxas_report(log)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, entry)
        fn.argtypes = build.SOURCES[stem][entry]
        fn.restype = ctypes.c_int
        libs[name] = lib
    shutil.rmtree(tmp, ignore_errors=True)
    return libs, report


def device_ms(fn, iters: int = 100, key: str = "coupling_gemm_kernel"):
    """Device time per call of the named kernel, from a profiler trace.  The
    profiler drops some records late in a long process, so a trace that
    holds fewer than half the calls, or more, is taken again, up to three
    times, then None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for evt in prof.key_averages():
            if key in evt.key:
                total += evt.device_time_total
                count += evt.count
        if iters // 2 <= count <= iters and total:
            return total / 1e3 / count
    return None


def wgmma_breakdown(build, dev, spins, weights, repeats: int = 2) -> None:
    """The wgmma regime's variants at its shapes, beside ``torch._int_mm``."""
    import chip_smoke
    from repro_torch.kernels import autotune, ops

    libs, report = build_variants(build, "coupling_wgmma", WGMMA_VARIANTS, "onn_coupling_wgmma")
    for row in report:
        print(json.dumps({"ptxas": row}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {  # label: (b, m, n)
        "baseline2d_1024x8192x8192": (1024, 8192, 8192),
        "rowpar_1024x512x131072": (1024, 512, 131072),
        "edge_quarter_1048576x506": (1_048_576, 506, 506),
        "edge_quarter_1048576x640": (1_048_576, 640, 640),
        # coupling_route's work threshold (B M N = 2^34) and a quarter of it,
        # which the route leaves to the wide tile (timed below beside it)
        "threshold_1024x4096x4096": (1024, 4096, 4096),
        "below_1024x2048x2048": (1024, 2048, 2048),
    }
    for label, (b, m, n) in shapes.items():
        s, wt = spins(b, n), weights(m, n)
        s_t, w_t = ops._tma_rows(s, n), ops._tma_rows(wt, n)
        h = torch.zeros(m, dtype=torch.int32, device=dev)
        kp, mp = -(-n // 16) * 16, -(-m // 8) * 8
        s_p = torch.nn.functional.pad(s, (0, kp - n))
        w_p = torch.nn.functional.pad(wt, (0, kp - n, 0, mp - m))
        modes = ("coupling_sum", "onn_step") if m == n else ("coupling_sum",)
        if n % 16:  # the wrapper's row copy of σ, by CUDA events
            copy_ms = chip_smoke.cuda_ms(lambda: ops._tma_rows(s, n), iters=10)
            moved = b * n + b * s_t.stride(0)
            print(json.dumps({"shape": label, "row_copy_ms": copy_ms, "bytes": moved,
                              "bytes_per_s": moved / copy_ms * 1e3}), flush=True)
        for repeat in range(repeats):
            int_mm = chip_smoke.cuda_ms(lambda: torch._int_mm(s_p, w_p.t()), iters=10)
            for mode in modes:
                plan = autotune.wgmma_plan(mode, b, m, n)
                out = torch.zeros((b, m), dtype=torch.int32 if mode == "coupling_sum"
                                  else torch.int8, device=dev)
                times = {}
                for name, lib in libs.items():
                    if mode == "coupling_sum" and name in ("no_bias", "no_ties"):
                        continue  # STEP's epilogue only
                    def call(lib=lib):
                        rc = lib.onn_coupling_wgmma(
                            ops.GEMM_MODES[mode], s_t.data_ptr(), s_t.stride(0), w_t.data_ptr(),
                            w_t.stride(0), h.data_ptr(), out.data_ptr(), b, m, n, *plan.args,
                            stream)
                        if rc:
                            raise RuntimeError(f"onn_coupling_wgmma: CUDA error {rc}")
                    times[name] = device_ms(call, iters=10, key="coupling_wgmma_kernel")
                print(json.dumps({"repeat": repeat, "shape": label, "mode": mode,
                                  "plan": plan.args, "kernel_ms": times,
                                  "int_mm_ms": int_mm}), flush=True)
        del s, wt, s_t, w_t, s_p, w_p
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        print("coupling_gemm_breakdown: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    import chip_smoke
    from repro_torch.kernels import autotune, build

    print(chip_smoke.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    # A timing script: the same operands in every run, so runs compare.
    g = torch.Generator(device=dev).manual_seed(0)  # repro-lint: disable=RPT001

    def spins(*shape):
        return torch.randint(0, 2, shape, generator=g, device=dev, dtype=torch.int8) * 2 - 1

    def weights(*shape):
        return torch.randint(-15, 16, shape, generator=g, device=dev, dtype=torch.int8)

    wgmma_breakdown(build, dev, spins, weights)
    if "--wgmma-only" in sys.argv[1:]:
        return
    libs, report = build_variants(build)
    for row in report:
        print(json.dumps({"ptxas": row}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {  # label: (inst, b, m, n, sigma, w)
        "1024x506x506": (1, 1024, 506, 506, spins(1024, 506), weights(506, 506)),
        "1024x512x512": (1, 1024, 512, 512, spins(1024, 512), weights(512, 512)),
        "16x64x32x506": (16, 64, 32, 506, spins(16, 64, 506), weights(16, 32, 506)),
        # the wide tile at the wgmma regime's threshold and below it
        "1024x4096x4096": (1, 1024, 4096, 4096, spins(1024, 4096), weights(4096, 4096)),
        "1024x2048x2048": (1, 1024, 2048, 2048, spins(1024, 2048), weights(2048, 2048)),
    }
    sig, w = shapes["1024x506x506"][4:]
    sig_p = torch.nn.functional.pad(sig, (0, 6))
    w_p = torch.nn.functional.pad(w, (0, 6, 0, 6))
    for repeat in range(2):
        int_mm = chip_smoke.cuda_ms(lambda: torch._int_mm(sig_p, w_p.t()), iters=100)
        print(json.dumps({"repeat": repeat, "int_mm_ms_1024x506x506": int_mm}), flush=True)
        for label, (inst, b, m, n, s, wt) in shapes.items():
            out = torch.empty((inst, b, m), dtype=torch.int32, device=dev)
            plan = autotune.coupling_plan(inst, b, m, n)
            times = {}
            for name, lib in libs.items():
                def call(lib=lib):
                    rc = lib.onn_coupling_sum(s.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                              inst, b, m, n, *plan.args, stream)
                    if rc:
                        raise RuntimeError(f"onn_coupling_sum: CUDA error {rc}")
                times[name] = device_ms(call)
            print(json.dumps({"repeat": repeat, "shape": label, "tile": plan.tile.name,
                              "kernel_ms": times}), flush=True)


if __name__ == "__main__":
    main()
