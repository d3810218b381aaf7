#!/usr/bin/env python3
"""Where the coupling GEMM's time goes on the card (``csrc/coupling_gemm.cu``).

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``::

    python3 coupling_gemm_breakdown.py

It builds the kernel source as it is and in four variants, each with one
part of the K loop taken out (their outputs are wrong; only their time is
read), and times each through its C entry point ``onn_coupling_sum`` (kernel
1) by profiler device time:

* ``full``: the kernel as committed;
* ``no_copies``: no ``cp.async`` (the ring is never filled);
* ``no_realign``: no realigning pass (the mma reads stale tiles);
* ``no_mma``: no fragment reads or ``mma.sync``;
* ``epilogue``: no K-steps at all (launch, partial-sum exchange, stores).

at three shapes: the main path's (B, M, N) = (1024, 506, 506) (wide tile),
(1024, 512, 512) (rows on 16 bytes) and the Max-Cut instance shape
16 × (64, 506) · (32, 506) (split tile).  The differences between variants
say what each part adds; the parts do not overlap in time if the
differences add up to the full time.  Prints the card's name and power
limit, the registers, stack and spill bytes that ``ptxas -v`` reports for
each instantiation of the committed source (one JSON line each),
``torch._int_mm`` on the main shape as a yardstick, and one JSON line per
shape and repeat.
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


def build_variants(build) -> tuple:
    """One shared library per variant, built in parallel; and the ``ptxas
    -v`` report of the committed source (the ``full`` variant)."""
    src = open(os.path.join(build.CSRC, "coupling_gemm.cu")).read()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"coupling_gemm_breakdown: {name}: source text not found: {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, cu]
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
        lib.onn_coupling_sum.argtypes = build.SOURCES["coupling_gemm"]["onn_coupling_sum"]
        lib.onn_coupling_sum.restype = ctypes.c_int
        libs[name] = lib
    return libs, report


def device_ms(fn, iters: int = 100):
    """Device time per call of the coupling GEMM kernel, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if "coupling_gemm_kernel" in evt.key:
            total += evt.device_time_total
            count += evt.count
    return total / 1e3 / count if count == iters else None


def main() -> None:
    if not torch.cuda.is_available():
        print("coupling_gemm_breakdown: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    import chip_smoke
    from repro_torch.kernels import autotune, build

    print(chip_smoke.nvidia_smi_line(), flush=True)
    libs, report = build_variants(build)
    for row in report:
        print(json.dumps({"ptxas": row}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def spins(*shape):
        return torch.randint(0, 2, shape, generator=g, device=dev, dtype=torch.int8) * 2 - 1

    def weights(*shape):
        return torch.randint(-15, 16, shape, generator=g, device=dev, dtype=torch.int8)

    shapes = {  # label: (inst, b, m, n, sigma, w)
        "1024x506x506": (1, 1024, 506, 506, spins(1024, 506), weights(506, 506)),
        "1024x512x512": (1, 1024, 512, 512, spins(1024, 512), weights(512, 512)),
        "16x64x32x506": (16, 64, 32, 506, spins(16, 64, 506), weights(16, 32, 506)),
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
