#!/usr/bin/env python3
"""Where kernel 5's time goes on the card (``csrc/phase_step_multi.cu``,
cluster regime), and how its launch plan and the A operand's home move it.

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``::

    python3 phase_step_multi_breakdown.py

It builds the kernel source as it is and in variants, and times each through
its C entry point ``onn_phase_step_multi`` by profiler device time, on the
operands of ``chip_smoke.py``'s kernel-5 row (B = 1024, N = 506, chunk 8,
a quarter of the lanes frozen, a quarter near their budget):

* ``full``: the kernel as committed;
* ``a_in_registers``: each warp keeps its 16 rows of W as mma fragments in
  registers for the whole launch (16 k32 steps, so N in (480, 512] only)
  instead of reading them from shared memory every cycle; exact, and its
  outputs are checked against ``full``'s;
* ``all_active``: no lane freezes (every lane within its budget runs all 8
  cycles); the baseline of the two variants below, whose dynamics would
  otherwise differ;
* ``all_active_no_mma``: as ``all_active`` without the products;
* ``all_active_no_exchange``: as ``all_active`` without the copy of σ into
  the peers' shared memory;
* ``no_cycles``: no cycle at all (the W slice, the lane state in and out,
  the first σ exchange and two cluster barriers).

All but ``full`` and ``a_in_registers`` give wrong outputs; only their
times are read.  ``full`` and ``a_in_registers`` are timed under every
cluster plan that fits (C CTAs of 2, 4, 8 and L lanes of 8, 16, 32), the
others under the plan ``autotune.multi_plan`` picks.  Prints the card's name
and power limit, the registers, stack and spill bytes ``ptxas -v`` reports
for the cluster instantiations of each variant, then one JSON line per
variant, plan and repeat.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

_LOOP = "  for (int cyc = 0; cyc < chunk; ++cyc) {\n    if (cyc == rescan) scan(cyc);"
_A_REGS = '''  uint32_t afr[16][4];  // this warp's rows of W as fragments, KS = 512
  {
    const int8_t* a_lo = sw + (size_t)(warp * 16 + g) * P + 4 * tq;
    const int8_t* a_hi = a_lo + 8 * P;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      afr[s][0] = ld32(a_lo + 32 * s);
      afr[s][1] = ld32(a_hi + 32 * s);
      afr[s][2] = ld32(a_lo + 32 * s + 16);
      afr[s][3] = ld32(a_hi + 32 * s + 16);
    }
  }
'''
_K_LOOP = '''      for (int k = 0; k < KS; k += 32) {
        const uint32_t a[4] = {ld32(a_lo + k), ld32(a_hi + k), ld32(a_lo + k + 16),
                               ld32(a_hi + k + 16)};
'''
_NO_FREEZE = ("    act &= ~newly;\n", "    (void)newly;\n")

#: Variant name -> (text in the source, its replacement).
VARIANTS = {
    "full": [],
    "a_in_registers": [
        (_LOOP, _A_REGS + _LOOP),
        (_K_LOOP, "#pragma unroll\n      for (int s = 0; s < 16; ++s) {\n"
                  "        const int k = 32 * s;\n        const uint32_t (&a)[4] = afr[s];\n"),
    ],
    "all_active": [_NO_FREEZE],
    "all_active_no_mma": [_NO_FREEZE, ("    if (tile_live) {\n      bool on[LT];",
                                       "    if (false) {\n      bool on[LT];")],
    "all_active_no_exchange": [_NO_FREEZE, ("    put_peers(nxt);\n", "")],
    "no_cycles": [(_LOOP, _LOOP.replace("cyc < chunk", "cyc < 0"))],
}


def build_variants(build) -> tuple:
    """One shared library per variant, built in parallel, and each one's
    ``ptxas -v`` report of its cluster instantiations."""
    from coupling_gemm_breakdown import ptxas_report

    src = open(os.path.join(build.CSRC, "phase_step_multi.cu")).read()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"phase_step_multi_breakdown: {name}: source text not found "
                                 f"once: {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        # -I: the copy includes the headers beside the committed source.
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-Xptxas", "-v",
               "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, reports = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"phase_step_multi_breakdown: nvcc failed for {name}:\n{log}")
        reports[name] = [r for r in ptxas_report(log) if "cluster" in r["kernel"]]
        lib = ctypes.CDLL(so)
        lib.onn_phase_step_multi.argtypes = build.SOURCES["phase_step_multi"]["onn_phase_step_multi"]
        lib.onn_phase_step_multi.restype = ctypes.c_int
        libs[name] = lib
    return libs, reports


def device_ms(fn, iters: int = 50):
    """Device time per call of kernel 5's cluster kernel, from a profiler trace."""
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
            if "phase_step_multi_cluster" in evt.key:
                total += evt.device_time_total
                count += evt.count
        if count == iters:
            return total / 1e3 / count
    return None


def main() -> None:
    if not torch.cuda.is_available():
        print("phase_step_multi_breakdown: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    import chip_smoke
    from repro_torch.core import oscillator as osc
    from repro_torch.kernels import autotune, build

    print(chip_smoke.nvidia_smi_line(), flush=True)
    libs, reports = build_variants(build)
    for name, rows in reports.items():
        for row in rows:
            print(json.dumps({"variant": name, "ptxas": row}), flush=True)

    # chip_smoke.py's kernel-5 operands, drawn in the same order.
    dev = torch.device("cuda")
    b, n, chunk, half, max_cycles = chip_smoke.B, chip_smoke.N, chip_smoke.CHUNK, chip_smoke.HALF, 100
    w_np, _, probes = chip_smoke.make_problem(0)
    rng = np.random.default_rng(1)
    bias = torch.as_tensor(rng.integers(-2, 3, size=n).astype(np.int32), device=dev)
    sigma = torch.as_tensor(probes, device=dev)
    phase = osc.phase_of_spin(sigma).to(torch.int32).contiguous()
    prev = osc.phase_of_spin(sigma.roll(1, 0)).to(torch.int32).contiguous()
    t = rng.integers(0, 60, size=b).astype(np.int32)
    t[b // 4: b // 2] = max_cycles - rng.integers(1, 5, size=b // 4)
    frozen = np.zeros(b, np.int32)
    frozen[: b // 4] = 1
    full = np.full(b, max_cycles, np.int32)
    zero = np.zeros(b, np.int32)
    cols = torch.as_tensor(np.stack([t, full, zero, zero, frozen, zero,
                                     np.where(frozen == 1, t, full)]), device=dev).contiguous()
    kp = autotune.padded_k(n)
    w_p = torch.nn.functional.pad(torch.as_tensor(w_np, device=dev), (0, kp - n)).contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, plan):
        outs = (torch.empty_like(phase), torch.empty_like(prev), torch.empty_like(cols))

        def call():
            rc = lib.onn_phase_step_multi(
                w_p.data_ptr(), bias.data_ptr(), phase.data_ptr(), prev.data_ptr(),
                cols.data_ptr(), *(o.data_ptr() for o in outs), b, n, kp, half, chunk,
                max_cycles, 0, *plan.args, stream)
            if rc:
                raise RuntimeError(f"onn_phase_step_multi: CUDA error {rc}")
        return call, outs

    chosen = autotune.multi_plan(b, n)
    plans = []
    for c in autotune.MULTI_CLUSTERS:
        for lanes in autotune.MULTI_CLUSTER_LANES:
            rows = autotune.multi_cluster_rows(n, c)
            smem = autotune.multi_cluster_smem_bytes(n, c, lanes)
            if rows <= autotune.MULTI_CLUSTER_MAX_ROWS and smem <= autotune.SMEM_PER_BLOCK:
                plans.append(autotune.MultiPlan(b, n, "cluster", c, lanes, rows,
                                                c * -(-b // lanes), smem))
    # a_in_registers computes what full computes: check it on the chosen plan.
    ref_call, ref_out = launcher(libs["full"], chosen)
    reg_call, reg_out = launcher(libs["a_in_registers"], chosen)
    ref_call()
    reg_call()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(ref_out, reg_out))
    print(json.dumps({"a_in_registers_equals_full": same}), flush=True)
    if not same:
        raise SystemExit("phase_step_multi_breakdown: a_in_registers differs from full")
    for repeat in range(2):
        for name, lib in libs.items():
            for plan in plans if name in ("full", "a_in_registers") else [chosen]:
                call, _ = launcher(lib, plan)
                print(json.dumps({
                    "repeat": repeat, "variant": name, "cluster": plan.cluster,
                    "lanes": plan.lanes, "rows": plan.rows, "grid": plan.grid,
                    "chosen": plan == chosen, "kernel_ms": device_ms(call)}), flush=True)


if __name__ == "__main__":
    main()
