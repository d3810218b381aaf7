#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--seed 0]

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and prints one JSON line per phase:

1. ``environment``: Python, torch, CUDA and nvcc versions, the card's name
   and power limit (also printed as ``nvidia-smi`` gives them);
2. ``build``: the kernels' build time (one nvcc per source, in parallel;
   each source's seconds to its nvcc's end in ``seconds_by_source``), and
   ``ptxas``: the registers, stack and spill bytes of each instantiation
   of kernel 5 (``csrc/phase_step_multi.cu``) from ``nvcc -Xptxas -v``;
3. ``kernels``: each kernel against its plain PyTorch version on the card at
   the main path's shapes (B = 1024, N = 506, chunk = 8, some lanes frozen or
   near their budget), exact equality required, with CUDA-event times of the
   kernel's wrapper, the plain version and, for the coupling sums, the
   ``torch._int_mm`` yardstick; the hybrid serialized-MAC kernels at MAC
   widths P = 1, 32 (the auto width, the row's times) and 506; the spin
   update ``onn_step`` (ties forced in 64 lanes); the quantized product
   ``quantized_matvec`` at (B, M, K) = (1024, 506, 506) on per-row quantized
   Hebbian weights and at (8, 4096, 4096), each element within the float32
   summation bound of the exact value, two calls bit-identical, with its
   launch plan, against one ``torch.matmul`` on pre-dequantized weights,
   and at the ragged (65, 100, 333) and (1, 3, 40) within the bound (not
   timed); the coupling sums with an instance axis at the
   Max-Cut shape (16 instances, 64 replicas, 32-row slabs, P = 32); the
   rows of the coupling GEMM's kernels 1, 2 and 6 (and their instance-axis
   rows) carry the launch plan of ``autotune.coupling_plan``: tile, grid,
   stages, K walk, load path; the rows of kernel 5 (packed and not) carry
   ``autotune.multi_plan``'s (regime, cluster, lanes, rows, grid, shared
   memory, and the clusters the card holds at once) and ``per_regime``:
   the cluster regime at the main shape and the stream regime at
   (B, N) = (256, 2048) on seeded Hebbian couplings, each exact; and the
   row ``coupling_wgmma``: kernels 1 and 2 in the wgmma regime
   (``csrc/coupling_wgmma.cu``, which ``autotune.coupling_route`` gives
   them at large shapes) at ``WGMMA_SHAPES``, the ``onn_131072``
   ``baseline2d`` share (1024, 8192, 8192) and a ragged (1000, 5000, 5000),
   each exact (kernel 2 with ties forced in 64 lanes), with its plan and
   ``torch._int_mm`` on padded operands as the yardstick (``per_mode``);
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
   ``_chunk_fused`` settle-chunk equal to the multi-cycle kernel's;
9. ``kernel_api``: the kernel library's entry points
   (``repro_torch.kernels.onn_step``, ``quantized_matvec``) on the phase-3
   operands, equal to (within the bound of) what phase 3 checked;
10. ``maxcut`` (twice: the kernel backend, kernel 1, and the hybrid backend's
   kernel route at the auto P, kernel 6): ``MaxCutSolver`` on 16 seeded
   Erdős–Rényi graphs at N = 506, 64 replicas, 64 sweeps, 16 groups,
   stagnation 16; every field equal to the CPU solve with the same uniforms
   and the two backends equal; instances/s of a warm solve, device busy time
   and idle share, the field kernel's share, launches per sweep, sweeps run
   and the mean cut ratio against a random assignment; and one
   ``async_sweep`` at N = 506 equal to the CPU;
11. ``engine`` (five lines): the serving engine (``repro_torch.engine``)
   through ``Engine.install`` / ``submit`` / ``drain`` and
   ``as_engine_solver``, every future read.  ``retrieval`` on the kernel
   backend: 1024 lanes in seeded requests of 1-8 lanes at ``ONN_HYBRID_506``,
   the default batch buckets, N padded to 512 (``"pow2"``) and then served
   at 506 (``"exact"``); every request equal to ``RetrievalSolver.solve`` of
   its rows on the card under both policies, and to those rows of phase 4's
   solve (equal to the CPU's); requests/s and lanes/s of a warm drain
   (median of five) against the direct solve's lanes/s, slabs, pad fraction,
   device busy time and idle share, and kernel 5 alone at (128, 512), equal
   to its plain version, with its device time and plan.
   ``retrieval_hybrid``: the same on the hybrid backend's kernel route
   (kernel 7, P = 32), 256 lanes.  ``rtl``: rtl with ``sync_jitter`` on both
   architectures (kernel 6, kernel 1), 64 lanes, each request's generator
   seeded, equal to ``RetrievalSolver.solve`` with a generator of the same
   seed and to the CPU's solve on the offsets that generator gives.
   ``maxcut``: the 16 graphs of phase 10 and two at n = 300, all in the 512
   bucket, 64 replicas, 64 sweeps, stagnation 16, each request's CPU
   generator seeded; on the kernel backend every field equal to
   ``MaxCutSolver.solve`` of that instance with a generator of the same
   seed, and two such solves (n = 506, n = 300) equal to the CPU's; on the
   hybrid route equal to the kernel backend's; the field kernel alone at
   the slab's shape (32 instances x 64 replicas x 32 rows x 512) equal to
   its plain version; instances/s of a warm drain and launches per sweep.
   ``hot_swap``: ``Engine.hot_swap`` to a second Hebbian matrix; the next
   drain equals the direct solve on the new weights.
12. ``daemon`` (five lines) and ``train``: the serve daemon
   (``repro_torch.serving``) on a ``ContinuousEngine`` (root generator seed
   0, 128-lane slabs, tenants alpha 2 and beta 1) with phase 4's weights on
   the kernel backend (``mem``) and Max-Cut as in phase 11 (``cuts``).
   ``closed``: phase 11's 228 retrieval requests with Max-Cut instances 0
   (n = 506) and 16 (n = 300) at positions 76 and 152, tenants seeded,
   eight requests a tick; every request equal to its rows of phase 4's
   result or to phase 11's CPU solve, requests joining live slabs; one cold
   run, three warm (requests/s, lanes/s, latency mean/p50/p99, host ms per
   tick, mean slab occupancy), one traced (idle share).  ``open``: the same
   stream on Poisson arrivals at half the closed rate.  ``drain``: the
   retrieval stream, ticked until a request joins a live slab, then
   ``finish_in_flight``: queued requests rejected, in-flight ones equal.
   ``hot_swap``: ``HotSwap.install`` of phase 11's second Hebbian matrix
   while a slab is live; requests before it equal phase 4's rows, after it
   the solve on the new weights.  ``train``: ``train_doi`` at N = 506 on
   phase 4's 40 patterns, on the card and the CPU, held to each other by
   the DO-I rule (``tests/doi_rule.py``); then ``install(..., xi=...)``
   trains on the card and 128 probes through the daemon equal the isolated
   solve.  ``mixed_stream``: ``install_mixed_workloads`` (DO-I on 7x6 and
   10x10 on the card, held to the CPU by the rule) and 64 requests of
   ``mixed_requests``, each equal to its isolated solve.
13. ``launchers`` (six lines): the ONN launchers on the card at the widest
   letter set, 22x22 (N = 484).  ``retrieve_cli`` three times, through
   ``repro_torch.launch.retrieve``'s ``build_solver`` (DO-I on the card, held
   to the CPU's by the DO-I rule) and ``serve_requests``' two halves
   (``draw_requests``, ``serve_corrupted``, seed 0, 25 % corruption): the
   kernel backend (kernel 5), 1024 requests under "pow2" (N 512) and
   "exact" (484); the hybrid backend's kernel route (kernel 7), 256
   requests; rtl on the recurrent architecture (kernel 1), 64 requests.
   Every request's spins, settle cycle and settled flag, and the report's
   accuracy, mean settle cycles and timeouts, equal the CPU's serve on the
   same weights and draws; requests/s of the first and a warm serve, slabs,
   pad fraction, launches.  ``train_onn``: ``run_train_serve`` at 22x22,
   128 probes, the kernel backend, QAT: converged, trained accuracy not
   below the Hebbian, one hot swap, no kernel built and no plan made after
   it, every probe completed, the checkpoint (reference route names) loaded
   back, the trained weights held to the CPU's by the DO-I rule; card and
   CPU seconds.  ``energy``: ``hamiltonian`` on phase 4's 1024 final states
   with its couplings at N = 506, ``is_local_minimum`` on 64 of them and
   ``energy_trace`` of an 8-step ``step`` trajectory of 8 lanes, each equal
   to the CPU.  ``examples``: ``examples/torch_quickstart.py`` in a
   subprocess on the card prints ``retrieved correctly: True``.
14. ``sharded`` (eleven lines): the row-sharded path of
   ``repro_torch.distributed`` on meshes that repeat the card (one card:
   every cross-device copy is a no-op).  ``retrieve`` under plans 1x4, 2x2,
   4x1 and 2x4: phase 4's 1024 probes at ``ONN_HYBRID_506`` on the kernel
   route, every field of every lane equal to phase 4's unsharded result;
   kernel 1 once per row block (and lane shard) a cycle under the model
   plans, kernel 5 once per lane shard a chunk under 4x1; per-block W
   bytes, first and warm solve seconds.  ``retrieve_hybrid``: kernel 6 at
   P = 32 under 1x4.  ``rtl``: phase 6's recurrent rtl with jitter on 64
   lanes under 1x2, kernel 1 twice an edge.  ``n4096``: Hebbian 5-bit
   couplings of 200 patterns at N = 4096, 1024 probes, under 1x8 (kernel 1
   eight times a cycle on 2 MiB blocks) equal to the unsharded solve
   (kernel 5), both timed, with the card's name and power limit.
   ``maxcut``: phase 10's 16 graphs under 2x4, kernel 1i eight times an
   update group, equal to phase 10.  ``compressed``: the int8 wire under
   1x4, equal to the CPU's run of the same plan, the lanes that differ from
   the exact path counted; the small field (N = 40, ``weight_bits`` 2)
   equal to the exact path.  ``daemon``: phase 12's request stream through
   ``ServeDaemon`` under 1x2, every request equal to its solve.
   ``launcher``: ``launch.retrieve``'s serve under 1x4, equal to the
   unsharded serve, the report with ``mesh_devices`` 4 and ``shard_plan``.
15. ``lm`` (fifteen lines): the LM serving path (``repro_torch.models``, the
   ``"lm"`` engine workload, ``repro_torch.launch.serve``), which runs
   plain PyTorch and none of the kernels above (``ported_kernel_launches``
   0).  ``serve``: qwen2-1.5b at full width (28 layers, 1.777 B parameters,
   bf16, random weights from ``--seed``) built as ``serve(...,
   reduced=False)`` builds it, serving the launcher's defaults (4 requests
   of 32-token prompts, 16 new tokens) through the daemon and through
   ``--once``: equal tokens, each request equal to a direct
   ``make_generate`` of the same 4-lane bucket; prefill and decode seconds,
   tokens/s and wall seconds of the warm serve (the ``--once`` one, the
   second at its batch), parameter bytes, peak memory, the idle share (the
   device time of the bucket's ``make_generate``, the one call a served
   slab makes, traced on the device alone, over the warm wall), and the decode
   step's ms against its bound ((weight bytes +
   KV bytes read) at 3.35 TB/s).  ``serve_batch128``: the same model with
   128 requests of 512-token prompts and 64 new tokens (the widest batch
   bucket), the same fields and equality.  ``cpu_check``: the ``serve``
   run's 4 streams held to a CPU copy of the card model by the LM rule
   (``tests/lm_rule.py``, bf16, all 28 layers), with the CPU seconds.
   ``serve_moe`` and ``serve_moe_batch128``: granite-moe-3b-a800m at full
   width (32 layers, 40 experts, top-8, 3.37 B parameters) with the same
   traffic, fields and equalities; TF32 must be off (the router is a
   float32 product).  ``cpu_check_moe``: the ``serve_moe`` streams held to a
   CPU copy by the MoE rule (``tests/moe_rule.py``, bf16, all 32 layers:
   tie-bound routings, steps held), and one float32 prefill of the same
   prompts on the same weights, card against CPU, every routing decided and
   the logits within the LM rule's τ.  ``serve_vlm``: llama-3.2-vision-11b
   at full width (40 layers, 8 of them gated cross-attention, 9.81 B
   parameters), the ``serve`` traffic with each request's 1601 × 7680 bf16
   vision rows.  ``cpu_check_vlm``: its streams held to a CPU copy by the
   LM rule with the materialized (zero) gates, under which another vision
   leaves the card's prefill logits bit-equal; then with the gates set
   non-zero on both copies, under which it moves them, a new stream held
   again (both fresh, cut streams: 2 requests × 8 tokens, and 1 × 4
   gated).  ``serve_encdec``: whisper-large-v3 at full width (32 encoder and
   32 decoder layers, 1.536 B parameters) with the ``serve`` traffic, each
   request with 32 bf16 frames of 1280 drawn after the prompts (the
   launcher's default; the decode's 1500 cross slots hold 32 real ones,
   reference fault 7); ``serve_encdec_1500``: 32 requests of 1500 frames
   (a 30 s window, no padded slot) and 16-token prompts, 64 new tokens;
   ``cpu_check_encdec``: the ``serve_encdec`` streams and the first 30 s
   request's own one-lane stream held to a CPU copy by the LM rule at depth
   64.  ``serve_zamba`` and ``serve_zamba_batch128``: zamba2-2.7b at full
   width (54 Mamba2 layers and 9 invocations of the shared block, 2.42 B
   parameters), 4 requests of 256-token prompts (one SSD chunk) and 16 new
   tokens, and 128 × 512 with 64 new; ``cpu_check_zamba`` at depth 63.
   ``serve_xlstm``, ``serve_xlstm_batch128`` and ``cpu_check_xlstm``:
   xlstm-1.3b at full width (42 mLSTM and 6 sLSTM blocks, 2.55 B
   parameters), the same traffic; the LM rule's ratios at depth 48 are
   reported and miss τ (the model compounds rounding from block to block,
   ROADMAP.md section 3, port fault 5), so the line is held block by block:
   every block, card against CPU, on identical inputs.  ``archs``: the ten archs at
   their reduced sizes (llama-3.2-vision gated, whisper with 32 frames),
   card against CPU on the same weights, float32 and bfloat16, by the LM
   rule at ``lm_rule.depth`` or the MoE rule.  The archs run in the order
   qwen2-1.5b, whisper-large-v3, llama-3.2-vision-11b,
   granite-moe-3b-a800m, zamba2-2.7b, xlstm-1.3b; each after the first is
   built (its weights drawn on one host core) while the previous arch's
   CPU check runs on the other cores; its ``build_s`` is that overlapped
   time.

16. ``train`` (four lines): LM training (``repro_torch.launch.train``,
   ``models/steps.py`` ``make_train_step``, ``repro_torch.optim``,
   ``repro_torch.checkpoint``), plain PyTorch that runs none of the kernels
   above.  ``train_full``: qwen2-1.5b at full width (bf16, ``remat``)
   trained through ``launch.train.train(..., reduced=False)`` on train_4k's
   sequence length (4096) at one card's share of its global batch (8 of
   256, ``reduced``), in ``auto_microbatches`` (2) microbatches, AdamW, one
   warm-up and two timed steps (five before the script gained phase 20
   and ``dryrun_share``: the depth cut that keeps it inside its time
   limit): losses finite and falling, step ms
   (median), tokens/s, the model FLOPs (6 · non-embedding parameters ·
   tokens, and the causal attention's) against their time at 989 TFLOP/s,
   the AdamW update's ms (CUDA events) against its bytes, peak memory, and
   the idle share of one warm step (profiler: its busy time over its own
   wall time) with its top device ops; no checkpoint at this size.
   ``train_check``: the same width cut to 2 layers (``depth_cut``),
   float32, TF32 off, one 2 × 256 batch: the loss
   and every gradient leaf card against CPU by ``tests/train_rule.py``, and
   AdamW's update on identical gradients by its optimizer rule.
   ``train_archs``: the ten reduced archs, float32, card against CPU by the
   same rule, and one ``make_train_step`` each (Adafactor for the MoE
   family).  ``train_resume``: reduced qwen2 through the launcher on the
   card, 6 steps uninterrupted, and 6 steps preempted (SIGTERM) after step
   3 and resumed from the checkpoint: the losses within the float32 loss
   rule; the checkpoint, and a state held on the card saved by the async
   writer, restore on the CPU bit for bit.

17. ``dryrun``: the LM dry run (``repro_torch.launch.dryrun``): each cell
   counts one device's program (``models/tp.py``) on the meta device.
   ``dryrun_train_full``: the cell of phase 16's own step (qwen2-1.5b, 8 ×
   4096, 2 microbatches, AdamW, a 1 × 1 mesh), counted in a process of its
   own beside phase 16 (:func:`count_train_full`): its argument bytes equal
   the bytes of phase 16's live
   ``TrainState`` and batch exactly, its predicted peak (arguments plus
   temporaries) lies within ``DRYRUN_PEAK_TOLERANCE`` of ``train_full``'s
   ``max_memory_allocated``, its counted FLOPs beside the model FLOPs and
   its roofline bound beside the measured step.  ``dryrun_production``:
   qwen2-1.5b train_4k on both production meshes, qwen2-1.5b decode_32k,
   h2o-danube-1.8b long_500k and arctic-480b train_4k (``DRYRUN_CLI_CELLS``
   through the CLI, in processes of their own, started before phase 16 so
   that they count on the host's idle cores while the card trains), each
   with its three roofline terms, dominant term, per-device bytes,
   ``fits``, the segment that holds its peak and its collectives in two
   parts (the parameters', the tensor-parallel hooks').
   ``dryrun_share``: device (0, 0)'s program of the first of those cells
   (qwen2-1.5b train_4k single: its blocks over the 16-way model axis, the
   FSDP leaves whole, 16 × 4096 tokens in 4 microbatches, AdamW) run on the
   card at full width and depth, one step with every collective the
   identity: its argument bytes equal the live tensors', the count's
   predicted peak within ``DRYRUN_PEAK_TOLERANCE`` of
   ``max_memory_allocated``, the step's ms against the roofline's card
   terms, its hooks' calls beside the count's.

18. ``dryrun_onn``: the ONN dry run (``run_onn_cell``).  ``count``: the ten
   cells (``onn_131072`` × 2 meshes × 4 variants, ``onn_506`` × 2 meshes)
   on the meta device, roofline terms, per-device bytes, ``fits``, no float
   tensor counted; ``refused``: the row layouts at ``onn_506``.  ``share``:
   device (0, 0)'s program of the single-pod ``onn_131072`` ``baseline2d``
   and ``rowpar`` cells (kernel 1) and of ``onn_506`` (kernel 2) on the
   card, its collectives the identity: argument bytes equal the live
   tensors', the predicted peak within ``DRYRUN_PEAK_TOLERANCE`` of the
   sweep's ``max_memory_allocated``, the roofline terms beside the sweep's
   time, the kernel's and the wrapper's ms at the share's shape beside
   ``torch._int_mm`` (on operands zero-padded to multiples of 8) and its
   bound, the first cycle equal to the plain version on the CPU; each
   share's launches by regime (``ops.REGIME_LAUNCHES``: the ``onn_131072``
   shares take the wgmma regime, ``onn_506`` the wide tile) and the plan.
   ``composed``: each variant's programs on a (2, 4) mesh of the card
   repeated (N = 4096, 256 lanes), the collectives done for real, equal
   after 32 cycles to the unsharded sweep of kernel 2.

19. ``analysis``: the tooling (``repro_torch.analysis``).  ``vmem_static``:
   every plan of ``autotune.iter_buckets``' grid within the card's shared
   memory, residency, grid and cluster limits, and each kernel's tightest
   plan; ``vmem_compiled``: each compiled instantiation those plans reach
   (registers, local bytes, static shared memory, most threads, occupancy)
   against what its planner assumes; a miss of a constant exits non-zero.
   ``tracegate``: ``python -m repro_torch.analysis.tracegate`` in a fresh
   process (started beside phase 15's enc-dec CPU check, while the card
   idles, and waited for before the VLM's serve: ``tracegate_joined``, an
   ``analysis`` line printed there, gives their seconds and the wait)
   passes against the committed ``TRACE_BUDGET_TORCH.json``, warm and
   steady, and the same with ``--inject-retrace`` fails on
   ``retrieve.steady``; each workload's deltas, the scheduler's syncs a
   slab tick, and which calls torch counts as waits on the card.

20. ``launch_edges`` (port fault 9): kernels 3, 4, 6 and 7 at N = 506 over
   4,194,341 lanes (two launches: 65,535 wide tiles and 2), kernels 1 and
   2 there in one launch of the wgmma regime, kernel 1 again at N = 640 (σ
   and S past 2³¹ elements; wgmma), kernels 1i and 6i over 65,539
   instances, kernel 8's GEMM over 8,388,557 lanes, each through its
   wrapper: every launch's grid within 65,535 on y and z, the rows on both
   sides of every boundary and the last rows equal to the plain version of
   those rows (kernel 8: within its bound), the call's device ms by CUDA
   events; then ``MaxCutSolver.solve`` over 65,539 instances, its instances
   on both sides of the edge equal to the CPU's solve of those instances
   alone.  Each affected kernel's row gains ``edge``, with the regime
   that ran.

Launch counts are set to 0 before each main-path phase (4-18) and read after
it; every kernel must have launched on a main path, and each row of the
``kernels`` line carries the launches of phase 12 as ``launches_daemon``, of
phase 13 as ``launches_launchers``, of phase 14 as ``launches_sharded``, of
phase 15 as ``launches_lm``, of phase 16 as ``launches_train``, of phase
17 as ``launches_dryrun`` (the last two must be 0), of phase 18 as
``launches_dryrun_onn`` (above 0 for kernels 1 and 2 and their wgmma row alone) and of phase
19's gate run (both passes) as ``launches_tracegate`` (above 0 for kernel 5)
and of phase 20 as ``launches_edges``.  The row ``coupling_wgmma`` counts
the wgmma regime's launches of kernels 1 and 2 (``ops.REGIME_LAUNCHES``;
they count under ``coupling_sum`` and ``onn_step`` too): above 0 on the
main path and in phase 18, through its ``onn_131072`` shares.
The line before the last
is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.  Any
mismatch, build failure or launch error exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), defined
#: once beside the dry run's roofline.
from repro_torch.launch.hlo_analysis import (  # noqa: E402
    H100_BF16_FLOPS_PER_S as BF16_FLOPS_PER_S,
    H100_FP32_FLOPS_PER_S as FP32_FLOPS_PER_S,
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_INT8_OPS_PER_S as INT8_OPS_PER_S,
)

TPU_KERNELS = "src/repro/kernels/coupling_kernel.py"
ROWS = {
    # name: (source, replaces)
    "coupling_sum": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:100"),
    "onn_step": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:161"),
    "phase_step": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:236"),
    "phase_step_packed": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:348"),
    "phase_step_multi": ("src/repro_torch/kernels/csrc/phase_step_multi.cu", f"{TPU_KERNELS}:520"),
    "phase_step_multi_packed": (
        "src/repro_torch/kernels/csrc/phase_step_multi.cu", f"{TPU_KERNELS}:520"
    ),
    "hybrid_coupling_sum": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:697"),
    "hybrid_phase_step": ("src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:724"),
    "quantized_matvec": (
        "src/repro_torch/kernels/csrc/quantized_matvec.cu", f"{TPU_KERNELS}:805"
    ),
    "coupling_sum_batched": (
        "src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:100"
    ),
    "hybrid_coupling_sum_batched": (
        "src/repro_torch/kernels/csrc/coupling_gemm.cu", f"{TPU_KERNELS}:697"
    ),
    # kernels 1 and 2 at large shapes (SUM replaces :100, STEP :161)
    "coupling_wgmma": ("src/repro_torch/kernels/csrc/coupling_wgmma.cu", f"{TPU_KERNELS}:100"),
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
#: The Max-Cut cell: instances, replicas, sweeps, stagnation, settle-chunk;
#: the update groups resolve to 16 (``stagger_groups`` 0).
MC_INSTANCES, MC_REPLICAS, MC_SWEEPS, MC_STAGNATION, MC_CHUNK = 16, 64, 64, 16, 8
#: The engine phase: lanes of its retrieval requests on the kernel route, on
#: the hybrid route and in rtl; the most lanes of one request; the true n of
#: the two Max-Cut requests beside the 16 graphs at N; warm drains timed
#: (retrieval, Max-Cut).
ENGINE_LANES, ENGINE_HYBRID_LANES, ENGINE_RTL_LANES = 1024, 256, 64
ENGINE_MAX_REQUEST_LANES, ENGINE_SMALL_N = 8, 300
ENGINE_REPEATS, ENGINE_MC_REPEATS = 5, 3
#: The daemon lines: a streaming slab's lanes, the tenants and their weights,
#: requests per tick of the closed run, the stream positions of the two
#: Max-Cut requests, warm closed runs timed, the open run's sleep between
#: idle ticks, the requests after the hot swap, of the trained workload and
#: of the mixed stream.
DAEMON_SLAB, DAEMON_TENANTS, DAEMON_PER_TICK = 128, (("alpha", 2.0), ("beta", 1.0)), 8
DAEMON_MC_AT, DAEMON_REPEATS, DAEMON_IDLE_SLEEP_S = (76, 152), 3, 0.0005
DAEMON_SWAP_REQUESTS, DAEMON_TRAINED_REQUESTS, MIXED_REQUESTS = 64, 128, 64
#: Phase 13, the launchers: the widest letter set (22x22, N = 484), its
#: requests (kernel 5, kernel 7, rtl), corruption and seed, the probes of
#: ``train_onn``; the energy checks' lanes of ``is_local_minimum`` and the
#: ``step`` trajectory's lanes and steps.
LAUNCH_DATASET, LAUNCH_CORRUPTION, LAUNCH_SEED, LAUNCH_PROBES = "22x22", 0.25, 0, 128
LAUNCH_REQUESTS, LAUNCH_HYBRID_REQUESTS, LAUNCH_RTL_REQUESTS = 1024, 256, 64
ENERGY_MIN_LANES, ENERGY_TRACE_LANES, ENERGY_TRACE_STEPS = 64, 8, 8
#: Phase 14: the oscillator count of the wall-breaker solve (W row-sharded 8
#: ways) and the launcher's requests.
SHARDED_N, SHARDED_LAUNCH_REQUESTS = 4096, 256
#: Phase 15, the LM: the dense, MoE and VLM archs served at full width;
#: (requests, prompt tokens, new tokens) of the launcher's defaults and of the
#: engine's widest batch bucket; the archs held card against CPU at their
#: reduced sizes.
LM_ARCH, LM_MOE_ARCH, LM_VLM_ARCH = "qwen2-1.5b", "granite-moe-3b-a800m", "llama-3.2-vision-11b"
LM_ENCDEC_ARCH, LM_ZAMBA_ARCH, LM_XLSTM_ARCH = "whisper-large-v3", "zamba2-2.7b", "xlstm-1.3b"
LM_SERVE, LM_BATCH128 = (4, 32, 16), (128, 512, 64)
#: Whisper's 30 s windows: requests and new tokens, each request with
#: ENCDEC_DECODE_MEMORY_LEN frames and ENCDEC_PREFILL_PROMPT_LEN prompt tokens.
LM_ENCDEC_1500 = (32, 64)
#: Zamba's and xLSTM's small batch: prompts of one SSD chunk (ssm_chunk 256).
LM_SSM_SERVE = (4, 256, 16)
#: The depth cut of an earlier LM line that keeps the script inside its time
#: limit (listed in its line's ``depth_cut``): (streams, new tokens) of
#: ``cpu_check_vlm``'s fresh zero-gate and gated streams (the served 4 × 16
#: before).
LM_VLM_ZERO_CUT, LM_VLM_GATED_CUT = (2, 8), (1, 4)
#: Phase 16, LM training: qwen2-1.5b trained at full width on train_4k's
#: sequence length at one card's share of its global batch (steps: one
#: warm-up, then timed); ``train_check``'s cut (layers, batch, sequence);
#: ``train_resume``'s steps and the step whose end brings the preemption.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_GLOBAL_BATCH, TRAIN_STEPS = 4096, 8, 256, 3
TRAIN_CHECK = (2, 2, 256)
TRAIN_RESUME_STEPS, TRAIN_PREEMPT_AFTER = 6, 3
#: Phase 17, the LM dry run: the production cells counted by
#: ``python -m repro_torch.launch.dryrun`` processes, (arch, shape, mesh);
#: the tolerance of the predicted peak against ``train_full``'s.
DRYRUN_CLI_CELLS = (("qwen2-1.5b", "train_4k", "single"), ("qwen2-1.5b", "train_4k", "multi"),
                    ("qwen2-1.5b", "decode_32k", "single"),
                    ("h2o-danube-1.8b", "long_500k", "single"),
                    ("arctic-480b", "train_4k", "single"))
DRYRUN_CLI_TIMEOUT_S = 300
DRYRUN_PEAK_TOLERANCE = 0.15
#: ``dryrun_share``: the production cell (arch, shape, mesh) whose device
#: (0, 0) runs its program on the card: ``DRYRUN_CLI_CELLS``' first.
DRYRUN_SHARE_CELL = DRYRUN_CLI_CELLS[0]
#: Phase 20, ``launch_edges``: past CUDA's 65,535 tiles on the grid's y and
#: z.  N and the lanes of kernels 1-4, 6 and 7 (the wide tile's 64-lane runs
#: end at 4,194,240); the instance axis's instances and per-instance
#: (lanes, rows, N); kernel 8's GEMM lanes (runs of 8,388,480) and (M, K);
#: the Max-Cut solve past 65,535 instances: (instances, N, replicas,
#: sweeps), and how many instances on each side of the edge the CPU solves;
#: the rows compared on each side of every boundary and at the end.
EDGE_N, EDGE_LANES = 506, 4_194_341
#: Kernel 1 once more at a width where σ and S hold more than 2³¹ elements
#: (4,194,341 × 640 = 2.68e9): the kernel's offsets are 64-bit.
EDGE_WIDE_N = 640
EDGE_INSTANCES, EDGE_INSTANCE_SHAPE = 65_539, (64, 32, 64)
EDGE_QMV_LANES, EDGE_QMV_MK = 8_388_557, (64, 64)
EDGE_MAXCUT, EDGE_MAXCUT_CPU = (65_539, 8, 4, 4), 4
EDGE_ROWS = 4
#: Phase 18, the ONN dry run: the cells counted (cell, multi_pod, variant);
#: the single-pod shares run on the card (cell, variant); the composed
#: sweeps' N, lanes and (data, model) mesh.
DRYRUN_ONN_CELLS = tuple(
    [("onn_131072", mp, v) for v in ("baseline2d", "rowpar", "rowpar_bitpack", "rowpar_bp_int4")
     for mp in (False, True)] + [("onn_506", mp, "baseline2d") for mp in (False, True)])
DRYRUN_ONN_SHARES = (("onn_131072", "baseline2d"), ("onn_131072", "rowpar"),
                     ("onn_506", "baseline2d"))
DRYRUN_ONN_COMPOSED = (4096, 256, (2, 4))
LM_DENSE = ("qwen2-1.5b", "codeqwen1.5-7b", "h2o-danube-1.8b", "qwen3-4b")
LM_FAMILIES = ("granite-moe-3b-a800m", "arctic-480b", "llama-3.2-vision-11b",
               "whisper-large-v3", "zamba2-2.7b", "xlstm-1.3b")
#: Phase 19: how long the tracegate processes may take after their start.
TRACEGATE_TIMEOUT_S = 600
#: Kernel 5's stream regime is held and timed at (B, N) = MULTI_STREAM.
MULTI_STREAM = (256, 2048)
#: Kernel 8's second shape: a GEMV that streams a 4096 x 4096 int8 matrix.
QMV_GEMV = (8, 4096, 4096)
#: Kernel 8's ragged shapes (B, M, K), held to the bound but not timed: one
#: per regime, K unaligned so that both take the scalar load path.
QMV_RAGGED = ((65, 100, 333), (1, 3, 40))
#: Kernels 1 and 2's wgmma regime, held and timed at the ONN dry run's
#: ``onn_131072`` ``baseline2d`` share, (B, M, K) = (1024, 8192, 8192) (the
#: row's numbers are kernel 1's there), and at a ragged shape, B and M off
#: the 128 x 256 tile and K off 16 bytes (rows copied for TMA); W square, so
#: that kernel 2 runs at both.
WGMMA_SHAPES = ((1024, 8192, 8192), (1000, 5000, 5000))


#: The script's start on the host clock: each line says when it was written.
T_START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - T_START}), flush=True)


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
    "coupling_sum": ("coupling_gemm_kernel<0,", "coupling_gemm_kernelILi0E"),
    "onn_step": ("coupling_gemm_kernel<3,", "coupling_gemm_kernelILi3E"),
    "phase_step": ("coupling_gemm_kernel<1,", "coupling_gemm_kernelILi1E"),
    "phase_step_packed": ("coupling_gemm_kernel<2,", "coupling_gemm_kernelILi2E"),
    "phase_step_multi": ("phase_step_multi_cluster<false", "phase_step_multi_clusterILb0E",
                         "phase_step_multi_stream<false", "phase_step_multi_streamILb0E"),
    "phase_step_multi_packed": ("phase_step_multi_cluster<true", "phase_step_multi_clusterILb1E",
                                "phase_step_multi_stream<true", "phase_step_multi_streamILb1E"),
    "hybrid_coupling_sum": ("coupling_gemm_kernel<0,", "coupling_gemm_kernelILi0E"),
    "hybrid_phase_step": ("coupling_gemm_kernel<1,", "coupling_gemm_kernelILi1E"),
    "quantized_matvec": ("qmv_gemv_kernel", "qmv_gemm_kernel"),
    "coupling_sum_batched": ("coupling_gemm_kernel<0,", "coupling_gemm_kernelILi0E"),
    "hybrid_coupling_sum_batched": ("coupling_gemm_kernel<0,", "coupling_gemm_kernelILi0E"),
    "coupling_wgmma": ("coupling_wgmma_kernel<0>", "coupling_wgmma_kernelILi0E"),
    "coupling_sum/wgmma": ("coupling_wgmma_kernel<0>", "coupling_wgmma_kernelILi0E"),
    "onn_step/wgmma": ("coupling_wgmma_kernel<3>", "coupling_wgmma_kernelILi3E"),
}


def device_ms(fn, name: str, iters: int = 20, launches: int = 1):
    """Device time per launch of the named hand-written kernel alone: the
    mean over the launches a ``torch.profiler`` trace of ``iters`` calls
    recorded, each call launching it ``launches`` times.  The profiler drops
    some records (late in a long process, the first few of each trace), so
    a trace that holds fewer than half the launches, or more than were
    made, is taken again, up to three times, then None."""
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
        if iters * launches // 2 <= count <= iters * launches and total_us:
            return total_us / 1e3 / count
    return None


def solve_seconds(solve) -> float:
    """Host-clock seconds of one warm call of ``solve``, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def warm_metrics(solve, repeats: int = 5, per_solve: int = B, unit: str = "requests") -> dict:
    """``unit``/s (``per_solve`` of them in a solve) of the median of
    ``repeats`` warm solves, and the device's busy time, idle share and
    device time by name in one more (profiler trace)."""
    warm = sorted(solve_seconds(solve) for _ in range(repeats))[repeats // 2]
    busy_ms, per_name, _ = device_busy(solve)
    return {
        "warm_solve_s": warm, f"{unit}_per_s": per_solve / warm, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (warm * 1e3),
        "top_device_ms": dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:5]),
        "device_ms_by_name": per_name,
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
    ``torch.profiler`` trace of the device alone, so that a call of 10⁵
    launches runs near its own speed), the device milliseconds by event
    name, and the traced call's own wall milliseconds.  The trace's raw
    events are read as the profiler recorded them (building its Python event
    tree costs minutes for a trace of 10⁵ launches).  A trace with no device
    event (the profiler now and then records none) is taken again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans, per_name = [], {}
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() != DeviceType.CUDA:
                continue
            start, length = evt.start_ns() / 1e3, evt.duration_ns() / 1e3  # µs
            spans.append((start, start + length))
            key = evt.name()[:80]
            per_name[key] = per_name.get(key, 0.0) + length / 1e3
        if spans:
            break
    return union_length(spans) / 1e3, per_name, wall_ms


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


def bound(bytes_moved: float, ops: float, ops_per_s: float = INT8_OPS_PER_S) -> tuple:
    """The least time (ms) for the work, and what bounds it: bytes at the
    HBM rate or operations at ``ops_per_s`` (int8 unless given)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fp32_error(got, x, wq, scale) -> tuple:
    """Kernel 8's error against the exact value (float64 on the card):
    (max |got − exact|, max |got − exact| / bound), where the bound is
    K · 2⁻²⁴ · |scale_m| · Σ_k |x_bk w_mk| per element."""
    x64, w64, s64 = x.double(), wq.double(), scale.double()
    exact = (x64 @ w64.T) * s64
    bnd = x.shape[-1] * 2.0**-24 * s64.abs() * (x64.abs() @ w64.abs().T)
    err = (got.double() - exact).abs()
    return float(err.max()), float((err / bnd.clamp_min(1e-300)).max())


def qmv_plan_dict(plan) -> dict:
    """Kernel 8's launch plan as the ``kernels`` row reports it."""
    return {"regime": plan.regime, "lanes": plan.lanes, "k_chunk": plan.k_chunk,
            "splits": plan.splits, "vector": plan.vector, "grid": list(plan.grid),
            "blocks": plan.blocks}


def coupling_plan_dict(plan) -> dict:
    """The coupling GEMM's launch plan as a ``kernels`` row reports it."""
    t = plan.tile
    return {"regime": t.name, "tile": t.name, "lanes": t.bm, "rows": t.bn, "k_split": t.ks,
            "stages": plan.stages, "load": "realign",  # the kernel's one load path
            "group_width": plan.group_width, "span": plan.span,
            "grid": list(plan.grid), "blocks": plan.blocks, "smem_bytes": plan.smem_bytes}


def wgmma_plan_dict(plan) -> dict:
    """The wgmma regime's launch plan as its rows report it."""
    return {"regime": "wgmma", "mode": plan.mode, "lanes": plan.args[0], "rows": plan.args[1],
            "stages": plan.stages, "k_chunk_steps": plan.k_chunk, "splits": plan.splits,
            "units": plan.units, "grid": list(plan.grid), "lanes_fastest": plan.lanes_fastest,
            "rows_copied": plan.padded, "smem_bytes": plan.smem_bytes}


def route_plan_dict(plan) -> dict:
    """The launch plan of ``autotune.coupling_route``, either regime."""
    return wgmma_plan_dict(plan) if plan.regime == "wgmma" else coupling_plan_dict(plan)


def multi_plan_dict(plan, occupancy) -> dict:
    """Kernel 5's launch plan as its rows report it, with the clusters of the
    plan the card holds at once (``occupancy``; None in the stream regime)."""
    return {"regime": plan.regime, "cluster": plan.cluster, "lanes": plan.lanes,
            "rows": plan.rows, "grid": plan.grid, "smem_bytes": plan.smem_bytes,
            "max_active_clusters": occupancy}


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


def _patterns(rng) -> np.ndarray:
    return np.where(rng.random((40, N)) < 0.5, 1, -1).astype(np.int8)


def make_hebbian(seed: int) -> torch.Tensor:
    """The float Hebbian couplings of :func:`make_problem`'s 40 patterns."""
    from repro_torch import api

    return api.hebbian(torch.as_tensor(_patterns(np.random.default_rng(seed))))


def make_problem(seed: int):
    """Hebbian 5-bit couplings of 40 seeded random patterns at N = 506 and
    1024 requests: a random stored pattern with 20 % of its pixels flipped
    (most lanes settle within a few cycles, some take two settle-chunks)."""
    from repro_torch import api

    rng = np.random.default_rng(seed)
    xi = _patterns(rng)
    w = api.quantize_weights(api.hebbian(torch.as_tensor(xi))).values.numpy()
    target = rng.integers(0, len(xi), size=B)
    probes = xi[target].copy()
    for row in probes:
        row[rng.choice(N, size=N // 5, replace=False)] *= -1
    return w, xi[target], probes


def make_graphs(seed: int) -> torch.Tensor:
    """The Max-Cut cell's instances: :data:`MC_INSTANCES` Erdős–Rényi graphs
    with edge probability 0.5 at N = 506, symmetric 0/1 int8 with a zero
    diagonal, from a numpy generator seeded from ``seed``."""
    rng = np.random.default_rng([seed, 13])
    upper = np.triu(rng.random((MC_INSTANCES, N, N)) < 0.5, k=1).astype(np.int8)
    return torch.as_tensor(upper + upper.transpose(0, 2, 1))


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


def request_spans(seed: int, lanes: int) -> list:
    """Seeded request sizes of 1-:data:`ENGINE_MAX_REQUEST_LANES` lanes that
    cover ``lanes`` lanes in order, as (start, count) spans."""
    rng = np.random.default_rng([seed, 19, lanes])
    spans, start = [], 0
    while start < lanes:
        count = min(int(rng.integers(1, ENGINE_MAX_REQUEST_LANES + 1)), lanes - start)
        spans.append((start, count))
        start += count
    return spans


def serve_requests(eng, name: str, payloads, keys=None):
    """Submit one request per payload (with its generator, if ``keys``), drain
    the engine, and read every future: a failed request fails the run.
    Returns (results, drain stats)."""
    from repro_torch.engine import Request

    keys = keys if keys is not None else [None] * len(payloads)
    futures = [eng.submit(Request(name, p, key=k)) for p, k in zip(payloads, keys)]
    stats = eng.drain()
    results = []
    for i, f in enumerate(futures):
        exc = f.exception()
        require(exc is None, f"engine {name}: request {i} failed: {exc!r}")
        results.append(f.result())
    return results, stats


def submit_then_drain(eng, name: str, payloads) -> tuple:
    """Host seconds of submitting one request per payload, and of draining
    them to the end of the card's work; every future read."""
    from repro_torch.engine import Request

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = [eng.submit(Request(name, p)) for p in payloads]
    t1 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for i, f in enumerate(futures):
        require(f.exception() is None, f"engine {name}: request {i} failed: {f.exception()!r}")
    return t1 - t0, t2 - t1


def require_same(got, want, fields, what: str) -> None:
    """Every named field of ``got`` equals ``want``'s: shape, dtype, values."""
    for f in fields:
        g, c = getattr(got, f), getattr(want, f)
        require(g.shape == c.shape and g.dtype == c.dtype, f"{what} {f}: shape/dtype")
        require(torch.equal(g, c.to(g.device)), f"{what} {f}: values differ")


def require_rows(got, ref, start: int, what: str) -> None:
    """One request's batched result ``got`` equals rows ``start`` onward of
    the lane-wise result ``ref`` (lanes never read each other's rows)."""
    count = got.settled.shape[0]
    require_same(got, type(ref)(*(x[start:start + count] for x in ref)), FIELDS, what)


def serve_stream(eng, reqs, source, **daemon_kw):
    """Run a ``ServeDaemon`` on ``eng`` over ``source``, which yields the
    requests ``reqs``.  Returns (the daemon's report, each request's future
    in the order of ``reqs``, wall seconds ending in a synchronise, the
    seconds of each tick, the host clock at which each future resolved)."""
    from repro_torch import serving

    futures, ticks, done_at = {}, [], {}
    submit, step = eng.submit, eng.step

    def recording_submit(request):
        fut = futures[id(request)] = submit(request)
        fut.add_done_callback(lambda _, k=id(request): done_at.setdefault(k, time.perf_counter()))
        return fut

    def timed_step(admit=True):
        t0 = time.perf_counter()
        out = step(admit)
        ticks.append(time.perf_counter() - t0)
        return out

    eng.submit, eng.step = recording_submit, timed_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = serving.ServeDaemon(eng, signals=(), **daemon_kw).run(source)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del eng.submit, eng.step
    return (report, [futures[id(r)] for r in reqs], seconds, ticks,
            [done_at.get(id(r)) for r in reqs])


def latency_ms(report) -> dict:
    lat = report["latency"]
    return {"count": lat["count"], "mean_ms": 1e3 * lat["mean_s"], "p50_ms": 1e3 * lat["p50_s"],
            "p99_ms": 1e3 * lat["p99_s"]}


def daemon_lines(dev, seed, cfg_mem, w_np, w2, xi, probes, checked, spans, mc, mc_kw,
                 drive) -> dict:
    """Phase 12: the serve daemon (``repro_torch.serving``) and DO-I training
    (``repro_torch.train``) on ``dev``, one JSON line per part; returns the
    launches of these lines by kernel.

    ``cfg_mem``, ``w_np``: the retrieval workload's config and int8 couplings;
    ``w2``: the float couplings of the hot swap; ``xi``: the (P, N) patterns
    behind both trainings; ``probes``: corrupted patterns, whose rows
    ``checked`` (a result on them, already held to the CPU) every retrieval
    request must equal; ``spans``: (start, count) of each retrieval request;
    ``mc``: (stream position, adjacency, generator seed, CPU result) of each
    Max-Cut request, served with ``mc_kw``; ``drive``: main's launch-counting
    runner."""
    from repro_torch import api, serving, train
    from repro_torch.core import ising
    from repro_torch.data import patterns as pat
    from repro_torch.engine import Request

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from doi_rule import hold, replay

    own = {}

    def driven(fn):
        res, seconds, path = drive(fn)
        for k, v in path.items():
            own[k] = own.get(k, 0) + v
        return res, seconds, path

    def rule(got, want, rp, what):
        try:
            return hold(got, want, rp, quantize=lambda w: api.quantize_weights(w.cpu()).values,
                        what=what, ports=("got", "want"))
        except AssertionError as exc:
            fail(str(exc))

    eng = serving.ContinuousEngine(torch.Generator().manual_seed(seed), device=dev,
                                   slab_lanes=DAEMON_SLAB, tenant_weights=dict(DAEMON_TENANTS))
    eng.install("mem", "retrieval",
                solver=api.RetrievalSolver(cfg_mem, api.make_params(cfg_mem, w_np, device=dev)))
    eng.install("cuts", "maxcut", device=dev, **mc_kw)

    def counts():
        stats = eng.stats()
        return {**{k: stats["serving"][k] for k in (
            "ticks", "chunks", "mid_flight_joins", "slabs_opened", "slabs_retired",
            "drain_rejected", "hot_swaps", "lanes_in_flight")}, "completed": stats["completed"]}

    def delta(before):
        now = counts()
        return {k: now[k] - before[k] for k in now}

    order = [("mem", a, c) for a, c in spans]
    for i, (pos, *_rest) in enumerate(mc):
        order.insert(pos, ("cuts", i, 1))
    weights = np.asarray([w for _, w in DAEMON_TENANTS])
    tenants = np.random.default_rng(seed).choice(len(DAEMON_TENANTS), size=len(order),
                                                 p=weights / weights.sum())

    def stream():
        """Fresh requests (a Max-Cut request's generator is drawn from by its
        solve)."""
        out = []
        for (kind, ref, count), t in zip(order, tenants):
            tenant = DAEMON_TENANTS[t][0]
            if kind == "mem":
                out.append(Request("mem", probes[ref:ref + count], tenant=tenant))
            else:
                _, adj, key_seed, _ = mc[ref]
                out.append(Request("cuts", adj, key=torch.Generator().manual_seed(key_seed),
                                   tenant=tenant))
        return out

    def check(futs, what, items=order):
        for i, ((kind, ref, _), f) in enumerate(zip(items, futs)):
            require(f.done(), f"{what} request {i} not served")
            require(f.exception() is None, f"{what} request {i} failed: {f.exception()!r}")
            if kind == "mem":
                require_rows(f.result(), checked, ref,
                             f"{what} request {i} != the CPU-checked solve")
            else:
                require_same(f.result(), mc[ref][3], ising.MaxCutResult._fields,
                             f"{what} Max-Cut request {i} != the CPU's solve")

    def closed():
        reqs = stream()
        return serve_stream(eng, reqs, serving.ticked_source(reqs, per_tick=DAEMON_PER_TICK))

    lanes = sum(c for _, c in spans)

    # closed: one cold run (equalities, launches), warm runs (times), one traced
    before = counts()
    t_part = time.perf_counter()
    (report, futs, cold_s, *_), _, path = driven(closed)
    check(futs, "daemon closed")
    moved = delta(before)
    require(moved["completed"] == len(order),
            f"daemon closed: {moved['completed']} of {len(order)} completed")
    require(moved["mid_flight_joins"] > 0, "daemon closed: no request joined a live slab")
    for k in ("phase_step_multi", "coupling_sum_batched"):
        require(path.get(k, 0) > 0, f"daemon closed: {k} never launched")
    ad, occupancy = eng.solver("mem"), []
    advance = ad.advance

    def measured_advance(slab):
        rec = next(r for r in eng._slabs.values() if r.slab is slab)
        occupancy.append(sum(len(e.slots) for e in rec.entries) / rec.width)
        advance(slab)

    ad.advance = measured_advance
    warm = []
    for _ in range(DAEMON_REPEATS):
        occupancy.clear()
        report_w, futs, seconds, ticks, _ = closed()
        check(futs, "daemon closed (warm)")
        warm.append((seconds, report_w, sorted(ticks), list(occupancy)))
    del ad.advance
    warm.sort(key=lambda x: x[0])
    seconds, report_w, ticks, occ = warm[len(warm) // 2]
    traced = []
    busy_ms, per_name, _ = device_busy(lambda: traced.append(closed()))
    check(traced[0][1], "daemon closed (traced)")
    closed_rps = len(order) / seconds
    emit({
        "phase": "daemon", "part": "closed", "config": "ONN_HYBRID_506",
        "backend": cfg_mem.backend, "slab_lanes": DAEMON_SLAB, "tenants": dict(DAEMON_TENANTS),
        "requests": len(order), "retrieval_requests": len(spans), "lanes": lanes,
        "maxcut_requests": len(mc), "maxcut_at": [m[0] for m in mc], "per_tick": DAEMON_PER_TICK,
        "cold_s": cold_s, "cold_counters": moved, "ticks": report["ticks"],
        "chunks": moved["chunks"], "slabs_opened": moved["slabs_opened"],
        "slabs_retired": moved["slabs_retired"], "mid_flight_joins": moved["mid_flight_joins"],
        "warm_s": [w[0] for w in warm], "requests_per_s": closed_rps,
        "lanes_per_s": lanes / seconds, "latency": latency_ms(report_w),
        "mean_slab_occupancy": float(np.mean(occ)) if occ else None,
        "chunks_per_run": len(occ), "host_ms_per_tick": {
            "median": 1e3 * ticks[len(ticks) // 2], "max": 1e3 * ticks[-1], "ticks": len(ticks)},
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (seconds * 1e3),
        "traced_s": traced[0][2],
        "top_device_ms": dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:5]),
        "launches": path, "kernel5_launches": path.get("phase_step_multi", 0),
        "kernel1i_launches": path.get("coupling_sum_batched", 0),
        "equal_to_cpu_checked": True, "completed": moved["completed"],
        "part_s": time.perf_counter() - t_part,
    })

    # open: Poisson arrivals at half the closed rate, on the same warm engine
    # The daemon times a request from its submission; the arrivals it pulls
    # after a long tick waited for that tick, so the latency from each
    # scheduled arrival (the source's first clock reading plus its offset)
    # is reported beside it.
    t_part = time.perf_counter()
    rate = 0.5 * closed_rps
    reqs = stream()
    offsets = serving.poisson_offsets(len(reqs), rate, seed=0)
    anchor = []

    def clock():
        now = time.perf_counter()
        anchor.append(now)
        return now

    (report, futs, seconds, ticks, done_at), _, path = driven(lambda: serve_stream(
        eng, reqs, serving.timed_source(reqs, offsets, clock=clock),
        idle_sleep_s=DAEMON_IDLE_SLEEP_S))
    check(futs, "daemon open")
    from_arrival = sorted(d - (anchor[0] + o) for d, o in zip(done_at, offsets))
    emit({
        "phase": "daemon", "part": "open", "rate_rps": rate, "requests": len(reqs),
        "completed": len(futs), "latency": latency_ms(report), "latency_from_arrival": {
            "mean_ms": 1e3 * float(np.mean(from_arrival)),
            "p50_ms": 1e3 * serving.daemon.percentile(from_arrival, 50.0),
            "p99_ms": 1e3 * serving.daemon.percentile(from_arrival, 99.0)},
        "seconds": seconds,
        "last_arrival_s": float(offsets[-1]), "after_last_arrival_s": seconds - float(offsets[-1]),
        "ticks": report["ticks"], "straggler_ticks": report["stragglers"]["ticks"],
        "straggler_slabs": report["stragglers"]["per_slab"], "launches": path,
        "equal_to_cpu_checked": True, "part_s": time.perf_counter() - t_part,
    })

    # drain: the retrieval stream, ticked until a request joins a live slab
    items = [("mem", a, c) for a, c in spans]
    before = counts()

    def drain():
        futs = [eng.submit(Request("mem", probes[a:a + c])) for a, c in spans]
        ticks = 0
        while counts()["mid_flight_joins"] == before["mid_flight_joins"]:
            eng.step()
            ticks += 1
            require(ticks < 1000, "daemon drain: no request joined a live slab")
        return futs, ticks, eng.finish_in_flight(reject_queued=True)

    (futs, ticks, drained), seconds, path = driven(drain)
    moved = delta(before)
    rejected = [i for i, f in enumerate(futs) if f.done() and isinstance(
        f.exception(), serving.DrainRejectedError)]
    require(all(f.done() for f in futs), "daemon drain: a request was left unresolved")
    check([f for i, f in enumerate(futs) if i not in set(rejected)], "daemon drain",
          [x for i, x in enumerate(items) if i not in set(rejected)])
    require(len(rejected) == drained["rejected"] == moved["drain_rejected"] > 0,
            f"daemon drain: {len(rejected)} rejected futures, report {drained}, "
            f"counter {moved['drain_rejected']}")
    require(moved["completed"] + moved["drain_rejected"] == len(spans),
            "daemon drain: completed + rejected != submitted")
    require(eng.idle and counts()["lanes_in_flight"] == 0, "daemon drain: live lanes remain")
    emit({"phase": "daemon", "part": "drain", "submitted": len(spans), "ticks_before": ticks,
          "mid_flight_joins": moved["mid_flight_joins"], "drain": drained,
          "completed": moved["completed"], "drain_rejected": moved["drain_rejected"],
          "seconds": seconds, "launches": path, "rejected_are_drain_rejected": True,
          "in_flight_equal_to_cpu_checked": True, "idle_after": True})

    # hot_swap: requests admitted before the swap run the old weights
    n_pre, total = 0, 0
    while n_pre < len(spans) and total + spans[n_pre][1] <= DAEMON_SLAB:
        total += spans[n_pre][1]
        n_pre += 1
    pre_spans, post_spans = spans[:n_pre], spans[n_pre:n_pre + DAEMON_SWAP_REQUESTS]
    hs = train.HotSwap(eng, "mem")

    def swap():
        pre = [eng.submit(Request("mem", probes[a:a + c])) for a, c in pre_spans]
        eng.step()  # every pre-swap request admitted and advanced one chunk
        queued = eng.stats()["queue_depth"]["requests"]
        at_swap = counts()
        params, _ = hs.install(w2)
        post = [eng.submit(Request("mem", probes[a:a + c])) for a, c in post_spans]
        eng.flush()
        return pre, post, queued, at_swap, params

    before = counts()
    (pre, post, queued, at_swap, params2), seconds, path = driven(swap)
    require(queued == 0, "daemon hot_swap: a pre-swap request was still queued at the swap")
    check(pre, "daemon hot_swap (before)", [("mem", a, c) for a, c in pre_spans])
    solver2 = api.RetrievalSolver(cfg_mem, params2)
    for i, ((a, c), f) in enumerate(zip(post_spans, post)):
        require(f.exception() is None, f"daemon hot_swap request {i} failed")
        require_same(f.result(), solver2.solve(probes[a:a + c]), FIELDS,
                     f"daemon hot_swap request {i} != the solve on the new weights")
    since = delta(at_swap)
    require(delta(before)["hot_swaps"] == 1, "daemon hot_swap: not counted once")
    require(since["slabs_retired"] >= 1 and since["slabs_opened"] >= 1,
            "daemon hot_swap: the live slab was not retired and reopened")
    emit({"phase": "daemon", "part": "hot_swap", "before_requests": len(pre),
          "before_lanes": total, "after_requests": len(post), "hot_swaps": 1,
          "slabs_retired_since_swap": since["slabs_retired"],
          "slabs_opened_since_swap": since["slabs_opened"], "seconds": seconds,
          "launches": path, "before_equal_to_cpu_checked": True,
          "after_equal_to_solve_on_new_weights": True})

    # train: DO-I at full width, card against CPU, then serve the trained ONN
    t_part = time.perf_counter()
    tcfg = train.TrainConfig()
    card, card_s, _ = driven(lambda: train.train_doi(xi, tcfg, device=dev))
    t0 = time.perf_counter()
    cpu = train.train_doi(xi, tcfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    rp = replay(xi.numpy(), **dataclasses.asdict(tcfg))
    kind = rule(card, cpu, rp, "train (card against CPU)")
    dw = (card.weights.cpu() - cpu.weights).abs().max()
    t0 = time.perf_counter()
    eng.install("trained", "retrieval", xi=xi, backend="kernel", device=dev)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    trained = eng.solver("trained").solver
    reqs = [Request("trained", probes[i:i + 1]) for i in range(DAEMON_TRAINED_REQUESTS)]
    (report, futs, seconds, *_), _, path = driven(lambda: serve_stream(
        eng, reqs, serving.ticked_source(reqs, per_tick=DAEMON_PER_TICK)))
    for i, f in enumerate(futs):
        require(f.exception() is None, f"train: trained request {i} failed")
        require_same(f.result(), trained.solve(probes[i:i + 1]), FIELDS,
                     f"train: trained request {i} != its isolated solve")
    emit({"phase": "train", "n": xi.shape[1], "patterns": xi.shape[0],
          "config": dataclasses.asdict(tcfg), "sweeps": int(card.sweeps),
          "converged": bool(card.converged), "kappa_min": float(card.kappa_min),
          "card_s": card_s, "cpu_s": cpu_s, "tie_free": rp.tie_free, "rule": kind,
          "ties": len(rp.ties), "first_ties": rp.ties[:3], "cpu_sweeps": int(cpu.sweeps),
          "weights_equal_to_cpu": bool(dw == 0), "max_abs_weight_diff": float(dw),
          "install_s": install_s, "install_config": {
              "self_coupling": True, "backend": trained.config.backend},
          "requests": len(reqs), "requests_per_s": len(reqs) / seconds,
          "latency": latency_ms(report), "launches": path,
          "trained_requests_equal_to_isolated_solve": True,
          "part_s": time.perf_counter() - t_part})

    # mixed_stream: the reference's own stream and workloads on the card
    t_part = time.perf_counter()
    meng = serving.ContinuousEngine(torch.Generator().manual_seed(seed), device=dev)
    t0 = time.perf_counter()
    serving.install_mixed_workloads(meng)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    reqs = serving.mixed_requests(MIXED_REQUESTS, seed=0)
    (report, futs, seconds, *_), _, path = driven(lambda: serve_stream(
        meng, reqs, serving.ticked_source(reqs, per_tick=4)))
    cuts = api.MaxCutSolver(sweeps=8, replicas=1, device=dev)
    for i, (r, f) in enumerate(zip(reqs, futs)):
        require(f.exception() is None, f"mixed_stream request {i} failed: {f.exception()!r}")
        if r.workload == "cuts":
            want = cuts.solve(r.payload, key=torch.Generator().manual_seed(r.key.initial_seed()))
            require_same(f.result(), want, ising.MaxCutResult._fields,
                         f"mixed_stream request {i} != its isolated solve")
            continue
        x = r.payload
        want = meng.solver(r.workload).solver.solve(x if x.dim() == 2 else x[None])
        if x.dim() == 1:
            want = type(want)(*(v[0] for v in want))
        require_same(f.result(), want, FIELDS, f"mixed_stream request {i} != its isolated solve")
    rules = {}
    for name, workload in (("7x6", "small"), ("10x10", "large")):
        lib = pat.load_dataset(name, device="cpu")
        cfg_l = train.TrainConfig(self_coupling=True)  # diederich_opper_i's
        card = train.train_doi(lib, cfg_l, device=dev)
        cpu = train.train_doi(lib, cfg_l, device="cpu")
        rules[name] = rule(card, cpu, replay(lib.numpy(), self_coupling=True),
                           f"mixed_stream {name} (card against CPU)")
        require(torch.equal(meng.solver(workload).solver.params.weights.cpu(),
                            api.quantize_weights(card.weights.cpu()).values),
                f"mixed_stream: {workload}'s weights are not the card's DO-I training")
    emit({"phase": "daemon", "part": "mixed_stream", "requests": len(reqs),
          "workloads": {w: sum(r.workload == w for r in reqs) for w in ("small", "large", "cuts")},
          "completed": len(futs), "install_s": install_s, "seconds": seconds,
          "requests_per_s": len(reqs) / seconds, "latency": latency_ms(report),
          "doi_rule": rules, "launches": path, "equal_to_isolated_solve": True,
          "part_s": time.perf_counter() - t_part})
    return own


def launcher_lines(dev, seed, w_np, checked, drive) -> dict:
    """Phase 13: the ONN launchers (``repro_torch.launch.retrieve``,
    ``launch.train_onn``), ``core.energy`` and ``examples/torch_quickstart.py``
    on ``dev``, one JSON line per part, each held to the CPU; returns the
    launches of these lines by kernel.

    ``w_np``: phase 4's int8 couplings (N = 506); ``checked``: phase 4's
    result on its probes (held to the CPU there); ``drive``: main's
    launch-counting runner."""
    from repro_torch import api, train
    from repro_torch.checkpoint import load_onn
    from repro_torch.configs import onn as configs
    from repro_torch.core import dynamics as dyn
    from repro_torch.core import energy, quantization
    from repro_torch.core import oscillator as osc
    from repro_torch.launch import retrieve as launch_retrieve
    from repro_torch.launch.train_onn import run_train_serve

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from doi_rule import hold, replay

    own = {}

    def driven(fn):
        res, seconds, path = drive(fn)
        for k, v in path.items():
            own[k] = own.get(k, 0) + v
        return res, seconds, path

    def rule(got, want, rp, what):
        try:
            return hold(got, want, rp, quantize=lambda w: api.quantize_weights(w.cpu()).values,
                        what=what, ports=("got", "want"))
        except AssertionError as exc:
            fail(str(exc))

    # retrieve_cli: build_solver + serve_requests' two halves, card against CPU
    xi_cpu = launch_retrieve.pat.load_dataset(LAUNCH_DATASET, device="cpu")
    doi = train.TrainConfig(self_coupling=True)  # diederich_opper_i's
    card_do = train.train_doi(xi_cpu, doi, device=dev)
    doi_kind = rule(card_do, train.train_doi(xi_cpu, doi, device="cpu"),
                    replay(xi_cpu.numpy(), self_coupling=True),
                    f"retrieve_cli {LAUNCH_DATASET} DO-I (card against CPU)")
    fields = ("final_sigma", "settle_cycle", "settled")
    for part, arch, mode, route, requests, kernel in (
        ("kernel", "hybrid", "functional", dict(backend="kernel"), LAUNCH_REQUESTS,
         "phase_step_multi"),
        ("hybrid_kernel", "hybrid", "functional", dict(backend="hybrid", hybrid_impl="kernel"),
         LAUNCH_HYBRID_REQUESTS, "hybrid_phase_step"),
        ("rtl", "recurrent", "rtl", dict(backend="kernel"), LAUNCH_RTL_REQUESTS, "coupling_sum"),
    ):
        t_part = time.perf_counter()
        (solver, xi), build_s, _ = driven(lambda: launch_retrieve.build_solver(
            LAUNCH_DATASET, arch, mode, device=dev, **route))
        require(torch.equal(solver.params.weights.cpu(),
                            api.quantize_weights(card_do.weights.cpu()).values),
                f"retrieve_cli {part}: build_solver's weights are not the card's DO-I")
        cpu_solver = api.RetrievalSolver(solver.config, api.make_params(
            solver.config, solver.params.weights.cpu(), device="cpu"))
        per_policy = {}
        for policy in (("pow2", "exact") if part != "rtl" else ("pow2",)):
            def serve(s=solver, policy=policy):
                gen = torch.Generator().manual_seed(LAUNCH_SEED)
                which, corrupted = launch_retrieve.draw_requests(
                    xi, LAUNCH_CORRUPTION, requests, gen)
                return launch_retrieve.serve_corrupted(
                    s, xi.cpu()[which], corrupted, gen, corruption=LAUNCH_CORRUPTION,
                    n_policy=policy)

            (report, res), first_s, path = driven(serve)
            require(path.get(kernel, 0) > 0, f"retrieve_cli {part} {policy}: {kernel} never launched")
            want, want_res = serve(cpu_solver)
            for f in fields:
                require(torch.equal(getattr(res, f), getattr(want_res, f)),
                        f"retrieve_cli {part} {policy}: {f} differs from the CPU")
            for k in ("accuracy", "mean_settle_cycles", "timeouts"):
                require(report[k] == want[k], f"retrieve_cli {part} {policy}: {k} != the CPU's")
            warm, _ = serve()
            per_policy[policy] = {
                "n_bucket": int(next(iter(report["engine"]["retrieval"]["n_buckets"]))),
                "slabs": report["engine"]["slabs"], "pad_fraction": report["engine"]["pad_fraction"],
                "slabs_per_bucket": report["engine"]["slabs_per_bucket"],
                "first_wall_s": report["wall_s"], "first_requests_per_s": report["requests_per_s"],
                "wall_s": warm["wall_s"], "requests_per_s": warm["requests_per_s"],
                "first_call_s": first_s, "launches": path, f"{kernel}_launches": path[kernel],
            }
        emit({"phase": "launchers", "part": "retrieve_cli", "route": part,
              "dataset": LAUNCH_DATASET, "n": int(xi.shape[1]), "architecture": arch,
              "mode": mode, "backend": solver.config.backend,
              "hybrid_impl": solver.config.hybrid_impl, "requests": requests,
              "corruption": LAUNCH_CORRUPTION, "seed": LAUNCH_SEED,
              "accuracy": report["accuracy"], "mean_settle_cycles": report["mean_settle_cycles"],
              "timeouts": report["timeouts"], "build_solver_s": build_s, "policies": per_policy,
              "doi_rule": doi_kind, "equal_to_cpu": True, "part_s": time.perf_counter() - t_part})

    # train_onn: train -> hot swap -> serve on the card, then on the CPU
    t_part = time.perf_counter()
    ckpt = tempfile.mkdtemp()
    try:
        kw = dict(dataset=LAUNCH_DATASET, probes=LAUNCH_PROBES, backend="kernel")
        card, card_s, path = driven(lambda: run_train_serve(
            ckpt_dir=os.path.join(ckpt, "card"), device=dev, **kw))
        t0 = time.perf_counter()
        run_train_serve(ckpt_dir=os.path.join(ckpt, "cpu"), device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        require(card["train"]["converged"], "train_onn: DO-I did not converge")
        require(card["accuracy_trained"] >= card["accuracy_hebbian"],
                "train_onn: training lowered the accuracy")
        require(card["hot_swaps"] == 1, "train_onn: not one hot swap")
        require(card["serving_retraces_after_swap"] == 0,
                f"train_onn: {card['serving_retraces_after_swap']} builds or plans after the swap")
        require(card["completed"] == 3 * LAUNCH_PROBES, "train_onn: requests not all completed")
        require(path.get("phase_step_multi", 0) > 0, "train_onn: phase_step_multi never launched")
        with open(os.path.join(card["checkpoint"], "onn.json")) as f:
            header = json.load(f)["config"]
        require(header["backend"] == "pallas", "train_onn: the header names the kernel route "
                f"{header['backend']!r}, not the reference's 'pallas'")
        loaded = load_onn(card["checkpoint"], device=dev)
        require(loaded.config.backend == "kernel", "train_onn: checkpoint config not restored")
        tcfg = train.TrainConfig(qat_bits=loaded.config.weight_bits)
        card_t = train.train_doi(xi_cpu, tcfg, device=dev)
        cpu_t = train.train_doi(xi_cpu, tcfg, device="cpu")
        require(torch.equal(loaded.params.weights.cpu(),
                            api.quantize_weights(card_t.weights.cpu()).values),
                "train_onn: the checkpoint does not hold the card's trained weights")
        kind = rule(card_t, cpu_t, replay(xi_cpu.numpy(), **dataclasses.asdict(tcfg),
                                          fake_quantize=quantization.fake_quantize),
                    "train_onn (card against CPU)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "launchers", "part": "train_onn", "dataset": LAUNCH_DATASET,
          "n": card["n"], "probes": LAUNCH_PROBES, "backend": "kernel", "rule": card["rule"],
          "train": card["train"], "accuracy_hebbian": card["accuracy_hebbian"],
          "accuracy_trained": card["accuracy_trained"], "hot_swaps": card["hot_swaps"],
          "serving_retraces_after_swap": card["serving_retraces_after_swap"],
          "completed": card["completed"], "ticks": card["ticks"], "card_s": card_s,
          "cpu_s": cpu_s, "checkpoint_round_trip": True, "doi_rule": kind,
          "launches": path,
          "part_s": time.perf_counter() - t_part})

    # energy: eq. 1 at N = 506 on phase 4's final spins, card against CPU
    t_part = time.perf_counter()
    wc = torch.as_tensor(w_np)
    wg = wc.to(dev)
    spins = checked.final_sigma
    (h_card, mins_card), seconds, path = driven(lambda: (
        energy.hamiltonian(wg, spins.to(dev)),
        torch.stack([energy.is_local_minimum(wg, spins[i].to(dev))
                     for i in range(ENERGY_MIN_LANES)])))
    h_cpu = energy.hamiltonian(wc, spins.cpu())
    mins_cpu = torch.stack([energy.is_local_minimum(wc, spins[i].cpu())
                            for i in range(ENERGY_MIN_LANES)])
    require(torch.equal(h_card.cpu(), h_cpu), "energy: hamiltonian on the card != CPU")
    require(torch.equal(mins_card.cpu(), mins_cpu), "energy: is_local_minimum on the card != CPU")
    cfg_e = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel")
    starts = spins[:ENERGY_TRACE_LANES]

    def trajectory(device):
        params = api.make_params(cfg_e, w_np, device=device)
        out = []
        for lane in starts:
            state = dyn.init_state(cfg_e, lane.to(device))
            steps = []
            for _ in range(ENERGY_TRACE_STEPS):
                state = dyn.step(cfg_e, params, state)
                steps.append(osc.spin(state.phase, cfg_e.phase_bits))
            out.append(torch.stack(steps))
        return torch.stack(out, dim=1)  # (T, lanes, N)

    traj_card, _, path_t = driven(lambda: trajectory(dev))
    traj_cpu = trajectory("cpu")
    require(torch.equal(traj_card.cpu(), traj_cpu), "energy: step trajectory on the card != CPU")
    e_card = energy.energy_trace(wg, traj_card)
    require(torch.equal(e_card.cpu(), energy.energy_trace(wc, traj_cpu)),
            "energy: energy_trace on the card != CPU")
    emit({"phase": "launchers", "part": "energy", "n": N, "lanes": int(spins.shape[0]),
          "hamiltonian_dtype": str(h_card.dtype), "mean_energy": float(h_cpu.mean()),
          "local_minimum_lanes": ENERGY_MIN_LANES,
          "local_minima": int(mins_cpu.sum()), "trace_steps": ENERGY_TRACE_STEPS,
          "trace_lanes": ENERGY_TRACE_LANES,
          "seconds": seconds, "launches": {**path, **path_t}, "equal_to_cpu": True,
          "part_s": time.perf_counter() - t_part})

    # examples: the quickstart in a subprocess on the card
    t_part = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py")],
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"examples: torch_quickstart.py exited {out.returncode}:\n"
            f"{out.stderr[-2000:]}")
    require("retrieved correctly: True" in out.stdout,
            f"examples: torch_quickstart.py did not retrieve:\n{out.stdout[-2000:]}")
    emit({"phase": "launchers", "part": "examples", "script": "examples/torch_quickstart.py",
          "exit_code": out.returncode, "retrieved_correctly": True,
          "seconds": time.perf_counter() - t_part})
    return own


def sharded_lines(dev, seed, w_np, xi, probes, checked, rtl_rec, graphs, mc_res, mc_kw,
                  spans, mc_in, drive) -> dict:
    """Phase 14: the row-sharded ONN path (``repro_torch.distributed``) on
    meshes that repeat ``dev``, one JSON line per part; returns the launches
    of these lines by kernel.

    ``w_np``, ``xi``, ``probes``: phase 4's int8 couplings, its 40 patterns
    and its 1024 probes; ``checked``: phase 4's unsharded kernel-route
    result (held to the CPU); ``rtl_rec``: phase 6's recurrent rtl (config,
    result, enable offsets); ``graphs``, ``mc_res``, ``mc_kw``: phase 10's
    instances, its kernel-route result (held to the CPU) and solver
    arguments; ``spans``, ``mc_in``: phase 12's retrieval request spans and
    Max-Cut requests; ``drive``: main's launch-counting runner."""
    from repro_torch import api, serving
    from repro_torch.configs import onn as configs
    from repro_torch.core import dynamics as dyn
    from repro_torch.core import ising
    from repro_torch.distributed import ShardPlan, make_mesh, sharding
    from repro_torch.engine import Request
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.launch import retrieve as launch_retrieve
    from repro_torch.optim import compress

    own = {}

    def driven(fn, seen=None):
        """``drive(fn)``; with a dict ``seen``, it also records the inputs of
        the path's first row-sharded sum per W rank (2: kernel 1 or 6, 3:
        their instance axis) and of its first kernel-5 launch."""
        if seen is None:
            res, seconds, path = drive(fn)
        else:
            real_sum, real_multi = dyn._model_sharded_sum, ops.phase_step_multi

            def sum_seen(cfg, w, sigma, plan, mesh, placement=None):
                if w.dim() not in seen:
                    seen[w.dim()] = (cfg, w, sigma.clone(), plan, mesh, placement)
                return real_sum(cfg, w, sigma, plan, mesh, placement=placement)

            def multi_seen(*args, **kw):
                if "multi" not in seen:
                    seen["multi"] = ([a.clone() for a in args], kw)
                return real_multi(*args, **kw)

            dyn._model_sharded_sum, ops.phase_step_multi = sum_seen, multi_seen
            try:
                res, seconds, path = drive(fn)
            finally:
                dyn._model_sharded_sum, ops.phase_step_multi = real_sum, real_multi
        for k, v in path.items():
            own[k] = own.get(k, 0) + v
        return res, seconds, path

    def shard_kernels(seen, what):
        """The kernels of the sharded path at the shapes it gave them, each
        held with max_abs_err 0 against its plain version on the inputs that
        ``driven`` recorded: the row-block partial fields
        (``dyn.row_block_partials``: every block and data shard, concatenated)
        against the plain sum of the whole W, and kernel 5 on a lane shard
        against its plain version; device ms a launch, and the plain
        version's ms on the same inputs."""
        out = []
        for rank in (2, 3):
            if rank not in seen:
                continue
            cfg, w, sig, plan, mesh, placement = seen[rank]
            hybrid = cfg.backend == "hybrid"
            require(cfg.backend == "kernel" or (hybrid and cfg.hybrid_impl == "kernel"),
                    f"{what}: backend {cfg.backend} runs no kernel")
            p = cfg.hybrid_parallel
            name = ("hybrid_coupling_sum" if hybrid else "coupling_sum") + (
                "_batched" if rank == 3 else "")

            def partials():
                return dyn.row_block_partials(cfg, w, sig, plan, mesh, placement)

            def whole_plain():
                if hybrid:
                    return plain.hybrid_coupling_sum_ref(w, sig, p)
                return plain.coupling_sum_ref(w, sig)

            parts = partials()
            got = torch.cat([torch.cat([q.to(sig.device) for q in ps], dim=-1) for ps in parts])
            err = max_abs_err(got, whole_plain())
            require(err == 0, f"{what}: {name} on its row blocks disagrees with its plain "
                              f"version (max_abs_err {err})")
            n_launch = sum(len(ps) for ps in parts)
            out.append({
                "kernel": name, "parallel": p if hybrid else None,
                "w": list(w.shape), "sigma": list(sig.shape), "data_shards": len(parts),
                "partial_shapes": [list(q.shape) for q in parts[0]],
                "launches_per_sum": n_launch, "max_abs_err": err,
                "kernel_ms_per_launch": device_ms(partials, name, launches=n_launch),
                "partials_ms": cuda_ms(partials), "combine_ms": cuda_ms(
                    lambda: torch.cat([q.to(sig.device) for q in parts[0]], dim=-1)),
                "plain_ms": cuda_ms(whole_plain, iters=5, warmup=1)})
        if "multi" in seen:
            args, kw = seen["multi"]
            w_, bias_, ph_, pv_, *cols_ = args

            def kern():
                return ops.phase_step_multi(*args, **kw)

            def plain_fn():
                return plain.phase_step_multi_ref(
                    w_, bias_, ph_, pv_, *(c.to(torch.int32)[:, None] for c in cols_),
                    half=kw["half"], chunk=kw["chunk"], max_cycles=kw["max_cycles"])

            want = plain_fn()
            err = max_abs_err(kern(), [want[0], want[1], *(x[:, 0] for x in want[2:])])
            require(err == 0, f"{what}: phase_step_multi on a lane shard disagrees with its "
                              f"plain version (max_abs_err {err})")
            name = "phase_step_multi_packed" if kw.get("packed") else "phase_step_multi"
            out.append({"kernel": name, "shape": list(ph_.shape), "max_abs_err": err,
                        "kernel_ms": device_ms(kern, name),
                        "plain_ms": cuda_ms(plain_fn, iters=5, warmup=1)})
        require(out, f"{what}: no kernel input recorded")
        return out

    def mesh_of(plan):
        return make_mesh((plan.batch, plan.model), devices=[dev] * plan.devices)

    def warm_s(solve, repeats=3):
        return sorted(solve_seconds(solve) for _ in range(repeats))[repeats // 2]

    def block_bytes(params, plan, mesh):
        return sorted({b.nbytes for b in sharding.weight_blocks(
            params.weights, plan, mesh, placement=params.placement)[0]})

    def per_cycle(launches, name, plan, chunk):
        """Launches of ``name`` a cycle: whole chunks of ``per`` launches."""
        n = launches.get(name, 0)
        per = plan.batch * plan.model if plan.model_sharded else plan.batch
        require(n > 0 and n % (per * chunk) == 0,
                f"sharded {name}: {n} launches, not whole chunks of {per} a cycle")
        return per

    cfg_k = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel")
    chunk = dyn.resolve_chunk(cfg_k)

    # retrieve: ONN_HYBRID_506 on the kernel route, 1024 probes, four plans
    for shape in ((1, 4), (2, 2), (4, 1), (2, 4)):
        plan = ShardPlan(*shape)
        mesh = mesh_of(plan)
        solver = api.RetrievalSolver(cfg_k, sharding.shard_onn_params(
            api.make_params(cfg_k, w_np, device=dev), plan, mesh))
        seen = {}
        with plan.context(mesh):
            res, seconds, path = driven(lambda: solver.solve(probes), seen)
            warm = warm_s(lambda: solver.solve(probes))
        require_equal(res, checked, f"sharded retrieve {shape}: != the unsharded solve")
        fields = shard_kernels(seen, f"sharded retrieve {shape}")
        if plan.model > 1:
            per = per_cycle(path, "coupling_sum", plan, chunk)
            require(path.get("phase_step_multi", 0) == 0, f"sharded {shape}: kernel 5 ran")
        else:
            per = plan.batch  # kernel-5 launches a chunk: one per lane shard
            require(path.get("phase_step_multi", 0) % plan.batch == 0
                    and path.get("phase_step_multi", 0) > 0,
                    f"sharded {shape}: kernel 5 not once per lane shard")
            require(path.get("coupling_sum", 0) == 0, f"sharded {shape}: kernel 1 ran")
        combine = {}
        if shape == (1, 4):
            # The combine alone at this shape: the four partial fields of the
            # probes, concatenated (exact) or through the int8 wire.
            parts = dyn.row_block_partials(cfg_k, solver.params.weights,
                                           torch.as_tensor(probes, device=dev), plan, mesh,
                                           solver.params.placement)[0]
            combine = {"combine_ms": cuda_ms(lambda: torch.cat(parts, dim=-1)),
                       "compressed_combine_ms": cuda_ms(
                           lambda: compress.compressed_psum_scatter(parts))}
        emit({"phase": "sharded", "part": "retrieve", "config": "ONN_HYBRID_506",
              "backend": "kernel", "plan": dataclasses.asdict(plan), "requests": B, **combine,
              "w_block_bytes": block_bytes(solver.params, plan, mesh),
              "w_bytes": int(solver.params.weights.nbytes),
              "launches": path, "kernel": "coupling_sum" if plan.model > 1 else
              "phase_step_multi", "launches_per_cycle_or_chunk": per,
              "field_kernel_at_shard": fields,
              "first_call_s": seconds, "warm_solve_s": warm,
              "requests_per_s": B / warm, "equal_to_unsharded": True})

    # retrieve_hybrid: kernel 6 per row block at P = 32 under 1x4
    cfg_h = dataclasses.replace(configs.ONN_HYBRID_506, backend="hybrid", hybrid_impl="kernel")
    plan = ShardPlan(1, 4)
    mesh = mesh_of(plan)
    solver = api.RetrievalSolver(cfg_h, sharding.shard_onn_params(
        api.make_params(cfg_h, w_np, device=dev), plan, mesh))
    seen = {}
    with plan.context(mesh):
        res, seconds, path = driven(lambda: solver.solve(probes), seen)
        warm = warm_s(lambda: solver.solve(probes))
    require_equal(res, checked, "sharded retrieve_hybrid: != the unsharded solve")
    fields = shard_kernels(seen, "sharded retrieve_hybrid")
    per = per_cycle(path, "hybrid_coupling_sum", plan, chunk)
    require(path.get("hybrid_phase_step", 0) == 0, "sharded retrieve_hybrid: kernel 7 ran")
    emit({"phase": "sharded", "part": "retrieve_hybrid", "config": "ONN_HYBRID_506",
          "parallel": cfg_h.hybrid_parallel, "plan": dataclasses.asdict(plan), "requests": B,
          "launches": path, "launches_per_cycle": per, "field_kernel_at_shard": fields,
          "first_call_s": seconds, "warm_solve_s": warm, "requests_per_s": B / warm,
          "equal_to_unsharded": True})

    # rtl: the recurrent architecture with sync_jitter, kernel 1 per block
    cfg_r, rtl_res, rtl_t0 = rtl_rec
    plan = ShardPlan(1, 2)
    mesh = mesh_of(plan)
    params_r = api.make_params(cfg_r, w_np, device=dev)
    lanes = RTL_CHECK_LANES
    seen = {}
    with plan.context(mesh):
        res, seconds, path = driven(lambda: dyn.retrieve(
            cfg_r, params_r, torch.as_tensor(probes[:lanes], device=dev), t0=rtl_t0[:lanes]),
            seen)
    require_rows(res, rtl_res, 0, "sharded rtl: != the unsharded rtl")
    fields = shard_kernels(seen, "sharded rtl")
    clocks = cfg_r.clocks_per_cycle
    n_launch = path.get("coupling_sum", 0)
    require(n_launch > 0 and n_launch % (2 * clocks * dyn.resolve_chunk(cfg_r)) == 0,
            f"sharded rtl: {n_launch} launches, not 2 an edge in whole chunks")
    emit({"phase": "sharded", "part": "rtl", "config": "ONN_HYBRID_506",
          "architecture": "recurrent", "sync_jitter": True, "plan": dataclasses.asdict(plan),
          "lanes": lanes, "launches": path, "launches_per_edge": 2,
          "launches_per_cycle": 2 * clocks, "field_kernel_at_shard": fields,
          "first_call_s": seconds, "equal_to_unsharded": True})

    # n4096: Hebbian 5-bit couplings of 200 patterns, 1024 probes, W split 8 ways
    n_big = SHARDED_N
    rng = np.random.default_rng([seed, 41])
    xi_big = torch.as_tensor(np.where(rng.random((200, n_big)) < 0.5, 1, -1).astype(np.int8))
    w_big = api.quantize_weights(api.hebbian(xi_big)).values
    target_big = torch.as_tensor(rng.integers(0, 200, B))
    probes_big = xi_big[target_big].clone()
    probes_big[torch.as_tensor(rng.random((B, n_big)) < 0.2)] *= -1
    cfg_big = dataclasses.replace(cfg_k, n=n_big)
    solver = api.RetrievalSolver(cfg_big, api.make_params(cfg_big, w_big, device=dev))
    plan = ShardPlan(1, 8)
    mesh = mesh_of(plan)
    solver_s = api.RetrievalSolver(cfg_big, sharding.shard_onn_params(solver.params, plan, mesh))
    want, seconds_u, path_u = driven(lambda: solver.solve(probes_big))
    require(path_u.get("phase_step_multi", 0) > 0, "n4096 unsharded: kernel 5 never launched")
    warm_u = warm_s(lambda: solver.solve(probes_big))
    seen = {}
    with plan.context(mesh):
        res, seconds, path = driven(lambda: solver_s.solve(probes_big), seen)
        warm = warm_s(lambda: solver_s.solve(probes_big))
    require_equal(res, want, "sharded n4096 1x8: != the unsharded solve (kernel 5)")
    fields = shard_kernels(seen, "sharded n4096")
    per = per_cycle(path, "coupling_sum", plan, chunk)
    blocks = block_bytes(solver_s.params, plan, mesh)
    require(blocks == [n_big * n_big // 8], f"n4096: W blocks of {blocks} bytes, not 2 MiB")
    accuracy = float(torch.all(res.final_sigma.cpu() == xi_big[target_big], dim=-1)
                     .float().mean())
    emit({"phase": "sharded", "part": "n4096", "n": n_big, "patterns": 200, "requests": B,
          "plan": dataclasses.asdict(plan), "w_bytes": int(w_big.nbytes),
          "w_block_bytes": blocks, "launches": path, "launches_per_cycle": per,
          "field_kernel_at_shard": fields, "unsharded_launches": path_u, "settled": int(res.settled.sum()),
          "sharded_first_call_s": seconds, "sharded_warm_solve_s": warm,
          "unsharded_first_call_s": seconds_u, "unsharded_warm_solve_s": warm_u,
          "sharded_over_unsharded_s": warm / warm_u, "accuracy": accuracy,
          "nvidia_smi": nvidia_smi_line(), "equal_to_unsharded": True})

    # maxcut: phase 10's 16 graphs under 2x4, kernel 1i per block and instance shard
    plan = ShardPlan(2, 4)
    mesh = mesh_of(plan)
    solver_mc = api.MaxCutSolver(**mc_kw, device=dev)
    seen = {}
    with plan.context(mesh):
        res, seconds, path = driven(lambda: solver_mc.solve(
            graphs, key=torch.Generator().manual_seed(seed)), seen)
        warm = warm_s(lambda: solver_mc.solve(graphs, key=torch.Generator().manual_seed(seed)))
    require_same(res, mc_res, ising.MaxCutResult._fields, "sharded maxcut 2x4: != unsharded")
    fields = shard_kernels(seen, "sharded maxcut")
    groups = ising.resolve_stagger_groups(0, N)
    stepped = -(-int(res.sweeps_run.max()) // MC_CHUNK) * MC_CHUNK
    n_launch = path.get("coupling_sum_batched", 0)
    require(n_launch == 8 * groups * stepped,
            f"sharded maxcut: {n_launch} launches of kernel 1i, not 8 a group")
    emit({"phase": "sharded", "part": "maxcut", "n": N, "instances": MC_INSTANCES,
          "plan": dataclasses.asdict(plan), "groups": groups, "sweeps_stepped": stepped,
          "launches": path, "launches_per_group": 8, "field_kernel_at_shard": fields,
          "first_call_s": seconds, "warm_solve_s": warm, "equal_to_unsharded": True})

    # compressed: the int8 wire under 1x4 at N = 506, card against the CPU,
    # then the small field (N = 40, weight_bits 2), where it is exact
    plan = ShardPlan(1, 4, compressed=True)
    mesh = mesh_of(plan)
    solver = api.RetrievalSolver(cfg_k, api.make_params(cfg_k, w_np, device=dev))
    seen = {}
    with plan.context(mesh):
        res, seconds, path = driven(lambda: solver.solve(probes), seen)
    fields = shard_kernels(seen, "sharded compressed")
    cpu_solver = api.RetrievalSolver(cfg_k, api.make_params(cfg_k, w_np, device="cpu"))
    with plan.context(make_mesh((1, 4), devices=["cpu"] * 4)):
        cpu_res = cpu_solver.solve(probes)
    require_equal(res, cpu_res, "sharded compressed 1x4: card != CPU")
    differs = torch.zeros(B, dtype=torch.bool)
    for f in FIELDS:
        a, b = getattr(res, f).cpu(), getattr(checked, f).cpu()
        differs |= (a != b).reshape(B, -1).any(dim=1)
    rng_s = np.random.default_rng([seed, 43])
    w_small = rng_s.integers(-1, 2, (40, 40)).astype(np.int8)
    np.fill_diagonal(w_small, 0)
    s_small = torch.as_tensor(rng_s.choice([-1, 1], (256, 40)).astype(np.int8), device=dev)
    cfg_s = dataclasses.replace(cfg_k, n=40, weight_bits=2)
    params_s = api.make_params(cfg_s, w_small, device=dev)
    exact = dyn.retrieve(cfg_s, params_s, s_small)
    seen = {}
    with plan.context(mesh):
        small, _, path_small = driven(lambda: dyn.retrieve(cfg_s, params_s, s_small), seen)
    require_equal(small, exact, "sharded compressed small field: != the exact path")
    fields_small = shard_kernels(seen, "sharded compressed small field")
    emit({"phase": "sharded", "part": "compressed", "config": "ONN_HYBRID_506",
          "plan": dataclasses.asdict(plan), "requests": B, "launches": path,
          "field_kernel_at_shard": fields, "first_call_s": seconds, "equal_to_cpu": True,
          "lanes_differing_from_exact": int(differs.sum()),
          "small_field": {"n": 40, "weight_bits": 2, "lanes": 256, "launches": path_small,
                          "field_kernel_at_shard": fields_small, "equal_to_exact": True}})

    # daemon: phase 12's retrieval stream and Max-Cut requests under 1x2
    plan = ShardPlan(1, 2)
    mesh = mesh_of(plan)
    eng = serving.ContinuousEngine(torch.Generator().manual_seed(seed), device=dev,
                                   slab_lanes=DAEMON_SLAB, tenant_weights=dict(DAEMON_TENANTS))
    eng.install("mem", "retrieval", solver=api.RetrievalSolver(
        cfg_k, sharding.shard_onn_params(api.make_params(cfg_k, w_np, device=dev), plan, mesh)))
    eng.install("cuts", "maxcut", device=dev, **mc_kw)
    order = [("mem", a, c) for a, c in spans]
    for i, (pos, *_rest) in enumerate(mc_in):
        order.insert(pos, ("cuts", i, 1))
    reqs = []
    for kind, ref, count in order:
        if kind == "mem":
            reqs.append(Request("mem", probes[ref:ref + count]))
        else:
            _, adj, key_seed, _ = mc_in[ref]
            reqs.append(Request("cuts", adj, key=torch.Generator().manual_seed(key_seed)))
    seen = {}
    with plan.context(mesh):
        (report, futs, wall, *_), seconds, path = driven(lambda: serve_stream(
            eng, reqs, serving.ticked_source(reqs, per_tick=DAEMON_PER_TICK)), seen)
    for i, ((kind, ref, _), f) in enumerate(zip(order, futs)):
        require(f.done() and f.exception() is None, f"sharded daemon request {i} failed")
        if kind == "mem":
            require_rows(f.result(), checked, ref, f"sharded daemon request {i} != solve")
        else:
            require_same(f.result(), mc_in[ref][3], ising.MaxCutResult._fields,
                         f"sharded daemon Max-Cut request {i} != solve")
    require(report["completed"] == len(reqs), "sharded daemon: not every request completed")
    for k in ("coupling_sum", "coupling_sum_batched"):
        require(path.get(k, 0) > 0, f"sharded daemon: {k} never launched")
    fields = shard_kernels(seen, "sharded daemon")
    emit({"phase": "sharded", "part": "daemon", "plan": dataclasses.asdict(plan),
          "requests": len(reqs), "completed": report["completed"], "ticks": report["ticks"],
          "wall_s": wall, "requests_per_s": len(reqs) / wall, "latency": latency_ms(report),
          "launches": path, "field_kernel_at_shard": fields, "equal_to_solve": True})

    # launcher: serve_requests' halves under 1x4 against the unsharded serve
    plan = ShardPlan(1, 4)
    mesh = mesh_of(plan)
    solver = api.RetrievalSolver(cfg_k, api.make_params(cfg_k, w_np, device=dev))
    xi_dev = torch.as_tensor(xi, device=dev)
    gen = torch.Generator().manual_seed(seed)
    which, corrupted = launch_retrieve.draw_requests(xi_dev, 0.25, SHARDED_LAUNCH_REQUESTS, gen)
    served, seen = [], {}
    for p in (None, plan):
        (report, res), seconds, path = driven(lambda p=p: launch_retrieve.serve_corrupted(
            solver, xi_dev.cpu()[which], corrupted, torch.Generator().manual_seed(seed),
            corruption=0.25, plan=p, mesh=None if p is None else mesh),
            None if p is None else seen)
        served.append((report, res, seconds, path))
    (rep_u, res_u, *_), (rep_s, res_s, seconds, path) = served
    require_same(res_s, res_u, FIELDS, "sharded launcher: != the unsharded serve")
    require(rep_s["mesh_devices"] == 4 and rep_s["shard_plan"] == dataclasses.asdict(plan),
            f"sharded launcher: report {rep_s['mesh_devices']}, {rep_s['shard_plan']}")
    require(path.get("coupling_sum", 0) > 0, "sharded launcher: kernel 1 never launched")
    fields = shard_kernels(seen, "sharded launcher")
    full = launch_retrieve.serve_requests(solver, xi_dev, 0.25, 64, seed, plan=plan, mesh=mesh)
    require(full["mesh_devices"] == 4, "serve_requests: mesh_devices != 4")
    emit({"phase": "sharded", "part": "launcher", "entry": "launch.retrieve.serve_requests",
          "requests": SHARDED_LAUNCH_REQUESTS, "mesh_devices": rep_s["mesh_devices"],
          "shard_plan": rep_s["shard_plan"], "accuracy": rep_s["accuracy"],
          "wall_s": rep_s["wall_s"], "unsharded_wall_s": rep_u["wall_s"], "launches": path,
          "field_kernel_at_shard": fields, "equal_to_unsharded": True})
    return own


def gate_vlm(lm, seed: int) -> None:
    """Set a built ``VisionLM``'s zero-initialized gates (each cross block's
    attention ``gate`` and ``mlp_gate``) to ±(0.5-1.5), drawn from a seeded
    CPU generator, group by group, in place."""
    gen = torch.Generator().manual_seed(seed)
    n_groups = len(lm.cross_blocks)
    values = [(0.5 + torch.rand((n_groups,), generator=gen))
              * (torch.randint(0, 2, (n_groups,), generator=gen) * 2 - 1) for _ in range(2)]
    with torch.no_grad():
        for g, cp in enumerate(lm.cross_blocks):
            cp["attn"]["gate"].fill_(float(values[0][g]))
            cp["mlp_gate"].fill_(float(values[1][g]))


def lm_decode_bound(model, batch: int, prompt_len: int, new: int) -> tuple:
    """(ms, by): the least time of one decode step of ``model``'s config,
    averaged over the steps of a run.  Bytes: every weight a step reads once
    (all but the embedding table, of which B rows; a VLM's ``vision_proj``
    and the cross ``wk``/``wv`` of the VLM and the enc-dec decoder are not
    read: their products sit in the cache; an enc-dec model's encoder is not
    read, and its tied ``embed`` is read whole as the head; Zamba's shared
    block is read once per invocation, its weights far past the L2; every
    MoE expert computes its slots, so every expert's weights count), the
    valid self-attention keys and values, the cross keys and values (a
    VLM's vision tokens; all ENCDEC_DECODE_MEMORY_LEN slots of the enc-dec
    cache), and a recurrent cache's state and conv buffers (Zamba, xLSTM),
    read and written.  Operations: two per multiplied weight and lane, at
    the bf16 peak."""
    from repro_torch.models import params as PM
    from repro_torch.models.model import ENCDEC_DECODE_MEMORY_LEN, ENCDEC_PREFILL_PROMPT_LEN

    cfg = model.cfg
    skip = ("embed", "vision_proj", "cross_blocks.attn.wk", "cross_blocks.attn.wv",
            "dec_blocks.cross_attn.wk", "dec_blocks.cross_attn.wv")
    invocations = cfg.n_layers // cfg.shared_attn_every if cfg.family == "zamba" else 1
    weights = n_mult = 0
    for path, spec in PM.leaves(model.param_specs):
        if path in skip or path.startswith(("enc_blocks.", "enc_norm.")):
            continue
        n = int(np.prod(spec.shape)) * (invocations if path.startswith("shared.") else 1)
        weights += n * spec.dtype.itemsize
        n_mult += n
    if cfg.family == "encdec":  # the tied head
        weights += cfg.padded_vocab * cfg.d_model * 2
        n_mult += cfg.padded_vocab * cfg.d_model
    weights += batch * cfg.d_model * 2
    kv_row = 2 * batch * cfg.n_kv_heads * cfg.hd * 2  # k and v of one layer and position, bf16
    n_self = {"vlm": cfg.n_layers // max(cfg.cross_every, 1) * (cfg.cross_every - 1),
              "zamba": invocations, "xlstm": 0}.get(cfg.family, cfg.n_layers)
    cache = 0
    if cfg.family == "vlm":
        cache = cfg.n_layers // cfg.cross_every * cfg.n_vision_tokens * kv_row
    elif cfg.family == "encdec":
        cache = cfg.n_layers * ENCDEC_DECODE_MEMORY_LEN * kv_row
    elif cfg.family in ("zamba", "xlstm"):  # the recurrent leaves, read and written
        cache = 2 * PM.param_bytes({k: v for k, v in model.cache_specs(batch, 1).items()
                                    if k not in ("k", "v")})
    steps = range(prompt_len, prompt_len + new - 1)  # index + 1 keys valid
    kv = sum(n_self * kv_row * (i + 1) for i in steps) / len(steps)
    return bound(weights + kv + cache, 2 * n_mult * batch, BF16_FLOPS_PER_S)


def xlstm_blocks_held(card, cpu, prompt, token, dev) -> dict:
    """Every block of an xLSTM on the card against its CPU copy on identical
    inputs (the CPU's hidden states): over ``prompt`` (1, T), then one decode
    step of ``token`` (1, 1) from the CPU's caches.  Each block's output
    must lie within 2⁻⁶ (bf16; float32: 2⁻¹⁸) of its largest magnitude, the
    single-block tolerance of the CPU tests.  Returns the largest |Δ| over
    that tolerance, for the prefill and the step, and the block count."""
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as X
    from repro_torch.models.params import torch_dtype

    cfg = cpu.cfg
    tol = 2.0**-6 if cfg.dtype == "bfloat16" else 2.0**-18
    worst = {"prefill": 0.0, "decode_step": 0.0}

    def held(part, got, want):
        err = float((got.float().cpu() - want.float()).abs().max())
        worst[part] = max(worst[part], err / (tol * float(want.float().abs().max())))

    def to_dev(cache):  # a copy: each side's decode step writes its cache in place
        if isinstance(cache, X.MLSTMCache):
            return X.MLSTMCache(*(t.to(dev, copy=True) for t in cache))
        return cache[0].to(dev, copy=True), X.SLSTMCache(*(t.to(dev, copy=True) for t in cache[1]))

    blocks = []
    for g_cpu, g_card, s_cpu, s_card in zip(cpu.mblocks, card.mblocks, cpu.sblocks, card.sblocks):
        blocks += [("mlstm", c, d) for c, d in zip(g_cpu, g_card)] + [("slstm", s_cpu, s_card)]
    with torch.inference_mode():
        x = cpu["embed"][prompt].to(torch_dtype(cfg.dtype))
        x_step = cpu["embed"][token].to(torch_dtype(cfg.dtype))
        for kind, c, d in blocks:
            forward = X.mlstm_forward if kind == "mlstm" else X.slstm_forward
            step = X.mlstm_decode_step if kind == "mlstm" else X.slstm_decode_step
            h = L.rms_norm(x, c["ln"], cfg.norm_eps)
            y, cache = forward(c[kind], h, cfg, return_cache=True)
            held("prefill", forward(d[kind], h.to(dev), cfg), y)
            card_cache = to_dev(cache)
            h = L.rms_norm(x_step, c["ln"], cfg.norm_eps)
            y_step, _ = step(c[kind], h, cache, cfg)
            held("decode_step", step(d[kind], h.to(dev), card_cache, cfg)[0], y_step)
            x, x_step = x + y, x_step + y_step
    return {"max_err_over_tol": max(worst.values()), "tolerance": tol, "blocks": len(blocks),
            **{f"{k}_max_err_over_tol": v for k, v in worst.items()}}


def lm_lines(dev, seed, drive, tracegate_dir, tracegate_procs) -> dict:
    """Phase 15: the LM serving path on ``dev``, one JSON line per part:
    the dense family (qwen2-1.5b), the enc-dec (whisper-large-v3), the VLM
    (llama-3.2-vision-11b), the MoE (granite-moe-3b-a800m), Zamba
    (zamba2-2.7b) and xLSTM (xlstm-1.3b) at full width, then the reduced
    archs of the six families card against CPU; returns the launches of
    these lines by kernel (none is expected: the path is plain PyTorch).
    ``drive``: main's launch-counting runner.  As the enc-dec's CPU check
    starts (the card idles through it), phase 19's tracegate processes
    start, writing into ``tracegate_dir``, and join ``tracegate_procs``;
    they are waited for before the VLM's serve."""
    import copy
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import configs as lm_configs
    from repro_torch.engine.adapters import LMEngineSolver
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import params as PM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import make_generate

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import moe_rule
    from lm_rule import depth, hold, ratios

    own = {}

    def driven(fn):
        res, seconds, path = drive(fn)
        for k, v in path.items():
            own[k] = own.get(k, 0) + v
        return res, seconds, sum(path.values())

    reduced_precision = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    tf32 = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    require(tf32 == {"allow_tf32": False, "float32_matmul_precision": "highest"},
            f"lm: TF32 would reach the float32 router's product: {tf32}")

    def build(arch, n_layers, d_model, n_params):
        """The arch at full width as ``serve(..., reduced=False)`` builds it,
        and the generator it drew from (it draws the prompts next).  Each
        arch after the first is built on ``drawer``'s thread while the
        previous arch's CPU check runs (its weights are drawn on one host
        core; the check's products take the others)."""
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(seed)
        lm = LMEngineSolver(arch, gen, reduced=False, device=dev)
        torch.cuda.synchronize()
        cfg = lm.cfg
        count = PM.count_params(lm.model.param_specs)
        require((cfg.n_layers, cfg.d_model, count) == (n_layers, d_model, n_params),
                f"lm: {arch} is not at full width")
        return lm, gen, time.perf_counter() - t0

    def serve_part(lm, gen, part, batch, prompt_len, new, prompts, vision, build_s, frames=None):
        cfg = lm.cfg
        torch.cuda.reset_peak_memory_stats()
        t_part = time.perf_counter()
        extras = {"vision": vision, "frames": frames}
        lm.timings.clear()
        (rep_d, tok_d), _, n_d = driven(
            lambda: launch_serve.serve_prompts(lm, prompts, new, gen, **extras))
        # The --once serve, the second at this batch, is the warm one timed.
        lm.timings.clear()
        (rep_o, tok_o), warm, n_o = driven(lambda: launch_serve.serve_prompts(
            lm, prompts, new, torch.Generator().manual_seed(seed), once=True, **extras))
        timing = dict(lm.timings[-1])
        require(torch.equal(tok_d, tok_o), f"lm {part}: daemon and --once tokens differ")
        # make_generate of the bucket, the one call a served slab makes, traced
        # on the device alone: the serve's device time, and its tokens the
        # served ones.
        batch_in = {"tokens": prompts, **{k: v for k, v in extras.items() if v is not None}}
        traced = []
        busy_ms, per_name, _ = device_busy(
            lambda: traced.append(make_generate(lm.model)(lm.params, batch_in, new)[0]))
        require(torch.equal(tok_d, traced[-1]),
                f"lm {part}: a served request differs from make_generate of its bucket")
        del traced
        step_ms = timing["decode_s"] * 1e3 / max(new - 1, 1)
        bound_ms, bound_by = lm_decode_bound(lm.model, batch, prompt_len, new)
        line = {
            "phase": "lm", "part": part, "arch": lm.arch, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": PM.count_params(lm.model.param_specs),
            "param_bytes": PM.param_bytes(lm.model.param_specs),
            "dtype": cfg.dtype, "requests": batch, "prompt_len": prompt_len, "new_tokens": new,
            "daemon": rep_d, "once": rep_o, "daemon_equals_once": True,
            "equal_to_make_generate_same_bucket": True,
            "warm": {"serve": "once", "wall_s": warm, "prefill_s": timing["prefill_s"],
                     "decode_s": timing["decode_s"],
                     "tokens_per_s": batch * new / max(timing["decode_s"], 1e-9),
                     "device_busy_ms": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / (warm * 1e3),
                     "top_device_ms": dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:6])},
            "decode_step_ms": step_ms, "decode_bound_ms": bound_ms, "decode_bound_by": bound_by,
            "decode_step_over_bound": step_ms / bound_ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "allow_bf16_reduced_precision_reduction": reduced_precision,
            "ported_kernel_launches": n_d + n_o, "build_s": build_s,
            "part_s": time.perf_counter() - t_part,
        }
        if cfg.family == "moe":
            line.update(experts=cfg.n_experts, top_k=cfg.top_k, tf32=tf32, capacity_prefill=int(
                np.ceil(cfg.capacity_factor * cfg.top_k * prompt_len / cfg.n_experts)))
        if vision is not None:
            line["vision"] = list(vision.shape[1:])
        if frames is not None:
            line["frames"] = list(frames.shape[1:])
        if cfg.family in ("zamba", "xlstm"):
            line["ssm_chunk"] = cfg.ssm_chunk
        emit(line)
        return tok_d

    def held(what, fn):
        try:
            return fn()
        except AssertionError as exc:
            fail(f"{what}: {exc}")

    drawer = ThreadPoolExecutor(max_workers=1)
    # In this order each draw fits inside the CPU check before it (the
    # VLM's, the longest, beside the enc-dec's check, the longest).
    upcoming = iter([(LM_ENCDEC_ARCH, 32, 1280, 1_535_595_520),
                     (LM_VLM_ARCH, 40, 4096, 9_806_614_544),
                     (LM_MOE_ARCH, 32, 1536, 3_374_679_552),
                     (LM_ZAMBA_ARCH, 54, 2560, 2_422_711_200),
                     (LM_XLSTM_ARCH, 48, 2048, 2_552_244_560)])

    threads = torch.get_num_threads()

    def draw_next():
        """Start building the next arch on the drawer's thread, and leave
        the draw a core of its own: beside it, the CPU check runs one
        intra-op thread fewer (with every thread, the draw's thread shares
        a core with one of the check's, and each parallel region waits for
        that one)."""
        torch.set_num_threads(max(threads - 1, 1))
        return drawer.submit(build, *next(upcoming))

    def drawn(future):
        """The next arch, once drawn, with every intra-op thread back."""
        built = future.result()
        torch.set_num_threads(threads)
        return built

    def cpu_check(part, arch, lm, held_runs, t_part):
        """Hold each (what, prompts, stream, frames) of ``held_runs`` made on
        the card to a CPU copy of ``lm`` by the LM rule at ``depth(cfg)``,
        emit the part's line, and free the model."""
        cfg = lm.cfg
        cpu_lm = copy.deepcopy(lm.params).to("cpu")
        rules, cpu_s = {}, {}
        for what, prompts_h, stream_h, frames_h in held_runs:
            t_cpu = time.perf_counter()
            rules[what] = held(f"lm {part} {what}", lambda: moe_rule.hold_streams(
                lm.model, lm.params, cpu_lm, prompts_h, stream_h, frames=frames_h,
                what=f"lm {part} {what}"))
            cpu_s[what] = time.perf_counter() - t_cpu
        del cpu_lm
        first = next(iter(rules))
        emit({"phase": "lm", "part": part, "arch": arch, "depth": depth(cfg),
              "layers": cfg.n_layers, "depth_cut": None,
              "streams": {what: list(stream.shape) for what, _, stream, _ in held_runs},
              "rule": rules[first], "max_diff_over_tau": max(
                  r["max_diff_over_tau"] for r in rules.values()),
              "rules": rules, "cpu_s": cpu_s, "ported_kernel_launches": 0,
              "part_s": time.perf_counter() - t_part})

    def xlstm_cpu_check(lm, prompts, served, t_part):
        """``cpu_check_xlstm``: the LM rule at depth 48 is measured and
        reported, but xlstm-1.3b's random weights compound rounding
        differences from block to block (port fault 5, ROADMAP.md section
        3), so the line is held by ``xlstm_blocks_held``: every block, card
        against CPU, on identical inputs.  Beside it, the model's own
        sensitivity: the card's bf16 stream against a float32 run of the same
        weights, in the rule's τ."""
        from lm_rule import stream_logits

        cfg = lm.cfg
        cpu_lm = copy.deepcopy(lm.params).to("cpu")
        t_cpu = time.perf_counter()
        card_logits = stream_logits(lm.model, lm.params, prompts, served)
        cpu_logits = stream_logits(lm.model, cpu_lm, prompts, served)
        cpu_s = time.perf_counter() - t_cpu
        measured = ratios(card_logits, cpu_logits, cfg.dtype, depth(cfg))
        try:
            rule = hold(served, card_logits, cpu_logits, cfg.dtype, depth(cfg), "cpu_check_xlstm")
        except AssertionError as exc:
            rule = {"held": False, "first_miss": str(exc)}
        rule.update(max_diff_over_tau=float(measured.max()),
                    min_diff_over_tau=float(measured.min()),
                    steps_over_tau=int((measured > 1).sum()), steps=int(measured.size))
        model32 = get_model(dataclasses.replace(cfg, dtype="float32"))
        card32 = stream_logits(model32, lm.params, prompts, served)
        sensitivity = ratios(card_logits, card32, cfg.dtype, depth(cfg))
        t_blocks = time.perf_counter()
        blocks = xlstm_blocks_held(lm.params, cpu_lm, prompts[:1], served[:1, :1], dev)
        blocks["cpu_s"] = time.perf_counter() - t_blocks
        require(blocks["max_err_over_tol"] <= 1.0,
                f"lm cpu_check_xlstm: a block differs between the card and the CPU on identical "
                f"inputs: {blocks}")
        del cpu_lm
        emit({"phase": "lm", "part": "cpu_check_xlstm", "arch": LM_XLSTM_ARCH,
              "depth": depth(cfg), "layers": cfg.n_layers, "depth_cut": None,
              "streams": {"serve_xlstm": list(served.shape)}, "rule": rule,
              "max_diff_over_tau": rule["max_diff_over_tau"], "port_fault": 5,
              "held_by": "blocks", "blocks": blocks,
              "sensitivity_bf16_vs_float32_over_tau": {
                  "max": float(sensitivity.max()), "min": float(sensitivity.min())},
              "cpu_s": cpu_s, "ported_kernel_launches": 0,
              "part_s": time.perf_counter() - t_part})

    # the dense family: qwen2-1.5b ------------------------------------------------
    lm, gen, build_s = build(LM_ARCH, 28, 1536, 1_777_088_000)
    cfg = lm.cfg
    batch, prompt_len, new = LM_SERVE
    prompts = launch_serve.draw_prompts(cfg.vocab, batch, prompt_len, gen)
    served = serve_part(lm, gen, "serve", batch, prompt_len, new, prompts, None, build_s)
    b128, p128, n128 = LM_BATCH128
    serve_part(lm, gen, "serve_batch128", b128, p128, n128,
               launch_serve.draw_prompts(cfg.vocab, b128, p128, gen), None, build_s)

    t_part = time.perf_counter()
    drawing = draw_next()
    cpu_lm = copy.deepcopy(lm.params).to("cpu")
    t_cpu = time.perf_counter()
    rule = held("lm cpu_check", lambda: moe_rule.hold_streams(
        lm.model, lm.params, cpu_lm, prompts, served, what="lm cpu_check"))
    cpu_s = time.perf_counter() - t_cpu
    del cpu_lm, lm
    torch.cuda.empty_cache()
    emit({"phase": "lm", "part": "cpu_check", "arch": LM_ARCH, "depth": cfg.n_layers,
          "depth_cut": None, "streams": batch, "steps": new, "rule": rule, "cpu_s": cpu_s,
          "ported_kernel_launches": 0, "part_s": time.perf_counter() - t_part})

    # the enc-dec: whisper-large-v3 -----------------------------------------------
    from repro_torch.models.model import ENCDEC_DECODE_MEMORY_LEN, ENCDEC_PREFILL_PROMPT_LEN

    lm, gen, build_s = drawn(drawing)
    cfg = lm.cfg
    require(cfg.n_encoder_layers == 32, "lm: whisper-large-v3 has 32 encoder layers")
    prompts = launch_serve.draw_prompts(cfg.vocab, batch, prompt_len, gen)
    frames = launch_serve.draw_frames(prompt_len, cfg.d_model, batch, gen)
    served = serve_part(lm, gen, "serve_encdec", batch, prompt_len, new, prompts, None, build_s,
                        frames=frames)
    (b1500, n1500), p1500 = LM_ENCDEC_1500, ENCDEC_PREFILL_PROMPT_LEN
    prompts_1500 = launch_serve.draw_prompts(cfg.vocab, b1500, p1500, gen)
    frames_1500 = launch_serve.draw_frames(ENCDEC_DECODE_MEMORY_LEN, cfg.d_model, b1500, gen)
    served_1500 = serve_part(lm, gen, "serve_encdec_1500", b1500, p1500, n1500, prompts_1500,
                             None, build_s, frames=frames_1500)
    t_part = time.perf_counter()
    # The first 30 s request alone: its own one-lane stream on the card (a
    # stream is held at the batch it was made at).
    (first_1500, _), _, n_first = driven(lambda: make_generate(lm.model)(
        lm.params, {"tokens": prompts_1500[:1], "frames": frames_1500[:1]}, new))
    require(n_first == 0, "lm cpu_check_encdec: a ported kernel launched")
    drawing = draw_next()
    t_tracegate = time.perf_counter()
    tracegate_procs.extend(start_tracegate(tracegate_dir))
    cpu_check("cpu_check_encdec", LM_ENCDEC_ARCH, lm, [
        ("serve_encdec", prompts, served, frames),
        ("serve_encdec_1500_first", prompts_1500[:1], first_1500, frames_1500[:1])], t_part)
    del lm, served_1500, frames_1500
    torch.cuda.empty_cache()

    # the VLM: llama-3.2-vision-11b ----------------------------------------------
    lm, gen, build_s = drawn(drawing)
    cfg = lm.cfg
    prompts = launch_serve.draw_prompts(cfg.vocab, batch, prompt_len, gen)
    vision = launch_serve.draw_vision(cfg.n_vision_tokens, cfg.vision_dim, batch, gen)
    # The tracegate processes end before the next serve, so that it has the
    # card to itself.
    t_wait = time.perf_counter()
    for proc in tracegate_procs:
        proc.wait(timeout=TRACEGATE_TIMEOUT_S)
    emit({"phase": "analysis", "part": "tracegate_joined",
          "tracegate_s": time.perf_counter() - t_tracegate,
          "waited_s": time.perf_counter() - t_wait})
    served = serve_part(lm, gen, "serve_vlm", batch, prompt_len, new, prompts, vision, build_s)

    t_part = time.perf_counter()
    drawing = draw_next()
    cpu_lm = copy.deepcopy(lm.params).to("cpu")
    vision2 = launch_serve.draw_vision(cfg.n_vision_tokens, cfg.vision_dim, batch,
                                       torch.Generator().manual_seed(seed + 1))

    def prefill_logits(vis):
        with torch.inference_mode():
            (logits, _), _, n = driven(lambda: lm.model.prefill_fn(
                lm.params, {"tokens": prompts.to(dev), "vision": vis.to(dev)}))
        return logits.float().cpu(), n

    def cut_stream(streams, steps):
        """A fresh card stream of the first ``streams`` requests (the depth
        cut of this line), and its batch."""
        batch_cut = {"tokens": prompts[:streams], "vision": vision[:streams]}
        (stream, _), _, n = driven(lambda: make_generate(lm.model)(lm.params, batch_cut, steps))
        return stream, batch_cut, n

    zero_stream, zero_batch, n_z = cut_stream(*LM_VLM_ZERO_CUT)
    t_cpu = time.perf_counter()
    zero = held("lm cpu_check_vlm", lambda: moe_rule.hold_streams(
        lm.model, lm.params, cpu_lm, zero_batch["tokens"], zero_stream,
        vision=zero_batch["vision"], what="lm cpu_check_vlm"))
    cpu_s = time.perf_counter() - t_cpu
    (base, n_a), (moved, n_b) = prefill_logits(vision), prefill_logits(vision2)
    require(torch.equal(base, moved), "lm cpu_check_vlm: vision moved the logits at zero gates")
    gate_vlm(lm.params, seed + 2)
    gate_vlm(cpu_lm, seed + 2)
    (gated_base, n_c), (gated_moved, n_d) = prefill_logits(vision), prefill_logits(vision2)
    require(not torch.equal(gated_base, gated_moved),
            "lm cpu_check_vlm: vision did not move the logits with non-zero gates")
    gated_stream, gated_batch, n_e = cut_stream(*LM_VLM_GATED_CUT)
    t_cpu = time.perf_counter()
    gated_rule = held("lm cpu_check_vlm gated", lambda: moe_rule.hold_streams(
        lm.model, lm.params, cpu_lm, gated_batch["tokens"], gated_stream,
        vision=gated_batch["vision"], what="lm cpu_check_vlm gated"))
    cpu_gated_s = time.perf_counter() - t_cpu
    del cpu_lm, lm
    torch.cuda.empty_cache()
    emit({"phase": "lm", "part": "cpu_check_vlm", "arch": LM_VLM_ARCH, "depth": cfg.n_layers,
          "cross_layers": cfg.n_layers // cfg.cross_every,
          "depth_cut": {"zero_gates": {"streams": [batch, LM_VLM_ZERO_CUT[0]],
                                       "steps": [new, LM_VLM_ZERO_CUT[1]]},
                        "gated": {"streams": [batch, LM_VLM_GATED_CUT[0]],
                                  "steps": [new, LM_VLM_GATED_CUT[1]]}},
          "streams": LM_VLM_ZERO_CUT[0], "steps": LM_VLM_ZERO_CUT[1], "rule": zero,
          "cpu_s": cpu_s,
          "vision_moves_logits": {"zero_gates": False, "gated": True},
          "gated": {"rule": gated_rule, "cpu_s": cpu_gated_s,
                    "max_abs_logit_change_from_vision": float(
                        (gated_base - gated_moved).abs().max())},
          "ported_kernel_launches": n_z + n_a + n_b + n_c + n_d + n_e,
          "part_s": time.perf_counter() - t_part})

    # the MoE: granite-moe-3b-a800m ----------------------------------------------
    lm, gen, build_s = drawn(drawing)
    cfg = lm.cfg
    prompts = launch_serve.draw_prompts(cfg.vocab, batch, prompt_len, gen)
    served = serve_part(lm, gen, "serve_moe", batch, prompt_len, new, prompts, None, build_s)
    serve_part(lm, gen, "serve_moe_batch128", b128, p128, n128,
               launch_serve.draw_prompts(cfg.vocab, b128, p128, gen), None, build_s)

    t_part = time.perf_counter()
    drawing = draw_next()
    cpu_lm = copy.deepcopy(lm.params).to("cpu")
    t_cpu = time.perf_counter()
    rule = held("lm cpu_check_moe", lambda: moe_rule.hold_streams(
        lm.model, lm.params, cpu_lm, prompts, served, what="lm cpu_check_moe"))
    cpu_s = time.perf_counter() - t_cpu
    # One float32 prefill of the same prompts on the bf16 weights (upcast
    # exactly in every product): every routing decided, the logits within τ.
    model32 = get_model(dataclasses.replace(cfg, dtype="float32"))
    with torch.inference_mode():
        with moe_rule.recording() as calls_card:
            (card32, _), _, n32 = driven(lambda: model32.prefill_fn(
                lm.params, {"tokens": prompts.to(dev)}))
        with moe_rule.recording() as calls_cpu:
            cpu32, _ = model32.prefill_fn(cpu_lm, {"tokens": prompts})
    routes = held("lm cpu_check_moe float32", lambda: moe_rule.hold_calls(moe_rule.pair_calls(
        calls_card, calls_cpu, [0] * cfg.n_layers), "lm cpu_check_moe float32"))
    require(routes["route_bound"] == 0,
            f"lm cpu_check_moe: {routes['route_bound']} float32 routings are tie-bound")
    card32, cpu32 = card32.float().cpu().numpy()[:, None], cpu32.float().cpu().numpy()[:, None]
    rule32 = held("lm cpu_check_moe float32", lambda: hold(
        card32.argmax(-1), card32, cpu32, "float32", cfg.n_layers, "lm cpu_check_moe float32"))
    del cpu_lm, lm
    torch.cuda.empty_cache()
    emit({"phase": "lm", "part": "cpu_check_moe", "arch": LM_MOE_ARCH, "depth": cfg.n_layers,
          "depth_cut": None, "streams": batch, "steps": new, "rule": rule,
          "route_bound": rule["route_bound"], "routings": rule["routings"],
          "positions_held": rule["steps_held"], "positions": rule["steps"],
          "max_diff_over_tau": rule["max_diff_over_tau"], "cpu_s": cpu_s,
          "float32_prefill": {"route_bound": routes["route_bound"],
                              "routings": routes["routings"],
                              "least_decided_gap_over_2delta":
                                  routes["least_decided_gap_over_2delta"],
                              "rule": rule32},
          "tf32": tf32, "ported_kernel_launches": n32, "part_s": time.perf_counter() - t_part})

    # Zamba and xLSTM: zamba2-2.7b, xlstm-1.3b -----------------------------------
    for arch, short in ((LM_ZAMBA_ARCH, "zamba"), (LM_XLSTM_ARCH, "xlstm")):
        lm, gen, build_s = drawn(drawing)
        cfg = lm.cfg
        s_batch, s_prompt, s_new = LM_SSM_SERVE
        prompts = launch_serve.draw_prompts(cfg.vocab, s_batch, s_prompt, gen)
        served = serve_part(lm, gen, f"serve_{short}", s_batch, s_prompt, s_new, prompts, None,
                            build_s)
        serve_part(lm, gen, f"serve_{short}_batch128", b128, p128, n128,
                   launch_serve.draw_prompts(cfg.vocab, b128, p128, gen), None, build_s)
        t_part = time.perf_counter()
        if short == "zamba":
            drawing = draw_next()
            cpu_check("cpu_check_zamba", arch, lm, [("serve_zamba", prompts, served, None)],
                      t_part)
        else:
            xlstm_cpu_check(lm, prompts, served, t_part)
        del lm
        torch.cuda.empty_cache()

    # archs: every arch at reduced size, card against CPU --------------------------
    t_part = time.perf_counter()
    rules, launches = {}, 0
    archs = LM_DENSE + LM_FAMILIES
    for i, arch in enumerate(archs):
        for dtype in ("float32", "bfloat16"):
            rcfg = dataclasses.replace(lm_configs.get_reduced(arch), dtype=dtype)
            model = get_model(rcfg)
            tree = PM.materialize(model.param_specs, torch.Generator().manual_seed(seed + i),
                                  device="cpu")
            batch_in = {"tokens": torch.randint(
                0, rcfg.vocab, (2, 32), dtype=torch.int32,
                generator=torch.Generator().manual_seed(seed + 100 + i))}
            cpu_params = model.build_params(tree)
            card_params = model.build_params(PM.map_tree(lambda t: t.to(dev), tree))
            vis = fr = None
            if rcfg.family == "vlm":
                gate_vlm(cpu_params, seed + i)
                gate_vlm(card_params, seed + i)
                vis = launch_serve.draw_vision(rcfg.n_vision_tokens, rcfg.vision_dim, 2,
                                               torch.Generator().manual_seed(seed + 200 + i))
                batch_in["vision"] = vis
            if rcfg.family == "encdec":
                fr = launch_serve.draw_frames(32, rcfg.d_model, 2,
                                              torch.Generator().manual_seed(seed + 300 + i))
                batch_in["frames"] = fr
            (stream, _), _, n = driven(lambda: make_generate(model)(card_params, batch_in, 16))
            launches += n
            what = f"lm archs {arch} {dtype}"
            rules[f"{arch}:{dtype}"] = held(what, lambda: moe_rule.hold_streams(
                model, card_params, cpu_params, batch_in["tokens"], stream, vision=vis,
                frames=fr, what=what))
            if rcfg.family == "moe" and dtype == "float32":
                require(rules[f"{arch}:{dtype}"]["route_bound"] == 0,
                        f"{what}: a float32 routing is tie-bound")
    emit({"phase": "lm", "part": "archs", "archs": list(archs), "prompt_len": 32,
          "new_tokens": 16, "rules": rules, "ring_buffer": "h2o-danube-1.8b (window 32)",
          "vlm_gated": True, "encdec_frames": 32,
          "depths": {arch: depth(lm_configs.get_reduced(arch)) for arch in archs},
          "ported_kernel_launches": launches,
          "part_s": time.perf_counter() - t_part})
    drawer.shutdown()
    torch.cuda.empty_cache()
    return own


def seeded_lm_tree(model, seed: int, device="cpu"):
    """Weights drawn by ``materialize`` from a seeded CPU generator, with
    every zeros- or ones-initialized leaf (norms, biases, the SSM's and the
    mLSTM's gate parameters, the VLM's gates) moved by 0.1 · N(0, 1), so
    that every term of the layers has a gradient."""
    from repro_torch.models import params as PM

    tree = PM.materialize(model.param_specs, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def seed_leaves(level, specs):
        for name, leaf in level.items():
            if isinstance(leaf, dict):
                seed_leaves(leaf, specs[name])
            elif specs[name].init != "normal":
                level[name] = (leaf.float() + 0.1 * torch.randn(leaf.shape, generator=gen)).to(
                    leaf.dtype)

    seed_leaves(tree, model.param_specs)
    return PM.map_tree(lambda t: t.to(device), tree)


def device_lm_tree(specs, seed: int, dev):
    """A parameter tree of ``specs`` drawn on the card (normal leaves at
    their scale, zeros and ones filled): the timing state of
    ``train_full``, whose values do not change its work."""
    from repro_torch.models import params as PM

    gen = torch.Generator(device=dev).manual_seed(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            fill = torch.zeros if spec.init == "zeros" else torch.ones
            return fill(spec.shape, dtype=spec.dtype, device=dev)
        std = spec.scale if spec.init == "normal" else 1.0
        return (torch.randn(spec.shape, generator=gen, device=dev) * std).to(spec.dtype)

    return PM.map_tree(one, specs)


def preempted_at(step: int):
    """A context in which the launcher's step monitor delivers SIGTERM to
    this process as step index ``step`` ends (a preemption notice)."""
    import contextlib

    from repro_torch.distributed import ft

    @contextlib.contextmanager
    def scope():
        stop = ft.StepMonitor.stop

        def stop_and_signal(self, i):
            if i == step:
                os.kill(os.getpid(), signal.SIGTERM)
            return stop(self, i)

        ft.StepMonitor.stop = stop_and_signal
        try:
            yield
        finally:
            ft.StepMonitor.stop = stop

    return scope()


def train_flops(model, batch: int, seq: int) -> dict:
    """Model FLOPs of one training step: 6 · non-embedding parameters ·
    tokens for the products (the head included), and the causal attention's
    QKᵀ and PV, forward and backward (3 · 2 · 2 · B · H · S² · hd / 2 a
    layer)."""
    from repro_torch.models import params as PM

    cfg = model.cfg
    params = PM.count_params(model.param_specs)
    embed = PM.count_params({"embed": model.param_specs["embed"]})
    gemm = 6 * (params - embed) * batch * seq
    attention = 6 * batch * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
    return {"gemm": float(gemm), "attention": float(attention),
            "total": float(gemm + attention), "non_embedding_params": params - embed}


def train_lines(dev, seed, drive) -> dict:
    """Phase 16: LM training on ``dev`` (``repro_torch.launch.train``,
    ``make_train_step``, the optimizers and the checkpointer), one JSON line
    per part: ``train_full`` (qwen2-1.5b at full width), ``train_check``
    (its full width cut to 2 layers, card against CPU), ``train_archs`` (the
    ten reduced archs, card against CPU) and ``train_resume`` (a preempted
    and resumed run on the card, its checkpoint restored on the CPU);
    returns the launches of these lines by kernel (none is expected: the
    path is plain PyTorch) and ``train_full``'s step: its live ``TrainState``
    and batch, peak memory, model FLOPs, step and bound seconds, for phase
    17.  ``drive``: main's launch-counting runner."""
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch import configs as lm_configs
    from repro_torch import optim
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train as launch_train
    from repro_torch.models import params as PM
    from repro_torch.models import steps
    from repro_torch.models.config import SHAPES
    from repro_torch.models.model import get_model

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import train_rule

    own = {}
    smi = nvidia_smi_line()

    def driven(fn):
        res, seconds, path = drive(fn)
        for k, v in path.items():
            own[k] = own.get(k, 0) + v
        return res, seconds, sum(path.values())

    def held(what, fn):
        try:
            return fn()
        except AssertionError as exc:
            fail(f"{what}: {exc}")

    tf32 = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}

    # train_full: qwen2-1.5b at full width through the launcher ------------------
    t_part = time.perf_counter()
    cfg = lm_configs.get_config(LM_ARCH)
    model = get_model(cfg)
    n_params = PM.count_params(model.param_specs)
    require((cfg.n_layers, cfg.d_model, n_params, cfg.remat, cfg.dtype)
            == (28, 1536, 1_777_088_000, True, "bfloat16"),
            f"train_full: {LM_ARCH} is not at full width with remat")
    shape = SHAPES["train_4k"]
    require((shape.seq_len, shape.global_batch) == (TRAIN_SEQ, TRAIN_GLOBAL_BATCH),
            "train_full: train_4k's shape changed")
    microbatches = steps.auto_microbatches(shape, TRAIN_GLOBAL_BATCH // TRAIN_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, run_s, n_full = driven(lambda: launch_train.train(
        LM_ARCH, reduced=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        microbatches=microbatches, seed=seed, log_every=0, device=dev))
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    require(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
            f"train_full: a loss is not finite: {losses}")
    require(losses[-1] < losses[0], f"train_full: the loss did not fall: {losses}")
    timed = sorted(out["step_s"][1:])
    step_s = timed[len(timed) // 2]
    flops = train_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    bound_s = flops["total"] / BF16_FLOPS_PER_S
    # One warm step traced (the device's events only; its idle share from
    # its own wall time), and the optimizer's update alone, on a state of
    # the same shapes drawn on the card (the launcher keeps its own).
    opt = optim.adamw(optim.cosine_warmup(3e-4, max(TRAIN_STEPS // 10, 1), TRAIN_STEPS))
    step_fn = steps.make_train_step(model, opt, microbatches=microbatches)
    params = device_lm_tree(model.param_specs, seed, dev)
    state = steps.TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                             opt.init(params))
    del params
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    batch = stream.next()
    stream.close()
    # warm: the launcher's run made the same step at the same shapes
    busy_ms, per_name, traced_ms = device_busy(lambda: step_fn(state, batch))
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = PM.map_tree(
        lambda p: (torch.randn(p.shape, generator=gen, device=dev) * 1e-3).to(p.dtype),
        state.params)
    update_ms = cuda_ms(lambda: opt.update(grads, state.opt, state.params), iters=3, warmup=1)
    # the update's least bytes: g, p, m, v read once, p, m, v written once
    update_bytes = sum(t.numel() * (2 * t.element_size() + 16) for _, t in PM.leaves(grads))
    del grads
    torch.cuda.empty_cache()
    # phase 17 counts this step on the meta device beside these tensors
    full_step = {"state": state, "batch": batch, "max_memory_allocated": peak,
                 "model_flops": flops, "step_s": step_s, "bound_s": bound_s,
                 "microbatches": microbatches}
    del state
    emit({"phase": "train", "part": "train_full", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params, "dtype": cfg.dtype, "remat": cfg.remat,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "global_batch": TRAIN_GLOBAL_BATCH,
          "reduced": {"global_batch": f"{TRAIN_GLOBAL_BATCH} -> {TRAIN_BATCH}"},
          "microbatches": microbatches, "optimizer": "adamw",
          "schedule": f"cosine_warmup(3e-4, {max(TRAIN_STEPS // 10, 1)}, {TRAIN_STEPS})",
          "steps": TRAIN_STEPS, "timed_steps": len(timed), "losses": losses,
          "first_loss": losses[0], "last_loss": losses[-1], "step_ms": step_s * 1e3,
          "step_ms_each": [x * 1e3 for x in out["step_s"]],
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "model_flops": flops,
          "bound_ms": bound_s * 1e3,
          "bound_by": "operations: the model FLOPs at 989 TFLOP/s dense bf16",
          "bound_over_step": bound_s / step_s, "optimizer_update_ms": update_ms,
          "optimizer_update_bound_ms": update_bytes / HBM_BYTES_PER_S * 1e3,
          "max_memory_allocated": peak, "device_busy_ms": busy_ms, "traced_step_ms": traced_ms,
          "device_idle_share": 1.0 - busy_ms / traced_ms,
          "top_device_ms": dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:6]),
          "checkpoint": None, "run_s": run_s, "nvidia_smi": smi,
          "ported_kernel_launches": n_full, "part_s": time.perf_counter() - t_part})

    # train_check: the full width cut to 2 layers, float32, card against CPU -----
    t_part = time.perf_counter()
    require(not tf32["allow_tf32"] and tf32["float32_matmul_precision"] == "highest",
            f"train_check: TF32 would reach the float32 products: {tf32}")
    layers, b_check, s_check = TRAIN_CHECK
    cfg2 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    model2 = get_model(cfg2)
    cpu_tree = seeded_lm_tree(model2, seed)
    card_tree = PM.map_tree(lambda t: t.to(dev), cpu_tree)
    stream = TokenStream(cfg2.vocab, b_check, s_check, seed=seed)
    batch = {k: torch.as_tensor(v) for k, v in stream.next().items()}
    stream.close()
    (summary, _, g_cpu), check_s, n_check = driven(lambda: held("train_check", lambda: (
        train_rule.hold_step(model2, card_tree, cpu_tree, batch, "train_check"))))
    counts = held("train_check adamw", lambda: train_rule.hold_adamw_identical(
        card_tree, cpu_tree, g_cpu, "train_check adamw"))
    del cpu_tree, card_tree, g_cpu
    torch.cuda.empty_cache()
    emit({"phase": "train", "part": "train_check", "arch": LM_ARCH, "layers": layers,
          "d_model": cfg2.d_model, "params": PM.count_params(model2.param_specs),
          "depth_cut": {"layers": [cfg.n_layers, layers]}, "dtype": "float32", "tf32": tf32,
          "batch": b_check, "seq_len": s_check, "rule": summary,
          "adamw_identical_grads_differing": counts, "adamw_held": True, "check_s": check_s,
          "ported_kernel_launches": n_check, "part_s": time.perf_counter() - t_part})

    # train_archs: the ten reduced archs, card against CPU --------------------------
    t_part = time.perf_counter()
    rules, launches = {}, 0
    archs = LM_DENSE + LM_FAMILIES
    for i, arch in enumerate(archs):
        cfg_a = dataclasses.replace(lm_configs.get_reduced(arch), dtype="float32")
        model_a = get_model(cfg_a)
        cpu_tree = seeded_lm_tree(model_a, seed + 300 + i)
        card_tree = PM.map_tree(lambda t: t.to(dev), cpu_tree)
        gen = torch.Generator().manual_seed(seed + 400 + i)
        tokens = torch.randint(0, cfg_a.vocab, (2, 32), dtype=torch.int32, generator=gen)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
        if cfg_a.family == "vlm":
            batch["vision"] = torch.randn((2, cfg_a.n_vision_tokens, cfg_a.vision_dim),
                                          generator=gen)
        if cfg_a.family == "encdec":
            batch["frames"] = torch.randn((2, 32, cfg_a.d_model), generator=gen)
        what = f"train_archs {arch}"
        name = "adafactor" if cfg_a.family == "moe" else "adamw"
        opt_a = optim.get_optimizer(name, optim.cosine_warmup(3e-4, 2000, 100_000))

        def one_arch():
            summary, _, _ = train_rule.hold_step(model_a, card_tree, cpu_tree, batch, what)
            state = steps.TrainState(torch.zeros((), dtype=torch.int32, device=dev), card_tree,
                                     opt_a.init(card_tree))
            new, metrics = steps.make_train_step(model_a, opt_a)(state, batch)
            train_rule.hold_loss(float(metrics["loss"]), summary["loss_card"], "float32",
                                 0, f"{what} make_train_step")
            require(all(bool(torch.isfinite(v).all()) for _, v in PM.leaves(new.params)),
                    f"{what}: make_train_step's params are not finite")
            return dict(summary, optimizer=name)

        rules[arch], _, n = driven(lambda: held(what, one_arch))
        launches += n
    emit({"phase": "train", "part": "train_archs", "archs": list(archs), "dtype": "float32",
          "batch": [2, 32], "rules": rules, "ported_kernel_launches": launches,
          "part_s": time.perf_counter() - t_part})

    # train_resume: preempted at step 3 and resumed, against an uninterrupted run --
    t_part = time.perf_counter()
    dirs = [tempfile.mkdtemp(prefix="train_resume_") for _ in range(2)]
    try:
        kw = dict(reduced=True, steps=TRAIN_RESUME_STEPS, batch=4, seq_len=64, lr=1e-3,
                  seed=seed, log_every=0, ckpt_every=TRAIN_PREEMPT_AFTER, device=dev)
        whole, _, n_a = driven(lambda: launch_train.train(LM_ARCH, ckpt_dir=dirs[0], **kw))
        with preempted_at(TRAIN_PREEMPT_AFTER - 1):
            first, _, n_b = driven(lambda: launch_train.train(LM_ARCH, ckpt_dir=dirs[1], **kw))
        require(first["status"] == "preempted" and first["final_step"] == TRAIN_PREEMPT_AFTER,
                f"train_resume: the preempted run: {first}")
        second, _, n_c = driven(lambda: launch_train.train(LM_ARCH, ckpt_dir=dirs[1], **kw))
        resumed = first["losses"] + second["losses"]
        require(len(resumed) == TRAIN_RESUME_STEPS and second["final_step"] == TRAIN_RESUME_STEPS,
                f"train_resume: the resumed run: {second}")
        ratios = [held("train_resume", lambda a=a, b=b: train_rule.hold_loss(
            a, b, "float32", 0, "train_resume")) for a, b in zip(resumed, whole["losses"])]
        # The checkpoint the card wrote, restored on the CPU and on the card.
        model_r = get_model(lm_configs.get_reduced(LM_ARCH))
        opt_r = optim.adamw(optim.constant(1e-3))
        target = launch_train.build_state(model_r, opt_r, torch.Generator().manual_seed(seed), "cpu")
        step_w = ckpt_lib.latest_step(dirs[1])
        on_cpu = ckpt_lib.restore(dirs[1], step_w, target, device="cpu")
        on_card = ckpt_lib.restore(dirs[1], step_w, target, device=dev)
        bits = all(torch.equal(a, b.cpu()) for (_, a), (_, b) in zip(
            PM.leaves(on_cpu._asdict()), PM.leaves(on_card._asdict())))
        # And a state held on the card, saved and restored on the CPU.
        state = launch_train.build_state(model_r, opt_r, torch.Generator().manual_seed(seed + 1), dev)
        stream = TokenStream(model_r.cfg.vocab, 4, 64, seed=seed)
        state, _ = steps.make_train_step(model_r, opt_r)(state, stream.next())
        stream.close()
        saver = ckpt_lib.AsyncCheckpointer(dirs[0], keep=10)
        saver.save(100, state, extra_meta={"data_state": {"cursor": 1, "seed": seed}})
        saver.wait()
        back = ckpt_lib.restore(dirs[0], 100, target, device="cpu")
        held_bits = all(torch.equal(a, b.cpu()) for (_, a), (_, b) in zip(
            PM.leaves(back._asdict()), PM.leaves(state._asdict())))
        require(bits and held_bits, "train_resume: a checkpoint did not restore bit for bit")
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "train", "part": "train_resume", "arch": f"{LM_ARCH} (reduced)",
          "steps": TRAIN_RESUME_STEPS, "preempted_at": TRAIN_PREEMPT_AFTER,
          "checkpoint_every": TRAIN_PREEMPT_AFTER, "losses_uninterrupted": whole["losses"],
          "losses_resumed": resumed, "max_loss_diff_over_bound": max(ratios),
          "restored_on_cpu_bit_for_bit": True, "card_state_restored_on_cpu_bit_for_bit": True,
          "checkpoint_step": step_w, "ported_kernel_launches": n_a + n_b + n_c,
          "part_s": time.perf_counter() - t_part})
    return own, full_step


def count_train_full(out_dir: str) -> None:
    """The dry run's cell of phase 16's own step (``LM_ARCH``, ``TRAIN_BATCH``
    × ``TRAIN_SEQ``, its microbatches, AdamW) on a 1 × 1 mesh, written
    under ``out_dir``: run by :func:`start_dryrun_cli` in a process of its
    own (``python -c``), beside phase 16."""
    from repro_torch.distributed import Mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import steps
    from repro_torch.models.config import SHAPES

    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    mesh1 = Mesh(np.array([[torch.device("meta")]], dtype=object))
    microbatches = steps.auto_microbatches(SHAPES["train_4k"], TRAIN_GLOBAL_BATCH // TRAIN_BATCH)
    dryrun.run_cell(LM_ARCH, "train_4k", False, microbatches=microbatches, mesh=mesh1,
                    shape=shape, outdir=out_dir, tag="train_full", verbose=False)


def start_dryrun_cli(out_dir: str) -> list:
    """Start ``DRYRUN_CLI_CELLS``' ``python -m repro_torch.launch.dryrun``
    processes, each writing under ``out_dir``/cli<i>, and the count of phase
    16's own step (:func:`count_train_full`, under ``out_dir``/train_full).
    They count on the meta device (one Python thread each, niced), so they
    run on the host's idle cores while phase 16 trains on the card; phase 17
    reads them."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape_name, "--mesh", mesh_name, "--out", os.path.join(out_dir, f"cli{i}")]
            for i, (arch, shape_name, mesh_name) in enumerate(DRYRUN_CLI_CELLS)]
    cmds.append([sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.count_train_full(sys.argv[1])", os.path.join(out_dir, "train_full")])
    return [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=ROOT, preexec_fn=lambda: os.nice(10))
            for cmd in cmds]


def stop_processes(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_lines(dev, seed, drive, full_step, procs, out_dir) -> dict:
    """Phase 17: the LM dry run (``repro_torch.launch.dryrun``) on the meta
    device, one JSON line per part.  ``dryrun_train_full``: the cell of
    phase 16's own step (qwen2-1.5b, 8 × 4096 tokens, 2 microbatches,
    AdamW) on a 1 × 1 mesh, counted beside ``full_step``: its argument
    bytes equal the live state's and batch's exactly, its peak (arguments
    plus temporaries) against the step's ``max_memory_allocated``, its
    FLOPs against the model FLOPs and its roofline against the measured
    step.  ``dryrun_production``: qwen2-1.5b train_4k on both production
    meshes, qwen2-1.5b decode_32k, h2o-danube-1.8b long_500k and
    arctic-480b train_4k, each cell's roofline terms, dominant term,
    per-device bytes and ``fits``: ``procs``, started by
    :func:`start_dryrun_cli` before phase 16, wrote those cells and the
    count of phase 16's step under ``out_dir``.  ``dryrun_share``: device
    (0, 0)'s program of ``DRYRUN_SHARE_CELL`` on the card
    (:func:`dryrun_share_line`).  Returns the launches of the phase by
    kernel (none is expected)."""
    from repro_torch.models import params as PM

    own = {}
    t_phase = time.perf_counter()
    for proc in procs:
        log, _ = proc.communicate(timeout=DRYRUN_CLI_TIMEOUT_S)
        require(proc.returncode == 0, f"dryrun: {proc.args}:\n{log}")
    # dryrun_train_full: phase 16's step, counted beside its live tensors
    t_part = time.perf_counter()
    state, batch = full_step["state"], full_step["batch"]
    live = (sum(t.nbytes for _, t in PM.leaves(state._asdict()))
            + sum(np.asarray(v).nbytes for v in batch.values()))
    (name,) = os.listdir(os.path.join(out_dir, "train_full"))
    with open(os.path.join(out_dir, "train_full", name)) as f:
        cell = json.load(f)
    require(cell["microbatches"] == full_step["microbatches"] and cell["mesh"] == "1x1",
            f"dryrun_train_full: the counted cell is not phase 16's step: {cell['microbatches']}")
    mem = cell["memory_analysis"]
    require(mem["argument_size_in_bytes"] == live,
            f"dryrun_train_full: argument bytes {mem['argument_size_in_bytes']} are not the "
            f"live state's and batch's {live}")
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = full_step["max_memory_allocated"]
    require(abs(predicted / measured - 1) <= DRYRUN_PEAK_TOLERANCE,
            f"dryrun_train_full: predicted peak {predicted} against {measured} measured")
    roof = cell["roofline"]
    bound = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    emit({"phase": "dryrun", "part": "dryrun_train_full", "cell": cell["cell"],
          "mesh": cell["mesh"], "arch": LM_ARCH, "batch": TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "microbatches": cell["microbatches"],
          "optimizer": cell["optimizer"], "memory_analysis": mem,
          "live_state_and_batch_bytes": live, "argument_bytes_equal_live": True,
          "predicted_peak_bytes": predicted, "max_memory_allocated": measured,
          "predicted_over_measured_peak": predicted / measured,
          "peak_tolerance": DRYRUN_PEAK_TOLERANCE,
          "counted_flops": cell["cost_analysis"]["flops"],
          "model_flops": full_step["model_flops"]["total"],
          "counted_over_model_flops":
              cell["cost_analysis"]["flops"] / full_step["model_flops"]["total"],
          "bytes_accessed": cell["cost_analysis"]["bytes_accessed"],
          "roofline": roof, "bound_s": bound, "dominant": roof["dominant"],
          "step_s": full_step["step_s"], "bound_over_step": bound / full_step["step_s"],
          "model_flops_bound_s": full_step["bound_s"],
          "cost_probe_s": cell["cost_probe_s"], "memory_probe_s": cell["memory_probe_s"],
          "cell_s": cell["seconds"], "counted_in": "a process beside phase 16",
          "ported_kernel_launches": 0, "part_s": time.perf_counter() - t_part})
    del state, batch

    # dryrun_production: the cells of the CLI's processes
    t_part = time.perf_counter()
    cells = []
    for i in range(len(DRYRUN_CLI_CELLS)):
        cli_dir = os.path.join(out_dir, f"cli{i}")
        for name in sorted(os.listdir(cli_dir)):
            with open(os.path.join(cli_dir, name)) as f:
                cells.append(json.load(f))
    require(len(cells) == len(DRYRUN_CLI_CELLS),
            f"dryrun_production: {len(cells)} cells written")
    for c, spec in zip(cells, DRYRUN_CLI_CELLS):
        r, m = c["roofline"], c["memory_analysis"]
        _, program_args, _ = dryrun_program(c, spec)
        require(program_args == m["argument_size_in_bytes"],
                f"dryrun_production: {c['cell']} ({c['mesh']}): the program's arguments "
                f"{program_args} B against the count's {m['argument_size_in_bytes']} B")
        emit({"phase": "dryrun", "part": "dryrun_production", "cell": c["cell"],
              "mesh": c["mesh"], "n_devices": c["n_devices"], "dp_size": c["dp_size"],
              "replica_batch": c["replica_batch"], "microbatches": c["microbatches"],
              "compute_s": r["compute_s"], "memory_s": r["memory_s"],
              "collective_s": r["collective_s"], "dominant": r["dominant"],
              "flops_per_device": r["flops_per_device"],
              "hbm_bytes_per_device": r["hbm_bytes_per_device"],
              "collective_bytes_per_device": r["collective_bytes_per_device"],
              "argument_bytes_per_device": m["argument_size_in_bytes"],
              "program_argument_bytes": program_args, "program_arguments_equal_count": True,
              "temp_bytes_per_device": m["temp_size_in_bytes"], "fits": c["fits"],
              "useful_flops_ratio": c["useful_flops_ratio"], "n_params": c["n_params"],
              "cell_s": c["seconds"], "model_axis": c["model_axis"],
              "per_device": c["per_device"], "peak_segment": c["peak_segment"],
              "collectives_params": c["collectives_params"],
              "collectives_tp": c["collectives_tp"], "ported_kernel_launches": 0,
              "part_s": time.perf_counter() - t_part})

    # dryrun_share: device (0, 0)'s program of DRYRUN_SHARE_CELL on the card
    share = next(c for c, spec in zip(cells, DRYRUN_CLI_CELLS) if spec == DRYRUN_SHARE_CELL)
    line, path = dryrun_share_line(dev, seed, drive, share)
    for k, v in path.items():
        own[k] = own.get(k, 0) + v
    emit(line)
    emit({"phase": "dryrun", "part": "phase", "phase_s": time.perf_counter() - t_phase,
          "device": str(dev)})
    return own


def dryrun_program(cell: dict, spec: tuple):
    """(one device's program of the counted production ``cell`` of
    ``DRYRUN_CLI_CELLS``' ``spec`` (arch, shape, mesh), its
    arguments' bytes, its parameters' specs at its blocks):
    ``build_cell(per_device=True)`` at the cell's replica batch and
    microbatches on the production mesh."""
    from repro_torch import configs as lm_configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import params as PM
    from repro_torch.models import steps, tp
    from repro_torch.models.config import SHAPES
    from repro_torch.models.model import get_model

    arch, shape_name, mesh_name = spec
    multi = mesh_name == "multi"
    sizes = PM.mesh_axis_sizes(make_production_mesh(multi_pod=multi))
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=cell["replica_batch"])
    cfg, rules = lm_configs.get_config(arch), dryrun.rules_for(arch, shape_name, multi)
    prog = steps.build_cell(cfg, shape, rules, microbatches=cell["microbatches"],
                            dp_size=cell["dp_size"], axis_sizes=sizes, per_device=True)
    leaves = PM.leaves({str(i): a._asdict() if hasattr(a, "_asdict") else a
                        for i, a in enumerate(prog.abstract_args)})
    local = tp.local_specs(get_model(cfg).param_specs, rules, sizes)
    return prog, sum(t.nbytes for _, t in leaves), local


def dryrun_share_line(dev, seed, drive, cell: dict) -> tuple:
    """``dryrun_share``: one device's program (``models/tp.py``) of the
    production cell ``DRYRUN_SHARE_CELL`` run on the card at full width and
    depth: its blocks of every split leaf, over ``"model"`` and the FSDP
    ``"data"`` (drawn on the card), its float32 gradient accumulators and
    optimizer state at those blocks, the replica's batch in the cell's
    microbatches, one train step with every collective the identity
    (``tp.IdentityHook``: a gather repeats the device's block, a
    reduce-scatter keeps its first block, a sum its own part).  Its
    argument bytes against the count's and the live tensors', the count's
    predicted peak (arguments plus the cell's temporaries) against
    ``max_memory_allocated`` less what earlier phases still hold, the
    hook's calls by op against the count's collectives, the step's ms
    against the roofline's card terms; (line, launches by kernel)."""
    from repro_torch import configs as lm_configs
    from repro_torch.models import params as PM
    from repro_torch.models import tp

    t_part = time.perf_counter()
    prog, args_bytes, local_specs = dryrun_program(cell, DRYRUN_SHARE_CELL)
    require(prog.kind == "train", f"dryrun_share: {cell['cell']} is not a train cell")
    counted_args = cell["memory_analysis"]["argument_size_in_bytes"]
    require(args_bytes == counted_args, f"dryrun_share: the program's arguments {args_bytes} B "
                                        f"against the count's {counted_args} B")
    abstract_state, abstract_batch = prog.abstract_args
    cfg = lm_configs.get_config(DRYRUN_SHARE_CELL[0])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    params = device_lm_tree(local_specs, seed, dev)
    state = type(abstract_state)(
        torch.zeros((), dtype=torch.int32, device=dev), params,
        PM.map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                    abstract_state.opt))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {k: torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen, device=dev,
                              dtype=t.dtype) for k, t in abstract_batch.items()}
    live = (sum(t.nbytes for _, t in PM.leaves(state._asdict()))
            + sum(t.nbytes for t in batch.values()))
    require(live == args_bytes, f"dryrun_share: live {live} B against the program's "
                                f"arguments {args_bytes} B")
    hook = tp.IdentityHook(prog.sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        with tp.use(prog.layout(hook), shared=True):
            out = prog.step_fn(state, batch)
        torch.cuda.synchronize()
        return out

    (new_state, metrics), step_s, path = drive(step)
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(metrics["loss"])
    require(math.isfinite(loss), f"dryrun_share: the loss is {loss}")
    del new_state, metrics, state, params, batch
    torch.cuda.empty_cache()
    predicted = args_bytes + cell["memory_analysis"]["temp_size_in_bytes"]
    require(abs(predicted / peak - 1) <= DRYRUN_PEAK_TOLERANCE,
            f"dryrun_share: predicted peak {predicted} against {peak} measured")
    require(hook.counts == cell["collectives"]["counts"],
            f"dryrun_share: the hook's calls {hook.counts} against the count's "
            f"{cell['collectives']['counts']}")
    roof = cell["roofline"]
    card_bound = max(roof["compute_s"], roof["memory_s"])
    return ({"phase": "dryrun", "part": "dryrun_share", "cell": cell["cell"],
             "mesh": cell["mesh"], "device": [0, 0], "model_axis": cell["model_axis"],
             "axis_sizes": prog.sizes,
             "replica_batch": cell["replica_batch"], "microbatches": cell["microbatches"],
             "seq_len": int(abstract_batch["tokens"].shape[1]), "layers": cfg.n_layers,
             "d_model": cfg.d_model,
             "program_argument_bytes": args_bytes, "live_argument_bytes": live,
             "device_argument_bytes": counted_args, "argument_bytes_equal_live": True,
             "argument_bytes_equal_count": True,
             "temp_size_in_bytes": cell["memory_analysis"]["temp_size_in_bytes"],
             "peak_segment": cell["peak_segment"], "predicted_peak_bytes": predicted,
             "max_memory_allocated": peak, "held_before_bytes": base,
             "predicted_over_measured_peak": predicted / peak,
             "peak_tolerance": DRYRUN_PEAK_TOLERANCE,
             "loss_identity_joined": loss,
             "step_ms": step_s * 1e3, "step_timed": "one step, after phase 16's warm run",
             "roofline": roof, "card_bound_ms": card_bound * 1e3,
             "card_bound_over_step": card_bound / step_s,
             "collectives": "the identity (no peers)", "hook_calls": hook.counts,
             "counted_collectives": cell["collectives"]["counts"],
             "hook_calls_equal_count": True,
             "nvidia_smi": nvidia_smi_line(), "ported_kernel_launches": sum(path.values()),
             "part_s": time.perf_counter() - t_part}, path)


def dryrun_onn_lines(dev, seed, drive) -> tuple:
    """Phase 18: the ONN dry run (``repro_torch.launch.dryrun.run_onn_cell``).
    ``count``: the ten cells of ``DRYRUN_ONN_CELLS`` counted on the meta
    device, each with its roofline terms, dominant term, per-device bytes
    and ``fits``, no float tensor among them; ``refused``: the row layouts
    at ``onn_506``.  ``share``: device (0, 0)'s program of the single-pod
    ``onn_131072`` cell (``baseline2d``, ``rowpar``) and of ``onn_506`` on
    the card, on a W block of seeded 5-bit values and seeded ±1 spins, its
    collectives the identity (one card has no peers): the counted argument
    bytes equal the live tensors', the predicted peak against the sweep's
    ``max_memory_allocated`` within ``DRYRUN_PEAK_TOLERANCE``, the roofline
    terms against the sweep's CUDA-event time, the kernel's ms a launch at
    the share's shape beside ``torch._int_mm`` and its bound, and the first
    cycle's block equal to the plain version on the CPU (the plain
    version's ms on the card beside the kernel's).  ``composed``:
    each variant's programs on a (2, 4) mesh of the card repeated at
    ``DRYRUN_ONN_COMPOSED``, the collectives done as sums and copies, equal
    after 32 cycles to the unsharded sweep of kernel 2.  Returns the
    launches of the phase by kernel and the kernels' times at the shares'
    shapes."""
    from repro_torch.core.dynamics import sign_update
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import ref as plain
    from repro_torch.launch import dryrun

    own = {}

    def driven(fn):
        res, seconds, path = drive(fn)
        for k, v in path.items():
            own[k] = own.get(k, 0) + v
        return res, seconds, path

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="dryrun_onn_")
    cells = {}
    try:
        for cell, multi_pod, variant in DRYRUN_ONN_CELLS:
            c = dryrun.run_onn_cell(cell, multi_pod, variant=variant, outdir=out_dir,
                                    verbose=False)
            floats = [d for d in c["dtypes_counted"] if "float" in d]
            require(not floats, f"dryrun_onn {cell} {variant}: float tensors counted {floats}")
            cells[(cell, multi_pod, variant)] = c
            r, m = c["roofline"], c["memory_analysis"]
            emit({"phase": "dryrun_onn", "part": "count", "cell": cell, "mesh": c["mesh"],
                  "variant": variant, "layout": c["layout"], "n_devices": c["n_devices"],
                  "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                  "collective_s": r["collective_s"], "dominant": r["dominant"],
                  "flops_per_device": r["flops_per_device"],
                  "hbm_bytes_per_device": r["hbm_bytes_per_device"],
                  "collectives": c["collectives"],
                  "argument_bytes_per_device": m["argument_size_in_bytes"],
                  "temp_bytes_per_device": m["temp_size_in_bytes"],
                  "output_bytes_per_device": m["output_size_in_bytes"], "fits": c["fits"],
                  "useful_flops_ratio": c["useful_flops_ratio"],
                  "dtypes_counted": c["dtypes_counted"], "cell_s": c["seconds"]})
        refused = {}
        for variant in dryrun.ONN_VARIANTS[1:]:
            try:
                dryrun.run_onn_cell("onn_506", False, variant=variant, outdir=out_dir,
                                    verbose=False)
            except ValueError as e:
                refused[variant] = str(e)
        require(len(refused) == 3, f"dryrun_onn: onn_506 row layouts not refused: {refused}")
        emit({"phase": "dryrun_onn", "part": "refused", "cell": "onn_506", "refused": refused})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # one device's share on the card, its collectives the identity
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = []
    for cell, variant in DRYRUN_ONN_SHARES:
        t_part = time.perf_counter()
        c = cells[(cell, False, variant)]
        prog = dryrun.onn_cell_program(cell, False, variant)
        (w_shape, _), (s_shape, _) = prog.argument_shapes()
        w = torch.randint(-15, 16, w_shape, generator=gen, device=dev, dtype=torch.int8)
        sigma = torch.randint(0, 2, s_shape, generator=gen, device=dev, dtype=torch.int8) * 2 - 1
        mem = c["memory_analysis"]
        live = w.nbytes + sigma.nbytes
        require(mem["argument_size_in_bytes"] == live,
                f"dryrun_onn share {cell} {variant}: argument bytes "
                f"{mem['argument_size_in_bytes']} are not the live tensors' {live}")
        pos = (0, 0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() - live
        torch.cuda.reset_peak_memory_stats()
        out, _, path = driven(lambda: dryrun.run_onn_share(prog, pos, w, sigma))
        measured = torch.cuda.max_memory_allocated() - before
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        require(abs(predicted / measured - 1) <= DRYRUN_PEAK_TOLERANCE,
                f"dryrun_onn share {cell} {variant}: predicted peak {predicted} against "
                f"{measured} measured")
        kernel = "onn_step" if prog.layout == "replicated" else "coupling_sum"
        require(path.get(kernel, 0) == prog.cycles and sum(path.values()) == prog.cycles,
                f"dryrun_onn share {cell} {variant}: launches {path}")
        regimes = dict(ops.REGIME_LAUNCHES)  # the sweep's launches by regime
        require(out.shape == sigma.shape and out.dtype == torch.int8
                and bool(torch.all(out.abs() == 1)), f"dryrun_onn share {cell}: not ±1 spins")
        del out
        sweep_ms = cuda_ms(lambda: dryrun.run_onn_share(prog, pos, w, sigma), iters=3, warmup=1)
        # the first cycle's block against the plain version on the CPU
        one = dryrun.run_onn_share(dataclasses.replace(prog, cycles=1), pos, w, sigma).cpu()
        w_cpu, s_cpu = w.cpu(), sigma.cpu()
        if kernel == "onn_step":
            x, rows = s_cpu, prog.n
            want = plain.onn_step_ref(w_cpu, s_cpu, torch.zeros(prog.n, dtype=torch.int32))
        else:
            rows, cols = prog.block
            x = s_cpu[:, :cols]
            want = sign_update(plain.coupling_sum_ref(w_cpu, x), s_cpu[:, :rows])
        require(torch.equal(one[:, :rows], want) and torch.equal(one[:, rows:], s_cpu[:, rows:]),
                f"dryrun_onn share {cell} {variant}: first cycle differs from the plain version")
        del one, w_cpu, s_cpu, want
        # the kernel at the share's shape: its ms a launch, torch._int_mm, its bound
        x = sigma[:, :x.shape[1]].contiguous()
        b, k = x.shape
        m = w.shape[0]
        plan = autotune.coupling_route(kernel, 1, b, m, k)
        require(regimes == {f"{kernel}/{plan.regime}": prog.cycles},
                f"dryrun_onn share {cell} {variant}: launches by regime {regimes}")
        out_bytes = b * m * (1 if kernel == "onn_step" else 4)
        b_ms, b_by = bound(w.nbytes + x.nbytes + out_bytes, 2 * b * m * k)
        if kernel == "onn_step":
            h = torch.zeros(m, dtype=torch.int32, device=dev)
            fn, plain_fn = (lambda: ops.onn_step(w, x)), (lambda: plain.onn_step_ref(w, x, h))
        else:
            fn, plain_fn = (lambda: ops.coupling_sum(w, x)), (
                lambda: plain.coupling_sum_ref(w, x))
        k_ms = device_ms(fn, f"{kernel}/wgmma" if plan.regime == "wgmma" else kernel, iters=10)
        ms_of = "kernel" if k_ms is not None else "wrapper"
        if k_ms is None:  # the profiler recorded too few launches
            k_ms = cuda_ms(fn, iters=10)
        wrapper_ms = cuda_ms(fn, iters=10)
        p_ms = cuda_ms(plain_fn, iters=2, warmup=1)
        lib_ms = None
        if b > 16:  # torch._int_mm on operands zero-padded to multiples of 8 (506 → 512)
            kp, mp = -(-k // 8) * 8, -(-m // 8) * 8
            x_p = torch.nn.functional.pad(x, (0, kp - k))
            w_p = torch.nn.functional.pad(w, (0, kp - k, 0, mp - m))
            lib_ms = cuda_ms(lambda: torch._int_mm(x_p, w_p.t()), iters=10)
            del x_p, w_p
        shape = {"kernel": kernel, "B": b, "M": m, "K": k, "ms": k_ms, "ms_of": ms_of,
                 "wrapper_ms": wrapper_ms, "plain_ms": p_ms,
                 "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "plan": route_plan_dict(plan)}
        shapes.append({"cell": cell, "variant": variant, **shape})
        r = c["roofline"]
        emit({"phase": "dryrun_onn", "part": "share", "cell": cell, "mesh": "single",
              "variant": variant, "position": list(pos), "w_block": list(w_shape),
              "sigma": list(s_shape), "live_argument_bytes": live,
              "argument_bytes_equal_live": True, "predicted_peak_bytes": predicted,
              "max_memory_allocated_over_sweep": measured,
              "predicted_over_measured_peak": predicted / measured,
              "peak_tolerance": DRYRUN_PEAK_TOLERANCE, "cycles": prog.cycles,
              "launches": path, "launches_by_regime": regimes, "sweep_ms": sweep_ms,
              "compute_ms": r["compute_s"] * 1e3, "memory_ms": r["memory_s"] * 1e3,
              "collective_ms_not_run": r["collective_s"] * 1e3,
              "bound_over_sweep": max(r["compute_s"], r["memory_s"]) * 1e3 / sweep_ms,
              "kernel_at_shape": shape, "first_cycle_equal_to_plain_on_cpu": True,
              "part_s": time.perf_counter() - t_part})
        del w, sigma, x

    # the sharded programs composed on a (2, 4) mesh of the card repeated
    t_part = time.perf_counter()
    n, b, mesh_shape = DRYRUN_ONN_COMPOSED
    mesh = make_mesh(mesh_shape, [dev] * (mesh_shape[0] * mesh_shape[1]))
    sigma = torch.randint(0, 2, (b, n), generator=gen, device=dev, dtype=torch.int8) * 2 - 1
    weights = {bits: torch.randint(lo, hi, (n, n), generator=gen, device=dev, dtype=torch.int8)
               for bits, lo, hi in ((5, -15, 16), (4, -8, 8))}
    unsharded = {}
    for bits, w in weights.items():
        def sweep(w=w):
            s = sigma
            for _ in range(32):
                s = ops.onn_step(w, s)
            return s
        unsharded[bits], _, path = driven(sweep)
        require(path.get("onn_step", 0) == 32, f"dryrun_onn composed: unsharded launches {path}")
        require(bool((unsharded[bits] != sigma).any()), "dryrun_onn composed: no spin moved")
    composed = {}
    for variant in dryrun.ONN_VARIANTS:
        bits = 4 if variant == "rowpar_bp_int4" else 5
        prog = dryrun.onn_program(variant, n, b, 32, mesh.shape)
        outs, seconds, path = driven(
            lambda: dryrun.run_onn_composed(prog, mesh, weights[bits], sigma))
        require(len(outs) == mesh.size, f"dryrun_onn composed {variant}: {len(outs)} outputs")
        for pos, got in outs.items():
            require(torch.equal(got, unsharded[bits][prog.lanes(pos)]),
                    f"dryrun_onn composed {variant}: position {pos} differs from the "
                    "unsharded sweep")
        composed[variant] = {"layout": prog.layout, "w_block": list(prog.argument_shapes()[0][0]),
                             "equal_to_unsharded": True, "launches": path, "seconds": seconds}
    emit({"phase": "dryrun_onn", "part": "composed", "n": n, "batch": b, "cycles": 32,
          "mesh": list(mesh_shape), "variants": composed,
          "unsharded": "32 launches of onn_step (kernel 2)",
          "part_s": time.perf_counter() - t_part})
    del weights, unsharded, sigma
    torch.cuda.empty_cache()
    emit({"phase": "dryrun_onn", "part": "phase", "phase_s": time.perf_counter() - t_phase,
          "launches": own, "kernel_at_shapes": shapes})
    return own, shapes


def start_tracegate(out_dir: str) -> list:
    """Start phase 19's two runs of ``python -m repro_torch.analysis.tracegate``
    (the gate, then with ``--inject-retrace``), each in a fresh process (the
    warm counts are a fresh process's) writing ``--out`` and its output
    under ``out_dir``; niced, so that they take the host's idle time."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for label, extra in (("gate", []), ("inject", ["--inject-retrace"])):
        with open(os.path.join(out_dir, f"{label}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.analysis.tracegate", "--out",
                 os.path.join(out_dir, f"{label}.json"), *extra],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                preexec_fn=lambda: os.nice(10)))
    return procs


def analysis_lines(dev, procs, out_dir) -> dict:
    """Phase 19: the tooling (``repro_torch.analysis``).  ``vmem_static``:
    every launch plan of the bucket grid held to the card's limits (none
    over), and each kernel's tightest plan.  ``vmem_compiled``: one line per
    compiled instantiation the plans reach (registers, local bytes, static
    shared memory against the constant its planner assumes, most threads,
    the occupancy against the assumed residency); a miss of a constant
    fails the script, a miss of a residency is reported.  ``tracegate``: the
    gate's and the injected run's processes (:func:`start_tracegate`, started
    beside phase 15's CPU checks) read back: the gate exits 0 against the
    committed ``TRACE_BUDGET_TORCH.json``, the injected run exits 1 on
    ``retrieve.steady``; each workload's warm and steady deltas, the
    scheduler's syncs a slab tick, and which calls torch counts as waits.
    Returns the gate run's launches by kernel, over both passes."""
    from repro_torch.analysis import tracegate, vmem

    t_phase = time.perf_counter()
    reports = vmem.check_all()
    over = [r.render() for r in reports if not r.ok]
    require(not over, f"analysis vmem: plans over the card's limits: {over[:5]}")
    emit({"phase": "analysis", "part": "vmem_static", "buckets": len(reports),
          "plans": sum(len(r.plans) for r in reports), "over": 0, "tightest": [
              {"kind": r.kind, "n": r.n, "batch": r.batch, "kernel": p.kernel, "plan": p.plan,
               "smem": p.smem, "budget": p.budget, "percent": 100.0 * p.ratio,
               "blocks_per_sm": p.blocks_per_sm, "sm_bytes": p.sm_bytes,
               "max_registers": p.max_registers} for r, p in vmem.tightest(reports)]})
    compiled = vmem.check_compiled(dev)
    for c in compiled:
        emit({"phase": "analysis", "part": "vmem_compiled", **c.as_dict()})
    misses = [c.kernel for c in compiled if not c.constants_ok]
    require(not misses, f"analysis vmem: compiled kernels miss a planner's constant: {misses}")
    in_process_s = time.perf_counter() - t_phase

    runs = {}
    for label, proc in zip(("gate", "inject"), procs):
        proc.wait(timeout=TRACEGATE_TIMEOUT_S)
        with open(os.path.join(out_dir, f"{label}.log")) as f:
            log = f.read()
        path = os.path.join(out_dir, f"{label}.json")
        require(os.path.exists(path), f"analysis tracegate {label}: no --out, rc "
                f"{proc.returncode}:\n{log[-3000:]}")
        with open(path) as f:
            runs[label] = (proc.returncode, json.load(f), log)
    rc, gate, log = runs["gate"]
    require(rc == 0 and gate["passed"], f"analysis tracegate: the gate failed (rc {rc}): "
            f"{gate['diffs']}\n{log[-3000:]}")
    rc_i, inject, _ = runs["inject"]
    require(rc_i == 1 and inject["diffs"]
            and all(d.startswith("retrieve.steady") for d in inject["diffs"]),
            f"analysis tracegate: the injected run did not fail on retrieve.steady "
            f"(rc {rc_i}): {inject['diffs']}")
    launches = {}
    for name in tracegate.WORKLOAD_ORDER:
        entry = gate["observed"][name]
        for label in ("warm", "steady"):
            for key, v in entry[label].items():
                if key.startswith("ops."):
                    launches[key[4:]] = launches.get(key[4:], 0) + v
        line = {"phase": "analysis", "part": "tracegate", "workload": name,
                "warm": entry["warm"], "steady": entry["steady"]}
        if "report" in entry:
            line.update(entry["report"])
        emit(line)
    emit({"phase": "analysis", "part": "tracegate_gate", "gate_rc": rc, "inject_rc": rc_i,
          "inject_diffs": inject["diffs"], "sync_probe": gate["sync_probe"],
          "launches": launches, "in_process_s": in_process_s,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def edge_windows(total: int, run: int) -> list:
    """The rows compared around each boundary of ``run``-sized launches and
    at the end of ``total``: (first, stop) of ``EDGE_ROWS`` each side."""
    out = [(max(0, b - EDGE_ROWS), min(total, b + EDGE_ROWS)) for b in range(run, total, run)]
    return out + [(total - EDGE_ROWS, total)]


def launch_edge_lines(dev, seed, rows) -> dict:
    """Phase 20 (port fault 9): each kernel that the planners now cut into
    several launches, launched once past its former edge through its
    wrapper, the rows on both sides of every 65,535-tile boundary and the
    last rows held to the plain version of those rows alone (lanes are
    independent), each launch's grid within 65,535 on y and z; then
    ``MaxCutSolver.solve`` past 65,535 instances, its instances on both
    sides of the edge equal to the CPU's solve of those instances alone.
    One ``launch_edges`` line; each affected kernel's row gains ``edge``.
    Returns the wrapper launches by kernel (not a main path's)."""
    from repro_torch import api
    from repro_torch.core import ising
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import ref as plain

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    n, lanes = EDGE_N, EDGE_LANES
    w = torch.randint(-15, 16, (n, n), generator=gen, device=dev, dtype=torch.int8)
    bias = torch.randint(-40, 41, (n,), generator=gen, device=dev, dtype=torch.int32)
    sigma = (torch.randint(0, 2, (lanes, n), generator=gen, device=dev, dtype=torch.int8) * 2 - 1)
    entries, counts = [], {}

    def held(name, call, want_rows, plan, windows, launches_each):
        """One kernel at the edge: launched once, compared on ``windows``,
        timed by CUDA events around one more call (all its launches)."""
        ops.reset_launches()
        got = call()
        torch.cuda.synchronize()
        n_launch = sum(ops.LAUNCHES.values())
        require(n_launch == launches_each,
                f"launch_edges {name}: {n_launch} launches, the plan has {launches_each}")
        regimes = dict(ops.REGIME_LAUNCHES)
        require(sum(regimes.values()) == n_launch and all(
            k.endswith("/" + plan.regime) for k in regimes),
            f"launch_edges {name}: launches by regime {regimes}, planned {plan.regime}")
        counts["coupling_wgmma"] = counts.get("coupling_wgmma", 0) + sum(
            v for k, v in regimes.items() if k.endswith("/wgmma"))
        for lo, hi in windows:
            err = max_abs_err(got[lo:hi], want_rows(lo, hi))
            require(err == 0, f"launch_edges {name}: rows {lo}:{hi} differ from the plain "
                              f"version (max_abs_err {err})")
        del got
        ms = cuda_ms(call, iters=2, warmup=0)
        counts[name] = counts.get(name, 0) + n_launch
        grids = [list(g) for g in plan_grids(plan)]
        require(all(g[1] <= autotune.MAX_GRID_YZ and g[2] <= autotune.MAX_GRID_YZ
                    for g in grids), f"launch_edges {name}: a grid past 65,535: {grids}")
        entry = {"kernel": name, "regime": plan.regime, "launches_by_regime": regimes,
                 "launches": n_launch, "grids": grids,
                 "rows_compared": [list(wi) for wi in windows], "exact": True, "device_ms": ms}
        entries.append(entry)
        if name in rows:
            rows[name]["edge"] = {k: entry[k] for k in ("regime", "launches", "grids", "exact",
                                                        "device_ms")}
            rows[name]["edge"]["shape"] = [plan.inst, plan.b, plan.m, plan.n]
        torch.cuda.empty_cache()

    def library(names, what, call, want_rows, windows):
        """One PyTorch call computing the function of the kernels ``names``
        on their operands (``what`` names it), held to the plain version on
        ``windows``, timed by CUDA events; each entry and row gains
        ``library_ms``.  A call the library refuses at this size is
        recorded with its error in place of a time."""
        try:
            got = call()
        except RuntimeError as e:  # a library's own size limit, not a check of the port
            result = {"library_call": what, "library_ms": None, "library_refused": str(e)[:300]}
        else:
            torch.cuda.synchronize()
            for lo, hi in windows:
                want = want_rows(lo, hi)
                require(torch.equal(got[lo:hi].to(want.dtype), want),
                        f"launch_edges {what}: rows {lo}:{hi} differ from the plain version")
            del got
            torch.cuda.empty_cache()
            result = {"library_call": what, "library_ms": cuda_ms(call, iters=2, warmup=0)}
        for entry in entries:
            if entry["kernel"] in names:
                entry.update(result)
                if entry["kernel"] in rows:
                    rows[entry["kernel"]]["edge"].update(result)
        torch.cuda.empty_cache()

    run = autotune.MAX_GRID_YZ * autotune.GEMM_TILES[0].bm
    windows = edge_windows(lanes, run)
    for name, parallel in (("coupling_sum", None), ("hybrid_coupling_sum", 32)):
        plan = autotune.coupling_route(name, 1, lanes, n, n, parallel)
        call = ((lambda: ops.coupling_sum(w, sigma)) if parallel is None else
                (lambda p=parallel: ops.hybrid_coupling_sum(w, sigma, parallel=p)))
        held(name, call, lambda lo, hi: plain.coupling_sum_ref(w, sigma[lo:hi]), plan, windows,
             len(plan.launches))
    plan = autotune.coupling_route("onn_step", 1, lanes, n, n)
    held("onn_step", lambda: ops.onn_step(w, sigma, bias),
         lambda lo, hi: plain.onn_step_ref(w, sigma[lo:hi], bias), plan, windows,
         len(plan.launches))
    # kernels 3, 4 and 7 keep the wide tile's runs past 65,535 lane tiles
    plan = autotune.coupling_route("phase_step", 1, lanes, n, n)
    require(plan.regime == "wide" and len(plan.launches) == 2,
            f"launch_edges: kernel 3 planned as {plan.regime} in {len(plan.launches)} launches")
    phase = torch.randint(0, 2 * HALF, (lanes, n), generator=gen, device=dev, dtype=torch.int32)
    held("phase_step", lambda: ops.phase_step(w, sigma, bias, phase, half=HALF),
         lambda lo, hi: plain.phase_step_ref(w, sigma[lo:hi], bias, phase[lo:hi], HALF), plan,
         windows, len(plan.launches))
    held("phase_step_packed", lambda: ops.phase_step_packed(w, bias, phase, half=HALF),
         lambda lo, hi: plain.phase_step_packed_ref(w, bias, phase[lo:hi], HALF), plan,
         windows, len(plan.launches))
    plan = autotune.coupling_plan(1, lanes, n, n, 32)
    held("hybrid_phase_step",
         lambda: ops.hybrid_phase_step(w, sigma, bias, phase, half=HALF, parallel=32),
         lambda lo, hi: plain.hybrid_phase_step_ref(w, sigma[lo:hi], bias, phase[lo:hi], HALF,
                                                    32), plan, windows, len(plan.launches))
    del phase
    # the library's product on the same operands, zero-padded to multiples of 8
    kp = -(-n // 8) * 8
    sig_p = torch.nn.functional.pad(sigma, (0, kp - n))
    w_p = torch.nn.functional.pad(w, (0, kp - n, 0, kp - n))
    library(("coupling_sum", "onn_step", "hybrid_coupling_sum"), "torch._int_mm (padded)",
            lambda: torch._int_mm(sig_p, w_p.t())[:, :n],
            lambda lo, hi: plain.coupling_sum_ref(w, sigma[lo:hi]), windows)
    del sigma, sig_p, w_p
    torch.cuda.empty_cache()
    # past 2³¹ elements in one tensor: kernel 1 at N = EDGE_WIDE_N
    nw = EDGE_WIDE_N
    w_w = torch.randint(-15, 16, (nw, nw), generator=gen, device=dev, dtype=torch.int8)
    s_w = torch.randint(0, 2, (lanes, nw), generator=gen, device=dev, dtype=torch.int8) * 2 - 1
    require(s_w.numel() > 2**31, "launch_edges: the wide operand is not past 2^31 elements")
    plan = autotune.coupling_route("coupling_sum", 1, lanes, nw, nw)
    held(f"coupling_sum_n{nw}", lambda: ops.coupling_sum(w_w, s_w),
         lambda lo, hi: plain.coupling_sum_ref(w_w, s_w[lo:hi]), plan, windows,
         len(plan.launches))
    library((f"coupling_sum_n{nw}",), "torch._int_mm", lambda: torch._int_mm(s_w, w_w.t()),
            lambda lo, hi: plain.coupling_sum_ref(w_w, s_w[lo:hi]), windows)
    del w_w, s_w
    torch.cuda.empty_cache()

    # the instance axis (kernels 1i and 6i): 65,539 instances in two launches
    b_i, m_i, n_i = EDGE_INSTANCE_SHAPE
    inst = EDGE_INSTANCES
    w3 = torch.randint(-15, 16, (inst, m_i, n_i), generator=gen, device=dev, dtype=torch.int8)
    s3 = torch.randint(0, 2, (inst, b_i, n_i), generator=gen, device=dev, dtype=torch.int8) * 2 - 1
    i_windows = edge_windows(inst, autotune.MAX_GRID_YZ)
    for name, parallel in (("coupling_sum_batched", None), ("hybrid_coupling_sum_batched", 32)):
        plan = autotune.coupling_plan(inst, b_i, m_i, n_i, parallel)
        call = ((lambda: ops.coupling_sum(w3, s3)) if parallel is None else
                (lambda p=parallel: ops.hybrid_coupling_sum(w3, s3, parallel=p)))
        held(name, call, lambda lo, hi: plain.coupling_sum_ref(w3[lo:hi], s3[lo:hi]), plan,
             i_windows, len(plan.launches))
    f_s3, f_w3t = s3.float(), w3.float().transpose(1, 2).contiguous()
    library(("coupling_sum_batched", "hybrid_coupling_sum_batched"),
            "torch.bmm (float32 copies)", lambda: torch.bmm(f_s3, f_w3t),
            lambda lo, hi: plain.coupling_sum_ref(w3[lo:hi], s3[lo:hi]), i_windows)
    del w3, s3, f_s3, f_w3t
    torch.cuda.empty_cache()

    # kernel 8's GEMM: 8,388,557 lanes, runs of 65,535 tiles of 128 on z
    m_q, k_q = EDGE_QMV_MK
    q_lanes = EDGE_QMV_LANES
    wq = torch.randint(-127, 128, (m_q, k_q), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand((m_q,), generator=gen, device=dev) * 0.1
    x = torch.randn((q_lanes, k_q), generator=gen, device=dev)
    plan = autotune.qmv_plan(q_lanes, m_q, k_q)
    ops.reset_launches()
    got = ops.quantized_matvec(wq, scale, x)
    torch.cuda.synchronize()
    require(ops.LAUNCHES["quantized_matvec"] == len(plan.launches),
            f"launch_edges quantized_matvec: {dict(ops.LAUNCHES)} launches")
    worst = 0.0
    q_windows = edge_windows(q_lanes, autotune.MAX_GRID_YZ * autotune.QMV_GEMM_TILE)
    for lo, hi in q_windows:
        err, ratio = fp32_error(got[lo:hi], x[lo:hi], wq, scale)
        worst = max(worst, ratio)
    require(worst <= 1.0, f"launch_edges quantized_matvec: error {worst} of its bound")
    del got
    ms = cuda_ms(lambda: ops.quantized_matvec(wq, scale, x), iters=2, warmup=0)
    counts["quantized_matvec"] = len(plan.launches)
    q_grids = [[plan.grid[0], plan.grid[1], -(-nb // autotune.QMV_GEMM_TILE)]
               for _, nb in plan.launches]
    entry = {"kernel": "quantized_matvec", "launches": len(plan.launches), "grids": q_grids,
             "rows_compared": [list(wi) for wi in q_windows], "within_bound": True,
             "error_bound_ratio": worst, "device_ms": ms}
    entries.append(entry)
    rows["quantized_matvec"]["edge"] = {"launches": len(plan.launches), "grids": q_grids,
                                        "within_bound": True, "error_bound_ratio": worst,
                                        "device_ms": ms, "shape": [q_lanes, m_q, k_q]}
    w_deq_t = (wq.float() * scale[:, None]).t().contiguous()
    lib = torch.matmul(x, w_deq_t)
    lib_worst = max(fp32_error(lib[lo:hi], x[lo:hi], wq, scale)[1] for lo, hi in q_windows)
    del lib
    lib_ms = cuda_ms(lambda: torch.matmul(x, w_deq_t), iters=2, warmup=0)
    lib_fields = {"library_call": "torch.matmul (dequantized W)", "library_ms": lib_ms,
                  "library_error_bound_ratio": lib_worst}
    entry.update(lib_fields)
    rows["quantized_matvec"]["edge"].update(lib_fields)
    del wq, x, scale, w_deq_t
    torch.cuda.empty_cache()

    # a public entry past the edge: Max-Cut over 65,539 instances on the card
    n_inst, mc_n, mc_r, mc_s = EDGE_MAXCUT
    rng = np.random.default_rng([seed, 20])
    upper = np.triu(rng.random((n_inst, mc_n, mc_n)) < 0.5, k=1).astype(np.int8)
    adj = torch.as_tensor(upper + upper.transpose(0, 2, 1))
    solver = api.MaxCutSolver(sweeps=mc_s, replicas=mc_r, settle_chunk=mc_s, backend="kernel")
    ops.reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(adj, key=torch.Generator().manual_seed(seed + 21))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    mc_launches = dict(ops.LAUNCHES)
    require(mc_launches.get("coupling_sum_batched", 0) > 0,
            f"launch_edges maxcut: the instance axis never launched: {mc_launches}")
    key = torch.Generator().manual_seed(seed + 21)
    init = torch.rand((n_inst, mc_r, mc_n), generator=key)
    sweeps = torch.rand((n_inst, mc_s, mc_n), generator=key)
    edge = autotune.MAX_GRID_YZ
    lo, hi = edge - EDGE_MAXCUT_CPU, edge + EDGE_MAXCUT_CPU
    cpu = ising.solve_maxcut_batch(solver.config(mc_n), adj[lo:hi], init[lo:hi], sweeps[lo:hi],
                                   stagger_groups=solver.stagger_groups,
                                   stagnation=solver.stagnation)
    for f in ising.MaxCutResult._fields:
        require(torch.equal(getattr(res, f)[lo:hi].cpu(), getattr(cpu, f)),
                f"launch_edges maxcut: instances {lo}:{hi} differ from the CPU's in {f}")
    emit({"phase": "launch_edges", "kernels": entries,
          "maxcut": {"instances": n_inst, "n": mc_n, "replicas": mc_r, "sweeps": mc_s,
                     "launches": mc_launches, "instances_compared": [lo, hi],
                     "equal_to_cpu": True, "solve_s": solve_s},
          "nvidia_smi": nvidia_smi_line(), "phase_s": time.perf_counter() - t_phase})
    counts["maxcut"] = sum(mc_launches.values())
    return counts


def plan_grids(plan) -> list:
    """Each launch's grid of a coupling-GEMM plan (either regime)."""
    if plan.regime == "wgmma":
        return [plan.grid]
    gx = -(-plan.m // plan.tile.bn)
    return [(gx, -(-nb // plan.tile.bm), ni) for _, ni, _, nb in plan.launches]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)

    from repro_torch import api
    from repro_torch.configs import onn as configs
    import repro_torch.kernels as kernel_api
    from repro_torch.core import dynamics as dyn
    from repro_torch.core import ising
    from repro_torch.core import oscillator as osc
    from repro_torch.kernels import autotune, build, ops
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

    # 2. build, and beside it kernel 5's registers and spills from ``ptxas -v`` --
    from coupling_gemm_breakdown import ptxas_report

    t0 = time.perf_counter()
    ptxas_dir = tempfile.mkdtemp()
    multi_src = os.path.join(build.CSRC, "phase_step_multi.cu")
    ptxas = subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(ptxas_dir, "k5.so"),
         multi_src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        build.build_all()
        for stem in build.SOURCES:
            build.library(stem)
        log, _ = ptxas.communicate(timeout=900)
    finally:
        if ptxas.poll() is None:
            ptxas.kill()
            ptxas.wait()
        shutil.rmtree(ptxas_dir, ignore_errors=True)
    require(ptxas.returncode == 0, f"nvcc -Xptxas -v failed for phase_step_multi.cu:\n{log}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": list(build.SOURCES),
          "seconds_by_source": dict(build.BUILD_SECONDS)})
    emit({"phase": "ptxas", "source": ROWS["phase_step_multi"][0],
          "kernels": ptxas_report(log)})

    # 3. kernels against their plain versions at the main path's shapes --------
    w_np, _, probes = make_problem(args.seed)
    rng = np.random.default_rng(args.seed + 1)
    w = torch.as_tensor(w_np, device=dev)
    bias = torch.as_tensor(rng.integers(-2, 3, size=N).astype(np.int32), device=dev)
    sigma = torch.as_tensor(probes, device=dev)
    phase = osc.phase_of_spin(sigma).to(torch.int32)
    rows = {}

    def record(name, got, want, kernel_fn, plain_fn, bytes_moved, n_ops, library_ms=None,
               ops_per_s=INT8_OPS_PER_S, err=None):
        """One row: exact equality with the plain version, unless ``err`` (an
        error already held to its bound) is given."""
        torch.cuda.synchronize()
        if err is None:
            err = max_abs_err(got, want)
            require(err == 0, f"{name}: kernel disagrees with its plain version (max_abs_err {err})")
        b_ms, b_by = bound(bytes_moved, n_ops, ops_per_s)
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
    # Kernel 5: a quarter of the lanes frozen, a quarter near their budget;
    # the row's times at the main path's shape (the cluster regime), the
    # stream regime's at MULTI_STREAM in "per_regime".
    max_cycles = 100

    def multi_cols(b_):
        t_ = torch.as_tensor(rng.integers(0, 60, size=b_).astype(np.int32), device=dev)
        t_[b_ // 4: b_ // 2] = max_cycles - torch.as_tensor(
            rng.integers(1, 5, size=b_ // 4).astype(np.int32), device=dev)
        frozen_ = torch.zeros(b_, dtype=torch.bool, device=dev)
        frozen_[: b_ // 4] = True
        full_ = torch.full((b_,), max_cycles, dtype=torch.int32, device=dev)
        false_ = torch.zeros(b_, dtype=torch.bool, device=dev)
        return (t_, full_, false_, false_, frozen_, false_, torch.where(frozen_, t_, full_))

    def multi_case(w_, bias_, ph_, pv_, cols_, packed):
        """Kernel 5 against its plain version: (got, want, kernel call,
        plain call, bytes, operations, lane-cycles) for one operand set."""
        b_, n_ = ph_.shape

        def kern():
            return ops.phase_step_multi(w_, bias_, ph_, pv_, *cols_, half=HALF, chunk=CHUNK,
                                        max_cycles=max_cycles, packed=packed)

        def plain_fn():
            return plain.phase_step_multi_ref(
                w_, bias_, ph_, pv_, *(c.to(torch.int32)[:, None] for c in cols_),
                half=HALF, chunk=CHUNK, max_cycles=max_cycles)

        got, want = kern(), plain_fn()
        lane_cycles = int((got[8] - cols_[0]).sum().item())
        state_bytes = 2 * b_ * (((n_ + 1) // 2) if packed else 4 * n_) + 7 * 4 * b_
        return (got, [want[0], want[1], *(x[:, 0] for x in want[2:])], kern, plain_fn,
                n_ * n_ + 4 * n_ + 2 * state_bytes, 2 * n_ * n_ * lane_cycles, lane_cycles)

    cols = multi_cols(B)
    prev = osc.phase_of_spin(sigma.roll(1, 0)).to(torch.int32)
    # The stream regime's operands: Hebbian couplings of 40 seeded patterns at
    # N = MULTI_STREAM[1], probes with 20 % of their pixels flipped.
    sb, sn = MULTI_STREAM
    rng_s = np.random.default_rng([args.seed, sn])
    xi_s = np.where(rng_s.random((40, sn)) < 0.5, 1, -1).astype(np.int8)
    w_s = api.quantize_weights(api.hebbian(torch.as_tensor(xi_s))).values.to(dev)
    probes_s = xi_s[rng_s.integers(0, 40, size=sb)].copy()
    probes_s[rng_s.random((sb, sn)) < 0.2] *= -1
    sig_s = torch.as_tensor(probes_s, device=dev)
    bias_s = torch.zeros(sn, dtype=torch.int32, device=dev)
    ph_s = osc.phase_of_spin(sig_s).to(torch.int32)
    pv_s = osc.phase_of_spin(sig_s.roll(1, 0)).to(torch.int32)
    cols_s = multi_cols(sb)
    for packed in (False, True):
        name = "phase_step_multi_packed" if packed else "phase_step_multi"
        got, want, kern, plain_fn, n_bytes, n_ops, lane_cycles = multi_case(
            w, bias, phase, prev, cols, packed)
        record(name, got, want, kern, plain_fn, n_bytes, n_ops)
        plan = autotune.multi_plan(B, N)
        rows[name].update(lane_cycles=lane_cycles,
                          plan=multi_plan_dict(plan, ops.multi_cluster_occupancy(plan, packed)))
        per_regime = {plan.regime: {k: rows[name][k] for k in (
            "max_abs_err", "kernel_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
            "lane_cycles")}}
        per_regime[plan.regime].update(shape=[B, N], exact=True, plan=rows[name]["plan"])
        got, want, kern, plain_fn, n_bytes, n_ops, lane_cycles = multi_case(
            w_s, bias_s, ph_s, pv_s, cols_s, packed)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"{name} at {MULTI_STREAM}: kernel disagrees with its plain version "
                          f"(max_abs_err {err})")
        plan_s = autotune.multi_plan(sb, sn)
        require(plan_s.regime == "stream", f"{MULTI_STREAM} planned as {plan_s.regime}")
        b_ms, b_by = bound(n_bytes, n_ops)
        per_regime["stream"] = {
            "max_abs_err": err, "kernel_ms": device_ms(kern, name), "wrapper_ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain_fn), "bound_ms": b_ms, "bound_by": b_by,
            "lane_cycles": lane_cycles, "shape": [sb, sn], "exact": True,
            "plan": multi_plan_dict(plan_s, None),
        }
        rows[name]["per_regime"] = per_regime
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

    # Kernel 2: sign(σWᵀ + h) with ties kept.  The first 64 lanes repeat
    # lane 0, and h = −(σ₀ Wᵀ), so every element of those lanes is a tie.
    sigma_t = sigma.clone()
    sigma_t[:64] = sigma[0]
    h_tie = -plain.coupling_sum_ref(w, sigma[:1])[0]
    step_want = plain.onn_step_ref(w, sigma_t, h_tie)
    require(torch.equal(step_want[:64], sigma_t[:64]), "onn_step: forced ties did not keep σ")
    record(
        "onn_step", ops.onn_step(w, sigma_t, h_tie), step_want,
        lambda: ops.onn_step(w, sigma_t, h_tie), lambda: plain.onn_step_ref(w, sigma_t, h_tie),
        B * N + N * N + 4 * N + B * N, 2 * B * N * N, library_ms=int_mm_ms,
    )
    rows["onn_step"]["tie_lanes"] = 64

    # Kernels 1 and 2 in the wgmma regime (``autotune.coupling_route`` at
    # large shapes), exact at WGMMA_SHAPES (kernel 2 with ties forced in 64
    # lanes), each beside torch._int_mm on operands padded to 16 (K) and 8
    # (M); the row's numbers are kernel 1's at the first shape.
    g_w = torch.Generator(device=dev).manual_seed(args.seed + 3)
    per_mode = {"coupling_sum": {}, "onn_step": {}}
    for wb, wm, wk in WGMMA_SHAPES:
        w_w = torch.randint(-15, 16, (wm, wk), generator=g_w, device=dev, dtype=torch.int8)
        s_w = torch.randint(0, 2, (wb, wk), generator=g_w, device=dev, dtype=torch.int8) * 2 - 1
        s_w[:64] = s_w[0]
        h_w = -plain.coupling_sum_ref(w_w, s_w[:1])[0]
        kp, mp = -(-wk // 16) * 16, -(-wm // 8) * 8
        s_p = torch.nn.functional.pad(s_w, (0, kp - wk))
        w_p = torch.nn.functional.pad(w_w, (0, kp - wk, 0, mp - wm))
        want_sum = plain.coupling_sum_ref(w_w, s_w)
        require(torch.equal(torch._int_mm(s_p, w_p.t())[:, :wm], want_sum),
                "torch._int_mm disagrees at the wgmma shapes")
        lib_w_ms = cuda_ms(lambda: torch._int_mm(s_p, w_p.t()))
        label = "x".join(map(str, (wb, wm, wk)))
        for mode in per_mode:
            plan = autotune.coupling_route(mode, 1, wb, wm, wk)
            require(plan.regime == "wgmma", f"{mode} at {label}: routed to {plan.regime}")
            if mode == "coupling_sum":
                fn = lambda: ops.coupling_sum(w_w, s_w)  # noqa: E731
                want, n_bytes = want_sum, wb * wk + wm * wk + 4 * wb * wm
                plain_w_ms = cuda_ms(lambda: plain.coupling_sum_ref(w_w, s_w), iters=3, warmup=1)
            else:
                fn = lambda: ops.onn_step(w_w, s_w, h_w)  # noqa: E731
                want, n_bytes = plain.onn_step_ref(w_w, s_w, h_w), wb * wk + wm * wk + 4 * wm + wb * wm
                require(torch.equal(want[:64], s_w[:64]), "onn_step: forced ties did not keep σ")
                plain_w_ms = cuda_ms(lambda: plain.onn_step_ref(w_w, s_w, h_w), iters=3, warmup=1)
            ops.reset_launches()
            got = fn()
            torch.cuda.synchronize()
            require(dict(ops.REGIME_LAUNCHES) == {f"{mode}/wgmma": 1},
                    f"{mode} at {label}: launches {dict(ops.REGIME_LAUNCHES)}")
            err = max_abs_err(got, want)
            require(err == 0, f"{mode} at {label}: wgmma regime disagrees with its plain "
                              f"version (max_abs_err {err})")
            b_ms, b_by = bound(n_bytes, 2 * wb * wm * wk)
            per_mode[mode][label] = {
                "shape": [wb, wm, wk], "max_abs_err": err, "exact": True,
                "kernel_ms": device_ms(fn, f"{mode}/wgmma"), "wrapper_ms": cuda_ms(fn),
                "plain_ms": plain_w_ms, "library_ms": lib_w_ms,
                "library_call": "torch._int_mm (padded)", "bound_ms": b_ms, "bound_by": b_by,
                "plan": wgmma_plan_dict(plan)}
            if mode == "onn_step":
                per_mode[mode][label]["tie_lanes"] = 64
            del got, want
        del w_w, s_w, s_p, w_p, want_sum
    torch.cuda.empty_cache()
    first = per_mode["coupling_sum"]["x".join(map(str, WGMMA_SHAPES[0]))]
    rows["coupling_wgmma"] = {
        "name": "coupling_wgmma", "route": "cuda", "source": ROWS["coupling_wgmma"][0],
        "replaces": ROWS["coupling_wgmma"][1], "replaces_step": f"{TPU_KERNELS}:161",
        "launches": 0, "exact": True, "max_abs_err": 0,
        "ms": first["wrapper_ms"] if first["kernel_ms"] is None else first["kernel_ms"],
        "ms_of": "wrapper" if first["kernel_ms"] is None else "kernel",
        **{k: first[k] for k in ("kernel_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "plan")},
        "per_mode": per_mode,
    }

    # Kernel 8 at two shapes: per-row quantized Hebbian weights at the main
    # path's (1024, 506, 506), and random int8 weights at the GEMV shape.
    # Each element within K · 2⁻²⁴ · |scale_m| · Σ|x w| of the exact value;
    # the yardstick is one float32 matmul on pre-dequantized weights.
    # The row keeps the main shape's numbers (recorded last); "per_shape"
    # holds both.
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    gb, gm, gk = QMV_GEMV
    rows_q = [api.quantize_weights(r) for r in make_hebbian(args.seed)]
    qmv_shapes = {
        "x".join(map(str, QMV_GEMV)): (
            torch.randint(-127, 128, (gm, gk), generator=g, device=dev, dtype=torch.int8),
            torch.rand((gm,), generator=g, device=dev) * 0.01 + 1e-4,
            torch.randn((gb, gk), generator=g, device=dev),
        ),
        f"{B}x{N}x{N}": (
            torch.stack([q.values for q in rows_q]).to(dev),
            torch.stack([q.scale for q in rows_q]).to(dev),
            torch.randn((B, N), generator=g, device=dev),
        ),
    }
    per_shape = {}
    for label, (wq, scale, x) in qmv_shapes.items():
        got = ops.quantized_matvec(wq, scale, x)
        again = ops.quantized_matvec(wq, scale, x)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"quantized_matvec {label}: two calls differ")
        err, ratio = fp32_error(got, x, wq, scale)
        p_err, p_ratio = fp32_error(plain.quantized_matvec_ref(wq, scale, x), x, wq, scale)
        require(ratio <= 1.0, f"quantized_matvec {label}: error {ratio} x its bound")
        require(p_ratio <= 1.0, f"quantized_matvec plain {label}: error {p_ratio} x its bound")
        w_deq_t = (wq.float() * scale[:, None]).t().contiguous()
        lib_ms = cuda_ms(lambda: torch.matmul(x, w_deq_t))
        (b_, k_), m_ = x.shape, wq.shape[0]
        name = "quantized_matvec"
        record(
            name, got, None, lambda: ops.quantized_matvec(wq, scale, x),
            lambda: plain.quantized_matvec_ref(wq, scale, x),
            4 * b_ * k_ + m_ * k_ + 4 * m_ + 4 * b_ * m_, 2 * b_ * m_ * k_,
            library_ms=lib_ms, ops_per_s=FP32_FLOPS_PER_S, err=err,
        )
        per_shape[label] = {k: rows[name][k] for k in (
            "max_abs_err", "ms", "ms_of", "kernel_ms", "wrapper_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")}
        plan = autotune.qmv_plan(b_, m_, k_, aligned=x.data_ptr() % 16 == 0
                                 and wq.data_ptr() % 16 == 0)
        per_shape[label].update(error_bound_ratio=ratio, plain_max_abs_err=p_err,
                                plain_error_bound_ratio=p_ratio, bit_identical=True,
                                plan=qmv_plan_dict(plan))
    # The ragged shapes, both regimes on the scalar load path: the bound only.
    ragged = {}
    for qb, qm, qk in QMV_RAGGED:
        wq = torch.randint(-127, 128, (qm, qk), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand((qm,), generator=g, device=dev) * 0.01 + 1e-4
        x = torch.randn((qb, qk), generator=g, device=dev)
        r_err, r_ratio = fp32_error(ops.quantized_matvec(wq, scale, x), x, wq, scale)
        label_r = f"{qb}x{qm}x{qk}"
        require(r_ratio <= 1.0, f"quantized_matvec {label_r}: error {r_ratio} x its bound")
        ragged[label_r] = {"max_abs_err": r_err, "error_bound_ratio": r_ratio,
                           "plan": qmv_plan_dict(autotune.qmv_plan(qb, qm, qk))}
    rows["quantized_matvec"].update(error_bound_ratio=ratio, shape=label, exact=False,
                                    within_bound=True, per_shape=per_shape, ragged=ragged)

    # Kernels 1 and 6 with the instance axis, at the Max-Cut shape: one
    # 32-row slab of each instance's couplings against its 64 replicas.
    graphs = make_graphs(args.seed)
    w_mc = torch.stack([ising.maxcut_couplings(a).values for a in graphs]).to(dev)
    members = torch.stack([torch.randperm(N, generator=torch.Generator().manual_seed(i))[:32]
                           for i in range(MC_INSTANCES)]).to(dev)
    slabs = w_mc[torch.arange(MC_INSTANCES, device=dev)[:, None], members]
    reps = torch.randint(0, 2, (MC_INSTANCES, MC_REPLICAS, N), generator=g, device=dev,
                         dtype=torch.int8) * 2 - 1
    want_mc = plain.coupling_sum_ref(slabs, reps)
    f_reps, f_slabs_t = reps.float(), slabs.float().transpose(1, 2).contiguous()
    require(torch.equal(torch.bmm(f_reps, f_slabs_t).to(torch.int32), want_mc), "bmm disagrees")
    bmm_ms = cuda_ms(lambda: torch.bmm(f_reps, f_slabs_t))
    mc_bytes = slabs.numel() + reps.numel() + 4 * want_mc.numel()
    mc_ops = 2 * MC_REPLICAS * slabs.numel()
    record("coupling_sum_batched", ops.coupling_sum(slabs, reps), want_mc,
           lambda: ops.coupling_sum(slabs, reps), lambda: plain.coupling_sum_ref(slabs, reps),
           mc_bytes, mc_ops, library_ms=bmm_ms)
    record("hybrid_coupling_sum_batched", ops.hybrid_coupling_sum(slabs, reps, parallel=AUTO_P),
           plain.hybrid_coupling_sum_ref(slabs, reps, AUTO_P),
           lambda: ops.hybrid_coupling_sum(slabs, reps, parallel=AUTO_P),
           lambda: plain.hybrid_coupling_sum_ref(slabs, reps, AUTO_P),
           mc_bytes, mc_ops, library_ms=bmm_ms)
    for name in ("coupling_sum_batched", "hybrid_coupling_sum_batched"):
        rows[name]["shape"] = {"I": MC_INSTANCES, "B": MC_REPLICAS, "M": 32, "N": N}
    rows["hybrid_coupling_sum_batched"]["parallel"] = AUTO_P
    # The coupling GEMM's launch plans, as the wrappers chose them.
    for name, (spins, wts), parallel in (
        ("coupling_sum", (sigma, w), None),
        ("onn_step", (sigma_t, w), None),
        ("hybrid_coupling_sum", (sigma, w), AUTO_P),
        ("coupling_sum_batched", (reps, slabs), None),
        ("hybrid_coupling_sum_batched", (reps, slabs), AUTO_P),
    ):
        inst = wts.shape[0] if wts.dim() == 3 else 1
        m_, n_ = wts.shape[-2:]
        rows[name]["plan"] = coupling_plan_dict(
            autotune.coupling_plan(inst, spins.numel() // (inst * n_), m_, n_, parallel))
    emit({"phase": "kernels", "shape": {"B": B, "N": N, "chunk": CHUNK},
          "kernels": list(rows.values())})

    # 4. main path: retrieval through the solver, pack off and on ------------------
    w_np, targets, probes = make_problem(args.seed)
    launches = {k: 0 for k in (*ops.KERNELS, "coupling_wgmma")}

    def drive(solve):
        """One cold call of ``solve`` with the launch counts set to 0 just
        before and read just after; returns (result, seconds, launches).
        The wgmma regime's launches (kernels 1 and 2, also counted under
        their kernel) add up under ``coupling_wgmma``."""
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path = dict(ops.LAUNCHES)
        for k, v in path.items():
            launches[k] += v
        launches["coupling_wgmma"] += sum(
            v for k, v in ops.REGIME_LAUNCHES.items() if k.endswith("/wgmma"))
        return res, seconds, path

    def with_wgmma(phase_launches: dict, before: int) -> dict:
        """A phase's launches by kernel, with the wgmma regime's launches
        that its drives added since ``before``."""
        return {**phase_launches, "coupling_wgmma": launches["coupling_wgmma"] - before}

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

    # 9. the kernel library's entry points: kernels 2 and 8 ----------------------
    def kernel_api_calls():
        got = kernel_api.onn_step(w, sigma_t, h_tie)
        require(torch.equal(got, step_want), "kernel_api: onn_step differs from phase 3")
        ratios = {}
        for label, (wq, scale, x) in qmv_shapes.items():
            ratios[label] = fp32_error(kernel_api.quantized_matvec(wq, scale, x), x, wq, scale)[1]
            require(ratios[label] <= 1.0, f"kernel_api: quantized_matvec {label} past its bound")
        return {"onn_step_exact": True, "quantized_matvec_error_bound_ratio": ratios}

    report, _, path_launches = drive(kernel_api_calls)
    for k in ("onn_step", "quantized_matvec"):
        require(path_launches.get(k, 0) > 0, f"kernel_api: {k} never launched")
    emit({"phase": "kernel_api", **report, "launches": path_launches})

    # 10. main path: the Max-Cut annealer on kernels 1 and 6 -----------------------
    maxcut = {}
    edges = graphs.sum(dim=(1, 2)).double() / 2
    for route, kernel in (
        (dict(backend="kernel"), "coupling_sum_batched"),
        (dict(backend="hybrid", hybrid_impl="kernel"), "hybrid_coupling_sum_batched"),
    ):
        kw = dict(sweeps=MC_SWEEPS, replicas=MC_REPLICAS, stagnation=MC_STAGNATION,
                  settle_chunk=MC_CHUNK, **route)
        solver = api.MaxCutSolver(**kw)  # on the GPU

        def key():  # the same uniforms on both devices: drawn on the CPU
            return torch.Generator().manual_seed(args.seed)

        res, seconds, path_launches = drive(lambda: solver.solve(graphs, key=key()))
        cpu_res = api.MaxCutSolver(**kw, device="cpu").solve(graphs, key=key())
        for f in ising.MaxCutResult._fields:
            require(torch.equal(getattr(res, f).cpu(), getattr(cpu_res, f)),
                    f"maxcut {route}: card != CPU in {f}")
        if maxcut:
            for f in ising.MaxCutResult._fields:
                require(torch.equal(getattr(res, f), getattr(maxcut["kernel"], f)),
                        f"maxcut: hybrid != kernel backend in {f}")
        cfg_mc = solver.config(N)
        groups = ising.resolve_stagger_groups(0, N)
        ran = res.sweeps_run.cpu()
        stepped = -(-int(ran.max()) // MC_CHUNK) * MC_CHUNK  # whole chunks
        n_launch = path_launches.get(kernel, 0)
        require(n_launch == groups * stepped,
                f"maxcut {route}: {n_launch} launches of {kernel}, not {groups} per sweep")
        metrics = warm_metrics(lambda: solver.solve(graphs, key=key()),
                               per_solve=MC_INSTANCES, unit="instances")
        kernel_ms = sum(v for k, v in metrics["device_ms_by_name"].items()
                        if "coupling_gemm_kernel" in k)
        emit({
            "phase": "maxcut", **route, "parallel": cfg_mc.hybrid_parallel if
            route["backend"] == "hybrid" else None, "n": N, "instances": MC_INSTANCES,
            "replicas": MC_REPLICAS, "sweeps": MC_SWEEPS, "groups": groups,
            "stagnation": MC_STAGNATION, "settle_chunk": MC_CHUNK,
            "sweeps_run": ran.tolist(), "sweeps_stepped": stepped,
            "launches_per_sweep": n_launch / stepped,
            "mean_cut_ratio_vs_random": float((res.cut_value.cpu().double() / (edges / 2)).mean()),
            "first_call_s": seconds, **metrics, "field_kernel_ms": kernel_ms,
            "field_kernel_share_of_wall": kernel_ms / (metrics["warm_solve_s"] * 1e3),
            "launches": path_launches, "equal_to_cpu": True,
            "equal_to_kernel_backend": True if maxcut else None,
        })
        maxcut[route["backend"]] = res
    # The sequential oracle's sweep at N = 506 on the card, equal to the CPU,
    # from random spins (many flips) in a random order.
    gen = torch.Generator().manual_seed(args.seed)
    sig0 = (torch.randint(0, 2, (N,), generator=gen, dtype=torch.int8) * 2 - 1).to(dev)
    order = torch.randperm(N, generator=gen)
    swept = dyn.async_sweep(w_mc[0], sig0, order)
    require(torch.equal(swept.cpu(), dyn.async_sweep(w_mc[0].cpu(), sig0.cpu(), order)),
            "async_sweep: card != CPU")
    emit({"phase": "async_sweep", "n": N, "equal_to_cpu": True,
          "flipped": int((swept != sig0).sum())})

    # 11. the serving engine: retrieval, rtl, Max-Cut and a hot swap -------------
    from repro_torch import engine as engine_lib

    nb = engine_lib.bucket_n(N)  # the "pow2" bucket: 512

    def new_engine(policy):
        return engine_lib.Engine(torch.Generator().manual_seed(args.seed),
                                 n_policy=policy)  # serves on the GPU

    def retrieval_part(part, cfg_e, lanes, kernel):
        """One retrieval line: every request of ``lanes`` seeded lanes served
        under "pow2" and "exact", each equal to the direct solve of its rows
        and to those rows of phase 4's solve (itself equal to the CPU's)."""
        solver_e = api.RetrievalSolver(cfg_e, api.make_params(cfg_e, w_np))
        spans = request_spans(args.seed, lanes)
        reqs = [probes[a:a + c] for a, c in spans]
        direct = [solver_e.solve(r) for r in reqs]
        served, engines = {}, {}
        for policy in ("pow2", "exact"):
            eng = new_engine(policy)
            eng.install("mem", solver_e.as_engine_solver())
            (res, stats), seconds, path = drive(lambda: serve_requests(eng, "mem", reqs))
            require(path.get(kernel, 0) > 0, f"engine {part} {policy}: {kernel} never launched")
            for i, (got, want, (a, _)) in enumerate(zip(res, direct, spans)):
                require_same(got, want, FIELDS, f"engine {part} {policy} request {i} != solve")
                require_rows(got, results[False], a,
                             f"engine {part} {policy} request {i} != the CPU-checked solve")
            served[policy] = {"first_drain_s": seconds, "slabs": stats["slabs"],
                              "pad_fraction": stats["pad_fraction"],
                              "n_bucket": eng.solver("mem").bucket(N, policy),
                              "launches": path}
            engines[policy] = eng
        eng = engines["pow2"]

        def drain():
            serve_requests(eng, "mem", reqs)

        metrics = warm_metrics(drain, repeats=ENGINE_REPEATS, per_solve=len(reqs))
        lanes_per_s = lanes / metrics["warm_solve_s"]
        # The host's share: the submit loop alone, then the drain, of warm
        # drains (medians), and one latency quote (Engine.estimate) alone.
        splits = sorted(submit_then_drain(eng, "mem", reqs) for _ in range(ENGINE_REPEATS))
        t_quote = time.perf_counter()
        for r in reqs:
            eng.estimate("mem", r)
        quote_s = (time.perf_counter() - t_quote) / len(reqs)
        direct_s = sorted(solve_seconds(lambda: solver_e.solve(probes[:lanes]))
                          for _ in range(ENGINE_REPEATS))[ENGINE_REPEATS // 2]
        line = {
            "phase": "engine", "part": part, "config": "ONN_HYBRID_506",
            "backend": cfg_e.backend, "hybrid_impl": cfg_e.hybrid_impl, "lanes": lanes,
            "requests": len(reqs), "lanes_per_request": [1, ENGINE_MAX_REQUEST_LANES],
            "batch_buckets": list(eng.batch_buckets), "policies": served,
            **metrics, "lanes_per_s": lanes_per_s,
            "direct_warm_solve_s": direct_s, "direct_lanes_per_s": lanes / direct_s,
            "engine_over_direct_lanes_per_s": lanes_per_s * direct_s / lanes,
            "submit_s": sorted(x[0] for x in splits)[ENGINE_REPEATS // 2],
            "drain_s": sorted(x[1] for x in splits)[ENGINE_REPEATS // 2],
            "submit_us_per_request": 1e6 * sorted(x[0] for x in splits)[ENGINE_REPEATS // 2]
            / len(reqs), "estimate_us_per_request": 1e6 * quote_s,
            "stats": {k: eng.stats()["solvers"]["mem"][k] for k in (
                "settle_ema_cycles", "expected_cycles", "n_buckets", "autotune")},
            "equal_to_solve": True, "equal_to_cpu_checked_solve": True, "policies_agree": True,
        }
        return line, eng, solver_e, reqs, spans

    # 11.1 retrieval, kernel backend: kernel 5 at (<= 128, nb) and (<= 128, N)
    cfg_k = dataclasses.replace(configs.ONN_HYBRID_506, backend="kernel")
    line, eng_k, solver_k, reqs_k, spans_k = retrieval_part(
        "retrieval", cfg_k, ENGINE_LANES, "phase_step_multi")
    k5_names = [k for k in line["device_ms_by_name"] if any(
        s in k for s in SYMBOLS["phase_step_multi"])]
    k5_launches = line["policies"]["pow2"]["launches"]["phase_step_multi"]
    # Kernel 5 alone at the slab shape (128, nb): the padded couplings and
    # the first 128 lanes, timing launches that count for no path.
    slab = max(engine_lib.DEFAULT_BATCH_BUCKETS)
    w_nb = torch.nn.functional.pad(w, (0, nb - N, 0, nb - N))
    b_nb = torch.nn.functional.pad(bias, (0, nb - N))
    ph_nb = torch.nn.functional.pad(phase[:slab], (0, nb - N))
    pv_nb = torch.nn.functional.pad(prev[:slab], (0, nb - N))
    got, want, k5_at_slab, k5_plain, k5_bytes, k5_ops, _ = multi_case(
        w_nb, b_nb, ph_nb, pv_nb, multi_cols(slab), False)
    torch.cuda.synchronize()
    k5_err = max_abs_err(got, want)
    require(k5_err == 0, f"phase_step_multi at {[slab, nb]}: kernel disagrees with its plain "
                         f"version (max_abs_err {k5_err})")
    plan_slab = autotune.multi_plan(slab, nb)
    line.update(
        kernel5_in_drain_ms=sum(line["device_ms_by_name"][k] for k in k5_names),
        kernel5_launches_in_drain=k5_launches,
        kernel5_slab_shape=[slab, nb], kernel5_at_slab_max_abs_err=k5_err,
        kernel5_at_slab_ms=device_ms(k5_at_slab, "phase_step_multi"),
        kernel5_at_slab_plain_ms=cuda_ms(k5_plain), kernel5_at_slab_bound_ms=bound(
            k5_bytes, k5_ops)[0],
        kernel5_at_main_shape_ms=rows["phase_step_multi"]["kernel_ms"],
        kernel5_slab_plan=multi_plan_dict(plan_slab, ops.multi_cluster_occupancy(plan_slab)),
    )
    emit(line)

    # 11.2 retrieval, hybrid kernel route: kernel 7 at P = 32 on nb
    cfg_hk = dataclasses.replace(configs.ONN_HYBRID_506, backend="hybrid", hybrid_impl="kernel")
    line, *_ = retrieval_part("retrieval_hybrid", cfg_hk, ENGINE_HYBRID_LANES,
                              "hybrid_phase_step")
    line["parallel"] = cfg_hk.hybrid_parallel
    emit(line)

    # 11.3 rtl with sync_jitter, each request's generator seeded
    for arch, route, kernel in (
        ("hybrid", dict(backend="hybrid", hybrid_impl="kernel"), "hybrid_coupling_sum"),
        ("recurrent", dict(backend="kernel"), "coupling_sum"),
    ):
        cfg_r = dataclasses.replace(configs.ONN_HYBRID_506, mode="rtl", sync_jitter=True,
                                    architecture=arch, **route)
        solver_r = api.RetrievalSolver(cfg_r, api.make_params(cfg_r, w_np))
        spans = request_spans(args.seed, ENGINE_RTL_LANES)
        reqs = [probes[a:a + c] for a, c in spans]

        def keys():
            return [torch.Generator(device=dev).manual_seed(1000 + i) for i in range(len(reqs))]

        direct = [solver_r.solve(r, key=k) for r, k in zip(reqs, keys())]
        # The CPU's solve of the same lanes, on each request's offsets drawn
        # as the adapter draws them from its generator.
        t0_e = torch.cat([
            torch.randint(0, cfg_r.clocks_per_cycle, (c,), generator=k, device=k.device,
                          dtype=torch.int32) for (_, c), k in zip(spans, keys())])
        cpu_e = dyn.retrieve(cfg_r, api.make_params(cfg_r, w_np, device="cpu"),
                             torch.as_tensor(probes[:ENGINE_RTL_LANES]), t0=t0_e.cpu())
        per_policy = {}
        for policy in ("pow2", "exact"):
            eng = new_engine(policy)
            eng.install("mem", solver_r.as_engine_solver())
            (res, stats), seconds, path = drive(lambda: serve_requests(eng, "mem", reqs, keys()))
            require(path.get(kernel, 0) > 0, f"engine rtl {arch} {policy}: {kernel} never launched")
            for i, (got, want, (a, _)) in enumerate(zip(res, direct, spans)):
                require_same(got, want, FIELDS, f"engine rtl {arch} {policy} request {i} != solve")
                require_rows(got, cpu_e, a, f"engine rtl {arch} {policy} request {i} != CPU")
            per_policy[policy] = {"drain_s": seconds, "slabs": stats["slabs"],
                                  "pad_fraction": stats["pad_fraction"], "launches": path}
        emit({"phase": "engine", "part": "rtl", "architecture": arch, **route,
              "sync_jitter": True, "lanes": ENGINE_RTL_LANES, "requests": len(reqs),
              "policies": per_policy, "equal_to_solve_with_same_seed": True,
              "equal_to_cpu": True})

    # 11.4 Max-Cut: the 16 graphs at N and two at n = 300, all in the bucket nb
    rng_mc = np.random.default_rng([args.seed, 29])
    small = []
    for _ in range(2):
        upper = np.triu(rng_mc.random((ENGINE_SMALL_N, ENGINE_SMALL_N)) < 0.5, k=1)
        small.append(torch.as_tensor((upper + upper.T).astype(np.int8)))
    adjs = list(graphs) + small
    bb = engine_lib.bucket_batch(len(adjs))
    groups = ising.resolve_stagger_groups(0, nb)
    window = -(-nb // groups)  # the member rows of one update group
    # The field kernels' operands at the slab's shape: a window of each padded
    # instance's couplings (bb instances, the 16 graphs repeated) against its
    # replicas' spins.
    w_mc_nb = torch.nn.functional.pad(w_mc, (0, nb - N, 0, nb - N))
    w_mc_nb = w_mc_nb[torch.arange(bb, device=dev) % MC_INSTANCES]
    members_nb = torch.stack([torch.randperm(nb, generator=torch.Generator().manual_seed(i))
                              [:window] for i in range(bb)]).to(dev)
    slabs_nb = w_mc_nb[torch.arange(bb, device=dev)[:, None], members_nb]
    reps_nb = torch.randint(0, 2, (bb, MC_REPLICAS, nb), generator=g, device=dev,
                            dtype=torch.int8) * 2 - 1
    mc_served, mc_cpu = {}, {}
    for route, kernel in (
        (dict(backend="kernel"), "coupling_sum_batched"),
        (dict(backend="hybrid", hybrid_impl="kernel"), "hybrid_coupling_sum_batched"),
    ):
        kw = dict(sweeps=MC_SWEEPS, replicas=MC_REPLICAS, stagnation=MC_STAGNATION,
                  settle_chunk=MC_CHUNK, **route)
        solver_mc = api.MaxCutSolver(**kw)  # on the GPU
        eng = new_engine("pow2")
        eng.install("cuts", solver_mc.as_engine_solver())

        def keys():  # drawn on the CPU: the same uniforms for the card's and the CPU's solve
            return [torch.Generator().manual_seed(2000 + i) for i in range(len(adjs))]

        (res, stats), seconds, path = drive(lambda: serve_requests(eng, "cuts", adjs, keys()))
        require(list(stats["slabs_per_bucket"]) == [f"cuts:{nb}:batch{bb}"],
                f"engine maxcut: slabs {stats['slabs_per_bucket']}")
        if not mc_served:  # the kernel backend against each isolated solve
            for i, (got, a, k) in enumerate(zip(res, adjs, keys())):
                require_same(got, solver_mc.solve(a, key=k), ising.MaxCutResult._fields,
                             f"engine maxcut {route} instance {i} != solve")
            cpu_solver = api.MaxCutSolver(**kw, device="cpu")
            for i in (0, len(graphs)):  # one instance at N, one at ENGINE_SMALL_N
                mc_cpu[i] = cpu_solver.solve(adjs[i], key=keys()[i])
                require_same(res[i], mc_cpu[i], ising.MaxCutResult._fields,
                             f"engine maxcut instance {i} != CPU")
        else:
            for i, (got, want) in enumerate(zip(res, mc_served["kernel"])):
                require_same(got, want, ising.MaxCutResult._fields,
                             f"engine maxcut {route} instance {i} != kernel backend")
        ran = max(int(r.sweeps_run) for r in res)
        stepped = -(-ran // MC_CHUNK) * MC_CHUNK
        n_launch = path.get(kernel, 0)
        require(n_launch == groups * stepped,
                f"engine maxcut {route}: {n_launch} launches of {kernel}, not {groups} per sweep")

        def drain():
            serve_requests(eng, "cuts", adjs, keys())

        metrics = warm_metrics(drain, repeats=ENGINE_MC_REPEATS, per_solve=len(adjs),
                               unit="instances")
        # The field kernel alone at the slab's shape, against its plain version.
        p_nb = solver_mc.config(nb).hybrid_parallel
        if kernel == "coupling_sum_batched":
            def field():
                return ops.coupling_sum(slabs_nb, reps_nb)

            def field_plain():
                return plain.coupling_sum_ref(slabs_nb, reps_nb)
        else:
            def field():
                return ops.hybrid_coupling_sum(slabs_nb, reps_nb, parallel=p_nb)

            def field_plain():
                return plain.hybrid_coupling_sum_ref(slabs_nb, reps_nb, p_nb)
        field_err = max_abs_err(field(), field_plain())
        require(field_err == 0, f"{kernel} at the engine's shape: kernel disagrees with its "
                                f"plain version (max_abs_err {field_err})")
        field_at_bucket = {
            "shape": {"I": bb, "B": MC_REPLICAS, "M": window, "N": nb},
            "parallel": p_nb if route["backend"] == "hybrid" else None,
            "max_abs_err": field_err, "kernel_ms": device_ms(field, kernel),
            # per launch in the traced drain: the same kernel at the same shape
            "kernel_ms_in_drain": sum(v for k, v in metrics["device_ms_by_name"].items()
                                      if "coupling_gemm_kernel" in k) / n_launch,
            "wrapper_ms": cuda_ms(field), "plain_ms": cuda_ms(field_plain, iters=5, warmup=1),
        }
        emit({
            "phase": "engine", "part": "maxcut", **route, "n": [N] * len(graphs) + [
                ENGINE_SMALL_N] * len(small), "n_bucket": nb, "replicas": MC_REPLICAS,
            "sweeps": MC_SWEEPS, "stagnation": MC_STAGNATION, "groups": groups,
            "slabs_per_bucket": stats["slabs_per_bucket"], "pad_fraction": stats["pad_fraction"],
            "sweeps_stepped": stepped, "launches_per_sweep": n_launch / stepped,
            "first_drain_s": seconds, **metrics, "launches": path,
            "field_kernel_at_bucket": field_at_bucket,
            "equal_to_solve_with_same_seed": not mc_served or None,
            "instances_equal_to_cpu": None if mc_served else [0, len(graphs)],
            "equal_to_kernel_backend": True if mc_served else None,
        })
        mc_served[route["backend"]] = res

    # 11.5 hot swap to a second Hebbian matrix on the kernel backend's engine
    w2_np, _, _ = make_problem(args.seed + 1)
    params2 = api.make_params(cfg_k, w2_np)
    eng_k.hot_swap("mem", params2)
    swap_reqs = reqs_k[:64]
    direct2 = [api.RetrievalSolver(cfg_k, params2).solve(r) for r in swap_reqs]
    (res, stats), seconds, path = drive(lambda: serve_requests(eng_k, "mem", swap_reqs))
    for i, (got, want) in enumerate(zip(res, direct2)):
        require_same(got, want, FIELDS, f"engine hot_swap request {i} != solve on new weights")
    require(stats["solvers"]["mem"]["hot_swaps"] == 1, "engine hot_swap: not counted")
    emit({"phase": "engine", "part": "hot_swap", "requests": len(swap_reqs),
          "lanes": sum(c for _, c in spans_k[:64]), "drain_s": seconds, "launches": path,
          "hot_swaps": 1, "equal_to_solve_on_new_weights": True})

    # 12. the serve daemon and DO-I training ---------------------------------------
    xi = torch.as_tensor(_patterns(np.random.default_rng(args.seed)))  # make_problem's
    mc_in = [(pos, adjs[i], 2000 + i, mc_cpu[i]) for pos, i in zip(DAEMON_MC_AT, sorted(mc_cpu))]
    mc_kw = dict(sweeps=MC_SWEEPS, replicas=MC_REPLICAS, stagnation=MC_STAGNATION,
                 settle_chunk=MC_CHUNK, backend="kernel")
    w0 = launches["coupling_wgmma"]
    daemon_launches = with_wgmma(daemon_lines(
        dev, args.seed, cfg_k, w_np, make_hebbian(args.seed + 1), xi, probes, results[False],
        spans_k, mc_in, mc_kw, drive), w0)

    # 13. the ONN launchers, the energy model and the quickstart example --------------
    w0 = launches["coupling_wgmma"]
    launcher_launches = with_wgmma(launcher_lines(dev, args.seed, w_np, results[False], drive),
                                   w0)

    # 14. the row-sharded path on meshes that repeat the card ---------------------------
    w0 = launches["coupling_wgmma"]
    sharded_launches = with_wgmma(sharded_lines(
        dev, args.seed, w_np, xi, probes, results[False], rtl["recurrent"], graphs,
        maxcut["kernel"], mc_kw, spans_k, mc_in, drive), w0)

    # 15. the LM serving path: dense, MoE and VLM at full width; phase 19's
    # tracegate processes start beside its enc-dec CPU check, while the card idles
    tracegate_dir = tempfile.mkdtemp(prefix="tracegate_")
    tracegate_procs = []
    try:
        w0 = launches["coupling_wgmma"]
        lm_launches = with_wgmma(lm_lines(dev, args.seed, drive, tracegate_dir,
                                          tracegate_procs), w0)

        # 16. LM training: qwen2-1.5b at full width, card against CPU, resume ---------
        # 17. the LM dry run on the meta device, beside phase 16's step: its CLI cells
        # count on the host's idle cores while phase 16 trains on the card
        dryrun_dir = tempfile.mkdtemp(prefix="dryrun_")
        dryrun_procs = start_dryrun_cli(dryrun_dir)
        try:
            w0 = launches["coupling_wgmma"]
            train_launches, full_step = train_lines(dev, args.seed, drive)
            train_launches = with_wgmma(train_launches, w0)
            w0 = launches["coupling_wgmma"]
            dryrun_launches = with_wgmma(dryrun_lines(dev, args.seed, drive, full_step,
                                                      dryrun_procs, dryrun_dir), w0)
        finally:
            stop_processes(dryrun_procs)
            shutil.rmtree(dryrun_dir, ignore_errors=True)
        del full_step

        # 18. the ONN dry run: counts, one device's share on the card, composed sweeps -
        w0 = launches["coupling_wgmma"]
        onn_launches, onn_shapes = dryrun_onn_lines(dev, args.seed, drive)
        onn_launches = with_wgmma(onn_launches, w0)
        for name in ("coupling_sum", "onn_step"):
            rows[name]["dryrun_onn_shapes"] = [s for s in onn_shapes if s["kernel"] == name]
        rows["coupling_wgmma"]["dryrun_onn_shapes"] = [
            s for s in onn_shapes if s["plan"]["regime"] == "wgmma"]

        # 19. the tooling: the launch plans' budget, the compiled kernels, the gate ----
        require(len(tracegate_procs) == 2, "analysis: the tracegate processes never started")
        tracegate_launches = analysis_lines(dev, tracegate_procs, tracegate_dir)
    finally:
        stop_processes(tracegate_procs)
        shutil.rmtree(tracegate_dir, ignore_errors=True)

    # 20. launches past CUDA's 65,535 grid tiles (port fault 9) ---------------------
    edge_launches = launch_edge_lines(dev, args.seed, rows)

    for name, row in rows.items():
        row["launches"] = launches[name]
        row["launches_daemon"] = daemon_launches.get(name, 0)
        row["launches_launchers"] = launcher_launches.get(name, 0)
        row["launches_sharded"] = sharded_launches.get(name, 0)
        row["launches_lm"] = lm_launches.get(name, 0)
        row["launches_train"] = train_launches.get(name, 0)
        row["launches_dryrun"] = dryrun_launches.get(name, 0)
        row["launches_dryrun_onn"] = onn_launches.get(name, 0)
        row["launches_tracegate"] = tracegate_launches.get(name, 0)
        row["launches_edges"] = edge_launches.get(name, 0)
        require(row["launches"] > 0, f"{name} was never launched on the main path")
        require(row["launches_train"] == 0, f"{name} launched on the LM training path")
        require(row["launches_dryrun"] == 0, f"{name} launched in the dry run")
        require((row["launches_dryrun_onn"] > 0) == (name in ("coupling_sum", "onn_step",
                                                              "coupling_wgmma")),
                f"{name}: {row['launches_dryrun_onn']} launches in the ONN dry run")
    require(rows["phase_step_multi"]["launches_tracegate"] > 0,
            "phase_step_multi was never launched by the tracegate's retrieve workload")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
