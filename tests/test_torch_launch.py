"""The port's serving CLIs (``repro_torch.launch.maxcut``,
``repro_torch.launch.serve_daemon``) on the CPU.

Mirrors ``test_maxcut_service`` and
``test_maxcut_service_deterministic_across_bucket_policy`` of
``tests/test_launchers.py`` on the port's ``serve_cuts``, and runs
``python -m repro_torch.launch.maxcut --device cpu`` in a subprocess.  The
graphs are the port's own (``random_graph`` from a seeded
``torch.Generator``), so the cuts are compared with the port's isolated
solves and across bucket policies, exactly, and against the |E|/2 baseline
of a random assignment; the FPGA quote equals the reference model's.  The
serve daemon's CLI runs the mixed stream (DO-I trained retrieval and
Max-Cut) in a subprocess on ticked arrivals and reports every request
completed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from repro.core import hardware_model as ref_hw
from repro_torch.api import MaxCutSolver
from repro_torch.core.ising import random_graph
from repro_torch.launch.maxcut import serve_cuts

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def test_maxcut_service():
    """Engine-served Ising machine: cuts beat the random baseline on every
    instance and requests carry the recurrent-vs-hybrid hardware quote."""
    solver = MaxCutSolver(sweeps=24, replicas=4, stagnation=6, backend="hybrid",
                          parallel_factor=8, device="cpu")
    out = serve_cuts(solver, n=24, n_requests=8, seed=3)
    assert out["min_ratio_vs_half_edges"] > 1.0, out
    assert out["mean_sweeps_run"] <= 24
    trade = out["estimate"]["fpga_tradeoff"]
    assert trade is not None and trade["hybrid[P=8]"] is not None
    # Bucket 32 at P = 8, 24 sweeps x 4 replicas: the reference model's value.
    assert trade["hybrid[P=8]"] == ref_hw.time_to_solution("hybrid", 32, 96.0, parallel=8)
    assert out["engine"]["maxcut"]["backend"] == "hybrid"
    assert out["engine"]["slabs"] == 1 and out["device"] == "cpu"


def test_maxcut_service_deterministic_across_bucket_policy():
    """Same instances + same seed ⇒ same cuts under exact and pow2 bucketing,
    and the cuts of the port's isolated solves: the engine roots its
    per-request seeds in the generator that drew the graphs."""
    solver = MaxCutSolver(sweeps=12, replicas=2, device="cpu")
    a = serve_cuts(solver, n=20, n_requests=4, seed=5, n_policy="exact")
    b = serve_cuts(solver, n=20, n_requests=4, seed=5, n_policy="pow2")
    assert a["mean_cut"] == b["mean_cut"]
    assert a["mean_ratio_vs_half_edges"] == b["mean_ratio_vs_half_edges"]
    assert a["engine"]["slabs_per_bucket"] == {"maxcut:20:batch4": 1}
    assert b["engine"]["slabs_per_bucket"] == {"maxcut:32:batch4": 1}
    gen = torch.Generator().manual_seed(5)
    adjs = [random_graph(gen, 20) for _ in range(4)]
    seeds = [int(torch.randint(2**62, (), generator=gen)) for _ in adjs]
    cuts = [float(solver.solve(adj, key=torch.Generator().manual_seed(s)).cut_value)
            for adj, s in zip(adjs, seeds)]
    assert round(sum(cuts) / len(cuts), 2) == a["mean_cut"]


def test_maxcut_cli_prints_json():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.maxcut", "--device", "cpu", "--n", "24",
         "--requests", "4", "--sweeps", "16"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["requests"] == 4 and report["device"] == "cpu"
    assert report["min_ratio_vs_half_edges"] > 1.0, report
    assert report["engine"]["slabs_per_bucket"] == {"maxcut:32:batch4": 1}


def test_serve_daemon_cli_prints_json_report(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    hb = str(tmp_path / "hb")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_daemon", "--device", "cpu",
         "--ticked", "4", "--requests", "16", "--heartbeat", hb],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["completed"] == 16 and report["failed"] == 0 and report["rejected"] == 0
    assert report["device"] == "cpu" and not report["preempted"]
    assert report["latency"]["count"] == 16
    assert report["stats"]["installed"] == ["cuts", "large", "small"]
    assert report["stats"]["serving"]["ticks"] == report["ticks"]
    assert os.path.exists(hb)
