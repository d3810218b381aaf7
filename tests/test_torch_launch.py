"""The port's CLIs (``repro_torch.launch.maxcut``, ``serve_daemon``,
``retrieve``, ``train_onn``) and its ``examples/torch_*.py`` on the CPU.

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

The retrieval service is held against ``repro.launch.retrieve``: the
reference's own draws (recomputed here as its ``serve_requests`` computes
them) and its int8 weights (carried across with
``convert.params_from_reference``) go through the port's serve half, and
the report's accuracy, mean settle cycles, timeouts, slabs, pad fraction and
slabs per bucket, and every request's spins, settle cycle and settled flag,
must equal the reference's exactly.  ``build_solver``'s own DO-I weights are
held by the rule of ``tests/doi_rule.py`` (the letter sets are tie-bound).
``run_train_serve`` meets every assertion the reference's test makes of its
own.  The launchers and examples import with ``jax`` and ``repro`` absent.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doi_rule import hold, replay
from repro import train as ref_train
from repro.core import dynamics as ref_dyn
from repro.core import hardware_model as ref_hw
from repro.data import patterns as ref_patterns
from repro.launch import retrieve as ref_retrieve
from repro_torch import api, convert, train
from repro_torch.api import MaxCutSolver
from repro_torch.core import learning, quantization
from repro_torch.core.ising import random_graph
from repro_torch.launch import retrieve as port_retrieve
from repro_torch.launch.maxcut import serve_cuts
from repro_torch.launch.train_onn import run_train_serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))


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


# ---------------------------------------------------------------------------
# The retrieval service against repro.launch.retrieve
# ---------------------------------------------------------------------------


def reference_draws(xi, corruption: float, n_requests: int, seed: int = 0):
    """(targets, corrupted) as ``repro.launch.retrieve.serve_requests`` draws
    them (``src/repro/launch/retrieve.py:167-172``), as numpy."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    which = jax.random.randint(k1, (n_requests,), 0, xi.shape[0])
    targets = xi[which]
    ckeys = jax.random.split(k2, n_requests)
    corrupted = jax.vmap(lambda t, k: ref_patterns.corrupt(t, k, corruption))(targets, ckeys)
    return np.array(targets), np.array(corrupted)


def carried_solver(ref_solver) -> api.RetrievalSolver:
    """The port's solver on the reference solver's config and int8 weights."""
    cfg = convert.config_from_reference(ref_solver.config)
    return api.RetrievalSolver(cfg, convert.params_from_reference(
        cfg, np.array(ref_solver.params.weights), np.array(ref_solver.params.bias),
        device="cpu"))


@pytest.mark.parametrize("dataset,backend,n_requests", [
    ("7x6", "parallel", 64),
    ("5x4", "pallas", 32),
    ("5x4", "parallel", 32),
])
def test_retrieval_service_equals_reference(dataset, backend, n_requests):
    """``tests/test_launchers.py:61`` and ``:90`` on the port: the serve half
    on the reference's draws and weights equals ``serve_requests``, request
    for request (the kernel route takes the plain versions on the CPU)."""
    ref_solver, xi = ref_retrieve.build_solver(dataset, "hybrid", backend=backend)
    want = ref_retrieve.serve_requests(ref_solver, xi, 0.10, n_requests)
    targets, corrupted = reference_draws(xi, 0.10, n_requests)
    solver = carried_solver(ref_solver)
    assert solver.config.backend == {"pallas": "kernel"}.get(backend, backend)
    got, res = port_retrieve.serve_corrupted(
        solver, torch.as_tensor(targets), torch.as_tensor(corrupted),
        torch.Generator().manual_seed(0), corruption=0.10)
    for key in ("n_oscillators", "requests", "corruption", "accuracy", "mean_settle_cycles",
                "timeouts"):
        assert got[key] == want[key], key
    for key in ("slabs", "pad_fraction", "slabs_per_bucket"):
        assert got["engine"][key] == want["engine"][key], key
    assert set(want) <= set(got)
    assert (got["mesh_devices"], got["shard_plan"]) == (want["mesh_devices"], want["shard_plan"])
    assert set(got) - set(want) == {"device"} and got["device"] == "cpu"
    # Each request's result: the engine serves it as its isolated solve, so
    # the reference's batched retrieve of the same rows gives it.
    ref_res = ref_dyn.retrieve(ref_solver.config, ref_solver.params, jnp.asarray(corrupted))
    for f in ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref_res, f)),
                                      err_msg=f)
    if dataset == "7x6":
        assert got["accuracy"] >= 0.9 and got["mean_settle_cycles"] < 50


def test_build_solver_follows_the_doi_rule():
    """``build_solver`` trains with ``diederich_opper_i``'s defaults: its
    config is the reference's (kernel for pallas), its int8 weights the
    quantized port DO-I, and that training is held to the reference's by the
    DO-I rule (the letter sets are tie-bound)."""
    solver, xi = port_retrieve.build_solver("7x6", "recurrent", backend="kernel", device="cpu")
    ref_solver, ref_xi = ref_retrieve.build_solver("7x6", "recurrent", backend="pallas")
    np.testing.assert_array_equal(xi.numpy(), np.asarray(ref_xi))
    assert solver.config == convert.config_from_reference(ref_solver.config)
    # diederich_opper_i's defaults are train_doi's with self-coupling on.
    port_do = train.train_doi(xi, train.TrainConfig(self_coupling=True), device="cpu")
    assert torch.equal(learning.diederich_opper_i(xi, device="cpu").weights, port_do.weights)
    assert torch.equal(solver.params.weights, quantization.quantize_weights(port_do.weights).values)
    ref_do = ref_train.train_doi(jnp.asarray(ref_xi), ref_train.TrainConfig(self_coupling=True))
    kind = hold(port_do, ref_do, replay(xi.numpy(), self_coupling=True),
                quantize=lambda w: quantization.quantize_weights(torch.as_tensor(np.array(w))).values)
    assert kind == "tie_bound" and bool(port_do.converged)


def test_serve_requests_draws_from_one_cpu_generator():
    """``serve_requests`` is ``draw_requests`` then ``serve_corrupted`` on one
    CPU generator seeded with ``seed``: the same seed, the same report."""
    solver, xi = port_retrieve.build_solver("5x4", "hybrid", backend="kernel", device="cpu")
    a = port_retrieve.serve_requests(solver, xi, 0.25, 16, seed=3)
    gen = torch.Generator().manual_seed(3)
    which, corrupted = port_retrieve.draw_requests(xi, 0.25, 16, gen)
    k = round(0.25 * xi.shape[1])
    assert ((corrupted != xi[which]).sum(dim=1) == k).all()
    b, res = port_retrieve.serve_corrupted(solver, xi[which], corrupted, gen, corruption=0.25)
    for key in ("accuracy", "mean_settle_cycles", "timeouts", "engine", "requests"):
        assert a[key] == b[key], key
    want = solver.solve(corrupted)
    for f in ("final_sigma", "settle_cycle", "settled"):
        assert torch.equal(getattr(res, f), getattr(want, f)), f


def test_retrieve_cli_prints_json():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.retrieve", "--device", "cpu",
         "--dataset", "5x4", "--requests", "32", "--backend", "kernel"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["requests"] == 32 and report["device"] == "cpu"
    assert report["n_oscillators"] == 20 and 0.0 <= report["accuracy"] <= 1.0
    assert report["engine"]["slabs_per_bucket"] == {"retrieval:32:batch32": 1}


# ---------------------------------------------------------------------------
# train -> hot-install -> serve
# ---------------------------------------------------------------------------


def test_train_onn_hot_swap_flow(tmp_path):
    """``tests/test_launchers.py:100`` on the port: Hebbian served, QAT DO-I
    trained and hot-installed mid-stream through a checkpoint round trip,
    accuracy improves, and the swap builds no kernel and makes no plan."""
    out = run_train_serve(
        dataset="7x6", corruption=0.15, probes=12, seed=0,
        ckpt_dir=str(tmp_path), max_sweeps=200, device="cpu",
    )
    assert out["train"]["converged"]
    assert out["accuracy_trained"] >= out["accuracy_hebbian"]
    assert out["hot_swaps"] == 1
    assert out["serving_retraces_after_swap"] == 0
    assert out["checkpoint"] is not None and os.path.exists(out["checkpoint"])
    assert out["completed"] == 3 * out["probes"]  # warmup + two phases
    assert out["device"] == "cpu" and out["n"] == 42


def test_train_onn_cli_prints_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_onn", "--device", "cpu",
         "--dataset", "5x4", "--probes", "8", "--backend", "kernel",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["hot_swaps"] == 1 and report["serving_retraces_after_swap"] == 0
    assert report["completed"] == 24 and report["device"] == "cpu"


# ---------------------------------------------------------------------------
# Isolation and the examples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["repro_torch.launch.retrieve", "repro_torch.launch.train_onn",
                                    "repro_torch.launch.maxcut", "repro_torch.launch.serve_daemon",
                                    "repro_torch.launch.mesh", "repro_torch.launch.train"]
                         + [os.path.basename(p) for p in EXAMPLES])
def test_imports_without_jax_or_repro(target):
    """Each launcher and ``examples/torch_*.py`` imports with ``jax`` and
    ``repro`` blocked, in a fresh process."""
    if target.endswith(".py"):
        load = ("import importlib.util; "
                f"s = importlib.util.spec_from_file_location('ex', {os.path.join(ROOT, 'examples', target)!r}); "
                "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); m.main")
    else:
        load = f"import {target}"
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; " + load)
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_six_torch_examples_exist():
    names = {os.path.basename(p) for p in EXAMPLES}
    assert names == {f"torch_{stem}.py" for stem in (
        "quickstart", "pattern_retrieval", "maxcut_ising", "engine_mixed_workloads",
        "serving_load", "train_retrieve_serve", "train_lm", "serve_lm")}


def test_quickstart_example_retrieves_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "retrieved correctly: True" in out.stdout


# ---------------------------------------------------------------------------
# The --mesh / --shard-batch flags and serving under a ShardPlan
# ---------------------------------------------------------------------------


def _cpu_mesh(batch, model):
    from repro_torch.distributed import make_mesh

    return make_mesh((batch, model), devices=["cpu"] * (batch * model))


@pytest.mark.parametrize("mesh_spec,shard_batch", [
    ("2x2", True), ("1x2", False), ("2x2", False), ("bad", False), ("1x1", False),
    (None, True), (None, False),
])
def test_plan_flags_parse_and_refuse_as_the_reference(mesh_spec, shard_batch):
    """``resolve_plan_args`` with the reference's outcome on one device:
    the flags are mutually exclusive, a mesh wider than the local devices is
    refused with its message, ``--shard-batch`` warns and is a no-op."""
    from repro_torch.distributed import ShardPlan

    def outcome(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                plan = fn()
                result = ("plan", None if plan is None else (plan.batch, plan.model, plan.layout))
            except SystemExit as exc:
                result = ("exit", str(exc))
            except ValueError as exc:
                result = ("error", str(exc))
        return result, [str(w.message) for w in caught if w.category is DeprecationWarning]

    want = outcome(lambda: ref_retrieve.resolve_plan_args(mesh_spec, shard_batch))
    got = outcome(lambda: port_retrieve.resolve_plan_args(mesh_spec, shard_batch, "cpu"))
    assert got == want
    if mesh_spec == "1x1":
        assert port_retrieve.resolve_plan_args("1x1", False, "cpu") == ShardPlan(1, 1)


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "2x2"], "needs 4 devices, only 1 available"),
    (["--mesh", "1x2", "--shard-batch"], "mutually exclusive"),
])
@pytest.mark.parametrize("module", ["retrieve", "maxcut", "serve_daemon"])
def test_cli_mesh_flag_counts_real_devices(module, argv, message):
    """Each launcher's ``--mesh`` counts the real local devices (one CPU)."""
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--device", "cpu", *argv],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and message in out.stderr, out.stderr[-2000:]


def test_retrieve_cli_reports_the_plan():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.retrieve", "--device", "cpu", "--dataset",
         "5x4", "--requests", "8", "--mesh", "1x1"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["mesh_devices"] == 1
    assert report["shard_plan"] == {"batch": 1, "model": 1, "layout": "row", "compressed": False}


@pytest.mark.parametrize("plan_shape,backend", [((2, 4), "kernel"), ((1, 4), "parallel"),
                                                 ((4, 1), "kernel")])
def test_serve_requests_under_a_plan_equals_unsharded(plan_shape, backend):
    """``serve_requests``' halves under a CPU mesh: every request's result
    equals the unsharded serve's, and the report carries the plan."""
    from repro_torch.distributed import ShardPlan

    solver, xi = port_retrieve.build_solver("5x4", "hybrid", backend=backend, device="cpu")
    gen = torch.Generator().manual_seed(4)
    which, corrupted = port_retrieve.draw_requests(xi, 0.25, 24, gen)
    plan = ShardPlan(*plan_shape)
    reports, results = [], []
    for p, mesh in ((None, None), (plan, _cpu_mesh(*plan_shape))):
        report, res = port_retrieve.serve_corrupted(
            solver, xi.cpu()[which], corrupted, torch.Generator().manual_seed(5),
            corruption=0.25, plan=p, mesh=mesh)
        reports.append(report)
        results.append(res)
    for f in results[0]._fields:
        assert torch.equal(getattr(results[0], f), getattr(results[1], f)), f
    for key in ("accuracy", "mean_settle_cycles", "timeouts"):
        assert reports[0][key] == reports[1][key]
    assert reports[0]["mesh_devices"] == 1 and reports[0]["shard_plan"] is None
    assert reports[1]["mesh_devices"] == plan.devices
    assert reports[1]["shard_plan"] == dataclasses.asdict(plan)
    full = port_retrieve.serve_requests(solver, xi, 0.25, 8, plan=plan,
                                        mesh=_cpu_mesh(*plan_shape))
    assert full["shard_plan"] == dataclasses.asdict(plan) and full["requests"] == 8


def test_serve_cuts_under_2x4_equals_unsharded(monkeypatch):
    """``serve_cuts`` under a 2x4 CPU mesh: every request's cut, spins and
    trace equal the unsharded serve's, and the report counts 8 devices."""
    from repro_torch.distributed import ShardPlan
    from repro_torch.launch import maxcut as port_maxcut

    served = []

    class Recording(port_maxcut.Engine):
        def submit(self, request):
            fut = super().submit(request)
            served.append(fut)
            return fut

    monkeypatch.setattr(port_maxcut, "Engine", Recording)
    solver = MaxCutSolver(sweeps=12, replicas=4, stagnation=4, backend="kernel", device="cpu")
    runs = []
    for plan, mesh in ((None, None), (ShardPlan(2, 4), _cpu_mesh(2, 4))):
        served.clear()
        report = serve_cuts(solver, n=20, n_requests=6, seed=2, plan=plan, mesh=mesh)
        runs.append((report, [f.result() for f in served]))
    (rep0, res0), (rep1, res1) = runs
    assert len(res0) == len(res1) == 6
    for a, b in zip(res0, res1):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert rep0["mean_cut"] == rep1["mean_cut"]
    assert (rep0["mesh_devices"], rep1["mesh_devices"]) == (1, 8)


def test_run_daemon_under_a_plan_reports_it():
    """The whole daemon under a 1x2 CPU plan serves every request and the
    report carries ``shard_plan`` as the reference's does."""
    from repro_torch.distributed import ShardPlan
    from repro_torch.launch.serve_daemon import run_daemon

    plan = ShardPlan(1, 2)
    report = run_daemon(n_requests=8, ticked=4, device="cpu", plan=plan, mesh=_cpu_mesh(1, 2))
    assert report["completed"] == 8 and report["failed"] == 0
    assert report["shard_plan"] == {"batch": 1, "model": 2, "layout": "row",
                                    "compressed": False}
