"""The port's serving stack (``repro_torch.serving``: the continuous-batching
scheduler, fair queues, daemon and load generation; ``repro_torch.train.
HotSwap``) on the CPU, against the JAX reference where the inputs can be
the same.

Tolerance: exact throughout (``==`` on every result field, counter, queue
order and offset).

* Against ``repro``: retrieval weights trained by the reference (DO-I) are
  carried across with ``convert.params_from_reference``, and both packages'
  ``ContinuousEngine`` + ``ServeDaemon`` serve the same payload stream
  (functional retrieval draws nothing) on the ``parallel``,
  ``kernel``/``pallas`` and hybrid ``scan`` routes: every served result,
  the scheduler's counters, per-tenant counts and the daemon report's
  non-time fields are equal.  ``FairQueues`` pops in the reference's order;
  ``mixed_requests`` has the reference's structure (tenant, workload,
  pattern row, lanes, graph size) for seeds 0-4; ``poisson_offsets`` and
  ``timed_source`` (on a fake clock) equal the reference's.
* The port's own invariants, mirroring ``tests/test_serving.py`` and
  ``tests/test_hotswap.py``: a request that joins a live slab equals its
  isolated solve; Max-Cut and rtl-jitter requests, which draw from their
  generators, equal the isolated solve with a generator of the same seed;
  slab caps, admission control, the preemption drain with its heartbeat,
  and the hot swap at a chunk boundary.
"""

from __future__ import annotations

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import engine as ref_engine
from repro import serving as ref_serving
from repro.data import patterns as ref_patterns
from repro_torch import api, convert, train
from repro_torch import engine as engine_lib
from repro_torch.core import dynamics
from repro_torch.core.ising import random_graph
from repro_torch.data import patterns as port_patterns
from repro_torch.distributed.ft import Heartbeat
from repro_torch.engine import adapters
from repro_torch.kernels import autotune
from repro_torch.serving import (
    ContinuousEngine,
    DrainRejectedError,
    FairQueues,
    ServeDaemon,
    load,
)

RESULT_FIELDS = ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled")
SERVING_COUNTERS = ("ticks", "chunks", "mid_flight_joins", "slabs_opened", "slabs_retired",
                    "drain_rejected", "hot_swaps")


def _patterns(seed: int, p: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice([-1, 1], (p, n)).astype(np.int8)


def _corrupt(xi: np.ndarray, row: int, flips: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.asarray(xi[row]).copy()  # int8, as the libraries are built
    idx = rng.choice(v.size, flips, replace=False)
    v[idx] = -v[idx]
    return v


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_result(got, want, fields=RESULT_FIELDS):
    for field in fields:
        g, w = _np(getattr(got, field)), _np(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def _engine(seed: int = 0, **kw) -> ContinuousEngine:
    return ContinuousEngine(torch.Generator().manual_seed(seed), device="cpu", **kw)


def _solo(seed: int = 99, **kw) -> engine_lib.Engine:
    return engine_lib.Engine(torch.Generator().manual_seed(seed), device="cpu", **kw)


# ---------------------------------------------------------------------------
# Against the reference: the same payload stream on carried-across weights
# ---------------------------------------------------------------------------

#: Retrieval routes: port config fields, reference config fields.
ROUTES = {
    "parallel": (dict(backend="parallel"), dict(backend="parallel")),
    "kernel": (dict(backend="kernel"), dict(backend="pallas")),
    "hybrid-scan": (dict(backend="hybrid", parallel_factor=5),
                    dict(backend="hybrid", parallel_factor=5)),
}


def _carried(ref_solver) -> api.RetrievalSolver:
    """The port's solver on the reference solver's config and int8 weights."""
    cfg = convert.config_from_reference(ref_solver.config)
    params = convert.params_from_reference(cfg, np.asarray(ref_solver.params.weights),
                                           np.asarray(ref_solver.params.bias), device="cpu")
    return api.RetrievalSolver(cfg, params)


def _stream(xi_a: np.ndarray, xi_b: np.ndarray, count: int, seed: int):
    """Seeded requests of 1-3 lanes over both libraries, two tenants:
    (payload, tenant) pairs; a 1-lane request is sometimes 1-d."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        xi = xi_a if i % 3 else xi_b
        lanes = int(rng.integers(1, 4))
        rows = [_corrupt(xi, int(rng.integers(0, len(xi))), 4, 1000 * seed + 10 * i + j)
                for j in range(lanes)]
        payload = rows[0] if lanes == 1 and i % 2 else np.stack(rows)
        out.append((payload, ("alpha", "beta")[int(rng.integers(0, 2))]))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_continuous_engine_and_daemon_equal_reference(route):
    """On weights the reference trained, the same stream through both
    packages' daemons (ticked arrivals, admission bound, two tenants), then
    a hot swap to a second trained matrix mid-stream and a preemption drain:
    every served result, every scheduler counter, per-tenant completed and
    rejected counts, and the daemon report's non-time fields equal."""
    port_kw, ref_kw = ROUTES[route]
    n = 20
    xi_a, xi_b = _patterns(1, 3, n), _patterns(2, 3, n)
    kw = dict(max_cycles=40, settle_chunk=2)
    ref_a = ref_api.RetrievalSolver.from_patterns(jnp.asarray(xi_a), **kw, **ref_kw)
    ref_b = ref_api.RetrievalSolver.from_patterns(jnp.asarray(xi_b), **kw, **ref_kw)
    port_a, port_b = _carried(ref_a), _carried(ref_b)
    eng_kw = dict(batch_buckets=(1, 2, 4), slab_lanes=4, max_queue_lanes=9,
                  tenant_weights={"alpha": 2.0, "beta": 1.0})
    eng = _engine(**eng_kw)
    ref_eng = ref_serving.ContinuousEngine(jax.random.PRNGKey(0), **eng_kw)
    eng.install("mem", port_a.as_engine_solver())
    ref_eng.install("mem", ref_a.as_engine_solver())

    stream = _stream(xi_a, xi_b, 18, seed=3)
    reqs = [engine_lib.Request("mem", p, tenant=t) for p, t in stream]
    ref_reqs = [ref_engine.Request("mem", jnp.asarray(p), tenant=t)
                for p, t in stream]
    report = ServeDaemon(eng, signals=()).run(load.ticked_source(reqs, per_tick=3))
    ref_report = ref_serving.ServeDaemon(ref_eng, signals=()).run(
        ref_serving.ticked_source(ref_reqs, per_tick=3))
    for k in ("ticks", "preempted", "drain", "completed", "failed", "rejected",
              "rejected_at_admission"):
        assert report[k] == ref_report[k], k
    assert report["latency"]["count"] == ref_report["latency"]["count"] == report["completed"]
    assert report["rejected_at_admission"] > 0  # the bound was reached

    # The second half: queued work, a hot swap while a slab is live, a drain.
    futs, ref_futs = [], []
    for (p, t) in _stream(xi_a, xi_b, 8, seed=4):
        try:
            futs.append(eng.submit(engine_lib.Request("mem", p, tenant=t)))
        except engine_lib.QueueFullError:
            with pytest.raises(ref_engine.QueueFullError):
                ref_eng.submit(ref_engine.Request("mem", jnp.asarray(p), tenant=t))
            continue
        ref_futs.append(ref_eng.submit(ref_engine.Request("mem", jnp.asarray(p), tenant=t)))
    for e, params in ((eng, port_b.params), (ref_eng, ref_b.params)):
        e.step()
        e.hot_swap("mem", params)
        e.step()
    assert eng.finish_in_flight(reject_queued=True) == ref_eng.finish_in_flight(
        reject_queued=True)
    for f, rf in zip(futs, ref_futs):
        assert (f.exception() is None) == (rf.exception() is None)
        if f.exception() is None:
            _assert_same_result(f.result(), rf.result())
        else:
            assert isinstance(f.exception(), DrainRejectedError)

    stats, ref_stats = eng.stats(), ref_eng.stats()
    for k in SERVING_COUNTERS:
        assert stats["serving"][k] == ref_stats["serving"][k], k
    assert stats["serving"]["mid_flight_joins"] > 0 and stats["serving"]["drain_rejected"] > 0
    for t in ("alpha", "beta"):
        for k in ("submitted", "completed", "rejected"):
            assert stats["tenants"][t][k] == ref_stats["tenants"][t][k], (t, k)
    assert set(stats["serving"]["autotune"]) == set(ref_stats["serving"]["autotune"])
    assert eng.idle and ref_eng.idle


def test_continuous_engine_served_results_equal_reference():
    """Result for result on the kernel route, mid-flight joins included:
    each served request equals the reference's for the same payload."""
    n = 16
    xi = _patterns(5, 3, n)
    ref_solver = ref_api.RetrievalSolver.from_patterns(jnp.asarray(xi), max_cycles=40,
                                                       settle_chunk=1, backend="pallas")
    eng, ref_eng = _engine(batch_buckets=(1, 2), slab_lanes=2), ref_serving.ContinuousEngine(
        jax.random.PRNGKey(0), batch_buckets=(1, 2), slab_lanes=2)
    eng.install("mem", _carried(ref_solver).as_engine_solver())
    ref_eng.install("mem", ref_solver.as_engine_solver())
    payloads = [_corrupt(xi, i % 3, 3, i) for i in range(7)]
    futs = [eng.submit(engine_lib.Request("mem", p)) for p in payloads]
    ref_futs = [ref_eng.submit(ref_engine.Request("mem", jnp.asarray(p)))
                for p in payloads]
    eng.flush()
    ref_eng.flush()
    for f, rf in zip(futs, ref_futs):
        _assert_same_result(f.result(), rf.result())
    for k in SERVING_COUNTERS:
        assert eng.stats()["serving"][k] == ref_eng.stats()["serving"][k], k
    assert eng.stats()["serving"]["mid_flight_joins"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queues_pop_order_equals_reference(seed):
    """A seeded sequence of pushes (tenants, buckets, lane counts, weights)
    and pops (with and without a lane budget, pop_all, drain_items): the
    same items in the same order, the same depths."""
    rng = np.random.default_rng(seed)
    weights = {"a": 3.0, "b": 1.0, "c": 0.5}
    fq, ref = FairQueues(weights), ref_serving.FairQueues(weights)
    for step in range(300):
        op = rng.random()
        if op < 0.55:
            t, q, lanes = str(rng.choice(["a", "b", "c", "d"])), int(rng.integers(0, 3)), int(
                rng.integers(1, 5))
            fq.push(t, q, step, lanes)
            ref.push(t, q, step, lanes)
        elif op < 0.95:
            q = int(rng.integers(0, 3))
            budget = None if rng.random() < 0.5 else int(rng.integers(1, 5))
            assert fq.pop(q, max_lanes=budget) == ref.pop(q, max_lanes=budget)
        else:
            q = int(rng.integers(0, 3))
            assert fq.pop_all(q) == ref.pop_all(q)
        assert fq.depths() == ref.depths()
        assert fq.qkeys() == ref.qkeys() and fq.queued_lanes() == ref.queued_lanes()
    assert fq.drain_items() == ref.drain_items()
    assert fq.request_count() == ref.request_count() == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_mixed_requests_structure_equals_reference(seed):
    """Tenant, workload, pattern row (each lane is its row's letter with
    exactly round(0.25·N) pixels flipped), lane count and graph size are the
    reference's for the same seed; payload draws are the port's own."""
    got = load.mixed_requests(24, seed=seed)
    want = ref_serving.mixed_requests(24, seed=seed)
    rng = np.random.default_rng(seed)  # the draws both packages make, in order
    libs = {"small": ref_patterns.load_dataset("7x6"), "large": ref_patterns.load_dataset("10x10")}
    for name, xi in libs.items():
        np.testing.assert_array_equal(
            port_patterns.load_dataset({"small": "7x6", "large": "10x10"}[name],
                                       device="cpu").numpy(), np.asarray(xi))
    seeds = set()
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.workload, g.tenant) == (w.workload, w.tenant)
        rng.choice(2, p=[2 / 3, 1 / 3])
        assert isinstance(g.key, torch.Generator) and g.key.device.type == "cpu"
        seeds.add(g.key.initial_seed())
        if g.workload == "cuts":
            n = int(rng.integers(16, 40))
            assert tuple(g.payload.shape) == tuple(w.payload.shape) == (n, n)
            a = g.payload.numpy()
            assert a.dtype == np.int8 and (a == a.T).all() and not np.diag(a).any()
            continue
        xi = np.asarray(libs[g.workload])
        row = int(rng.integers(0, xi.shape[0]))
        lanes = int(rng.integers(1, 5))
        assert tuple(g.payload.shape) == tuple(w.payload.shape)
        assert (g.payload.dim() == 1) == (lanes == 1)
        flips = port_patterns.n_corrupt_pixels(xi.shape[1], 0.25)
        for p in (g.payload.numpy(), np.asarray(w.payload)):
            assert ((np.atleast_2d(p) != xi[row]).sum(axis=1) == flips).all()
    assert len(seeds) == len(got)


def test_poisson_offsets_and_timed_source_equal_reference():
    for n, rate, seed in ((10, 5.0, 0), (200, 37.5, 3), (1, 0.1, 9)):
        assert load.poisson_offsets(n, rate, seed) == ref_serving.poisson_offsets(n, rate, seed)
    with pytest.raises(ValueError, match="rate_rps"):
        load.poisson_offsets(3, 0.0)

    def clock_of(ticks):
        it = iter(ticks)
        return lambda: next(it)

    offsets = [0.0, 0.5, 0.5, 1.2, 3.0]
    ticks = [0.0, 0.1, 0.6, 0.7, 1.3, 2.0, 3.5]
    items = list(range(5))
    got = list(load.timed_source(items, offsets, clock=clock_of(ticks)))
    assert got == list(ref_serving.timed_source(items, offsets, clock=clock_of(ticks)))
    assert got == [[0], [1, 2], None, [3], None, [4]]
    with pytest.raises(ValueError, match="offsets"):
        list(load.timed_source(items, offsets[:2]))


def test_ticked_source_chunks():
    items = list(range(7))
    assert list(load.ticked_source(items, per_tick=3)) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(load.ticked_source(items, per_tick=3)) == list(
        ref_serving.ticked_source(items, per_tick=3))
    with pytest.raises(ValueError, match="per_tick"):
        list(load.ticked_source(items, per_tick=0))


# ---------------------------------------------------------------------------
# Mid-flight join bit-exactness (the continuous-batching contract)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg_kw",
    [
        {"backend": "parallel"},
        {"backend": "kernel"},
        {"backend": "hybrid"},
        {"mode": "rtl", "sync_jitter": True},
    ],
    ids=["parallel", "kernel", "hybrid", "rtl-jitter"],
)
def test_mid_flight_join_bit_exact_with_isolated_solve(cfg_kw):
    """A request installed into a live slab (lanes already ticking) returns
    exactly what it returns solved alone — per-lane clocks make the join
    invisible to the physics, seeded generators make the draws identical."""
    xi = _patterns(0, 3, 24)
    kw = dict(max_cycles=60, settle_chunk=1, device="cpu", **cfg_kw)
    payload_a = np.stack([_corrupt(xi, 0, 5, 1), _corrupt(xi, 1, 5, 2)])
    payload_b = _corrupt(xi, 2, 5, 3)

    def keys():
        return torch.Generator().manual_seed(11), torch.Generator().manual_seed(22)

    ceng = _engine(batch_buckets=(1, 2, 4), slab_lanes=4)
    ceng.install("mem", "retrieval", xi=xi, **kw)
    key_a, key_b = keys()
    fut_a = ceng.submit(engine_lib.Request("mem", payload_a, key=key_a))
    ceng.step()  # slab live: A's lanes have advanced one chunk
    fut_b = ceng.submit(engine_lib.Request("mem", payload_b, key=key_b))
    ceng.flush()
    assert ceng.stats()["serving"]["mid_flight_joins"] >= 1

    solo = _solo(batch_buckets=(1, 2, 4))
    solo.install("mem", "retrieval", xi=xi, **kw)
    key_a, key_b = keys()
    ref_a = solo.submit(engine_lib.Request("mem", payload_a, key=key_a))
    solo.flush()
    ref_b = solo.submit(engine_lib.Request("mem", payload_b, key=key_b))
    solo.flush()

    _assert_same_result(fut_a.result(), ref_a.result())
    _assert_same_result(fut_b.result(), ref_b.result())


def test_slab_cap_chops_queued_lanes_under_load():
    """More queued lanes than the slab holds: the cap bounds in-flight lanes
    and the backlog flows into freed slots over subsequent ticks."""
    xi = _patterns(2, 3, 16)
    eng = _engine(batch_buckets=(1, 2), slab_lanes=2)
    eng.install("mem", "retrieval", xi=xi, max_cycles=40, settle_chunk=1, device="cpu")
    futs = [eng.submit(engine_lib.Request("mem", _corrupt(xi, i % 3, 3, i))) for i in range(5)]
    eng.step()
    stats = eng.stats()
    assert stats["serving"]["lanes_in_flight"] <= 2
    assert stats["queue_depth"]["lanes"] >= 3
    eng.flush()
    assert all(f.result() is not None for f in futs)
    assert eng.stats()["completed"] == 5


def test_maxcut_mixed_true_n_through_continuous_path_is_deterministic():
    """Blocking workloads (max-cut) served by scheduler ticks return exactly
    the one-shot engine's results and the isolated solve with a generator of
    the same seed, however arrivals coalesced into slabs — including mixed
    true-n graphs padded into one N bucket."""
    graphs = [random_graph(torch.Generator().manual_seed(i), n, 0.5)
              for i, n in enumerate((12, 20, 17))]

    def keys():
        return [torch.Generator().manual_seed(100 + i) for i in range(len(graphs))]

    ceng = _engine(batch_buckets=(1, 2, 4))
    ceng.install("cuts", "maxcut", sweeps=6, device="cpu")
    cont = []
    for adj, k in zip(graphs, keys()):
        cont.append(ceng.submit(engine_lib.Request("cuts", adj, key=k)))
        ceng.step()  # serve as they arrive: varying slab packings
    ceng.flush()

    solo = _solo(7, batch_buckets=(1, 2, 4))
    solo.install("cuts", "maxcut", sweeps=6, device="cpu")
    refs = [solo.submit(engine_lib.Request("cuts", adj, key=k)) for adj, k in zip(graphs, keys())]
    solo.flush()
    solver = api.MaxCutSolver(sweeps=6, device="cpu")
    for fut, ref, adj, k in zip(cont, refs, graphs, keys()):
        fields = type(fut.result())._fields
        _assert_same_result(fut.result(), ref.result(), fields)
        _assert_same_result(fut.result(), solver.solve(adj, key=k), fields)


def test_daemon_serves_maxcut_and_rtl_jitter_equal_to_isolated_solves():
    """Through the daemon, requests that draw from their generators (Max-Cut
    and rtl with ``sync_jitter``) equal the isolated solve with a generator
    of the same seed, beside functional retrieval in the same ticks."""
    xi = _patterns(8, 3, 20)
    eng = _engine(batch_buckets=(1, 2, 4), slab_lanes=4)
    rtl = api.RetrievalSolver.from_patterns(xi, device="cpu", max_cycles=8, mode="rtl",
                                            sync_jitter=True, backend="hybrid",
                                            parallel_factor=4, settle_chunk=1)
    eng.install("rtl", rtl.as_engine_solver())
    eng.install("mem", "retrieval", xi=xi, max_cycles=30, settle_chunk=1, device="cpu")
    cuts = api.MaxCutSolver(sweeps=10, replicas=2, stagnation=3, settle_chunk=2, device="cpu")
    eng.install("cuts", cuts.as_engine_solver())
    graphs = [random_graph(torch.Generator().manual_seed(50 + i), n) for i, n in
              enumerate((10, 14, 16))]
    rows = [np.stack([_corrupt(xi, i % 3, 4, 60 + i), _corrupt(xi, (i + 1) % 3, 4, 70 + i)])
            for i in range(4)]
    reqs = []
    for i in range(4):
        reqs.append(engine_lib.Request("rtl", rows[i], key=torch.Generator().manual_seed(80 + i)))
        reqs.append(engine_lib.Request("mem", rows[i][0]))
        if i < 3:
            reqs.append(engine_lib.Request("cuts", graphs[i],
                                           key=torch.Generator().manual_seed(90 + i)))
    futs = []
    orig = eng.submit

    def submit(r):
        futs.append(orig(r))
        return futs[-1]

    eng.submit = submit
    report = ServeDaemon(eng, signals=()).run(load.ticked_source(reqs, per_tick=2))
    assert report["completed"] == len(reqs) and report["failed"] == 0
    mem = eng.solver("mem").solver
    for r, f in zip(reqs, futs):
        seed = None if r.key is None else r.key.initial_seed()
        if r.workload == "cuts":
            want = cuts.solve(r.payload, key=torch.Generator().manual_seed(seed))
            _assert_same_result(f.result(), want, type(want)._fields)
        elif r.workload == "rtl":
            _assert_same_result(f.result(), rtl.solve(r.payload,
                                                      key=torch.Generator().manual_seed(seed)))
        else:
            want = mem.solve(r.payload[None])
            _assert_same_result(f.result(), dynamics.ONNResult(*(x[0] for x in want)))
    assert eng.stats()["serving"]["mid_flight_joins"] > 0


# ---------------------------------------------------------------------------
# Fairness + admission control
# ---------------------------------------------------------------------------


def test_fair_queues_weighted_2_to_1():
    fq = FairQueues({"a": 2.0, "b": 1.0})
    for i in range(4):
        fq.push("a", "q", f"a{i}", 1)
        fq.push("b", "q", f"b{i}", 1)
    order = [fq.pop("q")[0] for _ in range(8)]
    # While both tenants are backlogged, a is served twice per b.
    assert order[:6].count("a") == 4 and order[:6].count("b") == 2
    assert order.count("a") == order.count("b") == 4  # nobody starves
    assert fq.pop("q") is None


def test_fair_queues_pop_respects_lane_budget():
    fq = FairQueues()
    fq.push("t", "q", "wide", 4)
    fq.push("t", "q", "narrow", 1)
    fq.push("u", "q", "other", 1)
    # t's head needs 4 lanes: FIFO within a tenant is preserved, so t yields
    # nothing under a 2-lane budget — but u's head fits.
    assert fq.pop("q", max_lanes=2) == ("u", "other", 1)
    assert fq.pop("q", max_lanes=2) is None
    assert fq.pop("q", max_lanes=4) == ("t", "wide", 4)
    assert fq.pop("q") == ("t", "narrow", 1)


def test_admission_backpressure_rejects_and_counts():
    xi = _patterns(3, 3, 16)
    eng = _engine(batch_buckets=(1, 2), slab_lanes=2, max_queue_lanes=3)
    eng.install("mem", "retrieval", xi=xi, max_cycles=40, settle_chunk=1, device="cpu")
    futs = [eng.submit(engine_lib.Request("mem", _corrupt(xi, i % 3, 3, i), tenant="alpha"))
            for i in range(3)]
    with pytest.raises(engine_lib.QueueFullError):
        eng.submit(engine_lib.Request("mem", _corrupt(xi, 0, 3, 9), tenant="beta"))
    stats = eng.stats()
    assert stats["admission"]["rejected"] == 1
    assert stats["admission"]["max_queue_lanes"] == 3
    assert stats["queue_depth"] == {"requests": 3, "lanes": 3}
    assert stats["tenants"]["alpha"]["submitted"] == 3
    assert stats["tenants"]["beta"]["rejected"] == 1
    eng.flush()
    stats = eng.stats()
    assert stats["tenants"]["alpha"]["completed"] == 3
    assert 0.0 <= stats["lane_occupancy"] <= 1.0
    assert all(f.result() is not None for f in futs)
    assert stats["serving"]["autotune"] == autotune.cache_info()


def test_finish_in_flight_completes_lanes_and_sheds_queue():
    xi = _patterns(4, 3, 16)
    eng = _engine(batch_buckets=(1, 2), slab_lanes=2)
    eng.install("mem", "retrieval", xi=xi, max_cycles=80, settle_chunk=1, device="cpu")
    futs = [eng.submit(engine_lib.Request("mem", _corrupt(xi, i % 3, 3, i))) for i in range(5)]
    eng.step()  # two lanes in flight, three queued
    report = eng.finish_in_flight(reject_queued=True)
    assert report == {"rejected": 3, "completed": 2}
    served = [f for f in futs if f.exception() is None]
    shed = [f for f in futs if isinstance(f.exception(), DrainRejectedError)]
    assert len(served) == 2 and len(shed) == 3
    assert all(f.result() is not None for f in served)
    assert eng.idle


# ---------------------------------------------------------------------------
# Daemon lifecycle: SIGTERM mid-load
# ---------------------------------------------------------------------------


def test_daemon_sigterm_drains_in_flight_and_heartbeat_goes_stale(tmp_path):
    xi = _patterns(5, 3, 16)
    eng = _engine(batch_buckets=(1, 2), slab_lanes=2)
    eng.install("mem", "retrieval", xi=xi, max_cycles=80, settle_chunk=1, device="cpu")
    futs = [eng.submit(engine_lib.Request("mem", _corrupt(xi, i % 3, 3, i))) for i in range(6)]
    hb_path = str(tmp_path / "heartbeat")

    def source():
        yield None  # tick 1: two lanes enter flight
        os.kill(os.getpid(), signal.SIGTERM)
        while True:
            yield None

    daemon = ServeDaemon(eng, heartbeat_path=hb_path, signals=(signal.SIGTERM,))
    report = daemon.run(source())

    assert report["preempted"]
    assert report["drain"]["rejected"] >= 1
    served = [f for f in futs if f.exception() is None]
    shed = [f for f in futs if isinstance(f.exception(), DrainRejectedError)]
    assert len(served) + len(shed) == 6
    assert served and shed  # in-flight completed, queue was shed
    assert all(f.result() is not None for f in served)
    assert report["drain"]["rejected"] == len(shed)
    assert report["drain"]["completed"] <= len(served)
    assert eng.idle

    # Liveness: the file was beaten while running, and goes stale once the
    # daemon is gone — exactly what an external watchdog keys on.
    assert os.path.exists(hb_path)
    time.sleep(0.05)
    assert Heartbeat.is_stale(hb_path, max_age_s=0.04)


def test_daemon_serves_stream_to_completion_and_reports():
    xi = _patterns(6, 3, 16)
    eng = _engine(batch_buckets=(1, 2, 4), slab_lanes=4,
                  tenant_weights={"alpha": 2.0, "beta": 1.0})
    eng.install("mem", "retrieval", xi=xi, max_cycles=40, settle_chunk=2, device="cpu")
    reqs = [engine_lib.Request("mem", _corrupt(xi, i % 3, 3, i), tenant=("alpha", "beta")[i % 2])
            for i in range(8)]

    def source():
        for r in reqs:
            yield r

    report = ServeDaemon(eng, signals=()).run(source())
    assert report["completed"] == 8 and report["failed"] == 0
    assert report["latency"]["count"] == 8
    assert report["latency"]["p50_s"] <= report["latency"]["p99_s"]
    tenants = report["stats"]["tenants"]
    assert tenants["alpha"]["completed"] + tenants["beta"]["completed"] == 8
    assert report["stats"]["serving"]["ticks"] == report["ticks"]


# ---------------------------------------------------------------------------
# Hot weight install (mirrors tests/test_hotswap.py)
# ---------------------------------------------------------------------------


def _trained_solver(xi_new: np.ndarray, cfg: dynamics.ONNConfig) -> api.RetrievalSolver:
    """An api.RetrievalSolver carrying QAT-DO-I weights for ``xi_new``."""
    res = train.train_doi(xi_new, train.TrainConfig(qat_bits=cfg.weight_bits), device="cpu")
    params, _ = train.trained_params(cfg, res.weights)
    return api.RetrievalSolver(config=cfg, params=params)


@pytest.mark.parametrize("backend", ["parallel", "kernel", "hybrid"])
def test_hot_swap_mid_stream_bit_exact_with_cold_restart(backend):
    """Swap while a slab is in flight: pre-swap requests return exactly what
    an engine that never swapped returns (old weights), post-swap requests
    exactly what a cold restart on the new weights returns; the solver keeps
    its config and padded buckets."""
    n = 24
    xi_old, xi_new = _patterns(0, 3, n), _patterns(1, 3, n)
    kw = dict(max_cycles=60, settle_chunk=1, backend=backend, device="cpu")
    pre = [_corrupt(xi_old, i, 5, 10 + i) for i in range(2)]
    post = [_corrupt(xi_new, i, 5, 20 + i) for i in range(2)]

    live = _engine(batch_buckets=(1, 2, 4), slab_lanes=4)
    live.install("mem", "retrieval", xi=xi_old, **kw)
    cfg = live.solver("mem").config
    new_solver = _trained_solver(xi_new, cfg)
    warm = [live.submit(engine_lib.Request("mem", p)) for p in pre + post]
    live.flush()
    for f in warm:
        f.result()

    futs_pre = [live.submit(engine_lib.Request("mem", p)) for p in pre]
    live.step()  # slab live: pre lanes admitted and advanced one chunk
    buckets = live.stats()["solvers"]["mem"]["n_buckets"]
    live.hot_swap("mem", new_solver.params)
    futs_post = [live.submit(engine_lib.Request("mem", p)) for p in post]
    live.flush()
    stats = live.stats()
    assert stats["serving"]["hot_swaps"] == 1
    assert stats["solvers"]["mem"]["hot_swaps"] == 1
    assert stats["solvers"]["mem"]["n_buckets"] == buckets
    assert live.solver("mem").config == cfg

    cold_old = _engine(7, batch_buckets=(1, 2, 4), slab_lanes=4)
    cold_old.install("mem", "retrieval", xi=xi_old, **kw)
    ref_pre = [cold_old.submit(engine_lib.Request("mem", p)) for p in pre]
    cold_old.flush()
    cold_new = _engine(8, batch_buckets=(1, 2, 4), slab_lanes=4)
    cold_new.install("mem", adapters.RetrievalEngineSolver(solver=new_solver))
    ref_post = [cold_new.submit(engine_lib.Request("mem", p)) for p in post]
    cold_new.flush()

    for fut, ref in zip(futs_pre, ref_pre):
        _assert_same_result(fut.result(), ref.result())
    for fut, ref in zip(futs_post, ref_post):
        _assert_same_result(fut.result(), ref.result())


def test_hot_swap_retires_live_slab_at_chunk_boundary():
    """A swap marks the live slab to drain: freed slots stop backfilling and
    a fresh slab (new weights) opens for the queued work."""
    xi = _patterns(2, 3, 16)
    eng = _engine(batch_buckets=(1, 2), slab_lanes=2)
    eng.install("mem", "retrieval", xi=xi, max_cycles=40, settle_chunk=1, device="cpu")
    futs = [eng.submit(engine_lib.Request("mem", _corrupt(xi, i % 3, 3, i))) for i in range(4)]
    eng.step()  # 2 lanes in flight, 2 queued
    retired_before = eng.stats()["serving"]["slabs_retired"]
    opened_before = eng.stats()["serving"]["slabs_opened"]
    eng.hot_swap("mem", _trained_solver(xi, eng.solver("mem").config).params)
    eng.flush()
    assert all(f.result() is not None for f in futs)
    stats = eng.stats()
    assert stats["completed"] == 4
    assert stats["serving"]["slabs_retired"] >= retired_before + 1
    assert stats["serving"]["slabs_opened"] >= opened_before + 1
    assert stats["serving"]["hot_swaps"] == 1


def test_one_shot_engine_hot_swap_matches_fresh_build():
    """On the drain engine a swap takes effect at the next flush and matches
    an engine built cold on the new weights."""
    n = 20
    xi_old, xi_new = _patterns(3, 3, n), _patterns(4, 3, n)
    probe = _corrupt(xi_new, 0, 4, 5)

    eng = _solo(0)
    eng.install("mem", "retrieval", xi=xi_old, max_cycles=50, device="cpu")
    new_solver = _trained_solver(xi_new, eng.solver("mem").config)
    eng.hot_swap("mem", new_solver.params)
    fut = eng.submit(engine_lib.Request("mem", probe))
    eng.flush()

    fresh = _solo(1)
    fresh.install("mem", adapters.RetrievalEngineSolver(solver=new_solver))
    ref = fresh.submit(engine_lib.Request("mem", probe))
    fresh.flush()
    _assert_same_result(fut.result(), ref.result())


def test_hot_swap_validation():
    """Shape/dtype/range mismatches and non-swappable workloads fail loudly."""
    xi = _patterns(5, 3, 16)
    eng = _solo(0)
    eng.install("mem", "retrieval", xi=xi, max_cycles=40, device="cpu")
    eng.install("cuts", "maxcut", sweeps=4, device="cpu")
    cfg = eng.solver("mem").config

    wrong_n = dynamics.ONNConfig(n=8, weight_bits=cfg.weight_bits)
    bad = dynamics.make_params(wrong_n, np.zeros((8, 8), np.int8), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.hot_swap("mem", bad)
    with pytest.raises(TypeError, match="hot weight install"):
        eng.hot_swap("cuts", dynamics.make_params(cfg, np.zeros((16, 16), np.int8),
                                                  device="cpu"))
    with pytest.raises(TypeError, match="hot weight install"):
        train.HotSwap(eng, "cuts")
    over = torch.full((16, 16), 30, dtype=torch.int8)
    with pytest.raises(ValueError, match="signed range"):
        eng.solver("mem").install_params(
            dynamics.OnnParams(weights=over, bias=torch.zeros((16,), dtype=torch.int32)))


def test_hotswap_class_quantizes_and_counts():
    """HotSwap accepts float shadow weights, quantizes to the solver width,
    trains on the workload's device, and rejects mismatched quantized
    payloads; the installed weights serve as a cold build on them does."""
    from repro_torch.core.quantization import quantize_weights

    xi = _patterns(6, 3, 16)
    eng = _solo(0)
    eng.install("retrieval", xi=xi, max_cycles=40, device="cpu")
    hs = train.HotSwap(eng, "retrieval")
    res = hs.train_and_install(xi)
    assert bool(res.converged) and res.weights.device.type == "cpu"
    assert hs.swaps == 1
    params, qw = hs.install(res.weights)
    assert qw is not None and qw.bits == hs.config.weight_bits
    assert torch.equal(params.weights, qw.values)
    assert torch.equal(eng.solver("retrieval").solver.params.weights, qw.values)
    assert hs.swaps == 2
    with pytest.raises(ValueError, match="bit"):
        hs.install(quantize_weights(res.weights, bits=4))


def test_install_mixed_workloads_restores_small_from_checkpoint(tmp_path):
    """The daemon-restart path: ``small`` restored from an ONN checkpoint of
    a trained N=42 matrix serves with exactly those weights; a checkpoint of
    another N is refused."""
    from repro_torch.checkpoint.onn import save_onn

    xi = port_patterns.load_dataset("7x6", device="cpu")
    cfg = dynamics.ONNConfig(n=42, max_cycles=30)
    res = train.train_doi(xi, train.TrainConfig(qat_bits=5), device="cpu")
    params, qw = train.trained_params(cfg, res.weights)
    path = save_onn(str(tmp_path / "small"), cfg, qw, params.bias)
    eng = _engine()
    load.install_mixed_workloads(eng, sweeps=4, small_ckpt=path)
    assert torch.equal(eng.solver("small").solver.params.weights, qw.values)
    assert eng.solver("small").config == cfg
    assert sorted(eng.stats()["installed"]) == ["cuts", "large", "small"]
    with pytest.raises(ValueError, match="N=42"):
        load.restore_retrieval(path, n=100, device="cpu")
