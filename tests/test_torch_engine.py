"""The port's serving engine (``repro_torch.engine``) against the JAX package.

Tolerance: exact throughout (integer and float32 result fields compared with
``==``; the planner's quotes and the FPGA model's seconds are the same
Python floats in both packages).

* Bucketing and the planner take the same inputs in both packages and must
  return the same values.
* Retrieval through the port's engine equals ``repro``'s engine on the same
  int8 weights and payloads (both solvers built with ``make_params`` from one
  numpy matrix) on the ``parallel``, ``serial``, ``kernel``/``pallas`` and
  hybrid ``scan`` routes, under the ``"pow2"``, ``"exact"`` and an explicit N
  policy, with ``coalesce`` on and off; every request also equals the
  port's isolated ``RetrievalSolver.solve``.
* The randomness contract: rtl with ``sync_jitter`` and Max-Cut, served by
  the engine with a seeded generator per request, equal the port's isolated
  ``solve`` with a generator of the same seed, under every policy, with and
  without coalescing, with mixed true n in one Max-Cut bucket.  (The port
  draws from ``torch.Generator`` s, the reference from JAX keys: these
  configs are held to the port's own solve.)
* ``repro``'s engine tests, mirrored: registry, install errors, failures
  through futures, key decorrelation, ``auto_flush``, ``QueueFullError``,
  ``stats``/``estimate`` (quotes equal to ``repro``'s), the partitioned quote
  past the wall, hot swap, and the streaming-slab protocol.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import engine as ref_engine
from repro.engine import adapters as ref_adapters
from repro.engine import bucketing as ref_bucketing
from repro.engine.planner import Planner as RefPlanner
from repro_torch import api
from repro_torch import engine as engine_lib
from repro_torch.core import dynamics
from repro_torch.core import hardware_model as hw
from repro_torch.engine import adapters, bucketing
from repro_torch.engine.planner import Planner

N = 12
MAX_CYCLES = 12
BUCKETS = (4, 8)
POLICIES = ("pow2", "exact", (24,))
#: Lanes of the retrieval requests of one stream (``None``: a 1-d payload).
LANES = (1, 2, 3, None, 2)
#: Retrieval routes: port config fields, reference config fields.
ROUTES = {
    "parallel": (dict(backend="parallel"), dict(backend="parallel")),
    "serial": (dict(backend="serial", serial_chunk=5), dict(backend="serial", serial_chunk=5)),
    "kernel": (dict(backend="kernel"), dict(backend="pallas")),
    "hybrid-scan": (dict(backend="hybrid", parallel_factor=5),
                    dict(backend="hybrid", parallel_factor=5)),
}


def _policy_id(p):
    return p if isinstance(p, str) else "x".join(map(str, p))


def hebbian_weights(n: int, seed: int, patterns: int = 3) -> np.ndarray:
    """5-bit Hebbian couplings of ``patterns`` seeded random patterns."""
    rng = np.random.default_rng(seed)
    xi = np.where(rng.random((patterns, n)) < 0.5, 1, -1).astype(np.int32)
    w = np.clip(np.round(15 * (xi.T @ xi) / patterns), -15, 15).astype(np.int8)
    np.fill_diagonal(w, 0)
    return w


def payloads(n: int, seed: int, lanes=LANES):
    rng = np.random.default_rng(seed)
    out = []
    for b in lanes:
        x = np.where(rng.random((b or 1, n)) < 0.5, 1, -1).astype(np.int8)
        out.append(x[0] if b is None else x)
    return out


def port_solver(w: np.ndarray, max_cycles: int = MAX_CYCLES, **cfg) -> api.RetrievalSolver:
    c = api.ONNConfig(n=w.shape[0], max_cycles=max_cycles, **cfg)
    return api.RetrievalSolver(c, api.make_params(c, w, device="cpu"))


def cpu_engine(seed: int = 0, **kw) -> engine_lib.Engine:
    kw.setdefault("batch_buckets", BUCKETS)
    return engine_lib.Engine(torch.Generator().manual_seed(seed), device="cpu", **kw)


def same(got, want) -> None:
    """Every field equal: shape, dtype (the port's) and value."""
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, (f, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)


def isolated(solver: api.RetrievalSolver, payload, key=None):
    """The isolated solve of one payload, unbatched for a 1-d payload."""
    x = np.atleast_2d(payload)
    res = solver.solve(x) if key is None else solver.solve(x, key=key)
    return dynamics.ONNResult(*(f[0] for f in res)) if np.ndim(payload) == 1 else res


# ---------------------------------------------------------------------------
# Bucketing and planner: same inputs, same values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["pow2", "exact", (64, 128, 256), (16, 512)],
                         ids=_policy_id)
def test_bucketing_equals_reference(policy):
    assert bucketing.DEFAULT_BATCH_BUCKETS == ref_bucketing.DEFAULT_BATCH_BUCKETS
    assert bucketing.MIN_POW2_N == ref_bucketing.MIN_POW2_N == 16
    for n in (1, 3, 15, 16, 17, 48, 64, 100, 128, 200, 256, 300, 506, 512):
        try:
            want = ref_bucketing.bucket_n(n, policy)
        except ValueError:
            with pytest.raises(ValueError):
                bucketing.bucket_n(n, policy)
            continue
        assert bucketing.bucket_n(n, policy) == want
    for buckets in ((1, 2, 4, 8), bucketing.DEFAULT_BATCH_BUCKETS, (8, 2)):
        for lanes in (0, 1, 3, 8, 9, 21, 128, 300, 1024):
            assert bucketing.chop(lanes, buckets) == ref_bucketing.chop(lanes, buckets)
            slabs = bucketing.chop(lanes, buckets)
            assert bucketing.pad_waste(lanes, slabs) == ref_bucketing.pad_waste(lanes, slabs)
            if lanes:
                assert bucketing.bucket_batch(lanes, buckets) == ref_bucketing.bucket_batch(
                    lanes, buckets)
    with pytest.raises(ValueError):
        bucketing.bucket_n(0)


def test_planner_equals_reference():
    """The same observations give the same quotes, fit and snapshot."""
    ours, ref = Planner((1, 2, 4), ema_alpha=0.5), RefPlanner((1, 2, 4), ema_alpha=0.5)
    cold = ours.estimate("k", units=1000.0)
    assert cold.source == "model" and cold.seconds == ref.estimate("k", units=1000.0).seconds
    for key, seconds, units in (("k", 2.0, 1000.0), ("k", 1.0, 1000.0), ("j", 0.3, 50.0),
                                ("j", 0.25, 50.0), ("k", 0.7, 900.0)):
        ours.observe(key, seconds, units)
        ref.observe(key, seconds, units)
        for probe in ("k", "j", "other"):
            a, b = ours.estimate(probe, units=2000.0), ref.estimate(probe, units=2000.0)
            assert (a.seconds, a.source, a.units) == (b.seconds, b.source, b.units)
    assert ours.snapshot() == ref.snapshot()
    assert ours.plan(5) == ref.plan(5) == (4, 1)
    with pytest.raises(ValueError):
        Planner(ema_alpha=0.0)


# ---------------------------------------------------------------------------
# Retrieval: the port's engine equals repro's engine, and the isolated solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesce", "per-request"])
@pytest.mark.parametrize("policy", POLICIES, ids=_policy_id)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_retrieval_engine_equals_reference_engine(route, policy, coalesce):
    port_kw, ref_kw = ROUTES[route]
    w = hebbian_weights(N, seed=1)
    reqs = payloads(N, seed=2)
    solver = port_solver(w, **port_kw)
    ref_cfg = ref_api.ONNConfig(n=N, max_cycles=MAX_CYCLES, **ref_kw)
    ref_solver = ref_api.RetrievalSolver(ref_cfg, ref_api.make_params(ref_cfg, jnp.asarray(w)))

    eng = cpu_engine(n_policy=policy, coalesce=coalesce)
    ref_eng = ref_engine.Engine(jax.random.PRNGKey(0), batch_buckets=BUCKETS,
                                n_policy=policy, coalesce=coalesce)
    eng.install("mem", solver.as_engine_solver())
    ref_eng.install("mem", ref_solver.as_engine_solver())
    futs = [eng.submit(engine_lib.Request("mem", p)) for p in reqs]
    ref_futs = [ref_eng.submit(ref_engine.Request("mem", jnp.asarray(p))) for p in reqs]
    stats, ref_stats = eng.drain(), ref_eng.drain()

    for p, f, rf in zip(reqs, futs, ref_futs):
        got = f.result()
        same(got, rf.result())
        same(got, isolated(solver, p))
    for k in ("submitted", "completed", "failed", "slabs", "lanes_served", "lanes_padding",
              "pad_fraction", "slabs_per_bucket"):
        assert stats[k] == ref_stats[k], k
    mem, ref_mem = stats["solvers"]["mem"], ref_stats["solvers"]["mem"]
    assert mem["settle_slabs_observed"] == ref_mem["settle_slabs_observed"] == stats["slabs"]
    if stats["slabs"] == 1:  # with more, the reference folds slabs in readiness order
        assert mem["settle_ema_cycles"] == ref_mem["settle_ema_cycles"]
        assert mem["expected_cycles"] == ref_mem["expected_cycles"]
    assert mem["n_buckets"] == [bucketing.bucket_n(N, policy)]


# ---------------------------------------------------------------------------
# The randomness contract: served == isolated solve with the same seed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesce", "per-request"])
@pytest.mark.parametrize("policy", POLICIES, ids=_policy_id)
@pytest.mark.parametrize("arch", ["hybrid", "recurrent"])
def test_rtl_jitter_served_equals_isolated_with_same_seed(arch, policy, coalesce):
    """rtl with ``sync_jitter``: each request's enable offsets are drawn from
    its generator as ``RetrievalSolver.solve`` draws them, so the served
    result equals the isolated solve with a generator of the same seed; the
    hybrid architecture on the hybrid backend's kernel route, the recurrent
    one on the kernel backend (the card phases' routes)."""
    route = (dict(backend="hybrid", hybrid_impl="kernel", parallel_factor=5)
             if arch == "hybrid" else dict(backend="kernel"))
    solver = port_solver(hebbian_weights(N, seed=3), max_cycles=6, mode="rtl",
                         sync_jitter=True, architecture=arch, **route)
    reqs = payloads(N, seed=4)
    eng = cpu_engine(n_policy=policy, coalesce=coalesce)
    eng.install("mem", solver.as_engine_solver())
    futs = [eng.submit(engine_lib.Request("mem", p, key=torch.Generator().manual_seed(100 + i)))
            for i, p in enumerate(reqs)]
    assert eng.drain()["failed"] == 0
    for i, (p, f) in enumerate(zip(reqs, futs)):
        same(f.result(), isolated(solver, p, key=torch.Generator().manual_seed(100 + i)))


def graphs_of(sizes, seed: int):
    """Symmetric 0/1 int8 graphs with a zero diagonal, one per size."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        upper = np.triu(rng.random((n, n)) < 0.5, k=1).astype(np.int8)
        out.append(upper + upper.T)
    return out


MAXCUT_ROUTES = {
    "parallel": dict(backend="parallel"),
    "kernel": dict(backend="kernel"),
    "hybrid-kernel": dict(backend="hybrid", hybrid_impl="kernel", parallel_factor=4),
}


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesce", "per-request"])
@pytest.mark.parametrize("policy", POLICIES, ids=_policy_id)
@pytest.mark.parametrize("route", sorted(MAXCUT_ROUTES))
def test_maxcut_served_equals_isolated_with_same_seed(route, policy, coalesce):
    """Max-Cut draws each request's uniforms at its true n and pads them, so
    instances of n = 10, 13 and 16 served together in one bucket (pow2: 16,
    the explicit policy: 24; exact: one bucket each) equal their isolated
    solves with generators of the same seeds, on every field."""
    solver = api.MaxCutSolver(sweeps=12, replicas=3, stagnation=4, settle_chunk=3,
                              device="cpu", **MAXCUT_ROUTES[route])
    adjs = graphs_of((10, 13, 16, 13), seed=5)
    eng = cpu_engine(n_policy=policy, coalesce=coalesce)
    eng.install("cuts", solver.as_engine_solver())
    futs = [eng.submit(engine_lib.Request("cuts", a, key=torch.Generator().manual_seed(7 + i)))
            for i, a in enumerate(adjs)]
    stats = eng.drain()
    assert stats["completed"] == len(adjs) and stats["failed"] == 0
    if policy != "exact":
        assert len({k.split(":")[1] for k in stats["slabs_per_bucket"]}) == 1
    for i, (a, f) in enumerate(zip(adjs, futs)):
        got = f.result()
        assert got.sigma.shape == (a.shape[0],)
        same(got, solver.solve(a, key=torch.Generator().manual_seed(7 + i)))


def test_engine_key_split_per_request_decorrelates_maxcut():
    """Two identical max-cut submissions with no keys get distinct seeds
    from the root generator (no hidden shared seed)."""
    eng = cpu_engine(seed=11, batch_buckets=(1,))
    eng.install("cuts", "maxcut", sweeps=4, device="cpu")
    adj = graphs_of((16,), seed=12)[0]
    f1 = eng.submit(engine_lib.Request("cuts", adj))
    f2 = eng.submit(engine_lib.Request("cuts", adj))
    eng.drain()
    t1, t2 = f1.result().trace.numpy(), f2.result().trace.numpy()
    s1, s2 = f1.result().sigma.numpy(), f2.result().sigma.numpy()
    assert not (np.array_equal(t1, t2) and np.array_equal(s1, s2))


# ---------------------------------------------------------------------------
# Registry, errors, admission, stats
# ---------------------------------------------------------------------------


def test_registry_catalog_and_duplicates():
    cat = engine_lib.available_solvers()
    assert set(cat) == {"lm", "retrieval", "maxcut"}
    with pytest.raises(ValueError, match="already registered"):
        engine_lib.register_solver("retrieval", lambda **kw: None)
    with pytest.raises(KeyError, match="no solver"):
        engine_lib.solver_factory("nonexistent")
    eng = cpu_engine()
    with pytest.raises(KeyError, match=r"known: lm, maxcut, retrieval"):
        eng.install("nonexistent")
    lm = eng.install("lm", arch="qwen2-1.5b", generator=torch.Generator().manual_seed(0),
                     device="cpu")
    assert isinstance(lm, adapters.LMEngineSolver) and lm.device.type == "cpu"
    assert isinstance(eng.install("cuts", "maxcut", sweeps=4, device="cpu"),
                      adapters.MaxCutEngineSolver)
    solver = port_solver(hebbian_weights(8, seed=0))
    installed = eng.install("mem", "retrieval", solver=solver)
    assert isinstance(installed, adapters.RetrievalEngineSolver) and installed.solver is solver


def test_install_and_submit_errors():
    eng = cpu_engine(batch_buckets=(1, 2))
    with pytest.raises(KeyError, match="no installed solver"):
        eng.submit(engine_lib.Request("nowhere", None))
    s = port_solver(hebbian_weights(8, seed=5))
    eng.install("letters", s.as_engine_solver())
    with pytest.raises(ValueError, match="already installed"):
        eng.install("letters", s.as_engine_solver())
    with pytest.raises(ValueError, match="N=9"):
        eng.submit(engine_lib.Request("letters", np.ones((9,), np.int8)))
    with pytest.raises(ValueError, match="lanes"):
        eng.submit(engine_lib.Request("letters", np.ones((3, 8), np.int8)))
    with pytest.raises(TypeError, match="Generator"):
        eng.submit(engine_lib.Request("letters", np.ones((8,), np.int8), key=7))
    with pytest.raises(TypeError, match="kwargs"):
        eng.install("other", s.as_engine_solver(), sweeps=3)
    trained = eng.install("trained", "retrieval", xi=np.ones((2, 8), np.int8), device="cpu")
    assert isinstance(trained, adapters.RetrievalEngineSolver) and trained.config.n == 8
    with pytest.raises(TypeError, match="either a built solver"):
        adapters.RetrievalEngineSolver(solver=s, xi=np.ones((2, 8), np.int8))
    with pytest.raises(ValueError, match="solver= or xi="):
        adapters.RetrievalEngineSolver()
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        engine_lib.Engine(jax.random.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        adapters.MaxCutEngineSolver(replicas=0)


class _ExplodingSolver:
    def lane_count(self, payload):
        return 1

    def signature(self, payload):
        return 1

    def bucket(self, signature, n_policy):
        return 1

    def solve_bucket(self, bucket_sig, payloads, keys, batch_bucket):
        raise RuntimeError("boom")

    def cost_units(self, bucket_sig, batch_bucket):
        return 1.0

    def fpga_seconds(self, bucket_sig):
        return None


def test_solver_failure_propagates_through_futures():
    eng = cpu_engine(batch_buckets=(1,))
    eng.install("bad", _ExplodingSolver())
    fut = eng.submit(engine_lib.Request("bad", 0, tenant="t1"))
    stats = eng.drain()
    assert stats["failed"] == 1 and stats["completed"] == 0
    assert stats["tenants"]["t1"]["failed"] == 1
    with pytest.raises(RuntimeError, match="boom"):
        fut.result()


def test_auto_flush_serves_full_buckets_on_submit():
    s = port_solver(hebbian_weights(8, seed=6))
    eng = cpu_engine(batch_buckets=(1, 2), auto_flush=True)
    eng.install("letters", s.as_engine_solver())
    p1, p2 = payloads(8, seed=20, lanes=(None, None))
    f1 = eng.submit(engine_lib.Request("letters", p1))
    assert not f1.done()  # one lane < max bucket: still queued
    f2 = eng.submit(engine_lib.Request("letters", p2))
    assert f1.done() and f2.done()  # bucket filled → flushed inside submit
    same(f1.result(), isolated(s, p1))
    same(f2.result(), isolated(s, p2))


def test_queue_full_error_rejects_without_enqueueing():
    s = port_solver(hebbian_weights(8, seed=7))
    eng = cpu_engine(batch_buckets=(1, 2, 4), max_queue_lanes=3)
    eng.install("letters", s.as_engine_solver())
    a, b, c = payloads(8, seed=21, lanes=(2, 2, 1))
    fa = eng.submit(engine_lib.Request("letters", a, tenant="t1"))
    with pytest.raises(engine_lib.QueueFullError, match="max_queue_lanes=3"):
        eng.submit(engine_lib.Request("letters", b, tenant="t2"))
    fc = eng.submit(engine_lib.Request("letters", c, tenant="t2"))
    pending = eng.stats()
    assert pending["queue_depth"] == {"requests": 2, "lanes": 3}
    assert pending["admission"] == {"max_queue_lanes": 3, "rejected": 1}
    stats = eng.drain()
    assert stats["rejected"] == 1 and stats["completed"] == 2
    assert stats["tenants"]["t2"] == {"submitted": 1, "completed": 1, "failed": 0, "rejected": 1}
    same(fa.result(), isolated(s, a))
    same(fc.result(), isolated(s, c))


def test_stats_and_estimates_equal_reference():
    """Quotes before and after a drain: the cold model quote, its FPGA
    context and its per-design trade equal ``repro``'s engine's."""
    w = hebbian_weights(16, seed=8)
    s = port_solver(w, backend="hybrid", parallel_factor=4)
    ref_cfg = ref_api.ONNConfig(n=16, max_cycles=MAX_CYCLES, backend="hybrid", parallel_factor=4)
    ref_s = ref_api.RetrievalSolver(ref_cfg, ref_api.make_params(ref_cfg, jnp.asarray(w)))
    eng = cpu_engine(batch_buckets=(1, 2, 4))
    ref_eng = ref_engine.Engine(jax.random.PRNGKey(14), batch_buckets=(1, 2, 4))
    eng.install("letters", s.as_engine_solver())
    ref_eng.install("letters", ref_s.as_engine_solver())
    eng.install("cuts", "maxcut", sweeps=6, replicas=2, backend="hybrid", parallel_factor=8,
                device="cpu")
    ref_eng.install("cuts", "maxcut", sweeps=6, replicas=2, backend="hybrid", parallel_factor=8)
    probe = payloads(16, seed=22, lanes=(2,))[0]
    adj = graphs_of((20,), seed=9)[0]
    for name, payload in (("letters", probe), ("cuts", adj)):
        est = eng.estimate(name, payload)
        ref_est = ref_eng.estimate(name, jnp.asarray(payload))
        assert est.source == ref_est.source == "model"
        assert (est.seconds, est.units, est.fpga_seconds) == (
            ref_est.seconds, ref_est.units, ref_est.fpga_seconds)
        assert est.fpga_tradeoff == ref_est.fpga_tradeoff
        assert est.fpga_seconds is not None and est.fpga_seconds > 0
    fut = eng.submit(engine_lib.Request("letters", probe))
    pending = eng.stats()["pending"]
    assert sum(v["requests"] for v in pending.values()) == 1
    stats = eng.drain()
    assert fut.done() and stats["completed"] == 1 and not stats["pending"]
    assert stats["installed"] == ["cuts", "letters"]
    assert stats["solvers"]["cuts"]["backend"] == "hybrid"
    assert set(stats["solvers"]["letters"]["autotune"]) == {"multi_plan", "coupling_plan"}
    assert eng.estimate("letters", probe).source == "ema"  # measured by the drained slab
    assert stats["lane_occupancy"] == 1.0 and stats["pad_fraction"] == 0.0


def test_fpga_tradeoff_quotes_partitioned_design_past_the_wall():
    bits = hw.BitConfig()
    at_wall = adapters._fpga_design_tradeoff(506, 100.0, bits, 1)
    assert at_wall["hybrid[P=1]"] is not None
    assert not any(k.startswith("hybrid[K=") for k in at_wall)
    past = adapters._fpga_design_tradeoff(4096, 100.0, bits, 1)
    assert past["hybrid[P=1]"] is None
    k = hw.min_boards(4096, bits)
    assert past[f"hybrid[K={k},P=1]"] == hw.partitioned_time_to_solution(4096, k, 100.0, bits)
    for n, cycles, p in ((506, 100.0, 1), (4096, 100.0, 1), (1024, 37.0, 32), (48, 12.0, 8)):
        assert adapters._fpga_design_tradeoff(n, cycles, bits, p) == (
            ref_adapters._fpga_design_tradeoff(n, cycles, ref_adapters.hw.BitConfig(), p))


def test_fpga_quote_computed_once_per_bucket(monkeypatch):
    """The FPGA quote of ``submit``/``estimate`` is the hardware model's,
    computed on a bucket's first request and reused: a retrieval instance
    quotes its unpadded config once (a hot swap keeps it), Max-Cut once per
    N bucket; every call hands out its own copy of the per-design trade."""
    calls = []
    tts = adapters.hw.time_to_solution

    def counted(*args, **kwargs):
        calls.append(args[:2])
        return tts(*args, **kwargs)

    monkeypatch.setattr(adapters.hw, "time_to_solution", counted)
    w = hebbian_weights(N, seed=30)
    s = port_solver(w, backend="hybrid", parallel_factor=4).as_engine_solver()
    cfg = s.config
    want = tts(cfg.architecture, cfg.n, cfg.max_cycles, hw.BitConfig(cfg.weight_bits,
               cfg.phase_bits), parallel=cfg.hybrid_parallel)
    quotes = [(s.fpga_seconds(nb), s.fpga_tradeoff(nb)) for nb in (N, 16, 16, N)]
    assert all(q == (want, quotes[0][1]) for q in quotes)
    assert len(calls) == 1 + len(quotes[0][1])  # the quote, then each design's once
    quotes[0][1]["recurrent"] = -1.0  # a caller's copy: the next quote is untouched
    assert s.fpga_tradeoff(16) == quotes[1][1] != quotes[0][1]
    n_calls = len(calls)
    s.install_params(dynamics.OnnParams(weights=torch.as_tensor(w),
                                        bias=torch.zeros(N, dtype=torch.int32)))
    assert s.fpga_seconds(N) == want and len(calls) == n_calls
    mc = adapters.MaxCutEngineSolver(sweeps=6, replicas=2, device="cpu")
    by_bucket = {nb: (mc.fpga_seconds(nb), mc.fpga_tradeoff(nb)) for nb in (16, 32)}
    n_calls = len(calls)
    for nb in (16, 32, 16):
        assert (mc.fpga_seconds(nb), mc.fpga_tradeoff(nb)) == by_bucket[nb]
    assert len(calls) == n_calls
    assert by_bucket[16][0] == tts("hybrid", 16, 12.0, hw.BitConfig(weight_bits=5))
    assert by_bucket[16] != by_bucket[32]


# ---------------------------------------------------------------------------
# Hot swap and the streaming-slab protocol
# ---------------------------------------------------------------------------


def test_hot_swap_next_drain_equals_direct_solve_on_new_weights():
    old, new = hebbian_weights(N, seed=30), hebbian_weights(N, seed=31)
    solver = port_solver(old)
    eng = cpu_engine()
    eng.install("mem", solver.as_engine_solver())
    probe = payloads(N, seed=32, lanes=(3,))[0]
    before = eng.submit(engine_lib.Request("mem", probe))
    eng.drain()
    same(before.result(), isolated(solver, probe))
    fresh = port_solver(new)
    eng.hot_swap("mem", fresh.params)
    after = eng.submit(engine_lib.Request("mem", probe))
    stats = eng.drain()
    same(after.result(), isolated(fresh, probe))
    assert stats["solvers"]["mem"]["hot_swaps"] == 1

    bad = dynamics.make_params(api.ONNConfig(n=8), np.zeros((8, 8), np.int8), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.hot_swap("mem", bad)
    with pytest.raises(TypeError, match="int8"):
        eng.hot_swap("mem", dynamics.OnnParams(torch.zeros((N, N), dtype=torch.int32),
                                               torch.zeros(N, dtype=torch.int32)))
    with pytest.raises(ValueError, match="signed range"):
        eng.hot_swap("mem", dynamics.OnnParams(torch.full((N, N), 30, dtype=torch.int8),
                                               torch.zeros(N, dtype=torch.int32)))
    eng.install("cuts", "maxcut", sweeps=4, device="cpu")
    with pytest.raises(TypeError, match="hot weight install"):
        eng.hot_swap("cuts", fresh.params)


@pytest.mark.parametrize("mode", ["functional", "rtl"])
def test_streaming_slab_lanes_equal_isolated_solve(mode):
    """``begin_slab`` / ``admit`` / ``advance`` / ``done_mask`` / ``results``
    / ``extract``: requests installed into a live 4-lane slab at different
    ticks equal their isolated solves (rtl: with the same seeds)."""
    kw = dict(mode="rtl", sync_jitter=True, backend="hybrid", parallel_factor=5) \
        if mode == "rtl" else dict(backend="kernel")
    solver = port_solver(hebbian_weights(N, seed=40), **kw)
    ad = solver.as_engine_solver()
    slab = ad.begin_slab(16, 4)
    reqs = payloads(N, seed=41, lanes=(2, None, 1, 2))
    keys = [torch.Generator().manual_seed(50 + i) if mode == "rtl" else None
            for i in range(len(reqs))]
    queue, live, done_reqs = list(range(len(reqs))), {}, 0
    for _ in range(200):
        free = [s for s in np.flatnonzero(ad.done_mask(slab))
                if s not in {x for slots in live.values() for x in slots}]
        while queue and len(free) >= np.atleast_2d(reqs[queue[0]]).shape[0]:
            i = queue.pop(0)
            k = np.atleast_2d(reqs[i]).shape[0]
            live[i], free = [int(s) for s in free[:k]], free[k:]
            ad.admit(slab, live[i], reqs[i], keys[i])
        ad.advance(slab)
        mask, res = ad.done_mask(slab), ad.results(slab)
        for i, slots in list(live.items()):
            if all(mask[s] for s in slots):
                key = None if keys[i] is None else torch.Generator().manual_seed(50 + i)
                same(ad.extract(res, slots, reqs[i]), isolated(solver, reqs[i], key))
                ad.observe(res, slots)
                del live[i]
                done_reqs += 1
        if done_reqs == len(reqs):
            break
    assert done_reqs == len(reqs)
    assert ad.stats()["settle_slabs_observed"] == len(reqs)
