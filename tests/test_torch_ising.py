"""The port's Max-Cut / Ising slice against the JAX package on the CPU.

``repro_torch.core.ising`` (the batched annealer, its grouped sweep, the
sequential oracle), ``dynamics.async_sweep``, the batched ``weighted_sum``
and ``api.MaxCutSolver`` are fed the same graphs and the same random draws
as ``repro``: the reference draws from JAX keys, and :func:`reference_draws`
rebuilds those uniforms with the reference's own functions and hands them to
the port, which draws nothing itself.  On 0/1 graphs every ``MaxCutResult``
field must be equal, value and dtype (tolerance 0): spins, cut values and
traces are integers or float32 sums of integers below 2**24.  On graphs with
non-integer weights the spins and sweep counts must be equal and the cut
fields agree within the float32 bound of :func:`cut_bound` (the two packages
sum in different orders).

These tests hold the port to the reference's output under the same draws,
not to optimality (ROADMAP, faults of the reference, item 2).  The reference
solves on its ``parallel`` backend, which its own tests hold bit-exact with
every other route; the port solves on every route of its ``ONNConfig``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import dynamics as ref_dyn
from repro.core import ising as ref_ising
from repro.core.quantization import quantize_weights as ref_quantize
from repro_torch import api, convert
from repro_torch.core import dynamics as port_dyn
from repro_torch.core import ising
from repro_torch.engine.adapters import MaxCutEngineSolver

#: Every weighted-sum route of the port's ONNConfig: the name and its fields
#: (a hybrid P of 0 stands for P = N).
ROUTES = {
    "parallel": dict(backend="parallel"),
    "serial": dict(backend="serial"),
    "kernel": dict(backend="kernel"),
    **{
        f"hybrid-{impl}-P{p or 'N'}": dict(backend="hybrid", hybrid_impl=impl, parallel_factor=p)
        for impl in ("scan", "kernel")
        for p in (1, 5, 0)
    },
}


def route_config(route: str, n: int, **kw) -> port_dyn.ONNConfig:
    fields = dict(ROUTES[route])
    if fields.get("parallel_factor") == 0:
        fields["parallel_factor"] = n
    return port_dyn.ONNConfig(n=n, **fields, **kw)


def reference_draws(key, instances: int, replicas: int, n: int, sweeps: int):
    """The uniforms ``repro.core.ising.solve_maxcut_batch`` draws from ``key``:
    (I, R, n) initial and (I, sweeps, n) per-sweep, as numpy float32.

    One raw key serves one instance directly and is split per instance for
    several (the reference's rule); each instance's key splits into an init
    and an anneal key, and sweep t folds t into the anneal key.
    """
    keys = key[None] if instances == 1 else jax.random.split(key, instances)
    init, per_sweep = [], []
    for k in keys:
        k_init, k_anneal = jax.random.split(k)
        init.append(np.asarray(ref_ising._replica_index_uniform(k_init, replicas, n)))
        per_sweep.append(np.stack([
            np.asarray(ref_ising._index_uniform(jax.random.fold_in(k_anneal, t), n))
            for t in range(sweeps)
        ]))
    return np.stack(init), np.stack(per_sweep)


def graphs(seed: int, instances: int, n: int, p: float = 0.5) -> np.ndarray:
    """(I, n, n) Erdős–Rényi 0/1 adjacencies from the reference's generator."""
    key = jax.random.PRNGKey(seed)
    return np.stack([
        np.asarray(ref_ising.random_graph(jax.random.fold_in(key, i), n, p))
        for i in range(instances)
    ])


@functools.lru_cache(maxsize=None)
def reference_solve(n, instances, replicas, sweeps, groups=0, stagnation=0, settle_chunk=8,
                    seed=0, pad_to=None):
    """The reference's solve of ``graphs(seed, ...)`` on its parallel backend,
    with the draws it made; padded to ``pad_to`` vertices (true_n = n) if set."""
    adj = graphs(seed, instances, n)
    nn = n if pad_to is None else pad_to
    if pad_to is not None:
        adj = np.pad(adj, ((0, 0), (0, nn - n), (0, nn - n)))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1_000)
    cfg = ref_dyn.ONNConfig(n=nn, max_cycles=sweeps, settle_chunk=settle_chunk)
    res = ref_ising.solve_maxcut_batch(
        cfg, jnp.asarray(adj), key, replicas=replicas, stagger_groups=groups,
        stagnation=stagnation, true_n=None if pad_to is None else jnp.full((instances,), n),
    )
    init, per_sweep = reference_draws(key, instances, replicas, nn, sweeps)
    return adj, init, per_sweep, {f: np.asarray(getattr(res, f)) for f in res._fields}


def assert_fields_equal(got: ising.MaxCutResult, want: dict, what: str = "") -> None:
    for f in ising.MaxCutResult._fields:
        g, w = getattr(got, f), want[f]
        if w is None or (isinstance(w, np.ndarray) and w.dtype == object):
            assert g is None, (what, f)
            continue
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


def port_solve(route, adj, init, per_sweep, *, groups=0, stagnation=0, settle_chunk=8,
               true_n=None):
    n = adj.shape[-1]
    cfg = route_config(route, n, max_cycles=per_sweep.shape[-2], settle_chunk=settle_chunk)
    return ising.solve_maxcut_batch(
        cfg, torch.as_tensor(adj), torch.as_tensor(init), torch.as_tensor(per_sweep),
        stagger_groups=groups, stagnation=stagnation, true_n=true_n,
    )


# ---------------------------------------------------------------------------
# The annealer on every route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("n", [12, 33])
def test_maxcut_every_route_matches_reference(n, replicas, route):
    adj, init, per_sweep, want = reference_solve(n, 2, replicas, 10)
    assert_fields_equal(port_solve(route, adj, init, per_sweep), want, route)


@pytest.mark.parametrize("groups", [1, 4, 0, "n"])
@pytest.mark.parametrize("n", [12, 33])
def test_stagger_groups_match_reference(n, groups):
    k = n if groups == "n" else groups
    adj, init, per_sweep, want = reference_solve(n, 2, 2, 6, groups=k)
    for route in ("parallel", "kernel", "hybrid-kernel-P5"):
        assert_fields_equal(port_solve(route, adj, init, per_sweep, groups=k), want, route)


@pytest.mark.parametrize("stagnation", [0, 3])
def test_stagnation_with_instances_freezing_in_different_chunks(stagnation):
    """Six instances, settle_chunk 2: with stagnation on they freeze after
    different numbers of chunks, and the frozen ones keep their state while
    the others step (sweeps_run, trace tail and since-improve bookkeeping)."""
    adj, init, per_sweep, want = reference_solve(16, 6, 2, 30, stagnation=stagnation,
                                                 settle_chunk=2, seed=4)
    ran = want["sweeps_run"]
    if stagnation:  # the last chunk each instance ran differs across instances
        assert len(set(np.ceil(ran / 2).tolist())) > 1 and ran.max() < 30, ran
    else:
        assert np.all(ran == 30)
    for route in ("parallel", "kernel", "hybrid-kernel-P5", "hybrid-scan-P1"):
        got = port_solve(route, adj, init, per_sweep, stagnation=stagnation, settle_chunk=2)
        assert_fields_equal(got, want, route)


@pytest.mark.parametrize("pad_to", [32, 64])
def test_padded_solve_equals_unpadded_on_real_vertices(pad_to):
    adj, init, per_sweep, want = reference_solve(20, 2, 3, 16)
    padj, pinit, psweep, pwant = reference_solve(20, 2, 3, 16, pad_to=pad_to)
    # The reference's draws are counter-based per vertex: padding keeps them.
    np.testing.assert_array_equal(pinit[..., :20], init)
    np.testing.assert_array_equal(psweep[..., :20], per_sweep)
    for route in ("parallel", "kernel", "hybrid-kernel-P5"):
        got = port_solve(route, padj, pinit, psweep, true_n=torch.full((2,), 20))
        assert_fields_equal(got, pwant, f"{route} padded")
        np.testing.assert_array_equal(got.sigma[:, :20].numpy(), want["sigma"])
        for f in ("cut_value", "trace", "replica_cuts", "sweeps_run"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f)


def test_single_instance_and_one_key_rule():
    """An (N, N) instance gives an unbatched result; the reference uses one
    raw key directly for one instance."""
    adj = graphs(9, 1, 12)[0]
    key = jax.random.PRNGKey(21)
    cfg = ref_dyn.ONNConfig(n=12, max_cycles=5)
    want = ref_ising.solve_maxcut_batch(cfg, jnp.asarray(adj), key, replicas=2)
    init, per_sweep = reference_draws(key, 1, 2, 12, 5)
    got = port_solve("kernel", adj, init[0], per_sweep[0])
    assert_fields_equal(got, {f: np.asarray(getattr(want, f)) for f in want._fields})
    assert got.sigma.shape == (12,) and got.cut_value.shape == ()


def test_staggered_sweep_matches_reference():
    n = 20
    adj = graphs(3, 1, n)[0]
    w = ref_ising.maxcut_couplings(jnp.asarray(adj)).values
    sig = np.where(np.random.default_rng(1).random((3, n)) < 0.5, 1, -1).astype(np.int8)
    key = jax.random.PRNGKey(5)
    frozen = np.array([False, True, False])
    want = ref_ising.staggered_sweep(ref_dyn.ONNConfig(n=n), w, jnp.asarray(sig), key, groups=4,
                                     frozen=jnp.asarray(frozen))
    u = np.asarray(ref_ising._index_uniform(key, n))
    for route in ("parallel", "kernel"):
        got = ising.staggered_sweep(route_config(route, n), torch.as_tensor(np.array(w)),
                                    torch.as_tensor(sig), torch.as_tensor(u), groups=4,
                                    frozen=torch.as_tensor(frozen))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), sig[1])  # a frozen replica stays


def weighted_graphs(seed: int, instances: int, n: int) -> np.ndarray:
    """(I, n, n) symmetric float32 adjacencies, zero diagonal: each pair an
    edge with probability 0.5 and weight U[0, 1), from numpy's generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(instances):
        a = rng.random((n, n), dtype=np.float32) * (rng.random((n, n)) < 0.5)
        a = np.triu(a, 1)
        out.append(a + a.T)
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def reference_weighted_solve(seed, n, instances, replicas=4, sweeps=16, settle_chunk=2,
                             stagnation=2):
    adj = weighted_graphs(seed, instances, n)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1_000)
    cfg = ref_dyn.ONNConfig(n=n, max_cycles=sweeps, settle_chunk=settle_chunk)
    res = ref_ising.solve_maxcut_batch(cfg, jnp.asarray(adj), key, replicas=replicas,
                                       stagnation=stagnation)
    init, per_sweep = reference_draws(key, instances, replicas, n, sweeps)
    return adj, init, per_sweep, {f: np.asarray(getattr(res, f)) for f in res._fields}


def cut_bound(adj: np.ndarray) -> np.ndarray:
    """(I,) bound on |port − reference| for any float32 cut of each instance.

    A cut is 0.5 · fl(T − P), T = Σ_{i<j} A_ij and P = σ A_triu σ.  Each of
    T and P adds the E nonzero entries of A_triu (σ = ±1 and the zeros add
    no rounding), so in any order each is within γ_E · S of its exact value,
    S = Σ_{i<j} |A_ij|, γ_E = E·u / (1 − E·u), u = 2⁻²⁴ (a sum tree over E
    terms is at most E − 1 deep); the subtraction adds u·|T − P| ≤ 2u·S
    and the halving is exact.  So one side is within (γ_E + u) · S of the
    exact cut, and the two sides differ by at most 2 · (γ_E + u) · S.
    """
    tri = np.triu(np.abs(adj.astype(np.float64)), 1)
    s, e = tri.sum((-2, -1)), (tri != 0).sum((-2, -1))
    u = 2.0**-24
    return 2.0 * (e * u / (1.0 - e * u) + u) * s


def assert_weighted_within_bound(got: ising.MaxCutResult, want: dict, adj, what: str) -> None:
    for f in ("sigma", "sweeps_run"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f"{what} {f}")
    bound = cut_bound(adj)
    for f in ("cut_value", "trace", "replica_cuts"):
        g, w = getattr(got, f).numpy(), want[f]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, (what, f)
        err = np.abs(g.astype(np.float64) - w).reshape(len(bound), -1).max(-1)
        assert np.all(err <= bound), (what, f, err, bound)


@pytest.mark.parametrize("route", list(ROUTES))
def test_weighted_graphs_match_reference_within_bound(route):
    """Non-integer edge weights (U[0, 1) at density 0.5), seeds 0-19, n = 24,
    2 instances, 4 replicas, 16 sweeps, settle_chunk 2, stagnation 2, under
    the reference's own draws.  ``sigma`` and ``sweeps_run`` must be equal;
    ``cut_value``, ``trace`` and ``replica_cuts`` are float32 sums taken in
    torch's order here and in XLA's einsum order there, and must agree
    within :func:`cut_bound`: 2 · (γ_E + 2⁻²⁴) · Σ_{i<j} |A_ij|, with E the
    instance's edge count and γ_E = E·2⁻²⁴ / (1 − E·2⁻²⁴)."""
    for seed in range(20):
        adj, init, per_sweep, want = reference_weighted_solve(seed, 24, 2)
        got = port_solve(route, adj, init, per_sweep, stagnation=2, settle_chunk=2)
        assert_weighted_within_bound(got, want, adj, f"{route} seed {seed}")


def test_weighted_graphs_at_n40_match_reference_within_bound():
    """The same check at n = 40 with 3 instances (seeds 0-4), every route."""
    for seed in range(5):
        adj, init, per_sweep, want = reference_weighted_solve(seed, 40, 3)
        for route in ROUTES:
            got = port_solve(route, adj, init, per_sweep, stagnation=2, settle_chunk=2)
            assert_weighted_within_bound(got, want, adj, f"{route} seed {seed}")


# ---------------------------------------------------------------------------
# The batched weighted sum, async_sweep, the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_weighted_sum_equals_per_instance_loop(route):
    inst, b, m, n = 3, 4, 7, 33
    rng = np.random.default_rng(11)
    w = torch.as_tensor(rng.integers(-15, 16, (inst, m, n)).astype(np.int8))
    sig = torch.as_tensor(rng.choice([-1, 1], (inst, b, n)).astype(np.int8))
    cfg = route_config(route, n)
    got = port_dyn.weighted_sum(cfg, w, sig)
    assert got.shape == (inst, b, m) and got.dtype == torch.int32
    for i in range(inst):
        assert torch.equal(got[i], port_dyn.weighted_sum(cfg, w[i], sig[i]))
        want = ref_dyn.weighted_sum(ref_dyn.ONNConfig(n=n), jnp.asarray(w[i].numpy()),
                                    jnp.asarray(sig[i].numpy()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_async_sweep_int_and_float_weights_match_reference():
    """The reference's own float-accumulator case (Hebbian-like float
    couplings, sub-unit fields) and a random integer case."""
    rng = np.random.default_rng(0)
    w_float = rng.normal(size=(12, 12)).astype(np.float32) * 0.1
    w_float = (w_float + w_float.T) / 2
    np.fill_diagonal(w_float, 0.0)
    q = ref_quantize(jnp.asarray(w_float), bits=5)
    sigma = rng.choice([-1, 1], 12).astype(np.int8)
    order = rng.permutation(12)
    w_small = q.dequantize() * (0.9 / float(jnp.max(jnp.abs(q.dequantize()))))
    for w in (q.values, q.dequantize(), w_small):
        want = ref_dyn.async_sweep(w, jnp.asarray(sigma), jnp.asarray(order))
        got = port_dyn.async_sweep(torch.as_tensor(np.asarray(w)), torch.as_tensor(sigma),
                                   torch.as_tensor(order))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = 33
    w = rng.integers(-15, 16, (n, n)).astype(np.int8)
    w[:, :10] = 0  # ties keep the spin
    sigma = rng.choice([-1, 1], n).astype(np.int8)
    order = np.concatenate([rng.permutation(n), rng.integers(0, n, 5)])  # revisits too
    want = ref_dyn.async_sweep(jnp.asarray(w), jnp.asarray(sigma), jnp.asarray(order))
    got = port_dyn.async_sweep(torch.as_tensor(w), torch.as_tensor(sigma), order.tolist())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sequential_oracle_matches_reference():
    n, sweeps = 14, 6
    adj = graphs(2, 1, n)[0]
    key = jax.random.PRNGKey(8)
    want = ref_ising.solve_maxcut(jnp.asarray(adj), key, sweeps=sweeps)
    # The reference's draws: initial spins from k0, one permutation per sweep.
    k0, k1 = jax.random.split(key)
    sigma0 = np.asarray(jax.random.choice(k0, jnp.array([-1, 1], jnp.int8), shape=(n,)))
    orders = np.stack([np.asarray(jax.random.permutation(k, n))
                       for k in jax.random.split(k1, sweeps)])
    got = ising.solve_maxcut(torch.as_tensor(adj), torch.as_tensor(sigma0), torch.as_tensor(orders))
    assert got.replica_cuts is None and got.sweeps_run is None
    for f in ("sigma", "cut_value", "trace"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_cut_values_couplings_and_group_count_match_reference():
    adj = graphs(3, 1, 7, 0.6)[0]
    sigs = np.array(np.meshgrid(*[[-1, 1]] * 7)).reshape(7, -1).T.astype(np.int8)
    np.testing.assert_array_equal(
        ising.cut_value_exact(torch.as_tensor(adj), torch.as_tensor(sigs)).numpy(),
        np.asarray(ref_ising.cut_value_exact(jnp.asarray(adj), jnp.asarray(sigs))))
    weighted = np.triu(np.random.default_rng(0).integers(0, 4, (9, 9)), 1)
    weighted = (weighted + weighted.T).astype(np.float32)
    for a in (adj, weighted):
        got, want = ising.maxcut_couplings(torch.as_tensor(a)), ref_ising.maxcut_couplings(jnp.asarray(a))
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    for k, n in ((0, 5), (0, 40), (3, 40), (50, 40), (1, 1)):
        assert ising.resolve_stagger_groups(k, n) == ref_ising.resolve_stagger_groups(k, n)
    with pytest.raises(ValueError):
        ising.resolve_stagger_groups(-1, 4)
    assert ising.DEFAULT_STAGGER_GROUPS == ref_ising.DEFAULT_STAGGER_GROUPS


def test_random_graph_is_a_simple_graph_and_seeded():
    g = ising.random_graph(torch.Generator().manual_seed(3), 40, 0.5)
    assert g.dtype == torch.int8 and torch.equal(g, g.T) and not g.diagonal().any()
    assert set(g.unique().tolist()) <= {0, 1} and 0.3 < float(g.float().mean()) < 0.7
    assert torch.equal(g, ising.random_graph(torch.Generator().manual_seed(3), 40, 0.5))


# ---------------------------------------------------------------------------
# The solver surface, and the slice at the paper's full width
# ---------------------------------------------------------------------------


def test_maxcut_solver_surface_and_converter():
    ref_solver = ref_api.MaxCutSolver(sweeps=9, replicas=3, stagger_groups=4, stagnation=2,
                                      backend="hybrid", parallel_factor=5, hybrid_impl="pallas",
                                      settle_chunk=3)
    solver = convert.maxcut_solver_from_reference(ref_solver, device="cpu")
    assert (solver.backend, solver.hybrid_impl, solver.device) == ("hybrid", "kernel", "cpu")
    for f in ("sweeps", "replicas", "stagger_groups", "stagnation", "parallel_factor", "settle_chunk"):
        assert getattr(solver, f) == getattr(ref_solver, f), f
    assert solver.config(20) == convert.config_from_reference(ref_solver.config(20))
    defaults = api.MaxCutSolver()
    for f in ("sweeps", "weight_bits", "replicas", "stagger_groups", "stagnation", "backend",
              "parallel_factor", "hybrid_impl", "settle_chunk"):
        assert getattr(defaults, f) == getattr(ref_api.MaxCutSolver(), f), f
    assert api.MaxCutSolver(backend="kernel").config(8).backend == "kernel"
    adj = torch.as_tensor(graphs(1, 2, 10))
    with pytest.raises(ValueError, match="Generator"):
        solver.solve(adj)
    adapter = solver.as_engine_solver()  # the engine's adapter, with the solver's settings
    assert isinstance(adapter, MaxCutEngineSolver)
    for f in ("sweeps", "weight_bits", "replicas", "stagger_groups", "stagnation", "backend",
              "parallel_factor", "hybrid_impl", "settle_chunk", "device"):
        assert getattr(adapter, f) == getattr(solver, f), f
    one = solver.solve(adj[0], key=torch.Generator().manual_seed(0))
    both = solver.solve(adj, key=torch.Generator().manual_seed(0))
    assert one.sigma.shape == (10,) and both.sigma.shape == (2, 10)
    assert torch.equal(one.sigma, solver.solve(adj[0], key=torch.Generator().manual_seed(0)).sigma)


def test_maxcut_solver_at_n506_matches_reference():
    """The slice at the paper's N = 506 with few sweeps: the reference's solve
    under its draws equals the port's on the kernel and hybrid kernel routes,
    and MaxCutSolver equals solve_maxcut_batch under the generator's draws."""
    n, inst, replicas, sweeps = 506, 2, 4, 3
    adj, init, per_sweep, want = reference_solve(n, inst, replicas, sweeps, stagnation=1,
                                                 settle_chunk=2)
    for route in ("kernel", "hybrid-kernel-P5"):
        got = port_solve(route, adj, init, per_sweep, stagnation=1, settle_chunk=2)
        assert_fields_equal(got, want, route)
    solver = api.MaxCutSolver(sweeps=sweeps, replicas=replicas, stagnation=1, settle_chunk=2,
                              backend="hybrid", hybrid_impl="kernel", device="cpu")
    got = solver.solve(adj, key=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    u0 = torch.rand((inst, replicas, n), generator=gen)
    us = torch.rand((inst, sweeps, n), generator=gen)
    again = port_solve("kernel", adj, u0.numpy(), us.numpy(), stagnation=1, settle_chunk=2)
    for f in ising.MaxCutResult._fields:
        assert torch.equal(getattr(got, f), getattr(again, f)), f
    assert bool(torch.all(got.cut_value == torch.stack(
        [ising.cut_value_exact(torch.as_tensor(a), s) for a, s in zip(adj, got.sigma)])))
