"""The port's energy model (``repro_torch.core.energy``, paper eq. 1) against
``repro.core.energy`` on the same numpy inputs (CPU).

Integer couplings: ``hamiltonian`` and ``energy_trace`` equal the
reference's float32 einsum exactly (``==``) while N²·max|J| + N·max|h| <
2²⁴, with and without a field h and with several μ; ``is_local_minimum``
equals the reference exactly on int8 J and on int32 J up to 2²⁰.  Float
couplings: ``hamiltonian`` within the bound its docstring states of the
reference.  Then the reference's energy properties (Hopfield's theorem for
asynchronous sweeps, fixed points as local minima, the grouped-staggered
sweep at K = N) on the port's ``async_sweep`` and ``staggered_sweep``, at the
reference's sizes, with Hypothesis and bounded ``max_examples`` as the
reference's tests run them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:  # optional dep (see pyproject.toml): skip, not fail
    from hypothesis_fallback import given, settings, st

from repro.core import energy as ref_energy
from repro_torch.core import energy, ising
from repro_torch.core.dynamics import ONNConfig, async_sweep


def _symmetric(rng, n, lo, hi, dtype=np.int8, zero_diag=True):
    a = rng.integers(lo, hi, (n, n))
    w = np.triu(a, 1) + np.triu(a, 1).T
    if not zero_diag:
        w = w + np.diag(rng.integers(lo, hi, n))
    return w.astype(dtype)


def _spins(rng, *shape):
    return rng.choice(np.array([-1, 1], np.int8), size=shape)


def _ref(fn, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
                         **kw))


@pytest.mark.parametrize("n,lead", [(3, ()), (16, (5,)), (42, (2, 3)), (506, (8,))])
@pytest.mark.parametrize("zero_diag", [True, False])
@pytest.mark.parametrize("field,mu", [(False, 1.0), (True, 1.0), (True, 0.5), (True, -0.3)])
def test_hamiltonian_integer_couplings_exact(n, lead, zero_diag, field, mu):
    rng = np.random.default_rng(n + len(lead) + 7 * zero_diag + int(10 * mu))
    w = _symmetric(rng, n, -15, 16, zero_diag=zero_diag)
    sigma = _spins(rng, *lead, n)
    h = rng.integers(-3, 4, n).astype(np.int32) if field else None
    assert n * n * 15 + n * 3 < 2**24
    want = _ref(ref_energy.hamiltonian, w, sigma, None if h is None else jnp.asarray(h), mu)
    got = energy.hamiltonian(torch.as_tensor(w), torch.as_tensor(sigma),
                             None if h is None else torch.as_tensor(h), mu)
    assert got.dtype == torch.float32 and tuple(got.shape) == lead
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,steps,lanes", [(12, 4, 1), (42, 6, 3), (506, 8, 4)])
def test_energy_trace_integer_couplings_exact(n, steps, lanes):
    rng = np.random.default_rng(n)
    w = _symmetric(rng, n, -15, 16)
    trace = _spins(rng, steps, lanes, n)
    want = _ref(ref_energy.energy_trace, w, trace)
    got = energy.energy_trace(torch.as_tensor(w), torch.as_tensor(trace))
    assert tuple(got.shape) == (steps, lanes)
    np.testing.assert_array_equal(got.numpy(), want)


def _float_bound(w, h, mu):
    """2 · γ_K · (Σ|J| + |μ| Σ|h|), K = N² + 2: ``energy.hamiltonian``'s
    stated bound against the reference on float couplings."""
    k = w.shape[-1] ** 2 + 2
    gamma = k * 2.0**-24 / (1.0 - k * 2.0**-24)
    total = np.abs(w.astype(np.float64)).sum()
    if h is not None:
        total += abs(mu) * np.abs(h.astype(np.float64)).sum()
    return 2.0 * gamma * total


def _settled(w, sigma, sweeps):
    """``sigma`` after ``sweeps`` asynchronous sweeps in index order."""
    s = torch.as_tensor(sigma)
    for _ in range(sweeps):
        s = async_sweep(torch.as_tensor(w), s, range(w.shape[0]))
    return s.numpy()


@pytest.mark.parametrize("dtype,bound", [(np.int8, 15), (np.int32, 2**20)])
@pytest.mark.parametrize("n", [5, 24, 100])
def test_is_local_minimum_exact(dtype, bound, n):
    rng = np.random.default_rng(n + bound % 97)
    w = _symmetric(rng, n, -bound, bound + 1, dtype=dtype)
    states = [_spins(rng, n) for _ in range(6)]
    states += [_settled(w, s, n) for s in states[:3]]  # local minima
    seen = set()
    for s in states:
        want = bool(_ref(ref_energy.is_local_minimum, w, s))
        got = energy.is_local_minimum(torch.as_tensor(w), torch.as_tensor(s))
        assert got.dtype == torch.bool and bool(got) == want
        seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("n", [8, 64, 506])
@pytest.mark.parametrize("field", [False, True])
def test_hamiltonian_float_couplings_within_bound(n, field):
    rng = np.random.default_rng(n + field)
    a = rng.standard_normal((n, n)).astype(np.float32)
    w = (a + a.T) / np.float32(3.0)
    sigma = _spins(rng, 16, n)
    h = rng.standard_normal(n).astype(np.float32) if field else None
    mu = 0.7
    want = _ref(ref_energy.hamiltonian, w, sigma, None if h is None else jnp.asarray(h), mu)
    got = energy.hamiltonian(torch.as_tensor(w), torch.as_tensor(sigma),
                             None if h is None else torch.as_tensor(h), mu)
    bound = _float_bound(w, h, mu)
    err = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert err.max() <= bound, (err.max(), bound)
    # The port's float64 sums agree with an exact float64 evaluation to one
    # float32 rounding of each of its two parts.
    exact = -0.5 * (np.einsum("bi,ij,bj->b", sigma.astype(np.float64), w.astype(np.float64),
                              sigma.astype(np.float64)) - np.trace(w.astype(np.float64)))
    if h is not None:
        exact -= mu * sigma.astype(np.float64) @ h.astype(np.float64)
    scale = np.abs(w.astype(np.float64)).sum() + (mu * np.abs(h).sum() if field else 0.0)
    assert np.abs(got.numpy() - exact).max() <= 4 * 2.0**-24 * scale


def test_integer_path_refuses_float_couplings():
    w = np.zeros((4, 4), np.float32)
    with pytest.raises(TypeError, match="integer"):
        energy.is_local_minimum(torch.as_tensor(w), torch.ones(4, dtype=torch.int8))
    with pytest.raises(TypeError, match="integer"):
        energy.is_local_minimum(w, np.ones(4, np.int8))
    with pytest.raises(ValueError, match=r"one \(N,\) state"):
        energy.is_local_minimum(torch.zeros((4, 4), dtype=torch.int8),
                                torch.ones((2, 4), dtype=torch.int8))


# -- the reference's energy properties on the port's dynamics --------------


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.sampled_from([8, 16, 24]))
def test_property_async_updates_never_increase_energy(seed, n):
    """Hopfield's theorem (``tests/test_onn_dynamics.py:95``): asynchronous
    sign updates on symmetric zero-diagonal couplings never raise H."""
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(_symmetric(rng, n, -15, 16))
    sigma = torch.as_tensor(_spins(rng, n))
    order = torch.as_tensor(rng.permutation(n))
    e0 = float(energy.hamiltonian(w, sigma))
    for _ in range(3):
        sigma = async_sweep(w, sigma, order)
        e1 = float(energy.hamiltonian(w, sigma))
        assert e1 <= e0
        e0 = e1


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_property_async_fixed_point_is_local_minimum(seed):
    """``tests/test_onn_dynamics.py:113``: N sweeps at N = 12 reach a fixed
    point, which is a local minimum, as the reference also finds."""
    rng = np.random.default_rng(seed)
    n = 12
    w = _symmetric(rng, n, -15, 16)
    sigma = _settled(w, _spins(rng, n), n)
    assert bool(energy.is_local_minimum(torch.as_tensor(w), torch.as_tensor(sigma)))
    assert bool(_ref(ref_energy.is_local_minimum, w, sigma))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(4, 24))
def test_property_async_sweep_never_increases_energy(seed, n):
    """``tests/test_properties.py:45``: (W + Wᵀ) // 2 with its diagonal
    zeroed, one sweep in a random order."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-15, 16, (n, n))
    w = ((a + a.T) // 2 * (1 - np.eye(n, dtype=np.int64))).astype(np.int8)
    sigma = torch.as_tensor(_spins(rng, n))
    wt = torch.as_tensor(w)
    e0 = energy.hamiltonian(wt, sigma)
    e1 = energy.hamiltonian(wt, async_sweep(wt, sigma, torch.as_tensor(rng.permutation(n))))
    assert float(e1) <= float(e0)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(4, 20))
def test_property_async_limit_of_staggered_sweep_never_increases_energy(seed, n):
    """``tests/test_ising.py:149``: K = N update groups fire one oscillator
    per enable window, the asynchronous sweep, through the port's
    grouped-staggered sweep on Max-Cut couplings; two replicas."""
    gen = torch.Generator().manual_seed(seed)
    adj = ising.random_graph(gen, n, 0.5)
    w = ising.maxcut_couplings(adj).values
    cfg = ONNConfig(n=n)
    sigma = torch.where(torch.rand((2, n), generator=gen) < 0.5, 1, -1).to(torch.int8)
    e = energy.hamiltonian(w, sigma)
    for _ in range(3):
        sigma = ising.staggered_sweep(cfg, w, sigma, torch.rand(n, generator=gen), groups=n)
        e2 = energy.hamiltonian(w, sigma)
        assert torch.all(e2 <= e)
        e = e2
