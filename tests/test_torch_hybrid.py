"""The hybrid serialized-MAC backend of the port against ``repro`` on the same
numpy inputs (CPU; the JAX ``pallas`` route runs in interpret mode, the port's
``kernel`` route through the kernels' plain versions).

* ``kernels.ops.hybrid_coupling_sum`` / ``hybrid_phase_step`` (kernels 6, 7)
  against ``repro.kernels.ops`` (Pallas) and ``repro.kernels.ref``;
* ``core.dynamics.hybrid_mac_sum`` against the reference's scan;
* ``retrieve`` / ``run_batch`` / ``run`` with ``backend="hybrid"`` on both
  routes against the reference's ``scan`` and ``pallas`` routes.

Every output is an integer or a bool and must be exactly equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynamics as ref_dyn
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_plain
from repro_torch.core import dynamics as port_dyn
from repro_torch.kernels import ops

HALF = 8
FIELDS = ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled")
REF_IMPL = {"scan": "scan", "kernel": "pallas"}
#: (N, P) pairs of the reference's own hybrid matrix: ragged tails (P ∤ N),
#: P = 1 (the paper's single MAC) and P = N (one pass).
NP_CASES = [(12, 1), (12, 5), (12, 12), (20, 7), (9, 2), (33, 32)]


def same(port, ref) -> None:
    p = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


def same_result(port, ref) -> None:
    for name in FIELDS:
        p = getattr(port, name).cpu().numpy()
        r = np.asarray(getattr(ref, name))
        assert p.shape == r.shape, (name, p.shape, r.shape)
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64), err_msg=name)


def _inputs(n, b, seed, m=None):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    w = rng.integers(-15, 16, size=(m, n)).astype(np.int8)
    w[:, : n // 3] = 0  # many exact ties: S + h == 0 keeps θ
    bias = rng.integers(-2, 3, size=m).astype(np.int32)
    phase = rng.integers(0, 16, size=(b, m)).astype(np.int32)
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    return w, bias, phase, sigma


def problem(n, b, seed, kind):
    """(weights, bias, spins) of one of three kinds: ``random`` asymmetric
    couplings (lanes wander), ``hebbian`` 5-bit weights of three patterns
    with corrupted probes (lanes settle), ``symmetric`` (period-2 orbits)."""
    rng = np.random.default_rng(seed)
    if kind == "hebbian":
        xi = np.where(rng.random((3, n)) < 0.5, 1, -1).astype(np.int8)
        w = (xi.T.astype(np.int32) @ xi.astype(np.int32)).astype(np.float32) / n
        w = np.clip(np.round(w / (np.abs(w).max() / 15)), -15, 15).astype(np.int8)
        sigma = xi[rng.integers(0, 3, size=b)].copy()
        sigma[rng.random((b, n)) < 0.15] *= -1
        return w, np.zeros(n, np.int32), sigma
    a = rng.integers(-15, 16, size=(n, n))
    if kind == "symmetric":
        a = np.tril(a) + np.tril(a, -1).T
    w = np.clip(a, -15, 15).astype(np.int8)
    bias = rng.integers(-1, 2, size=n).astype(np.int32)
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    return w, bias, sigma


# ---------------------------------------------------------------------------
# Kernels 6 and 7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p", NP_CASES)
def test_hybrid_kernels_match_pallas_and_ref(n, p):
    w, bias, phase, sigma = _inputs(n, 5, seed=n * 13 + p)
    got = ops.hybrid_coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma), parallel=p)
    assert got.dtype == torch.int32
    same(got, ref_ops.hybrid_coupling_sum(jnp.asarray(w), jnp.asarray(sigma), parallel=p,
                                          use_pallas=True))
    same(got, ref_plain.hybrid_coupling_sum_ref(jnp.asarray(w), jnp.asarray(sigma), p))
    # Bit-exact with the one-pass coupling sum, whatever P.
    same(got, ops.coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma)))

    ph8 = phase.astype(np.uint8)
    got = ops.hybrid_phase_step(torch.as_tensor(w), torch.as_tensor(sigma), torch.as_tensor(bias),
                                torch.as_tensor(ph8), half=HALF, parallel=p)
    assert got.dtype == torch.uint8  # returned in the phase's dtype
    same(got, ref_ops.hybrid_phase_step(jnp.asarray(w), jnp.asarray(sigma), jnp.asarray(bias),
                                        jnp.asarray(ph8), half=HALF, parallel=p,
                                        use_pallas=True))
    same(got, ref_plain.hybrid_phase_step_ref(jnp.asarray(w), jnp.asarray(sigma),
                                              jnp.asarray(bias), jnp.asarray(phase), HALF, p))


@pytest.mark.parametrize("n,m,p", [(47, 13, 5), (129, 64, 32)])
def test_hybrid_coupling_sum_row_slab_and_vector(n, m, p):
    """``w`` may be an (M, N) row slab with M < N, and σ a single vector."""
    w, _, _, sigma = _inputs(n, 3, seed=m, m=m)
    for s in (sigma, sigma[0]):
        same(
            ops.hybrid_coupling_sum(torch.as_tensor(w), torch.as_tensor(s), parallel=p),
            ref_ops.hybrid_coupling_sum(jnp.asarray(w), jnp.asarray(s), parallel=p,
                                        use_pallas=True),
        )


def test_hybrid_kernels_reject_bad_width_and_count_no_cpu_launch():
    w, bias, phase, sigma = _inputs(12, 2, seed=4)
    ops.reset_launches()
    ops.hybrid_coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma), parallel=3)
    ops.hybrid_phase_step(torch.as_tensor(w), torch.as_tensor(sigma), None,
                          torch.as_tensor(phase), half=HALF, parallel=3)
    assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
    for p in (0, -2):
        with pytest.raises(ValueError, match="parallel"):
            ops.hybrid_coupling_sum(torch.as_tensor(w), torch.as_tensor(sigma), parallel=p)
    with pytest.raises(TypeError):
        ops.hybrid_coupling_sum(torch.as_tensor(w).float(), torch.as_tensor(sigma), parallel=3)


# ---------------------------------------------------------------------------
# The scan route and the backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 7, 16, 30, 31])
def test_hybrid_mac_sum_matches_reference(p):
    w, _, _, sigma = _inputs(30, 4, seed=p)
    got = port_dyn.hybrid_mac_sum(torch.as_tensor(w), torch.as_tensor(sigma), p)
    same(got, ref_dyn.hybrid_mac_sum(jnp.asarray(w), jnp.asarray(sigma), p))
    # Any lead shape, and a row slab.
    same(port_dyn.hybrid_mac_sum(torch.as_tensor(w), torch.as_tensor(sigma[0]), p),
         ref_dyn.hybrid_mac_sum(jnp.asarray(w), jnp.asarray(sigma[0]), p))
    same(port_dyn.hybrid_mac_sum(torch.as_tensor(w[:9]), torch.as_tensor(sigma), p),
         ref_dyn.hybrid_mac_sum(jnp.asarray(w[:9]), jnp.asarray(sigma), p))


def test_hybrid_mac_sum_rejects_zero_width():
    w, _, _, sigma = _inputs(8, 2, seed=0)
    with pytest.raises(ValueError):
        port_dyn.hybrid_mac_sum(torch.as_tensor(w), torch.as_tensor(sigma), 0)


def _both(n, impl, w, bias, **cfg_kw):
    ref_cfg = ref_dyn.ONNConfig(n=n, backend="hybrid", hybrid_impl=REF_IMPL[impl], **cfg_kw)
    port_cfg = port_dyn.ONNConfig(n=n, backend="hybrid", hybrid_impl=impl, **cfg_kw)
    ref_params = ref_dyn.make_params(ref_cfg, jnp.asarray(w), jnp.asarray(bias))
    return ref_cfg, ref_params, port_cfg, port_dyn.make_params(port_cfg, w, bias, device="cpu")


KINDS = ("random", "hebbian", "symmetric")


@pytest.mark.parametrize("settle_chunk", [0, 1, 8])
@pytest.mark.parametrize("n", [47, 48, 129])
@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_hybrid_retrieve_and_run_batch_match_reference(impl, n, settle_chunk):
    kind = KINDS[(n + settle_chunk) % 3]
    w, bias, sigma = problem(n, 6, seed=n + settle_chunk, kind=kind)
    p = (1, 7, 32)[settle_chunk % 3]
    rc, rp, pc, pp = _both(n, impl, w, bias, max_cycles=24, settle_chunk=settle_chunk,
                           parallel_factor=p)
    ops.reset_launches()
    got = port_dyn.retrieve(pc, pp, torch.as_tensor(sigma))
    same_result(got, ref_dyn.retrieve(rc, rp, jnp.asarray(sigma)))
    assert got.final_phase.dtype == torch.uint8
    assert sum(ops.LAUNCHES.values()) == 0
    phase0 = np.random.default_rng(n).integers(0, 16, size=(4, n)).astype(np.uint8)
    same_result(port_dyn.run_batch(pc, pp, torch.as_tensor(phase0)),
                ref_dyn.run_batch(rc, rp, jnp.asarray(phase0)))


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_hybrid_run_matches_reference_and_batch(impl):
    n = 33
    w, bias, sigma = problem(n, 3, seed=9, kind="symmetric")
    rc, rp, pc, pp = _both(n, impl, w, bias, max_cycles=15, parallel_factor=32)
    batch = port_dyn.retrieve(pc, pp, torch.as_tensor(sigma))
    for lane in range(3):
        phase0 = port_dyn.initial_phase(pc, torch.as_tensor(sigma[lane]))
        got = port_dyn.run(pc, pp, phase0)
        same_result(got, ref_dyn.run(rc, rp, jnp.asarray(phase0.numpy())))
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(batch, name)[lane]), name


def test_hybrid_weighted_sum_and_default_width():
    """``weighted_sum`` on the hybrid backend, both routes, at the auto P."""
    n = 70
    w, bias, sigma = problem(n, 4, seed=2, kind="random")
    for impl in ("scan", "kernel"):
        rc, rp, pc, pp = _both(n, impl, w, bias)
        assert pc.hybrid_parallel == rc.hybrid_parallel == 32
        assert pc.hybrid_passes == rc.hybrid_passes == 3
        got = port_dyn.weighted_sum(pc, pp.weights, torch.as_tensor(sigma))
        same(got, ref_dyn.weighted_sum(rc, rp.weights, jnp.asarray(sigma)))


def test_hybrid_padded_instance_is_exact():
    """Bucketing a hybrid instance freezes P and only adds idle passes."""
    n, n_to = 47, 64
    w, bias, sigma = problem(n, 4, seed=12, kind="hebbian")
    cfg = port_dyn.ONNConfig(n=n, backend="hybrid", hybrid_impl="kernel", parallel_factor=0,
                             max_cycles=20)
    params = port_dyn.make_params(cfg, w, bias, device="cpu")
    cfg2, params2 = port_dyn.pad_config(cfg, n_to), port_dyn.pad_params(cfg, params, n_to)
    assert cfg2.hybrid_parallel == cfg.hybrid_parallel == 32
    padded = port_dyn.retrieve(cfg2, params2, port_dyn.pad_sigma(torch.as_tensor(sigma), n_to))
    plain = port_dyn.retrieve(cfg, params, torch.as_tensor(sigma))
    assert torch.equal(padded.final_phase[:, :n], plain.final_phase)
    for name in ("settle_cycle", "settled", "cycled"):
        assert torch.equal(getattr(padded, name), getattr(plain, name))
