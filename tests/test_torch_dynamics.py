"""Functional-mode dynamics of the port against ``repro.core.dynamics`` on the
same numpy inputs (CPU; the JAX ``pallas`` backend runs in interpret mode,
the port's ``kernel`` backend through the kernels' plain versions).

Every ``ONNResult`` field is an integer or bool and must be exactly equal:
final phases, final spins, settle cycles, settled and cycled flags.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynamics as ref_dyn
from repro_torch.core import dynamics as port_dyn
from repro_torch.core import oscillator as port_osc
from repro_torch.kernels import ops

REF_BACKEND = {"parallel": "parallel", "serial": "serial", "kernel": "pallas"}
FIELDS = ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled")


def same_result(port, ref) -> None:
    for name in FIELDS:
        p = getattr(port, name).cpu().numpy()
        r = np.asarray(getattr(ref, name))
        assert p.shape == r.shape, (name, p.shape, r.shape)
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64), err_msg=name)


def problem(n, b, seed, kind="random"):
    """(weights int8, bias int32, spins int8 (b, n)) from a numpy seed.

    ``random``: asymmetric couplings, lanes wander and often hit the budget.
    ``hebbian``: 5-bit Hebbian weights of three patterns, corrupted probes
    that settle.  ``symmetric``: random symmetric couplings (period-2 orbits).
    """
    rng = np.random.default_rng(seed)
    if kind == "hebbian":
        xi = np.where(rng.random((3, n)) < 0.5, 1, -1).astype(np.int8)
        w = (xi.T.astype(np.int32) @ xi.astype(np.int32)).astype(np.float32) / n
        w = np.clip(np.round(w / (np.abs(w).max() / 15)), -15, 15).astype(np.int8)
        sigma = xi[rng.integers(0, 3, size=b)].copy()
        flips = rng.random((b, n)) < 0.15
        sigma[flips] *= -1
        return w, np.zeros(n, np.int32), sigma
    a = rng.integers(-15, 16, size=(n, n))
    if kind == "symmetric":
        a = np.tril(a) + np.tril(a, -1).T
    w = np.clip(a, -15, 15).astype(np.int8)
    bias = rng.integers(-1, 2, size=n).astype(np.int32)
    sigma = np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)
    return w, bias, sigma


def both(n, backend, w, bias, **cfg_kw):
    ref_cfg = ref_dyn.ONNConfig(n=n, backend=REF_BACKEND[backend], **cfg_kw)
    port_cfg = port_dyn.ONNConfig(n=n, backend=backend, **cfg_kw)
    ref_params = ref_dyn.make_params(ref_cfg, jnp.asarray(w), jnp.asarray(bias))
    port_params = port_dyn.make_params(port_cfg, w, bias, device="cpu")
    return ref_cfg, ref_params, port_cfg, port_params


# A cover in which every backend meets every N, settle_chunk and phase_pack.
CASES = [
    ("parallel", 47, 0, False, "random"), ("parallel", 48, 1, True, "hebbian"),
    ("parallel", 129, 8, False, "symmetric"),
    ("serial", 47, 1, False, "symmetric"), ("serial", 48, 8, True, "random"),
    ("serial", 129, 0, True, "hebbian"),
    ("kernel", 47, 8, True, "symmetric"), ("kernel", 48, 0, False, "symmetric"),
    ("kernel", 129, 1, True, "random"), ("kernel", 47, 1, False, "hebbian"),
    ("kernel", 129, 8, False, "hebbian"), ("kernel", 48, 8, True, "random"),
]


KINDS = ("random", "hebbian", "symmetric")


@pytest.mark.parametrize("phase_pack", [False, True])
@pytest.mark.parametrize("settle_chunk", [0, 1, 8])
@pytest.mark.parametrize("n", [47, 48, 129])
@pytest.mark.parametrize("backend", ["parallel", "serial", "kernel"])
def test_retrieve_matches_reference(backend, n, settle_chunk, phase_pack):
    kind = KINDS[(n + settle_chunk + phase_pack) % 3]
    w, bias, sigma = problem(n, 6, seed=n + settle_chunk, kind=kind)
    rc, rp, pc, pp = both(n, backend, w, bias, max_cycles=24,
                          settle_chunk=settle_chunk, phase_pack=phase_pack)
    ops.reset_launches()
    got = port_dyn.retrieve(pc, pp, torch.as_tensor(sigma))
    same_result(got, ref_dyn.retrieve(rc, rp, jnp.asarray(sigma)))
    assert got.final_phase.dtype == torch.uint8
    assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors never launch


@pytest.mark.parametrize("backend,n,settle_chunk,phase_pack,kind", CASES[::2])
def test_run_batch_from_noncanonical_phases(backend, n, settle_chunk, phase_pack, kind):
    w, bias, _ = problem(n, 5, seed=3 * n, kind=kind)
    phase0 = np.random.default_rng(n).integers(0, 16, size=(5, n)).astype(np.uint8)
    rc, rp, pc, pp = both(n, backend, w, bias, max_cycles=20,
                          settle_chunk=settle_chunk, phase_pack=phase_pack)
    same_result(
        port_dyn.run_batch(pc, pp, torch.as_tensor(phase0)),
        ref_dyn.run_batch(rc, rp, jnp.asarray(phase0)),
    )


@pytest.mark.parametrize("backend", ["parallel", "serial", "kernel"])
@pytest.mark.parametrize("phase_pack", [False, True])
def test_run_and_step_match_reference_and_batch(backend, phase_pack):
    n = 48
    w, bias, sigma = problem(n, 3, seed=5, kind="symmetric")
    rc, rp, pc, pp = both(n, backend, w, bias, max_cycles=15, phase_pack=phase_pack)
    batch = port_dyn.retrieve(pc, pp, torch.as_tensor(sigma))
    for lane in range(3):
        phase0 = port_dyn.initial_phase(pc, torch.as_tensor(sigma[lane]))
        got = port_dyn.run(pc, pp, phase0)
        same_result(got, ref_dyn.run(rc, rp, jnp.asarray(phase0.numpy())))
        for name in FIELDS:  # run == the lane of the early-exit batch
            assert torch.equal(getattr(got, name), getattr(batch, name)[lane]), name
    # step keeps its single-lane all() semantics over the whole array.
    sp = port_dyn.init_state(pc, torch.as_tensor(sigma))
    sr = ref_dyn.init_state(rc, jnp.asarray(sigma))
    for _ in range(4):
        sp, sr = port_dyn.step(pc, pp, sp), ref_dyn.step(rc, rp, sr)
        for a, b in zip(sp, sr):
            np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("phase_bits", [2, 3, 8])
def test_other_phase_widths_match_reference(phase_bits):
    """half = 2**phase_bits / 2 reaches the kernels; phase_pack needs <= 4 bits."""
    n = 47
    w, bias, sigma = problem(n, 5, seed=phase_bits, kind="symmetric")
    phase0 = np.random.default_rng(phase_bits).integers(0, 1 << phase_bits, size=(5, n))
    for pack in (False, True) if phase_bits <= 4 else (False,):
        rc, rp, pc, pp = both(n, "kernel", w, bias, max_cycles=18, phase_bits=phase_bits,
                              phase_pack=pack)
        same_result(
            port_dyn.run_batch(pc, pp, torch.as_tensor(phase0.astype(np.uint8))),
            ref_dyn.run_batch(rc, rp, jnp.asarray(phase0.astype(np.uint8))),
        )
        same_result(
            port_dyn.retrieve(pc, pp, torch.as_tensor(sigma)),
            ref_dyn.retrieve(rc, rp, jnp.asarray(sigma)),
        )


def test_weighted_sum_backends_and_sign_update():
    n = 47
    w, bias, sigma = problem(n, 4, seed=8)
    for backend in ("parallel", "serial", "kernel"):
        rc, rp, pc, pp = both(n, backend, w, bias)
        got = port_dyn.weighted_sum(pc, pp.weights, torch.as_tensor(sigma))
        want = np.asarray(ref_dyn.weighted_sum(rc, rp.weights, jnp.asarray(sigma)))
        np.testing.assert_array_equal(got.numpy(), want)
        field = got + pp.bias
        np.testing.assert_array_equal(
            port_dyn.sign_update(field, torch.as_tensor(sigma)).numpy(),
            np.asarray(ref_dyn.sign_update(jnp.asarray(field.numpy()), jnp.asarray(sigma))),
        )


def test_padding_is_exact_and_matches_reference():
    n, n_to = 47, 64
    w, bias, sigma = problem(n, 4, seed=12, kind="hebbian")
    rc, rp, pc, pp = both(n, "kernel", w, bias, max_cycles=20)
    pc2, pp2 = port_dyn.pad_config(pc, n_to), port_dyn.pad_params(pc, pp, n_to)
    rc2, rp2 = ref_dyn.pad_config(rc, n_to), ref_dyn.pad_params(rc, rp, n_to)
    np.testing.assert_array_equal(pp2.weights.numpy(), np.asarray(rp2.weights))
    np.testing.assert_array_equal(pp2.bias.numpy(), np.asarray(rp2.bias))
    s2 = port_dyn.pad_sigma(torch.as_tensor(sigma), n_to)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(ref_dyn.pad_sigma(jnp.asarray(sigma), n_to)))
    padded = port_dyn.retrieve(pc2, pp2, s2)
    plain = port_dyn.retrieve(pc, pp, torch.as_tensor(sigma))
    assert torch.equal(padded.final_phase[:, :n], plain.final_phase)
    assert torch.equal(padded.settle_cycle, plain.settle_cycle)
    hyb = port_dyn.ONNConfig(n=n, backend="hybrid")
    assert port_dyn.pad_config(hyb, n_to).parallel_factor == ref_dyn.pad_config(
        ref_dyn.ONNConfig(n=n, backend="hybrid"), n_to
    ).parallel_factor
    with pytest.raises(ValueError):
        port_dyn.pad_params(pc, pp, n - 1)
    port_dyn.validate_weights(pp.weights, 5)
    with pytest.raises(ValueError):
        port_dyn.validate_weights(pp.weights * 0 + 16, 5)


def test_unported_routes_raise_not_implemented():
    """Only ``async_sweep`` (the Ising slice) is still unported; ``step`` on an
    rtl config is refused as in the reference; the rtl and hybrid routes that
    used to raise now run, and ``run`` equals the batched lane."""
    w, bias, sigma = problem(16, 2, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_dyn.async_sweep(torch.as_tensor(w), torch.as_tensor(sigma[0]), torch.arange(16))
    with pytest.raises(ValueError, match="functional"):
        cfg = port_dyn.ONNConfig(n=16, mode="rtl")
        port_dyn.step(cfg, port_dyn.make_params(cfg, w, device="cpu"),
                      port_dyn.init_state(cfg, torch.as_tensor(sigma[0])))
    for kw in (dict(mode="rtl"), dict(backend="hybrid"), dict(parallel_factor=4)):
        cfg = port_dyn.ONNConfig(n=16, max_cycles=10, **kw)
        params = port_dyn.make_params(cfg, w, bias, device="cpu")
        batch = port_dyn.retrieve(cfg, params, torch.as_tensor(sigma))
        one = port_dyn.run(cfg, params, port_osc.phase_of_spin(torch.as_tensor(sigma[0])))
        for name in FIELDS:
            assert torch.equal(getattr(one, name), getattr(batch, name)[0]), (kw, name)


def test_chunk_fused_equals_chunk_multi_and_batch_steps():
    """The two chunk routes and `chunk` per-cycle steps agree exactly,
    including lanes already frozen and lanes near their budget."""
    n, b, chunk = 48, 8, 5
    w, bias, sigma = problem(n, b, seed=21, kind="symmetric")
    cfg = port_dyn.ONNConfig(n=n, backend="kernel", max_cycles=12)
    params = port_dyn.make_params(cfg, w, bias, device="cpu")
    state = port_dyn.init_batch_state(cfg, port_dyn.initial_phase(cfg, torch.as_tensor(sigma)))
    state = state._replace(
        t=torch.tensor([0, 3, 9, 10, 11, 12, 0, 2], dtype=torch.int32),
        frozen=torch.tensor([False, True, False, False, False, False, False, True]),
    )
    for _ in range(3):
        fused = port_dyn._chunk_fused(cfg, params, state, chunk)
        multi = port_dyn._chunk_multi(cfg, params, state, chunk)
        stepped = state
        for _ in range(chunk):
            stepped = port_dyn._batch_step(cfg, params, stepped)
        for f, m, s in zip(fused, multi, stepped):
            assert torch.equal(f, m) and torch.equal(f, s)
        state = fused


def test_dataclass_replace_keeps_validation():
    cfg = port_dyn.ONNConfig(n=20, serial_chunk=4)
    assert cfg.backend == "serial"
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, backend="parallel", parallel_factor=3, serial_chunk=2)
