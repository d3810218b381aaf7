"""The whole slice at the paper's design point, and the resumable serving API.

* ``retrieve`` at N = 506, B = 16 on the kernel backend against the JAX
  reference's ``pallas`` backend (interpret mode), on Hebbian weights (lanes
  settle) and random symmetric weights (lanes enter period-2 orbits).
* ``init_batch_state`` / ``advance_chunk`` / ``install_lanes`` /
  ``batch_result``: a lane installed mid-flight equals its isolated solve.

All compared fields are integers or bools and must be exactly equal.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import onn as ref_configs
from repro.core import dynamics as ref_dyn
from repro_torch import api
from repro_torch.configs import onn as port_configs
from repro_torch.core import dynamics as port_dyn
from repro_torch.core import quantization as port_quant

FIELDS = ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled")


def same_result(port, ref) -> None:
    for name in FIELDS:
        p = getattr(port, name).cpu().numpy()
        r = np.asarray(getattr(ref, name))
        assert p.shape == r.shape, (name, p.shape, r.shape)
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64), err_msg=name)


def hebbian_problem(n, b, seed):
    """5-bit Hebbian weights (the port's own hebbian + quantize_weights) on
    four random patterns, probes with 10 % of pixels flipped."""
    rng = np.random.default_rng(seed)
    xi = np.where(rng.random((4, n)) < 0.5, 1, -1).astype(np.int8)
    w = port_quant.quantize_weights(api.hebbian(torch.as_tensor(xi))).values.numpy()
    probes = xi[rng.integers(0, 4, size=b)].copy()
    for row in probes:
        row[rng.choice(n, size=n // 10, replace=False)] *= -1
    return w, probes


def symmetric_problem(n, b, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-15, 16, size=(n, n))
    w = np.clip(np.tril(a) + np.tril(a, -1).T, -15, 15).astype(np.int8)
    return w, np.where(rng.random((b, n)) < 0.5, 1, -1).astype(np.int8)


@pytest.mark.parametrize("phase_pack", [False, True])
@pytest.mark.parametrize("kind", ["hebbian", "symmetric"])
def test_slice_at_n506_matches_reference(kind, phase_pack):
    n, b = 506, 16
    w, sigma = (hebbian_problem if kind == "hebbian" else symmetric_problem)(n, b, seed=506)
    ref_cfg = dataclasses.replace(ref_configs.ONN_HYBRID_506, backend="pallas", phase_pack=phase_pack)
    port_cfg = dataclasses.replace(port_configs.ONN_HYBRID_506, backend="kernel", phase_pack=phase_pack)
    want = ref_dyn.retrieve(ref_cfg, ref_dyn.make_params(ref_cfg, jnp.asarray(w)), jnp.asarray(sigma))
    solver = api.RetrievalSolver(port_cfg, api.make_params(port_cfg, w, device="cpu"))
    got = solver.solve(sigma)
    same_result(got, want)
    if kind == "hebbian":
        assert bool(got.settled.all())
    else:
        assert bool(got.cycled.any())


def test_solver_protocol_and_key_rule():
    cfg = port_dyn.ONNConfig(n=16, backend="kernel")
    w, sigma = symmetric_problem(16, 2, seed=0)
    solver = api.RetrievalSolver(cfg, api.make_params(cfg, w, device="cpu"))
    assert isinstance(solver, api.Solver)
    with pytest.raises(ValueError, match="key"):
        solver.solve(sigma, key=0)


@pytest.mark.parametrize("phase_pack", [False, True])
@pytest.mark.parametrize("backend", ["parallel", "kernel"])
def test_midflight_install_equals_isolated_solve(backend, phase_pack):
    n, slab, chunk = 129, 6, 3
    w, sigma = symmetric_problem(n, 10, seed=7)
    heb_w, heb = hebbian_problem(n, 4, seed=8)
    sigma[:4] = heb  # mix settling and cycling lanes
    w[:] = np.clip(w.astype(np.int32) // 4 + heb_w, -15, 15)
    cfg = port_dyn.ONNConfig(n=n, backend=backend, max_cycles=30, settle_chunk=chunk,
                             phase_pack=phase_pack)
    params = port_dyn.make_params(cfg, w, device="cpu")
    isolated = port_dyn.retrieve(cfg, params, torch.as_tensor(sigma))
    ref_cfg = ref_dyn.ONNConfig(n=n, backend="pallas" if backend == "kernel" else backend,
                                max_cycles=30, settle_chunk=chunk, phase_pack=phase_pack)
    same_result(isolated, ref_dyn.retrieve(ref_cfg, ref_dyn.make_params(ref_cfg, jnp.asarray(w)), jnp.asarray(sigma)))

    phase0 = port_dyn.initial_phase(cfg, torch.as_tensor(sigma))
    state = port_dyn.dead_batch_state(cfg, slab, device="cpu")
    pending = list(range(len(sigma)))
    slot_of = {}
    harvested = {}
    ticks = 0
    while len(harvested) < len(sigma):
        done = port_dyn.batch_done(cfg, state)
        free = [s for s in range(slab) if bool(done[s]) and s not in slot_of.values()]
        take = free[:2] if ticks else free  # trickle requests in after the first tick
        if pending and take:
            reqs, pending = pending[: len(take)], pending[len(take):]
            sub = port_dyn.init_batch_state(cfg, phase0[reqs])
            before = state
            state = port_dyn.install_lanes(state, sub, take[: len(reqs)])
            keep = [s for s in range(slab) if s not in take[: len(reqs)]]
            for a, b in zip(before, state):  # untouched rows stay bit-identical
                assert torch.equal(a[keep], b[keep])
            slot_of.update(zip(reqs, take))
        state = port_dyn.advance_chunk(cfg, params, state)
        ticks += 1
        done = port_dyn.batch_done(cfg, state)
        res = port_dyn.batch_result(cfg, state)
        for req, slot in list(slot_of.items()):
            if bool(done[slot]):
                harvested[req] = tuple(getattr(res, f)[slot].clone() for f in FIELDS)
                del slot_of[req]
        assert ticks < 200
    for req, got in harvested.items():
        for name, g in zip(FIELDS, got):
            assert torch.equal(g, getattr(isolated, name)[req]), (req, name)
