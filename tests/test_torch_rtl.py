"""Clock-accurate rtl mode of the port against ``repro.core.dynamics`` on the
same numpy inputs (CPU).

The enable-signal offsets ``t0`` of ``sync_jitter`` are drawn by the reference
from its keys (``_jitter_offsets`` for a batch, ``jax.random.randint`` for one
lane) and handed to the port as explicit integers.  The reference side runs
the hybrid backend on its ``scan`` route, which its own tests hold bit-exact
with every other route (its pallas-hybrid route crashes XLA's CPU compiler on
some rtl shapes; ROADMAP, faults).

Covered: ``retrieve``, per-lane ``run`` and a mid-flight install equal to the
isolated solve, for architecture ∈ {recurrent, hybrid} × backend ∈ {parallel,
kernel, hybrid-scan, hybrid-kernel} × ``sync_jitter`` ∈ {off, on}; the ``t0``
contract; ``RetrievalSolver`` with a ``torch.Generator``; config conversion
and checkpoints of an rtl hybrid config.  Every compared output is an integer
or a bool and must be exactly equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import onn as ref_ckpt
from repro.core import dynamics as ref_dyn
from repro.core import quantization as ref_quant
from repro_torch import api, convert
from repro_torch.checkpoint import onn as port_ckpt
from repro_torch.core import dynamics as port_dyn
from repro_torch.kernels import ops

FIELDS = ("final_phase", "final_sigma", "settle_cycle", "settled", "cycled")
#: Port route → (port config fields, reference config fields).
ROUTES = {
    "parallel": (dict(backend="parallel"), dict(backend="parallel")),
    "kernel": (dict(backend="kernel"), dict(backend="pallas")),
    "hybrid-scan": (dict(backend="hybrid", hybrid_impl="scan", parallel_factor=5),
                    dict(backend="hybrid", hybrid_impl="scan", parallel_factor=5)),
    "hybrid-kernel": (dict(backend="hybrid", hybrid_impl="kernel", parallel_factor=5),
                      dict(backend="hybrid", hybrid_impl="scan", parallel_factor=5)),
}


def same_result(port, ref) -> None:
    for name in FIELDS:
        p = getattr(port, name).cpu().numpy()
        r = np.asarray(getattr(ref, name))
        assert p.shape == r.shape, (name, p.shape, r.shape)
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64), err_msg=name)


def problem(n, b, seed):
    """Hebbian weights of three patterns under a random asymmetric part, and
    probes with 30 % of pixels flipped: lanes settle after one to several
    cycles, or wander to the budget (more so with jitter)."""
    rng = np.random.default_rng(seed)
    xi = np.where(rng.random((3, n)) < 0.5, 1, -1).astype(np.int32)
    heb = np.round(15 * (xi.T @ xi) / 3).astype(np.int32)
    w = np.clip(heb // 4 + rng.integers(-10, 11, size=(n, n)), -15, 15).astype(np.int8)
    bias = rng.integers(-1, 2, size=n).astype(np.int32)
    sigma = xi[rng.integers(0, 3, size=b)].astype(np.int8)
    sigma[rng.random((b, n)) < 0.3] *= -1
    return w, bias, sigma


def configs(route, **kw):
    port_kw, ref_kw = ROUTES[route]
    return ref_dyn.ONNConfig(mode="rtl", **ref_kw, **kw), port_dyn.ONNConfig(mode="rtl", **port_kw, **kw)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("architecture", ["recurrent", "hybrid"])
def test_rtl_matches_reference(architecture, route, jitter):
    n, b, max_cycles = 47, 6, 12
    w, bias, sigma = problem(n, b, seed=n + 3 * jitter + (architecture == "hybrid"))
    rc, pc = configs(route, n=n, architecture=architecture, sync_jitter=jitter,
                     max_cycles=max_cycles, settle_chunk=3)
    rp = ref_dyn.make_params(rc, jnp.asarray(w), jnp.asarray(bias))
    pp = port_dyn.make_params(pc, w, bias, device="cpu")
    key = jax.random.PRNGKey(n) if jitter else None
    lane_keys = ref_dyn._lane_keys(rc, key, b)
    t0 = torch.as_tensor(np.array(ref_dyn._jitter_offsets(rc, lane_keys, b))) if jitter else None

    # retrieve: the whole batch, early exit, lane for lane.
    ops.reset_launches()
    got = port_dyn.retrieve(pc, pp, torch.as_tensor(sigma), t0=t0)
    same_result(got, ref_dyn.retrieve(rc, rp, jnp.asarray(sigma), keys=key))
    assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors never launch

    # run: one lane, fixed length, its own offset.
    phase0 = port_dyn.initial_phase(pc, torch.as_tensor(sigma))
    for lane in (0, b - 1):
        lane_t0 = None
        if jitter:
            lane_t0 = int(jax.random.randint(lane_keys[lane], (), 0, rc.clocks_per_cycle,
                                             dtype=jnp.int32))
            assert lane_t0 == int(t0[lane])
        one = port_dyn.run(pc, pp, phase0[lane], t0=lane_t0)
        ref_key = None if not jitter else lane_keys[lane]
        same_result(one, ref_dyn.run(rc, rp, jnp.asarray(phase0[lane].numpy()), ref_key))
        for name in FIELDS:
            assert torch.equal(getattr(one, name), getattr(got, name)[lane]), (lane, name)

    # A slab of 3 lanes, requests installed as slots free up mid-flight.
    offsets = torch.zeros(b, dtype=torch.int32) if t0 is None else t0
    state = port_dyn.dead_batch_state(pc, 3, device="cpu")
    assert tuple(state.aux.shape) == (3, n)
    pending, slot_of, harvested, ticks = list(range(b)), {}, {}, 0
    while len(harvested) < b:
        done = port_dyn.batch_done(pc, state)
        free = [s for s in range(3) if bool(done[s]) and s not in slot_of.values()]
        take = free[:1] if ticks else free
        if pending and take:
            reqs, pending = pending[: len(take)], pending[len(take):]
            sub = port_dyn.init_batch_state(pc, phase0[reqs], t0=offsets[reqs] if jitter else None)
            state = port_dyn.install_lanes(state, sub, take[: len(reqs)])
            slot_of.update(zip(reqs, take))
        state = port_dyn.advance_chunk(pc, pp, state)
        ticks += 1
        done = port_dyn.batch_done(pc, state)
        res = port_dyn.batch_result(pc, state)
        for req, slot in list(slot_of.items()):
            if bool(done[slot]):
                harvested[req] = tuple(getattr(res, f)[slot].clone() for f in FIELDS)
                del slot_of[req]
        assert ticks < 100
    for req, fields in harvested.items():
        for name, g in zip(FIELDS, fields):
            assert torch.equal(g, getattr(got, name)[req]), (req, name)


@pytest.mark.parametrize("phase_bits", [3, 5])
def test_rtl_other_phase_widths_match_reference(phase_bits):
    """Other clock counts per cycle (8 and 32 edges), jitter on."""
    n, b = 20, 4
    w, bias, sigma = problem(n, b, seed=phase_bits)
    rc, pc = configs("hybrid-kernel", n=n, sync_jitter=True, phase_bits=phase_bits,
                     max_cycles=8, settle_chunk=2)
    key = jax.random.PRNGKey(phase_bits)
    t0 = np.array(ref_dyn._jitter_offsets(rc, ref_dyn._lane_keys(rc, key, b), b))
    got = port_dyn.retrieve(pc, port_dyn.make_params(pc, w, bias, device="cpu"),
                            torch.as_tensor(sigma), t0=torch.as_tensor(t0))
    want = ref_dyn.retrieve(rc, ref_dyn.make_params(rc, jnp.asarray(w), jnp.asarray(bias)),
                            jnp.asarray(sigma), keys=key)
    same_result(got, want)


def test_t0_contract():
    n, b = 12, 3
    w, bias, sigma = problem(n, b, seed=0)
    jit = port_dyn.ONNConfig(n=n, mode="rtl", sync_jitter=True, max_cycles=4)
    plain = port_dyn.ONNConfig(n=n, max_cycles=4)
    rtl = dataclasses.replace(jit, sync_jitter=False)
    s = torch.as_tensor(sigma)
    for cfg in (jit, plain, rtl):
        params = port_dyn.make_params(cfg, w, bias, device="cpu")
        phase0 = port_dyn.initial_phase(cfg, s)
        if cfg is jit:
            # A jitter config needs t0 on every entry point.
            for call in (lambda: port_dyn.retrieve(cfg, params, s),
                         lambda: port_dyn.run_batch(cfg, params, phase0),
                         lambda: port_dyn.init_batch_state(cfg, phase0),
                         lambda: port_dyn.run(cfg, params, phase0[0])):
                with pytest.raises(ValueError, match="t0"):
                    call()
            with pytest.raises(ValueError, match=r"\(3,\)"):
                port_dyn.retrieve(cfg, params, s, t0=torch.zeros(2, dtype=torch.int32))
            with pytest.raises(TypeError):
                port_dyn.retrieve(cfg, params, s, t0=torch.zeros(3))
            continue
        # Any other config takes no t0, or zeros, and rejects a non-zero one.
        base = port_dyn.retrieve(cfg, params, s)
        zeros = port_dyn.retrieve(cfg, params, s, t0=torch.zeros(b, dtype=torch.int32))
        assert all(torch.equal(x, y) for x, y in zip(base, zeros))
        assert torch.equal(port_dyn.run(cfg, params, phase0[0], t0=0).final_phase,
                           base.final_phase[0])
        with pytest.raises(ValueError, match="sync_jitter"):
            port_dyn.retrieve(cfg, params, s, t0=torch.tensor([0, 1, 0], dtype=torch.int32))
        with pytest.raises(ValueError, match="sync_jitter"):
            port_dyn.run(cfg, params, phase0[0], t0=2)
    # step() drives functional mode only, as in the reference.
    with pytest.raises(ValueError, match="functional"):
        port_dyn.step(jit, port_dyn.make_params(jit, w, device="cpu"),
                      port_dyn.init_state(jit, s[0]))


def test_retrieval_solver_draws_t0_from_a_generator():
    n, b = 24, 5
    w, bias, sigma = problem(n, b, seed=4)
    cfg = port_dyn.ONNConfig(n=n, mode="rtl", sync_jitter=True, backend="hybrid",
                             hybrid_impl="kernel", max_cycles=10)
    solver = api.RetrievalSolver(cfg, api.make_params(cfg, w, bias, device="cpu"))
    a = solver.solve(sigma, key=torch.Generator().manual_seed(7))
    again = solver.solve(sigma, key=torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    # The draw the solver makes, handed to retrieve by hand, gives the same result.
    t0 = torch.randint(0, cfg.clocks_per_cycle, (b,), generator=torch.Generator().manual_seed(7),
                       dtype=torch.int32)
    by_hand = api.retrieve(cfg, solver.params, torch.as_tensor(sigma), t0=t0)
    assert all(torch.equal(x, y) for x, y in zip(a, by_hand))
    for bad in (None, 7):
        with pytest.raises(ValueError, match="Generator"):
            solver.solve(sigma, key=bad)
    no_jitter = api.RetrievalSolver(dataclasses.replace(cfg, sync_jitter=False), solver.params)
    with pytest.raises(ValueError, match="key"):
        no_jitter.solve(sigma, key=torch.Generator())
    assert no_jitter.solve(sigma).final_phase.shape == (b, n)


def test_rtl_hybrid_config_converts_and_checkpoints(tmp_path):
    ref_cfg = ref_dyn.ONNConfig(n=20, mode="rtl", sync_jitter=True, backend="hybrid",
                                hybrid_impl="pallas", parallel_factor=6, max_cycles=30,
                                architecture="hybrid", phase_bits=3)
    port_cfg = convert.config_from_reference(ref_cfg)
    assert port_cfg == port_dyn.ONNConfig(n=20, mode="rtl", sync_jitter=True, backend="hybrid",
                                          hybrid_impl="kernel", parallel_factor=6,
                                          max_cycles=30, architecture="hybrid", phase_bits=3)
    assert convert.config_from_reference(dataclasses.asdict(ref_cfg)) == port_cfg
    rng = np.random.default_rng(1)
    q = ref_quant.quantize_weights(jnp.asarray(rng.standard_normal((20, 20)).astype(np.float32)))
    path = ref_ckpt.save_onn(str(tmp_path / "ref"), ref_cfg, q, None)
    loaded = port_ckpt.load_onn(path, device="cpu")
    assert loaded.config == port_cfg
    again = port_ckpt.load_onn(
        port_ckpt.save_onn(str(tmp_path / "port"), loaded.config, loaded.quantized,
                           loaded.params.bias),
        device="cpu",
    )
    assert again.config == port_cfg
    assert torch.equal(again.params.weights, loaded.params.weights)
