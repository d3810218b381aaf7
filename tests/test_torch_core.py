"""The port's elementwise core, data, configs, checkpoints and isolation,
held against the JAX reference on the same numpy inputs (CPU).

Integer outputs must be exactly equal.  Float outputs that both frameworks
compute with the same IEEE operations (quantization scale, fake_quantize,
hebbian) are compared with rtol=0, atol=0; stability margins sum products in
another order and use atol=1e-5 (|κ| ≤ P·max|W| ≤ 5 in float32).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import onn as ref_ckpt
from repro.configs import onn as ref_configs
from repro.core import coupling as ref_coupling
from repro.core import dynamics as ref_dyn
from repro.core import learning as ref_learning
from repro.core import oscillator as ref_osc
from repro.core import quantization as ref_quant
from repro.data import patterns as ref_patterns
from repro_torch import convert
from repro_torch.checkpoint import onn as port_ckpt
from repro_torch.configs import onn as port_configs
from repro_torch.core import checks
from repro_torch.core import coupling as port_coupling
from repro_torch.core import dynamics as port_dyn
from repro_torch.core import learning as port_learning
from repro_torch.core import oscillator as port_osc
from repro_torch.core import quantization as port_quant
from repro_torch.data import patterns as port_patterns

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def same(port, ref) -> None:
    """Exact equality of a port tensor and a reference array, values and shape."""
    p = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    np.testing.assert_array_equal(p.astype(np.float64), r.astype(np.float64))


# ---------------------------------------------------------------------------
# oscillator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase_bits", [2, 4, 8])
def test_oscillator_functions_bit_exact(phase_bits):
    rng = np.random.default_rng(phase_bits)
    theta = rng.integers(0, 1 << phase_bits, size=(5, 37)).astype(np.uint8)
    s = rng.integers(-3, 4, size=(5, 37)).astype(np.int32)
    sigma = np.where(rng.random((5, 37)) < 0.5, 1, -1).astype(np.int8)
    tt = torch.as_tensor(theta)
    same(port_osc.amplitude(tt, phase_bits), ref_osc.amplitude(jnp.asarray(theta), phase_bits))
    same(port_osc.spin(tt, phase_bits), ref_osc.spin(jnp.asarray(theta), phase_bits))
    same(
        port_osc.phase_of_spin(torch.as_tensor(sigma), phase_bits),
        ref_osc.phase_of_spin(jnp.asarray(sigma), phase_bits),
    )
    same(port_osc.free_run(tt, 11, phase_bits), ref_osc.free_run(jnp.asarray(theta), 11, phase_bits))
    same(
        port_osc.phase_align(tt, torch.as_tensor(s), phase_bits),
        ref_osc.phase_align(jnp.asarray(theta), jnp.asarray(s), phase_bits),
    )
    amp = port_osc.amplitude(tt, phase_bits)
    same(
        port_osc.reference_signal(torch.as_tensor(s), amp),
        ref_osc.reference_signal(jnp.asarray(s), jnp.asarray(amp.numpy())),
    )
    assert port_osc.n_positions(phase_bits) == ref_osc.n_positions(phase_bits)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [3, 5, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_weights_and_fake_quantize_bit_exact(bits, seed):
    rng = np.random.default_rng(seed * 10 + bits)
    w = (rng.standard_normal((33, 33)) * rng.uniform(0.01, 3.0)).astype(np.float32)
    w[0, :4] = [0.5, -0.5, 1.5, -2.5]  # ties at several scales
    qp = port_quant.quantize_weights(torch.as_tensor(w), bits)
    qr = ref_quant.quantize_weights(jnp.asarray(w), bits)
    same(qp.values, qr.values)
    assert qp.values.dtype == torch.int8
    same(qp.scale, qr.scale)  # rtol=0, atol=0
    same(port_quant.fake_quantize(torch.as_tensor(w), bits), ref_quant.fake_quantize(jnp.asarray(w), bits))
    same(qp.dequantize(), qr.dequantize())
    zero = np.zeros((4, 4), np.float32)
    same(port_quant.quantize_weights(torch.as_tensor(zero), bits).scale, ref_quant.quantize_weights(jnp.asarray(zero), bits).scale)


@pytest.mark.parametrize("n", [1, 6, 7, 47])
def test_phase_and_int4_packing_bit_exact(n):
    rng = np.random.default_rng(n)
    ph = rng.integers(0, 16, size=(3, n)).astype(np.uint8)
    packed_p = port_quant.pack_phases(torch.as_tensor(ph))
    packed_r = ref_quant.pack_phases(jnp.asarray(ph))
    same(packed_p, packed_r)
    assert packed_p.dtype == torch.uint8
    same(port_quant.unpack_phases(packed_p, n), ref_quant.unpack_phases(packed_r, n))
    with pytest.raises(ValueError):
        port_quant.unpack_phases(packed_p, n + 2)
    if n % 2 == 0:
        v = rng.integers(-8, 8, size=(2, n)).astype(np.int8)
        p4 = port_quant.pack_int4(torch.as_tensor(v))
        same(p4, ref_quant.pack_int4(jnp.asarray(v)))
        same(port_quant.unpack_int4(p4), ref_quant.unpack_int4(jnp.asarray(p4.numpy())))
    else:
        with pytest.raises(ValueError):
            port_quant.pack_int4(torch.zeros((2, n), dtype=torch.int8))


def test_quantization_helpers_match():
    rng = np.random.default_rng(3)
    theta = rng.uniform(0, 2 * np.pi, size=100).astype(np.float32)
    same(port_quant.quantize_phase(torch.as_tensor(theta), 4), ref_quant.quantize_phase(jnp.asarray(theta), 4))
    for n in (1, 48, 506, 4096, 131072):
        assert port_quant.accumulator_bits(n) == ref_quant.accumulator_bits(n)
        assert port_quant.weight_memory_bits(n) == ref_quant.weight_memory_bits(n)
    vals = rng.integers(-16, 17, size=(9, 9)).astype(np.int8)
    for bits in (4, 5, 6):
        assert bool(port_quant.check_weight_range(torch.as_tensor(vals), bits)) == bool(
            ref_quant.check_weight_range(jnp.asarray(vals), bits)
        )


# ---------------------------------------------------------------------------
# coupling and learning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(47, 47), (48, 20), (129, 129)])
def test_weighted_sums_bit_exact(n, m):
    rng = np.random.default_rng(n + m)
    w = rng.integers(-15, 16, size=(m, n)).astype(np.int8)
    sigma = np.where(rng.random((4, n)) < 0.5, 1, -1).astype(np.int8)
    want = ref_coupling.weighted_sum_parallel(jnp.asarray(w), jnp.asarray(sigma))
    same(port_coupling.weighted_sum_parallel(torch.as_tensor(w), torch.as_tensor(sigma)), want)
    for chunk in (1, 5, 64):
        same(
            port_coupling.weighted_sum_serial(torch.as_tensor(w), torch.as_tensor(sigma), chunk),
            ref_coupling.weighted_sum_serial(jnp.asarray(w), jnp.asarray(sigma), chunk),
        )
    with pytest.raises(ValueError):
        port_coupling.weighted_sum_serial(torch.as_tensor(w), torch.as_tensor(sigma), 0)
    with pytest.raises(TypeError):
        port_coupling.weighted_sum_parallel(torch.as_tensor(w).float(), torch.as_tensor(sigma))


def test_int_matmul_exact_past_float32_range():
    """N·128² > 2**24 takes the float64 route; extreme int8 operands stay exact."""
    n = 1100
    rng = np.random.default_rng(11)
    w = rng.choice(np.array([-128, 127], np.int8), size=(3, n))
    x = rng.choice(np.array([-128, 127], np.int8), size=(2, n))
    got = port_coupling.int_matmul(torch.as_tensor(x), torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64).T)


def test_adder_counts_match():
    for n in (1, 48, 506):
        assert port_coupling.adders_required_parallel(n) == ref_coupling.adders_required_parallel(n)
        assert port_coupling.adders_required_serial(n) == ref_coupling.adders_required_serial(n)
        for p in (1, 8, 32):
            assert port_coupling.serialization_factor(n, 2, p) == ref_coupling.serialization_factor(n, 2, p)


@pytest.mark.parametrize("self_coupling", [True, False])
def test_learning_rules_match(self_coupling):
    rng = np.random.default_rng(5)
    xi = np.where(rng.random((4, 41)) < 0.5, 1, -1).astype(np.int8)
    wp = port_learning.hebbian(torch.as_tensor(xi), self_coupling)
    wr = ref_learning.hebbian(jnp.asarray(xi), self_coupling)
    same(wp, wr)  # rtol=0, atol=0
    np.testing.assert_allclose(
        port_learning.stability_margins(wp, torch.as_tensor(xi)).numpy(),
        np.asarray(ref_learning.stability_margins(wr, jnp.asarray(xi))),
        rtol=0, atol=1e-5,
    )
    q = port_quant.quantize_weights(wp).values
    assert bool(port_learning.patterns_are_fixed_points(q, torch.as_tensor(xi))) == bool(
        ref_learning.patterns_are_fixed_points(jnp.asarray(q.numpy()), jnp.asarray(xi))
    )


def test_require_int_dtype_rejects_floats():
    assert checks.require_int_dtype(None, "x") is None
    checks.require_int_dtype(torch.zeros(3, dtype=torch.int8), "x")
    checks.require_int_dtype(np.zeros(3, np.int32), "x")
    with pytest.raises(TypeError, match="w must be an integer"):
        checks.require_int_dtype(torch.zeros(3), "w")
    with pytest.raises(TypeError):
        checks.require_int_dtype(np.zeros(3, np.float32), "w")


# ---------------------------------------------------------------------------
# ONNConfig, conversion, configs, checkpoints, data
# ---------------------------------------------------------------------------

_INVALID = [
    dict(n=8, architecture="ring"),
    dict(n=8, mode="fast"),
    dict(n=8, settle_chunk=-1),
    dict(n=8, serial_chunk=4, parallel_factor=2),
    dict(n=8, backend="gpu"),
    dict(n=8, backend="hybrid", parallel_factor=-1),
    dict(n=8, backend="hybrid", hybrid_impl="loop"),
    dict(n=8, backend="hybrid", serial_chunk=4),
    dict(n=8, backend="serial", parallel_factor=4),
    dict(n=8, backend="serial", hybrid_impl="KERNEL"),
    dict(n=8, phase_pack=True, phase_bits=5),
]


@pytest.mark.parametrize("kwargs", _INVALID, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_invalid_configs_raise_in_both(kwargs):
    with pytest.raises(ValueError):
        ref_dyn.ONNConfig(**kwargs)
    with pytest.raises(ValueError):
        port_dyn.ONNConfig(**kwargs)


def test_hybrid_impl_kernel_name_and_kernel_only_names():
    """The kernel route is "kernel" in the port and "pallas" in the reference."""
    port_dyn.ONNConfig(n=8, backend="hybrid", hybrid_impl="kernel")
    with pytest.raises(ValueError):
        port_dyn.ONNConfig(n=8, backend="pallas")
    with pytest.raises(ValueError):
        port_dyn.ONNConfig(n=8, backend="serial", hybrid_impl="kernel")


_VALID_REF = [
    dict(n=506),
    dict(n=48, architecture="recurrent", weight_bits=4, max_cycles=33),
    dict(n=20, serial_chunk=6),
    dict(n=20, parallel_factor=7, hybrid_impl="pallas", settle_chunk=0),
    dict(n=129, backend="pallas", phase_pack=True, settle_chunk=1),
    dict(n=16, mode="rtl", sync_jitter=True, phase_bits=3),
]


@pytest.mark.parametrize("kwargs", _VALID_REF)
def test_config_from_reference_round_trips(kwargs):
    ref = ref_dyn.ONNConfig(**kwargs)
    port = convert.config_from_reference(ref)
    assert convert.config_from_reference(dataclasses.asdict(ref)) == port
    for field in dataclasses.fields(ref):
        want = getattr(ref, field.name)
        if field.name in ("backend", "hybrid_impl") and want == "pallas":
            want = "kernel"
        assert getattr(port, field.name) == want, field.name
    assert port.hybrid_parallel == ref.hybrid_parallel
    assert port.hybrid_passes == ref.hybrid_passes
    assert port.clocks_per_cycle == ref.clocks_per_cycle


def test_params_from_reference_and_device_rule():
    cfg = port_dyn.ONNConfig(n=12)
    rng = np.random.default_rng(2)
    w = rng.integers(-15, 16, size=(12, 12)).astype(np.int8)
    bias = rng.integers(-3, 4, size=12).astype(np.int32)
    params = convert.params_from_reference(cfg, w, bias, device="cpu")
    np.testing.assert_array_equal(params.weights.numpy(), w)
    np.testing.assert_array_equal(params.bias.numpy(), bias)
    assert params.bias.dtype == torch.int32
    nobias = convert.params_from_reference(cfg, w, None, device="cpu")
    assert not bool(nobias.bias.any())
    with pytest.raises(TypeError):
        port_dyn.make_params(cfg, w.astype(np.int32), device="cpu")
    with pytest.raises(ValueError):
        port_dyn.make_params(cfg, w[:5], device="cpu")
    if torch.cuda.is_available():
        assert port_dyn.make_params(cfg, w).weights.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_dyn.make_params(cfg, w)
        with pytest.raises(RuntimeError):
            port_dyn.dead_batch_state(cfg, 4)


def test_configs_match_reference():
    for name in ("ONN_RECURRENT_48", "ONN_HYBRID_506", "ONN_LARGE"):
        assert convert.config_from_reference(getattr(ref_configs, name)) == getattr(port_configs, name)
    assert port_configs.ONN_CELLS == ref_configs.ONN_CELLS
    assert port_configs.ONN_LARGE.backend == "kernel"


def test_checkpoint_saved_by_reference_loads_in_port(tmp_path):
    rng = np.random.default_rng(9)
    cfg = ref_dyn.ONNConfig(n=20, backend="pallas", phase_pack=True, max_cycles=40)
    wf = rng.standard_normal((20, 20)).astype(np.float32)
    q = ref_quant.quantize_weights(jnp.asarray(wf))
    bias = rng.integers(-2, 3, size=20).astype(np.int32)
    path = ref_ckpt.save_onn(str(tmp_path / "ref"), cfg, q, bias, extra_meta={"who": "ref"})
    got = port_ckpt.load_onn(path, device="cpu")
    assert got.config == convert.config_from_reference(cfg)
    assert got.config.backend == "kernel"
    same(got.params.weights, q.values)
    same(got.params.bias, bias)
    same(got.quantized.scale, q.scale)
    assert got.meta == {"who": "ref"}
    # The port writes the same format back, and it reloads to equal params.
    path2 = port_ckpt.save_onn(str(tmp_path / "port"), got.config, got.quantized, got.params.bias)
    again = port_ckpt.load_onn(path2, device="cpu")
    assert again.config == got.config
    same(again.params.weights, q.values)
    same(again.params.bias, bias)


@pytest.mark.parametrize("name", sorted(ref_patterns.DATASET_SHAPES))
def test_datasets_match_and_corrupt(name):
    pats = port_patterns.load_dataset(name, device="cpu")
    same(pats, ref_patterns.load_dataset(name))
    n = pats.shape[1]
    k = port_patterns.n_corrupt_pixels(n, 0.2)
    assert k == ref_patterns.n_corrupt_pixels(n, 0.2)
    rng = np.random.default_rng(n)
    idx = rng.choice(n, size=k, replace=False)
    got = port_patterns.corrupt(pats[0], 0.2, idx=idx)
    want = pats[0].numpy().copy()
    want[idx] *= -1
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(n)
    batch = port_patterns.corrupt_batch(pats[0], 0.2, 3, generator=gen)
    assert batch.shape == (3, n) and batch.dtype == torch.int8
    assert ((batch != pats[0]).sum(dim=1) == k).all()
    with pytest.raises(ValueError):
        port_patterns.corrupt(pats[0], 0.2)


# ---------------------------------------------------------------------------
# isolation: the port imports without jax and without repro
# ---------------------------------------------------------------------------

_ISOLATION = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
]
assert not bad, bad
print(len(names))
"""


_IMPORT_FIRST = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
failed = []
for name in names:
    for key in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[key]
    try:
        importlib.import_module(name)
    except Exception as exc:
        failed.append(f"{name}: {exc!r}")
assert not failed, failed
print(len(names))
"""


def test_every_module_imports_first():
    """Port fault 8 (ROADMAP.md section 3): each module of the port imports
    as the first ``repro_torch`` module of a clean import state (every
    ``repro_torch`` entry removed from ``sys.modules`` before each, in one
    subprocess).  ``models.params`` used to close a cycle through
    ``core/__init__``, ``core.dynamics`` and ``optim``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_FIRST], env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 75


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
