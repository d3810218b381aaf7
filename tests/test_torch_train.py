"""The port's DO-I trainer (``repro_torch.train``, ``core.learning.
diederich_opper_i``) against the JAX reference, under the DO-I rule.

Tolerance: the rule of ``tests/doi_rule.py``.  Each run is replayed in
float64 from the float32 weights; where no stability check lies within the
float32 summation bound γ_N · Σ_j |W_eff,ij| of the threshold (the run is
*tie-free*), ``weights``, ``sweeps``, ``converged`` and the quantized int8
weights must equal the reference's exactly (``==``), and each ``kappa_min``
lie within that bound of the replay's float64 minimum.  Otherwise (the run
is *tie-bound*) ``converged`` must agree and, when converged, the port's own
``kappa_min`` must meet the threshold.

Two of the reference's float32 operations compile to another form than the
eager functions: ``/ n`` of the Hebbian init to a multiplication by the
float32 reciprocal (the port's trainer does the same, exactly), and the
QAT scale ``absmax / qmax`` to ``absmax · fl(1/qmax)`` (the port's
``fake_quantize`` keeps the eager form, bit-equal to the reference's
``fake_quantize``; the scales then differ by up to one ulp, so every QAT run
is held as tie-bound against the reference).  Port against port (solo,
batched, masked) is exact.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doi_rule import hold, replay
from repro import api as ref_api
from repro import train as ref_train
from repro.core import learning as ref_learning
from repro.core import quantization as ref_quant
from repro.data import patterns as ref_patterns
from repro_torch import api, train
from repro_torch import engine as engine_lib
from repro_torch.checkpoint.onn import load_onn, save_onn
from repro_torch.core import dynamics, learning, quantization
from repro_torch.engine import adapters


def _patterns(seed, p: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(rng.random((p, n)) < 0.5, 1, -1).astype(np.int8)


def _ref(xi, cfg: train.TrainConfig, **kw):
    """The reference's ``train_doi`` on the same numpy library and config."""
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return ref_train.train_doi(jnp.asarray(xi), ref_train.TrainConfig(**dataclasses.asdict(cfg)),
                               **kw)


def _int8(bits: int):
    return lambda w: quantization.quantize_weights(
        torch.as_tensor(np.asarray(w)), bits).values


def _held(xi, cfg: train.TrainConfig, port, ref, lr=None, n_patterns=None) -> str:
    """Hold one library's port and reference results under the rule."""
    rp = replay(xi, **dataclasses.asdict(cfg), lr=lr, n_patterns=n_patterns,
                fake_quantize=quantization.fake_quantize)
    if cfg.qat_bits:  # the scales differ by an ulp: held as tie-bound
        rp = dataclasses.replace(rp, ties=rp.ties or [(-1, -1, -1, 0.0, 0.0)])
    return hold(port, ref, rp, cfg.threshold, quantize=_int8(5))


# ---------------------------------------------------------------------------
# The paper's libraries and seeded random ones, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["5x4", "7x6", "10x10"])
def test_paper_libraries_follow_the_rule(name):
    """DO-I with ``diederich_opper_i``'s defaults (self-coupling on) on the
    paper's letter sets; the wrapper equals ``train_doi`` under that config
    exactly.  All three hold checks that tie the threshold within the bound;
    10x10 is port fault 2 (ROADMAP.md §3): one update decided the other
    way, max |ΔW| = lr = 0.01, quantized weights differ."""
    xi = np.array(ref_patterns.load_dataset(name))
    cfg = train.TrainConfig(self_coupling=True)
    port = train.train_doi(xi, cfg, device="cpu")
    wrapper = learning.diederich_opper_i(xi, device="cpu")
    for f in learning.DOResult._fields:
        assert torch.equal(getattr(wrapper, f), getattr(port, f)), f
    assert _held(xi, cfg, port, _ref(xi, cfg)) == "tie_bound"
    assert bool(port.converged) and int(port.sweeps) >= 1
    if name == "10x10":
        rp = replay(xi, self_coupling=True)
        assert rp.ties[0][:2] == (0, 4)  # the first tie: sweep 0, pattern 4


#: Seeded random libraries: P in [2, 8], N in [12, 40] (odd and even).
LIBRARIES = [int(s) for s in range(24)]


@pytest.mark.parametrize("seed", LIBRARIES)
def test_random_libraries_follow_the_rule(seed):
    """Self-coupling on and off, QAT off and at 5 bits.  With self-coupling
    off and N odd every κ·N is an even integer in exact arithmetic (it
    starts at (N−1) + a sum of (N−1)(P−1) signs, and each update adds a sum
    of N−1 signs), never N: those runs are tie-free, and must be exact."""
    rng = np.random.default_rng([seed, 5])
    p, n = int(rng.integers(2, 9)), int(rng.integers(12, 41))
    xi = np.where(rng.random((p, n)) < 0.5, 1, -1).astype(np.int8)
    kinds = {}
    for sc in (False, True):
        for qat in (0, 5):
            cfg = train.TrainConfig(self_coupling=sc, qat_bits=qat)
            port = train.train_doi(xi, cfg, device="cpu")
            kinds[(sc, qat)] = _held(xi, cfg, port, _ref(xi, cfg))
            assert bool(port.converged)
    if n % 2:
        assert kinds[(False, 0)] == "tie_free"


def test_fake_quantize_is_the_references_on_trained_weights():
    """The QAT projection itself: the port's ``fake_quantize`` equals the
    reference's (eager) on both packages' trained shadow weights, exactly."""
    for seed in range(4):
        xi = _patterns(seed, 6, 28)
        cfg = train.TrainConfig(qat_bits=5)
        for w in (train.train_doi(xi, cfg, device="cpu").weights,
                  torch.as_tensor(np.asarray(_ref(xi, cfg).weights))):
            for bits in (4, 5, 8):
                np.testing.assert_array_equal(
                    quantization.fake_quantize(w, bits).numpy(),
                    np.asarray(ref_quant.fake_quantize(jnp.asarray(w.numpy()), bits)))


# ---------------------------------------------------------------------------
# Batching, masking, lr: port against itself (exact) and the reference
# ---------------------------------------------------------------------------


def test_batched_libraries_equal_solo_and_follow_the_rule():
    """A (L, P, N) batch with per-library counts equals each solo call
    exactly; a converged library stops changing and counting while the
    others sweep; each library holds against the reference's batch."""
    libs = np.stack([_patterns(s, 6, 21) for s in range(3)] + [_patterns(0, 6, 21)])
    counts = np.asarray([6, 4, 2, 6], np.int32)
    cfg = train.TrainConfig()
    batched = train.train_doi(libs, cfg, n_patterns=counts, device="cpu")
    ref = _ref(libs, cfg, n_patterns=counts)
    assert len(set(batched.sweeps.tolist())) > 1  # some stopped while others swept
    for i in range(len(libs)):
        solo = train.train_doi(libs[i], cfg, n_patterns=int(counts[i]), device="cpu")
        for f in train.TrainResult._fields:
            np.testing.assert_array_equal(getattr(batched, f)[i].numpy(),
                                          getattr(solo, f).numpy(), err_msg=f)
        one = train.TrainResult(*(x[i] for x in batched))
        ref_one = ref_train.TrainResult(*(x[i] for x in ref))
        assert _held(libs[i], cfg, one, ref_one, n_patterns=int(counts[i])) == "tie_free"


def test_masked_padding_matches_sliced_library():
    """Trailing masked rows are invisible: a padded (P_max, N) library with
    n_patterns=k equals training xi[:k], field for field."""
    xi = _patterns(1, 8, 25)
    cfg = train.TrainConfig()
    full = train.train_doi(xi[:5], cfg, device="cpu")
    masked = train.train_doi(xi, cfg, n_patterns=5, device="cpu")
    for f in train.TrainResult._fields:
        np.testing.assert_array_equal(getattr(full, f).numpy(), getattr(masked, f).numpy())
    assert _held(xi, cfg, masked, _ref(xi, cfg, n_patterns=5), n_patterns=5) == "tie_free"


def test_lr_is_per_call():
    """``lr`` is an argument of each call; ``lr=None`` means 1/N of this
    call's N, equal to passing it."""
    xi = _patterns(2, 5, 29)
    cfg = train.TrainConfig()
    a = train.train_doi(xi, cfg, lr=0.05, device="cpu")
    b = train.train_doi(xi, cfg, lr=0.25, n_patterns=3, device="cpu")
    assert not torch.equal(a.weights, b.weights)
    assert _held(xi, cfg, a, _ref(xi, cfg, lr=0.05), lr=0.05) == "tie_free"
    small = _patterns(3, 4, 15)
    default = train.train_doi(small, cfg, device="cpu")
    explicit = train.train_doi(small, cfg, lr=1.0 / 15, device="cpu")
    assert torch.equal(default.weights, explicit.weights)


def test_qat_margins_survive_quantization():
    """QAT convergence is measured on the 5-bit projection, so the quantized
    network holds the patterns: every pattern is a strict fixed point of the
    int8 sign dynamics and the dequantized margins meet the threshold."""
    xi = _patterns(4, 10, 40)
    res = train.train_doi(xi, train.TrainConfig(qat_bits=5), device="cpu")
    assert bool(res.converged) and float(res.kappa_min) >= 1.0
    qw = quantization.quantize_weights(res.weights, 5)
    assert bool(learning.patterns_are_fixed_points(qw.values, torch.as_tensor(xi)))


def test_self_coupling_off_keeps_the_diagonal_empty():
    """With self_coupling=False the stored couplings have no diagonal and the
    port's own stability check (``kappa_min``, the trainer's product) holds
    every pattern.  The fixture is not the reference's fault-3 one."""
    xi = _patterns(16, 8, 23)
    res = train.train_doi(xi, train.TrainConfig(self_coupling=False), device="cpu")
    assert bool(res.converged) and float(res.kappa_min) >= 1.0
    np.testing.assert_array_equal(torch.diagonal(res.weights).numpy(), np.zeros(23, np.float32))


def test_train_config_validation():
    for cls in (train.TrainConfig, ref_train.TrainConfig):
        with pytest.raises(ValueError, match="threshold"):
            cls(threshold=0.0)
        with pytest.raises(ValueError, match="max_sweeps"):
            cls(max_sweeps=0)
        with pytest.raises(ValueError, match="qat_bits"):
            cls(qat_bits=1)
    assert [f.name for f in dataclasses.fields(train.TrainConfig)] == [
        f.name for f in dataclasses.fields(ref_train.TrainConfig)]
    assert train.TrainConfig() == train.TrainConfig(**dataclasses.asdict(ref_train.TrainConfig()))
    with pytest.raises(ValueError, match="xi"):
        train.train_doi(np.zeros((4,)), device="cpu")
    with pytest.raises(ValueError, match="n_patterns"):
        train.train_doi(_patterns(0, 4, 10), n_patterns=np.asarray([2, 2]), device="cpu")


def test_legacy_wrapper_defaults_resolve_per_call():
    """``diederich_opper_i`` delegates to ``train_doi`` with its own
    arguments (lr resolved per call) and follows the rule against the
    reference's wrapper."""
    xi = _patterns(7, 4, 17)
    res = learning.diederich_opper_i(xi, self_coupling=False, device="cpu")
    ref = ref_learning.diederich_opper_i(jnp.asarray(xi), self_coupling=False)
    assert torch.equal(res.weights, train.train_doi(xi, device="cpu").weights)
    rp = replay(xi)
    assert rp.tie_free and not rp.weights[np.diag_indices(17)].any()
    np.testing.assert_array_equal(res.weights.numpy(), np.asarray(ref.weights))
    np.testing.assert_array_equal(res.weights.numpy(), rp.weights)
    assert int(res.sweeps) == int(ref.sweeps) == rp.sweeps and bool(res.converged)


# ---------------------------------------------------------------------------
# The train → serve seam
# ---------------------------------------------------------------------------


def _tie_free_library():
    """A library whose default DO-I run (self-coupling on) is tie-free."""
    for seed in range(40):
        xi = _patterns([seed, 9], 3, 17)
        if replay(xi, self_coupling=True).tie_free:
            return xi
    raise AssertionError("no tie-free library among the seeds")


def test_trained_params_and_from_patterns_equal_reference():
    """Given equal float weights the serving format is exact: the port's
    ``trained_params`` on the reference's trained weights equals the
    reference's, and ``from_patterns`` on a tie-free library equals
    ``repro.api.RetrievalSolver.from_patterns`` (config and int8 params)."""
    xi = _patterns(8, 4, 16)
    ref = _ref(xi, train.TrainConfig(qat_bits=5))
    cfg = dynamics.ONNConfig(n=16)
    params, qw = train.trained_params(cfg, torch.as_tensor(np.asarray(ref.weights)))
    ref_params, ref_qw = ref_train.trained_params(ref_api.ONNConfig(n=16), ref.weights)
    assert params.weights.dtype == torch.int8 and qw.bits == cfg.weight_bits
    np.testing.assert_array_equal(params.weights.numpy(), np.asarray(ref_params.weights))
    np.testing.assert_array_equal(qw.scale.numpy(), np.asarray(ref_qw.scale))
    with pytest.raises(ValueError, match="weights"):
        train.trained_params(dynamics.ONNConfig(n=8), torch.as_tensor(np.asarray(ref.weights)))

    xi = _tie_free_library()
    solver = api.RetrievalSolver.from_patterns(xi, device="cpu", max_cycles=40)
    ref_solver = ref_api.RetrievalSolver.from_patterns(jnp.asarray(xi), max_cycles=40)
    assert dataclasses.asdict(solver.config) == dataclasses.asdict(ref_solver.config)
    np.testing.assert_array_equal(solver.params.weights.numpy(),
                                  np.asarray(ref_solver.params.weights))
    np.testing.assert_array_equal(solver.params.bias.numpy(), np.asarray(ref_solver.params.bias))


def test_xi_factory_trains_and_serves():
    """``install(name, "retrieval", xi=...)`` trains with ``from_patterns``
    and serves its requests exactly as that solver's isolated solve."""
    xi = _tie_free_library()
    eng = engine_lib.Engine(torch.Generator().manual_seed(0), device="cpu",
                            batch_buckets=(1, 2, 4))
    ad = eng.install("mem", "retrieval", xi=xi, device="cpu", max_cycles=30)
    assert isinstance(ad, adapters.RetrievalEngineSolver)
    solver = api.RetrievalSolver.from_patterns(xi, device="cpu", max_cycles=30)
    assert torch.equal(ad.solver.params.weights, solver.params.weights)
    probes = np.stack([xi[i % 3] * np.where(np.arange(17) % 5 == i, -1, 1) for i in range(3)])
    futs = [eng.submit(engine_lib.Request("mem", probes[i:i + 1 + i % 2])) for i in range(2)]
    eng.drain()
    for i, f in enumerate(futs):
        want = solver.solve(probes[i:i + 1 + i % 2])
        for name in dynamics.ONNResult._fields:
            assert torch.equal(getattr(f.result(), name), getattr(want, name)), name


def test_onn_checkpoint_round_trip_of_trained_weights(tmp_path):
    xi = _patterns(9, 5, 20)
    res = train.train_doi(xi, train.TrainConfig(qat_bits=5), device="cpu")
    cfg = dynamics.ONNConfig(n=20, max_cycles=64)
    params, qw = train.trained_params(cfg, res.weights)
    path = save_onn(str(tmp_path / "ckpt"), cfg, qw, params.bias, extra_meta={"sweeps": 7})
    ck = load_onn(path, device="cpu")
    assert ck.config == cfg and ck.meta == {"sweeps": 7} and ck.quantized.bits == qw.bits
    assert torch.equal(ck.quantized.values, qw.values)
    assert torch.equal(ck.quantized.scale, qw.scale)
    assert torch.equal(ck.params.bias, params.bias)
