"""The port's FPGA cost model and oscillator helpers against the JAX package.

``repro_torch.core.hardware_model`` is a copy of ``repro.core.hardware_model``
(pure Python): every public function must return the reference's value with
``==`` (tolerance 0) over a grid of oscillator counts N, MAC widths P and two
bit configurations, and the calibration pins of ``tests/test_hardware_model.py``
(paper Tables 4 and 5) must hold on the port's copy.  The oscillator helpers
``phase_step_degrees`` and ``oscillator_period`` must equal the reference's,
and the explicit shift register ``ShiftRegisterOscillator`` (a numpy oracle)
must equal both packages' copy and the port's counter model (``free_run`` /
``amplitude``), exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hardware_model as ref_hw
from repro.core import oscillator as ref_osc
from repro_torch.core import hardware_model as hw
from repro_torch.core import oscillator as osc

GRID_N = (8, 48, 100, 506, 1024, 4096)
GRID_P = (1, 8, 32)
#: Two bit configurations: the paper's (5-bit weights, 4-bit phases) and a
#: wider one.
BITS = ((5, 4), (8, 6))
ARCHS = ("recurrent", "hybrid")


def _bits(pair):
    return hw.BitConfig(*pair), ref_hw.BitConfig(*pair)


@pytest.mark.parametrize("bits", BITS, ids=lambda b: f"w{b[0]}p{b[1]}")
@pytest.mark.parametrize("p", GRID_P)
@pytest.mark.parametrize("n", GRID_N)
def test_every_function_equals_reference(n, p, bits):
    """Each public function of the model, called with the same arguments in
    both packages, returns the same value (dicts, floats, bools: ``==``)."""
    pb, rb = _bits(bits)
    assert pb.registers_per_oscillator == rb.registers_per_oscillator
    assert hw.recurrent_resources(n, pb) == ref_hw.recurrent_resources(n, rb)
    assert hw.hybrid_resources(n, pb, p) == ref_hw.hybrid_resources(n, rb, p)
    for arch in ARCHS:
        assert hw.resources(arch, n, pb, p) == ref_hw.resources(arch, n, rb, p)
        assert hw.oscillation_frequency(arch, n, pb, p) == ref_hw.oscillation_frequency(
            arch, n, rb, p)
        for cycles in (1, 100, 37.5):
            assert hw.time_to_solution(arch, n, cycles, pb, p) == ref_hw.time_to_solution(
                arch, n, cycles, rb, p)
        assert hw.fits(arch, n, pb, parallel=p) == ref_hw.fits(arch, n, rb, parallel=p)
        assert hw.utilization(arch, n, pb, parallel=p) == ref_hw.utilization(
            arch, n, rb, parallel=p)
        assert hw.area_fraction(arch, n, pb) == ref_hw.area_fraction(arch, n, rb)
    for boards in (1, 2, 4, 64):
        assert hw.partitioned_resources(n, boards, pb, p) == ref_hw.partitioned_resources(
            n, boards, rb, p)
        assert hw.partition_fits(n, boards, pb, parallel=p) == ref_hw.partition_fits(
            n, boards, rb, parallel=p)
        assert hw.partitioned_time_to_solution(n, boards, 100.0, pb, p) == (
            ref_hw.partitioned_time_to_solution(n, boards, 100.0, rb, p))
    assert hw.min_boards(n, pb, parallel=p) == ref_hw.min_boards(n, rb, parallel=p)
    assert hw._acc_width(n, pb.weight_bits) == ref_hw._acc_width(n, rb.weight_bits)


@pytest.mark.parametrize("bits", BITS, ids=lambda b: f"w{b[0]}p{b[1]}")
@pytest.mark.parametrize("p", GRID_P)
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch, p, bits):
    """``max_oscillators`` (a search over ``fits``) lands on the same N, with
    the default budget and with a halved one."""
    pb, rb = _bits(bits)
    half = {k: v // 2 for k, v in hw.ZYNQ_7020.items()}
    assert hw.max_oscillators(arch, pb, parallel=p) == ref_hw.max_oscillators(
        arch, rb, parallel=p)
    assert hw.max_oscillators(arch, pb, budget=half, parallel=p) == ref_hw.max_oscillators(
        arch, rb, budget=dict(half), parallel=p)


def test_constants_and_fit_equal_reference():
    assert hw.ZYNQ_7020 == ref_hw.ZYNQ_7020
    assert dataclasses.astuple(hw.BitConfig()) == dataclasses.astuple(ref_hw.BitConfig())
    constants = [name for name in dir(ref_hw) if name.startswith("_") and name[1:].isupper()]
    assert len(constants) >= 15
    for name in constants:  # the calibrated costs, ceilings and link widths
        assert getattr(hw, name) == getattr(ref_hw, name), name
    ns = [8, 16, 32, 64, 96, 128, 192, 256, 384, 506]
    luts = [hw.hybrid_resources(n)["lut"] for n in ns]
    assert hw.loglog_slope(ns, luts) == ref_hw.loglog_slope(ns, luts)


def test_errors_match_reference():
    for fn in (lambda m: m.hybrid_resources(16, parallel=0),
               lambda m: m.oscillation_frequency("hybrid", 16, parallel=-1),
               lambda m: m.resources("systolic", 16),
               lambda m: m.time_to_solution("systolic", 16, 1),
               lambda m: m.partitioned_resources(64, 0),
               lambda m: m.partitioned_time_to_solution(64, -1, 10.0)):
        with pytest.raises(ValueError):
            fn(hw)
        with pytest.raises(ValueError):
            fn(ref_hw)


# ---------------------------------------------------------------------------
# The calibration pins of tests/test_hardware_model.py, on the port's copy
# ---------------------------------------------------------------------------

TABLE4_RECURRENT_48 = {"lut": 49_441, "ff": 13_906, "dsp": 0, "bram": 0}
TABLE4_HYBRID_506 = {"lut": 41_547, "ff": 44_748, "dsp": 220, "bram": 140}


def test_table4_and_table5_pins():
    assert hw.recurrent_resources(48) == TABLE4_RECURRENT_48
    assert hw.hybrid_resources(506) == TABLE4_HYBRID_506
    assert hw.hybrid_resources(506, parallel=1) == TABLE4_HYBRID_506
    assert hw.max_oscillators("recurrent") == 48
    assert hw.max_oscillators("hybrid") == 506
    assert hw.max_oscillators("hybrid") / hw.max_oscillators("recurrent") == pytest.approx(
        10.5, abs=0.1)
    assert hw.oscillation_frequency("recurrent", 48) == pytest.approx(625e3, rel=0.01)
    assert hw.oscillation_frequency("hybrid", 506) == pytest.approx(6.1e3, rel=0.02)
    assert hw.fits("recurrent", 48) and not hw.fits("recurrent", 49)
    assert hw.fits("hybrid", 506) and not hw.fits("hybrid", 507)


def test_scaling_and_partition_pins():
    ns_rec = [8, 12, 16, 20, 24, 32, 40, 48]
    ns_hyb = [8, 16, 32, 64, 96, 128, 192, 256, 384, 506]
    rec, rec_r2 = hw.loglog_slope(ns_rec, [hw.recurrent_resources(n)["lut"] for n in ns_rec])
    hyb, hyb_r2 = hw.loglog_slope(ns_hyb, [hw.hybrid_resources(n)["lut"] for n in ns_hyb])
    assert rec == pytest.approx(2.08, abs=0.15) and hyb == pytest.approx(1.22, abs=0.15)
    assert rec_r2 > 0.99 and hyb_r2 > 0.99 and rec - hyb > 0.7
    tts = hw.time_to_solution("hybrid", 506, 100)
    assert tts == pytest.approx(100 / hw.oscillation_frequency("hybrid", 506))
    assert hw.time_to_solution("recurrent", 48, 100) < tts / 50
    caps = [hw.max_oscillators("hybrid", parallel=p) for p in (1, 8, 32)]
    assert caps[0] == 506 and caps[0] > caps[1] > caps[2]
    k = hw.min_boards(507)
    assert k is not None and k > 1 and hw.partition_fits(507, k)
    assert not hw.partition_fits(507, k // 2)
    k4096 = hw.min_boards(4096)
    r = hw.partitioned_resources(4096, k4096)
    assert all(r[key] <= hw.ZYNQ_7020[key] for key in r)
    for n in (48, 506):
        assert hw.partitioned_resources(n, 1) == hw.hybrid_resources(n)


# ---------------------------------------------------------------------------
# Oscillator helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase_bits", [1, 2, 4, 6, 8])
def test_oscillator_helpers_equal_reference(phase_bits):
    assert osc.phase_step_degrees(phase_bits) == ref_osc.phase_step_degrees(phase_bits)
    for t_clock in (1e-8, 2e-8, 1 / 50e6):
        assert osc.oscillator_period(t_clock, phase_bits) == ref_osc.oscillator_period(
            t_clock, phase_bits)
    assert osc.phase_step_degrees() == ref_osc.phase_step_degrees() == 22.5
    assert osc.oscillator_period(1e-8) == ref_osc.oscillator_period(1e-8)


@pytest.mark.parametrize("phase_bits", [2, 4])
def test_shift_register_equals_counter_model(phase_bits):
    """Clocking the register equals ``free_run`` of the counter, tap k equals
    the amplitude at θ + k, and the register state equals the reference's."""
    n = osc.n_positions(phase_bits)
    for tap in range(n):
        reg = osc.ShiftRegisterOscillator(phase_bits=phase_bits, tap=tap)
        ref_reg = ref_osc.ShiftRegisterOscillator(phase_bits=phase_bits, tap=tap)
        for theta in range(n):
            reg.set_phase(theta)
            ref_reg.set_phase(theta)
            np.testing.assert_array_equal(reg.registers, ref_reg.registers)
            for clocks in range(2 * n):
                lab = osc.free_run(torch.tensor(theta + tap, dtype=torch.uint8), clocks,
                                   phase_bits)
                assert reg.output() == int(osc.amplitude(lab, phase_bits))
                reg.clock()
                ref_reg.clock()
            np.testing.assert_array_equal(reg.registers, ref_reg.registers)
