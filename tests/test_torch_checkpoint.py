"""The port's checkpoints load in the reference, and its packages re-export
what the reference's re-export (CPU).

A checkpoint the port saves on any route, the kernel route included, must
load in ``repro.checkpoint.load_onn`` as the reference's config with
``"pallas"`` in place of ``"kernel"``, and reload in the port to an equal
config with equal int8 weights, bias and scale (exactly).  Every name that
``repro.core``, ``repro.data`` and ``repro.checkpoint`` re-export, where its
module is ported, imports from the port's package of the same name.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.checkpoint as ref_checkpoint_pkg
import repro.core as ref_core_pkg
import repro.data as ref_data_pkg
from repro.core import dynamics as ref_dyn
from repro_torch import convert
from repro_torch.checkpoint import onn as port_ckpt
from repro_torch.core import dynamics as port_dyn
from repro_torch.core import quantization as port_quant

ROUTES = [
    ("parallel", "scan"),
    ("serial", "scan"),
    ("kernel", "scan"),
    ("hybrid", "scan"),
    ("hybrid", "kernel"),
]


@pytest.mark.parametrize("backend,hybrid_impl", ROUTES)
def test_port_checkpoint_loads_in_reference(tmp_path, backend, hybrid_impl):
    rng = np.random.default_rng(len(backend) + len(hybrid_impl))
    cfg = port_dyn.ONNConfig(n=20, backend=backend, hybrid_impl=hybrid_impl, max_cycles=40,
                             parallel_factor=8 if backend == "hybrid" else 0)
    qw = port_quant.quantize_weights(torch.as_tensor(rng.standard_normal((20, 20)),
                                                     dtype=torch.float32))
    bias = rng.integers(-2, 3, size=20).astype(np.int32)
    path = port_ckpt.save_onn(str(tmp_path / "port"), cfg, qw, bias, extra_meta={"who": "port"})

    ref = ref_checkpoint_pkg.load_onn(path)
    names = {"kernel": "pallas"}
    want = ref_dyn.ONNConfig(**{
        **dataclasses.asdict(cfg),
        "backend": names.get(backend, backend),
        "hybrid_impl": names.get(hybrid_impl, hybrid_impl),
    })
    assert ref.config == want
    assert convert.config_to_reference(cfg) == dataclasses.asdict(want)
    np.testing.assert_array_equal(np.asarray(ref.params.weights), qw.values.numpy())
    np.testing.assert_array_equal(np.asarray(ref.params.bias), bias)
    assert ref.meta == {"who": "port"}

    again = port_ckpt.load_onn(path, device="cpu")
    assert again.config == cfg
    assert torch.equal(again.params.weights, qw.values)
    assert torch.equal(again.params.bias, torch.as_tensor(bias))
    assert torch.equal(again.quantized.scale, qw.scale)
    assert again.quantized.bits == qw.bits


def test_config_to_reference_inverts_config_from_reference():
    for backend, hybrid_impl in ROUTES:
        cfg = port_dyn.ONNConfig(n=33, backend=backend, hybrid_impl=hybrid_impl,
                                 phase_pack=True, settle_chunk=3)
        assert convert.config_from_reference(convert.config_to_reference(cfg)) == cfg


#: Each reference package's re-exports whose modules the port has.  The
#: general checkpointer of ``repro.checkpoint`` (``save``, ``restore``,
#: ``latest_step``, ``AsyncCheckpointer``) waits for the LM side.
REEXPORTS = [
    ("core", name) for name in (
        "BACKENDS", "ONNConfig", "ONNResult", "OnnParams", "OnnState", "async_sweep",
        "functional_update", "init_state", "initial_phase", "make_params", "retrieve", "run",
        "run_batch", "sign_update", "step", "validate_weights", "weighted_sum",
        "QuantizedWeights", "quantize_weights", "pack_int4", "unpack_int4",
        "diederich_opper_i", "hebbian", "hamiltonian", "is_local_minimum",
    )
] + [("data", name) for name in ("DATASET_SHAPES", "corrupt", "corrupt_batch", "load_dataset")] + [
    ("checkpoint", name) for name in ("OnnCheckpoint", "load_onn", "save_onn")
]
REFERENCE = {"core": ref_core_pkg, "data": ref_data_pkg, "checkpoint": ref_checkpoint_pkg}


@pytest.mark.parametrize("package,name", REEXPORTS)
def test_package_reexports_what_the_reference_does(package, name):
    ref_obj = getattr(REFERENCE[package], name)
    port_obj = getattr(importlib.import_module(f"repro_torch.{package}"), name)
    # The port's object is its own (same name), never the reference's.
    assert getattr(port_obj, "__name__", name) == getattr(ref_obj, "__name__", name)
    assert not getattr(port_obj, "__module__", "repro_torch").startswith("repro.")


def test_reexport_list_covers_the_reference_core():
    """Every public name ``repro.core`` re-exports is in the list above."""
    names = {n for n in vars(ref_core_pkg) if not n.startswith("_")}
    modules = {n for n in names if isinstance(getattr(ref_core_pkg, n), type(ref_core_pkg))}
    assert names - modules == {name for pkg, name in REEXPORTS if pkg == "core"}
