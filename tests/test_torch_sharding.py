"""The port's ShardPlan, Mesh, placement and int8 wire on the CPU.

``repro_torch.distributed.plan`` is held to ``repro.distributed.plan``:
the same fields, properties, parse results and every validation error with
the reference's message.  ``repro_torch.distributed.sharding`` places the
coupling matrix as the reference's ``shard_onn_params`` does (row blocks
when N divides the model degree, replicated otherwise) and never copies W
per call.  ``repro_torch.optim.compress`` is held with ``==`` against the
reference's functions as they run in its solves, compiled: ``quantize``,
``ef_compress``, the wire's ``q`` and ``scale``, ``compressed_psum_scatter``
(under ``jax.vmap`` over a named axis, which binds its collectives on one
device) and ``compressed_psum_mean`` (here on 1 shard; on 3 and 8 shards in
``tests/test_torch_model_parallel.py``).  Meshes repeat the CPU
(``["cpu"] * 8``), as the reference's tests force 8 host devices.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import plan as ref_plan
from repro.optim import compress as ref_compress
from repro_torch.core import dynamics as dyn
from repro_torch.distributed import Mesh, ShardPlan, make_mesh, plan_of_legacy_shard_batch
from repro_torch.distributed import plan as port_plan
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.optim import compress

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


# ---------------------------------------------------------------------------
# ShardPlan and Mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,n_devices", [
    ("2x4", 8), ("1x8", 8), ("4x2", 8), (" 1X1 ", 1), ("3x1", 4), ("auto", 8), ("auto", 6),
    ("auto", 1), ("auto", 32), ("auto", 12),
])
def test_parse_equals_reference(spec, n_devices):
    """``parse`` gives the reference's plan, ``auto`` through the port's
    ``ft.propose_mesh``."""
    got = ShardPlan.parse(spec, n_devices=n_devices)
    want = ref_plan.ShardPlan.parse(spec, n_devices=n_devices)
    assert (got.batch, got.model, got.layout, got.compressed) == (
        want.batch, want.model, want.layout, want.compressed)
    assert (got.devices, got.model_sharded) == (want.devices, want.model_sharded)


@pytest.mark.parametrize("make", [
    lambda m: m.ShardPlan(batch=0),
    lambda m: m.ShardPlan(model=-1),
    lambda m: m.ShardPlan(layout="2d"),
    lambda m: m.ShardPlan.parse("2by4", n_devices=8),
    lambda m: m.ShardPlan.parse("x4", n_devices=8),
    lambda m: m.ShardPlan.parse("2x2", n_devices=1),
    lambda m: m.ShardPlan.parse("4x4", n_devices=8),
    lambda m: m.ShardPlan.auto(0),
], ids=["batch0", "model-1", "layout", "spec", "spec-x4", "2x2-on-1", "4x4-on-8", "auto-0"])
def test_validation_errors_equal_reference(make):
    """Every validation rule raises the reference's error, word for word."""
    with pytest.raises(ValueError) as want:
        make(ref_plan)
    with pytest.raises(ValueError) as got:
        make(port_plan)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch,model,layout,sharded", [
    (1, 1, "row", False), (1, 8, "row", True), (2, 4, "replicated", False), (4, 1, "row", False),
])
def test_plan_properties_and_specs(batch, model, layout, sharded):
    """``model_sharded``, the weight spec (a tuple of axis names for the
    reference's PartitionSpec) and the OnnParams-shaped specs."""
    plan = ShardPlan(batch, model, layout)
    want = ref_plan.ShardPlan(batch, model, layout)
    assert plan.model_sharded == want.model_sharded == sharded
    from repro.distributed import sharding as ref_sharding

    ref_spec = tuple(ref_sharding.onn_weight_spec(plan=want))
    assert sharding.onn_weight_spec(plan=plan) == ref_spec
    specs = sharding.onn_param_shardings(plan=plan)
    assert specs.weights == ref_spec and specs.bias == (None,)
    assert sharding.at_rest_spec(48, plan) == (("model", None) if sharded else (None, None))
    if sharded:
        assert sharding.at_rest_spec(50, plan) == ((None, None) if 50 % model else
                                                   ("model", None))


def test_one_card_machine_refuses_a_wider_mesh(monkeypatch):
    """On a one-card machine ``parse("2x2")`` raises as the reference does,
    and ``--mesh`` on the CPU counts one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices, only 1 available"):
        ShardPlan.parse("2x2")
    assert ShardPlan.parse("1x1").devices == 1
    with pytest.raises(ValueError, match="needs 2 devices, only 1 available"):
        ShardPlan.parse("1x2", device="cpu")
    assert plan_of_legacy_shard_batch() == ShardPlan(1, 1, "replicated")
    assert plan_of_legacy_shard_batch(4) == ShardPlan(4, 1, "replicated")
    assert ShardPlan.auto() == ShardPlan(1, 1)


def test_mesh_from_explicit_devices():
    """A mesh repeats a device only when the caller lists it; the grid is
    data-major, with the reference's axis names and shape."""
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.devices.shape == (2, 4)
    assert mesh.size == 8 and launch_mesh.mesh_devices(mesh) == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.first == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices, got 7"):
        make_mesh((2, 4), devices=["cpu"] * 7)
    with pytest.raises(ValueError, match="needs 8 devices, only 1 available"):
        make_mesh((2, 4), device="cpu")
    assert make_mesh((1, 1), device="cpu").key() == ("cpu",)
    assert launch_mesh.make_host_mesh(1, 2, devices=["cpu", "cpu"]).shape == {
        "data": 1, "model": 2}
    assert launch_mesh.build_shard_plan("1x1", device="cpu") == ShardPlan(1, 1)
    plan = ShardPlan(2, 2)
    assert launch_mesh.make_plan_mesh(plan, devices=["cpu"] * 4).shape == {"data": 2, "model": 2}
    assert isinstance(Mesh([["cpu"]]), Mesh)


def test_context_validates_and_nests():
    """``context`` refuses a mesh smaller than the plan (the reference's
    message) and restores the outer context on exit."""
    small = make_mesh((1, 1), devices=["cpu"])
    with pytest.raises(ValueError) as got:
        with ShardPlan(2, 1).context(small):
            pass
    with pytest.raises(ValueError) as want:
        with ref_plan.ShardPlan(2, 1).context(jax.make_mesh((1, 1), ("data", "model"))):
            pass
    assert str(got.value) == str(want.value)
    outer, inner = ShardPlan(1, 2), ShardPlan(2, 1)
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    assert sharding.current_plan() is None
    with outer.context(mesh) as m:
        assert m is mesh and sharding.current_plan() is outer
        # a plan carries the reference's minimal rule table (lanes → "data")
        assert sharding.current_rules() == {"batch": None}
        with inner.context(mesh):
            assert sharding.current_plan() is inner
            assert sharding.current_rules() == {"batch": "data"}
            with sharding.use_rules({"batch": "data"}):
                assert sharding.current_rules() == {"batch": "data"}
                assert sharding.current_plan() is None
        assert sharding.current_plan() is outer and sharding.current_mesh() is mesh
    assert sharding.current_plan() is None and sharding.current_mesh() is None


def test_shard_and_constrain_are_identities():
    x = torch.arange(6)
    params = dyn.OnnParams(torch.zeros((3, 3), dtype=torch.int8), torch.zeros(3, dtype=torch.int32))
    with ShardPlan(1, 2).context(make_mesh((1, 2), devices=["cpu"] * 2)):
        assert sharding.shard(x, "batch") is x
        assert sharding.constrain_onn(params) is params


# ---------------------------------------------------------------------------
# Placement of the coupling matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,model", [(48, 8), (50, 8), (4096, 8), (506, 4), (5, 8)])
def test_weight_blocks_cover_w_as_views(n, model):
    """Blocks of ``ceil(N / model)`` rows (the last shorter, possibly empty)
    that concatenate to W; on a mesh of one repeated device each is a view
    of W (no copy), and the placement of a 1/model share is ``N²/model``
    bytes when N divides."""
    w = torch.arange(n * n, dtype=torch.int32).reshape(n, n).to(torch.int8)
    plan = ShardPlan(1, model)
    mesh = make_mesh((1, model), devices=["cpu"] * model)
    placed = sharding.shard_onn_params(dyn.OnnParams(w, torch.zeros(n, dtype=torch.int32)),
                                       plan, mesh)
    assert placed.weights is w
    blocks = sharding.weight_blocks(w, plan, mesh)
    assert len(blocks) == 1 and len(blocks[0]) == model
    assert torch.equal(torch.cat(blocks[0], dim=0), w)
    blk = -(-n // model)
    assert [b.shape[0] for b in blocks[0]] == [
        max(0, min(blk, n - j * blk)) for j in range(model)]
    for b in blocks[0]:
        assert b.numel() == 0 or b.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    if n % model == 0:
        assert {b.nbytes for b in blocks[0]} == {n * n // model}


def test_weight_blocks_of_instances_and_data_rows():
    """A stack (I, M, N) splits its rows (axis −2); each data row of the
    mesh gets the model blocks, and a data-only plan gets W whole."""
    w = torch.arange(3 * 10 * 7, dtype=torch.int32).reshape(3, 10, 7).to(torch.int8)
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    blocks = sharding.weight_blocks(w, ShardPlan(2, 4), mesh)
    assert len(blocks) == 2 and all(len(r) == 4 for r in blocks)
    for row in blocks:
        assert torch.equal(torch.cat(row, dim=-2), w)
    whole = sharding.weight_blocks(w, ShardPlan(2, 4, layout="replicated"), mesh)
    assert [len(r) for r in whole] == [1, 1] and all(r[0] is not None for r in whole)
    assert all(torch.equal(r[0], w) for r in whole)


def test_placement_copies_once_into_the_params():
    """When blocks lie on another device than W they are copied once, by
    ``shard_onn_params``, into the params' placement, and every solve reads
    them from there; W without a placement (or another W) gets its blocks
    cut anew.  The other device is ``meta``, which holds shapes only."""
    n, model = 48, 4
    plan = ShardPlan(1, model)
    mesh = make_mesh((1, model), devices=["cpu"] + ["meta"] * (model - 1))
    params = dyn.OnnParams(torch.ones((n, n), dtype=torch.int8), torch.zeros(n, dtype=torch.int32))
    placed = sharding.shard_onn_params(params, plan, mesh)
    blocks = placed.placement.blocks
    assert placed.weights.device.type == "cpu" and blocks[0][0]._base is placed.weights
    assert all(b.device.type == "meta" and b.shape == (n // model, n) for b in blocks[0][1:])
    assert all(b._base is None for b in blocks[0][1:])  # row-sharded at rest: own blocks
    again = sharding.weight_blocks(placed.weights, plan, mesh, placement=placed.placement)
    assert all(a is b for a, b in zip(again[0], blocks[0]))  # no copy per call
    fresh = sharding.weight_blocks(placed.weights, plan, mesh)
    assert all(a is not b for a, b in zip(fresh[0][1:], blocks[0][1:]))
    other = sharding.weight_blocks(placed.weights.clone(), plan, mesh, placement=placed.placement)
    assert all(a is not b for a, b in zip(other[0], blocks[0]))
    # N not divisible: one full copy per other device, the blocks are its views.
    w = torch.ones((50, 50), dtype=torch.int8)
    blocks = sharding.weight_blocks(
        w, ShardPlan(1, 8), make_mesh((1, 8), devices=["cpu"] + ["meta"] * 7))
    bases = {id(b._base) for b in blocks[0][1:]}
    assert len(bases) == 1 and blocks[0][1]._base.shape == (50, 50)
    assert blocks[0][0].shape == (7, 50) and blocks[0][-1].shape == (1, 50)


# ---------------------------------------------------------------------------
# The int8 wire against the reference's functions
# ---------------------------------------------------------------------------


def _partials(seed: int, shape, hi: int):
    rng = np.random.default_rng(seed)
    return rng.integers(-hi, hi + 1, shape).astype(np.int32)


@pytest.mark.parametrize("seed,hi", [(0, 100), (1, 127), (2, 128), (3, 5000), (4, 300000),
                                     (5, 0)])
def test_quantize_and_ef_compress_equal_reference(seed, hi):
    """(q, scale) and the residual with ``==`` against the reference's
    functions compiled, as its solves and collectives run them (XLA turns
    ``absmax / 127`` into a product with the float32 reciprocal)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 33)) * hi).astype(np.float32)
    err = (rng.normal(size=(4, 33)) * 0.5).astype(np.float32)
    q, scale = compress.quantize(torch.as_tensor(x))
    rq, rscale = jax.jit(ref_compress.quantize)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.dtype == torch.float32 and scale.item() == float(rscale)
    got = compress.ef_compress(torch.as_tensor(x), torch.as_tensor(err))
    want = jax.jit(ref_compress.ef_compress)(jnp.asarray(x), jnp.asarray(err))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(
        compress.dequantize(q, scale).numpy(), np.asarray(ref_compress.dequantize(rq, rscale)))
    tree = compress.ef_init({"a": torch.ones(2, 3), "b": [torch.ones(4)]})
    assert tree["a"].shape == (2, 3) and tree["b"][0].shape == (4,)
    assert tree["a"].dtype == torch.float32 and not tree["a"].any()


def _ref_scatter(parts: np.ndarray) -> np.ndarray:
    """The reference's ``compressed_psum_scatter`` over the stacked
    per-block partials (blocks, ..., blk), with its named axis bound by
    ``jax.vmap``; returns block 0's (every block's) combined fields."""
    blocks = parts.shape[0]

    def one(part, idx):
        return ref_compress.compressed_psum_scatter(part, idx, blocks, "model")

    out = jax.jit(jax.vmap(one, axis_name="model"))(jnp.asarray(parts), jnp.arange(blocks))
    out = np.asarray(out)
    for k in range(1, blocks):
        np.testing.assert_array_equal(out[k], out[0])
    return out[0]


@pytest.mark.parametrize("seed,blocks,hi", [
    (0, 4, 100), (1, 8, 127), (2, 4, 5000), (3, 3, 300000), (4, 2, 128), (5, 4, 1271),
])
def test_wire_equals_reference_on_the_same_partials(seed, blocks, hi):
    """The wire's q and scale of each block, and the combined fields, with
    ``==`` against the reference's on the same partials; exact (the
    identity) while every partial fits in ±127."""
    parts = _partials(seed, (blocks, 6, 13), hi)
    tparts = [torch.as_tensor(p) for p in parts]
    got = compress.compressed_psum_scatter(tparts)
    assert len(got) == blocks and all(torch.equal(g, got[0]) for g in got)
    want = _ref_scatter(parts)
    np.testing.assert_array_equal(got[0].numpy(), want)
    for p, tp in zip(parts, tparts):
        q, scale = compress.wire_quantize(tp)
        # The reference's own arithmetic (compress.py:110-113), compiled.
        rs = jax.jit(lambda a: jnp.maximum(jnp.max(jnp.abs(a)).astype(jnp.float32) / 127.0,
                                           jnp.float32(1.0)))(jnp.asarray(p))
        rq = jax.jit(lambda a, s: jnp.clip(jnp.round(a / s), -127, 127).astype(jnp.int8))(
            jnp.asarray(p), rs)
        assert scale.item() == float(rs)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    if hi <= 127:
        np.testing.assert_array_equal(got[0].numpy(), np.concatenate(list(parts), axis=-1))


def test_wire_short_last_block_equals_reference_padded():
    """A short last block (M not divisible) combines as the reference's
    zero-padded one, sliced."""
    parts = _partials(9, (4, 5, 7), 2000)
    parts[-1, :, 4:] = 0  # the reference's padded columns
    want = _ref_scatter(parts)[..., :7 * 3 + 4]
    got = compress.compressed_psum_scatter(
        [torch.as_tensor(p) for p in parts[:-1]] + [torch.as_tensor(parts[-1][:, :4])])
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_compressed_psum_mean_one_shard_equals_reference():
    """On one shard the mean and residual equal the reference's under
    ``jax.vmap`` with a named axis of size 1."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 64)).astype(np.float32)
    e = (rng.normal(size=(1, 64)) * 0.01).astype(np.float32)
    fn = jax.jit(jax.vmap(functools.partial(ref_compress.compressed_psum_mean, axis_name="d"),
                          axis_name="d"))
    want_mean, want_err = fn(jnp.asarray(x), jnp.asarray(e))
    mean, err = compress.compressed_psum_mean([torch.as_tensor(x[0])], [torch.as_tensor(e[0])])
    np.testing.assert_array_equal(mean[0].numpy(), np.asarray(want_mean)[0])
    np.testing.assert_array_equal(err[0].numpy(), np.asarray(want_err)[0])


def test_ef_telescoping_identity():
    """Summed over shards and steps, the decoded means (× n) plus the final
    residuals give back the raw gradients: the quantization error is carried,
    never lost (the reference's ``test_compressed_collectives_roundtrip``)."""
    rng = np.random.default_rng(3)
    n = 8
    grads = [torch.as_tensor(rng.normal(size=(n, 64)).astype(np.float32)) for _ in range(4)]
    errs = [torch.zeros(64) for _ in range(n)]
    decoded = torch.zeros(64)
    for g in grads:
        means, errs = compress.compressed_psum_mean(list(g), errs)
        assert all(torch.equal(m, means[0]) for m in means)
        decoded = decoded + means[0] * float(n)
    raw = sum(grads).sum(dim=0)
    resid = float((decoded + torch.stack(errs).sum(dim=0) - raw).abs().max())
    assert resid < 1e-3


def test_distributed_modules_import_without_jax():
    """``repro_torch.distributed``, ``optim.compress`` and ``launch.mesh``
    import with ``jax`` and ``repro`` blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch.distributed, repro_torch.distributed.sharding\n"
        "import repro_torch.optim.compress, repro_torch.launch.mesh\n"
        "from repro_torch.distributed import ShardPlan, Mesh, plan_of_legacy_shard_batch\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
