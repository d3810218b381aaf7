"""The port's token stream (``repro_torch.data.tokens``) and general
checkpointer (``repro_torch.checkpoint``) against ``repro`` on the CPU.

Held with ``==``: the stream's batches (tokens and labels, dtype and
values), its host shards and its cursor; checkpoints written by one side and
restored by the other, every leaf bit for bit (bf16 included) under the
reference's keys, with the same manifest.  Retention, atomicity and the
async writer as ``tests/test_substrates.py`` holds the reference's.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.data.tokens import TokenStream as RefStream
from repro.models.steps import TrainState as RefTrainState
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.models.params import leaves
from repro_torch.models.steps import TrainState


def batches_equal(a, b) -> None:
    assert sorted(a) == sorted(b) == ["labels", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("vocab,batch,seq,seed,ngram", [
    (1000, 8, 32, 3, 8), (151646, 4, 128, 0, 8), (50, 2, 16, 7, 3), (32000, 6, 64, 11, 16)])
def test_stream_equals_reference(vocab, batch, seq, seed, ngram):
    port = TokenStream(vocab, batch, seq, seed=seed, ngram=ngram)
    ref = RefStream(vocab, batch, seq, seed=seed, ngram=ngram)
    try:
        for _ in range(4):
            batches_equal(port.next(), ref.next())
    finally:
        port.close()
        ref.close()


def test_host_shards_equal_reference():
    for host in range(2):
        port = TokenStream(100, 8, 16, seed=1, host_id=host, n_hosts=2)
        ref = RefStream(100, 8, 16, seed=1, host_id=host, n_hosts=2)
        try:
            a, b = port.next(), ref.next()
            assert a["tokens"].shape == (4, 16)
            batches_equal(a, b)
        finally:
            port.close()
            ref.close()
    with pytest.raises(ValueError):
        TokenStream(100, 7, 16, n_hosts=2)


def test_cursor_restore_and_iteration_equal_reference():
    port = TokenStream(1000, 8, 32, seed=3)
    for _ in range(3):
        port.next()
    state = port.state()
    assert state == {"cursor": 3, "seed": 3}
    port.close()
    resumed = TokenStream(1000, 8, 32, seed=3)
    resumed.restore(state)
    ref = RefStream(1000, 8, 32, seed=3)
    ref.restore(state)
    try:
        for _, a, b in zip(range(3), resumed, ref):
            batches_equal(a, b)
        assert resumed.state() == ref.state() == {"cursor": 6, "seed": 3}
        with pytest.raises(ValueError):
            resumed.restore({"cursor": 0, "seed": 4})
    finally:
        resumed.close()
        ref.close()


def test_labels_are_the_next_tokens():
    s = TokenStream(50, 2, 16, seed=0)
    b = s.next()
    s.close()
    assert b["tokens"][0, 1:].tolist() == b["labels"][0, :-1].tolist()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def ref_state(seed: int = 0):
    """A reference TrainState: bf16 and float32 params (stacked and not), an
    AdamW-shaped state with an int32 count."""
    rng = np.random.default_rng(seed)
    params = {
        "blocks": {"attn": {"wq": jnp.asarray(rng.standard_normal((2, 8, 4)), jnp.bfloat16)},
                   "ln1": jnp.asarray(rng.standard_normal((2, 8)), jnp.bfloat16)},
        "embed": jnp.asarray(rng.standard_normal((16, 8)), jnp.bfloat16),
        "router": jnp.asarray(rng.standard_normal((8, 4)), jnp.float32),
    }
    m = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)
    v = jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), params)
    opt = {"m": m, "v": v, "count": jnp.int32(7)}
    return RefTrainState(step=jnp.int32(7), params=params, opt=opt)


def port_of(tree):
    """A reference tree as CPU tensors, bit for bit, in the port's
    TrainState."""
    as_t = jax.tree.map(lambda a: convert._tensor_from_reference(np.asarray(a)), tree)
    return TrainState(step=as_t.step, params=as_t.params, opt=as_t.opt)


def flat_bits(tree) -> dict:
    """{//-joined key: int view of the leaf's bits}."""
    out = {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    for path, leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        else:
            a = np.asarray(leaf)
            a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        out[path.replace(".", "//")] = (a.dtype.name, a.shape, a.tobytes())
    return out


def test_port_checkpoint_restores_in_reference_bit_for_bit(tmp_path):
    d = str(tmp_path)
    want = ref_state(1)
    path = ckpt.save(d, 7, port_of(want), extra_meta={"data_state": {"cursor": 7, "seed": 0}})
    assert path == os.path.join(d, "step_7")
    got = ref_ckpt.restore(d, 7, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                                 want))
    assert flat_bits(got) == flat_bits(want)
    meta, ref_meta_keys = ref_ckpt.load_meta(d, 7), {"step", "n_leaves", "dtypes", "time"}
    assert ref_meta_keys <= set(meta) and meta["data_state"] == {"cursor": 7, "seed": 0}
    assert meta["dtypes"] == {"params//blocks//attn//wq": "bfloat16",
                              "params//blocks//ln1": "bfloat16", "params//embed": "bfloat16"}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert sorted(data.files) == sorted(flat_bits(want))


def test_reference_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    d = str(tmp_path)
    want = ref_state(2)
    ref_ckpt.save(d, 3, want, extra_meta={"data_state": {"cursor": 3, "seed": 0}})
    assert ckpt.latest_step(d) == 3 and ckpt.all_steps(d) == [3]
    target = port_of(ref_state(9))  # the structure and dtypes, other values
    got = ckpt.restore(d, 3, target, device="cpu")
    assert isinstance(got, TrainState)
    assert flat_bits(got) == flat_bits(want)
    assert got.params["embed"].dtype == torch.bfloat16 and got.step.dtype == torch.int32
    assert ckpt.load_meta(d, 3)["data_state"] == {"cursor": 3, "seed": 0}


def test_restore_casts_and_reports_a_missing_leaf(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.arange(4, dtype=torch.float32)})
    got = ckpt.restore(d, 1, {"w": torch.zeros(4, dtype=torch.float64)}, device="cpu")
    assert got["w"].dtype == torch.float64 and got["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        ckpt.restore(d, 1, {"w": torch.zeros(4), "b": torch.zeros(1)}, device="cpu")


class _Tree(NamedTuple):
    params: dict
    step: torch.Tensor


def _tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return _Tree(params={"w": torch.randn((8, 8), generator=g), "b": torch.zeros(8)},
                 step=torch.tensor(7, dtype=torch.int32))


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _tree(), keep=2)
    assert ckpt.all_steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir (crash mid-write) must not be seen as a checkpoint."""
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_2.tmp"))  # simulated crash
    assert ckpt.latest_step(d) == 1
    ckpt.save(d, 2, _tree(2))  # the stale tmp is replaced
    assert ckpt.all_steps(d) == [1, 2] and not os.path.exists(os.path.join(d, "step_2.tmp"))


def test_async_checkpointer_snapshots_at_save(tmp_path):
    d = str(tmp_path)
    saver = ckpt.AsyncCheckpointer(d, keep=2)
    tree = _tree(10)
    want = tree.params["w"].clone()
    saver.save(10, tree)
    tree.params["w"].add_(1.0)  # the write must hold the values at save()
    saver.save(20, _tree(20))
    saver.wait()
    assert ckpt.all_steps(d) == [10, 20]
    assert ckpt.load_meta(d, 20)["step"] == 20
    got = ckpt.restore(d, 10, _tree(), device="cpu")
    assert torch.equal(got.params["w"], want)


def test_async_checkpointer_surfaces_a_write_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(str(blocker))
    saver.save(1, _tree())
    with pytest.raises(OSError):
        saver.wait()


# ---------------------------------------------------------------------------
# restore onto a mesh (the reference's elastic restore)
# ---------------------------------------------------------------------------

#: Leaf → spec on a (data 2, model 4) mesh: split over one axis, over both
#: (one dim each, and two axes on one dim), replicated, and a scalar.
MESH_SPECS = {
    "params//blocks//attn//wq": (None, "data", "model"),
    "params//blocks//ln1": (None, "model"),
    "params//embed": (("data", "model"),),
    "params//router": ("data",),
    "opt//m//embed": ("model", None),
    "opt//v//router": (None, "model"),
    "opt//count": (),
    "step": None,
}

_REF_MESH_RESTORE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import checkpoint as ref_ckpt
directory, step, specs_json, out = sys.argv[1:5]
specs = json.loads(specs_json)
mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
meta = ref_ckpt.load_meta(directory, int(step))
data = np.load(f"{directory}/step_{step}/arrays.npz")
target = {k: jax.ShapeDtypeStruct(data[k].shape, jax.numpy.bfloat16 if meta["dtypes"].get(k)
                                  else data[k].dtype) for k in data.files}
def tree_of(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("//")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree
def named(s):
    return None if s is None else NamedSharding(
        mesh, P(*[tuple(e) if isinstance(e, list) else e for e in s]))
shard = {k: named(specs.get(k)) for k in data.files}
got = ref_ckpt.restore(directory, int(step), tree_of(target), tree_of(shard))
flat = {}
def walk(node, prefix):
    if isinstance(node, dict):
        for k in sorted(node):
            walk(node[k], prefix + [k])
    else:
        flat["//".join(prefix)] = node
walk(got, [])
saved = {}
for k, arr in flat.items():
    ids = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    for s in arr.addressable_shards:
        a = np.asarray(s.data)
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        saved[f"{k}@{ids[s.device.id]}"] = a
        saved[f"{k}@{ids[s.device.id]}@index"] = np.array(
            [[sl.start or 0, sl.stop if sl.stop is not None else n]
             for sl, n in zip(s.index, arr.shape)], dtype=np.int64).reshape(-1, 2)
np.savez(out, **saved)
"""


def test_restore_onto_a_mesh_equals_reference_block_by_block(tmp_path):
    import json
    import subprocess
    import sys

    from repro_torch.distributed import Mesh
    from repro_torch.distributed.sharding import NamedSharding, ShardedTensor, block_index
    from repro_torch.models import params as PM

    d = str(tmp_path / "ckpt")
    want = ref_state(5)
    ref_ckpt.save(d, 4, want)
    out = str(tmp_path / "ref_blocks.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _REF_MESH_RESTORE, d, "4", json.dumps(MESH_SPECS), out],
                   check=True, env=env, timeout=300)
    ref_blocks = np.load(out)

    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    target = port_of(ref_state(9))

    def sharding_of(path):
        spec = MESH_SPECS["//".join(path)]
        return None if spec is None else NamedSharding(mesh, spec)

    shardings = TrainState(
        step=sharding_of(["step"]),
        params={"blocks": {"attn": {"wq": sharding_of(["params", "blocks", "attn", "wq"])},
                           "ln1": sharding_of(["params", "blocks", "ln1"])},
                "embed": sharding_of(["params", "embed"]),
                "router": sharding_of(["params", "router"])},
        opt={"m": {"blocks": None, "embed": sharding_of(["opt", "m", "embed"]), "router": None},
             "v": {"blocks": None, "embed": None, "router": sharding_of(["opt", "v", "router"])},
             "count": sharding_of(["opt", "count"])})
    got = ckpt.restore(d, 4, target, device="cpu", shardings=shardings)
    flat_want = flat_bits(want)
    got_flat = dict(leaves({"step": got.step, "params": got.params, "opt": got.opt}))
    for path, leaf in got_flat.items():
        key = path.replace(".", "//")
        spec = MESH_SPECS.get(key)
        if spec is None:  # restored whole on the device, as without shardings
            assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
            assert flat_bits({"x": leaf})["x"] == flat_want[key], key
            continue
        assert isinstance(leaf, ShardedTensor) and leaf.blocks.shape == (2, 4), key
        sizes = {"data": 2, "model": 4}
        for pos in np.ndindex(2, 4):
            blk = leaf.blocks[pos]
            rank = pos[0] * 4 + pos[1]
            assert tuple(blk.shape) == PM.local_shape(leaf.shape, spec, sizes), key
            assert blk.device == mesh.devices[pos]
            a = blk.view(torch.int16).numpy() if blk.dtype == torch.bfloat16 else blk.numpy()
            np.testing.assert_array_equal(a, ref_blocks[f"{key}@{rank}"], err_msg=f"{key}@{pos}")
            index = [(s.start, s.stop) for s in block_index(leaf.shape, leaf.sharding, pos)]
            np.testing.assert_array_equal(np.array(index, dtype=np.int64).reshape(-1, 2),
                                          ref_blocks[f"{key}@{rank}@index"])

    # a split that does not divide raises as jax.device_put does
    with pytest.raises(ValueError, match="axis 1 is partitioned 8 times, but does not evenly "
                                         "divide the dimension size 4"):
        ckpt.restore(d, 4, target, device="cpu", shardings=TrainState(
            step=None, params={"blocks": None, "embed": None,
                               "router": NamedSharding(mesh, (None, ("data", "model")))},
            opt=None))
