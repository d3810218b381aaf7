"""The port's optimizers (``repro_torch.optim``) and the error-feedback
gradient mean (``repro_torch.optim.compress.compressed_grads``) against
``repro`` on the CPU.

On identical numpy inputs (gradients, state and params), every output is
held by the optimizer rule of ``tests/train_rule.py``: float32 values within
4 ulps elementwise (plus, for Adafactor, its reductions' error on the
update), bf16 params at most one bf16 ulp apart.  The trees hold factored
Adafactor leaves — a stacked (3, 128, 256) leaf and a (130, 129) one, since
the reduced configs' widths never reach ``_FACTOR_MIN_SIZE`` — beside small
and bf16 leaves; each optimizer takes a first step from zero state and a
second from the reference's state after it, so the bias corrections and
Adafactor's decay run at count 2.  Every float32 parameter leaf is also
shown to fail the rule when left as it was (a no-op update), and a float32
stacked leaf to fail it when clipped block by block.  ``compressed_grads`` is
held with ``==`` to the reference's, run on 8 forced host devices in a
subprocess.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.models.params import ParamSpec as RefSpec
from repro_torch import convert
from repro_torch import optim
from repro_torch.distributed import make_mesh
from repro_torch.models.params import ParamSpec, leaves
from repro_torch.optim import compress
from train_rule import gamma, hold_update

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

#: (shape, dtype) of each leaf of the test tree, nested as a parameter tree.
LEAVES = {
    "blocks": {"w": ((3, 128, 256), "bfloat16"), "b": ((3, 256), "float32")},
    "wide": ((130, 129), "float32"),
    "small": ((4, 8), "bfloat16"),
    "bias": ((7,), "float32"),
}


def np_tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)

    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        shape, dtype = spec
        return (scale * rng.standard_normal(shape)).astype(np.float32), dtype

    return draw(LEAVES)


def to_ref(tree):
    if isinstance(tree, dict):
        return {k: to_ref(v) for k, v in tree.items()}
    values, dtype = tree
    return jnp.asarray(values).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def to_port(ref_tree):
    """The reference's tree bit for bit as CPU tensors."""
    if isinstance(ref_tree, dict):
        return {k: to_port(v) for k, v in ref_tree.items()}
    return convert._tensor_from_reference(np.asarray(ref_tree))


def hold_trees(got, want, what: str, before=None, reductions: bool = False,
               decay: float = 0.0, state: bool = False) -> int:
    """Every leaf by the optimizer rule, ulps at the leaf's magnitude
    before the update too (``before``: the tree the update started from).
    ``reductions``: Adafactor's, whose row and column means and RMS are
    float32 sums of at most a leaf's elements (4γ_n relative on the
    update, n the parameter leaf's size).  ``decay``: lr · weight decay;
    ``state``: the trees are optimizer states (``hold_update``)."""
    flat_got = dict(leaves(got))
    flat_want = dict(leaves(jax.tree.map(np.asarray, want)))
    flat_before = {} if before is None else dict(leaves(jax.tree.map(np.asarray, before)))
    sizes = {k: int(np.prod(shape)) for k, (shape, _) in leaves(LEAVES)}
    assert sorted(flat_got) == sorted(flat_want), what

    def rel(k):  # the parameter leaf a state leaf belongs to: its path inside k's
        size = [n for p, n in sizes.items() if f".{p}." in f".{k}."]
        return 4 * gamma(size[0]) if reductions and size else 0.0

    return sum(hold_update(flat_got[k], flat_want[k], f"{what} {k}", rel(k),
                           before=flat_before.get(k), decay=decay, state=state)
               for k in flat_want)


def ref_state_to_port(state):
    """An optimizer state of the reference (counts included) as tensors."""
    return to_port(jax.tree.map(np.asarray, state))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 109, 110, 200])
def test_schedules_match_reference(step):
    for ref_fn, fn in (
        (ref_optim.constant(3e-4), optim.constant(3e-4)),
        (ref_optim.cosine_warmup(1.0, 10, 110, floor=0.1),
         optim.cosine_warmup(1.0, 10, 110, floor=0.1)),
        (ref_optim.cosine_warmup(3e-4, 2000, 100_000), optim.cosine_warmup(3e-4, 2000, 100_000)),
    ):
        want = jax.jit(ref_fn)(jnp.int32(step))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        hold_update(got, np.asarray(want), f"schedule at {step}")


def test_global_norm_and_clip_match_reference():
    """The norm within γ_{n−1} relative (n squared terms) and 4 ulps; the
    clipped leaves within that plus 4 ulps; under the clip norm, the leaves
    in float32 unscaled."""
    ref = to_ref(np_tree(1, scale=0.3))
    port = to_port(ref)
    n = sum(int(np.prod(shape)) for _, (shape, _) in leaves(LEAVES))
    rel = gamma(n - 1)
    norm = optim.global_norm(port)
    hold_update(norm, np.asarray(jax.jit(ref_optim.global_norm)(ref)), "global_norm", rel)
    for max_norm in (1.0, 1e3):
        (clipped, got_n), (ref_clipped, ref_n) = (
            optim.clip_by_global_norm(port, max_norm),
            jax.jit(ref_optim.clip_by_global_norm, static_argnums=1)(ref, max_norm))
        hold_update(got_n, np.asarray(ref_n), "clip norm", rel)
        flat_want = dict(leaves(jax.tree.map(np.asarray, ref_clipped)))
        for k, v in leaves(clipped):
            assert v.dtype == torch.float32
            hold_update(v, flat_want[k], f"clipped at {max_norm} {k}",
                        rel if max_norm == 1.0 else 0.0)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_reference_on_identical_inputs(name):
    """Two steps; each from identical inputs (the second from the
    reference's state and params after the first).  Left as they were, the
    float32 parameter leaves fail the same rule."""
    sched = (ref_optim.cosine_warmup(1e-2, 1, 10), optim.cosine_warmup(1e-2, 1, 10))
    kw = {"weight_decay": 0.1} if name == "adafactor" else {}
    decay = 1e-2 * 0.1  # the schedule's peak times Adafactor's weight decay
    ref_opt = ref_optim.get_optimizer(name, sched[0], **kw)
    opt = optim.get_optimizer(name, sched[1], **kw)
    params = to_ref(np_tree(2))
    state = ref_opt.init(params)
    update = jax.jit(ref_opt.update)
    differing = 0
    assert float(ref_optim.global_norm(to_ref(np_tree(10, scale=0.002)))) < 1.0
    for step in range(2):
        grads = to_ref(np_tree(10 + step, scale=0.002))  # norm < 1: the clip's scale is 1
        want_p, want_s, want_m = update(grads, state, params)
        got_p, got_s, got_m = opt.update(to_port(grads), ref_state_to_port(state),
                                         to_port(params))
        red = name == "adafactor"
        differing += hold_trees(got_p, want_p, f"{name} params, step {step}", params, red,
                                decay)
        hold_trees(got_s, want_s, f"{name} state, step {step}", state, red, state=True)
        flat_want, flat_before = (dict(leaves(jax.tree.map(np.asarray, t)))
                                  for t in (want_p, params))
        for k, (_, dtype) in leaves(LEAVES):
            if dtype == "float32":
                rel = 4 * gamma(flat_before[k].size) if red else 0.0
                with pytest.raises(AssertionError):
                    hold_update(to_port(flat_before[k]), flat_want[k], f"{name} no-op {k}", rel,
                                before=flat_before[k], decay=decay)
        n = sum(int(np.prod(shape)) for _, (shape, _) in leaves(LEAVES))
        hold_update(got_m["grad_norm"], np.asarray(want_m["grad_norm"]), f"{name} grad_norm",
                    gamma(n - 1))
        hold_update(got_m["lr"], np.asarray(want_m["lr"]), f"{name} lr")
        params, state = want_p, want_s
    assert differing < sum(int(np.prod(s[0])) for _, s in leaves(LEAVES))


def test_adafactor_factors_the_stacked_leaf_as_the_reference():
    """The stacked (3, 128, 256) leaf keeps (3, 128) row and (3, 256)
    column statistics and the (130, 129) leaf (130,) and (129,); the
    others a full second moment; the update's RMS clip runs over each whole
    leaf (a per-block clip would change the stacked leaf's update).  On a
    float32 stacked leaf whose blocks' update RMS differ (0.5, about 5 and
    about 1 before the clip), the port's update holds to the reference's by
    the rule, while a no-op and a clip block by block fail it."""
    opt = optim.adafactor(optim.constant(1e-2))
    params = to_port(to_ref(np_tree(3)))
    state = opt.init(params)
    stats = state["stats"]
    assert tuple(stats["blocks"]["w"]["vr"].shape) == (3, 128)
    assert tuple(stats["blocks"]["w"]["vc"].shape) == (3, 256)
    assert tuple(stats["wide"]["vr"].shape) == (130,)
    assert tuple(stats["wide"]["vc"].shape) == (129,)
    assert set(stats["small"]) == {"v"} and set(stats["blocks"]["b"]) == {"v"}
    # Blocks of unequal gradient scale: one RMS over the stacked leaf.
    g = to_port(to_ref(np_tree(4, scale=0.05)))
    g["blocks"]["w"] = g["blocks"]["w"] * torch.tensor([1.0, 10.0, 100.0])[:, None, None].to(
        g["blocks"]["w"].dtype)
    new, _, _ = opt.update(g, state, params)
    per_block = []
    for i in range(3):
        sub = {k: v for k, v in g.items() if k != "blocks"}
        sub_p = {k: v for k, v in params.items() if k != "blocks"}
        sub["blocks"] = {k: v[i] for k, v in g["blocks"].items()}
        sub_p["blocks"] = {k: v[i] for k, v in params["blocks"].items()}
        out, _, _ = opt.update(sub, opt.init(sub_p), sub_p)
        per_block.append(out["blocks"]["w"])
    assert not torch.equal(new["blocks"]["w"], torch.stack(per_block))

    rng = np.random.default_rng(31)
    shape = (3, 128, 256)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (1e-3 * rng.standard_normal(shape)).astype(np.float32)  # norm < 1: the clip's scale 1
    g[0, 64:, :] = 0  # one quadrant: the factored second moment overestimates, RMS 0.5
    g[0, :, 128:] = 0
    g[1, :64, 128:] = 0  # two quadrants of unequal scale: RMS about 5
    g[1, 64:, :128] = 0
    g[1, 64:, 128:] *= 10
    ref_opt = ref_optim.adafactor(ref_optim.constant(1e-2))
    ref_p = {"w": jnp.asarray(p)}
    want = np.asarray(jax.jit(ref_opt.update)({"w": jnp.asarray(g)}, ref_opt.init(ref_p),
                                              ref_p)[0]["w"])
    port_p, port_g = {"w": torch.from_numpy(p)}, {"w": torch.from_numpy(g)}
    got = opt.update(port_g, opt.init(port_p), port_p)[0]["w"]
    rel = 4 * gamma(int(np.prod(shape)))
    hold_update(got, want, "stacked float32", rel, before=p)
    blocks = [opt.update({"w": port_g["w"][i]}, opt.init({"w": port_p["w"][i]}),
                         {"w": port_p["w"][i]})[0]["w"] for i in range(3)]
    for what, wrong in (("no-op", port_p["w"]), ("per-block clip", torch.stack(blocks))):
        with pytest.raises(AssertionError):
            hold_update(wrong, want, f"stacked float32 {what}", rel, before=p)


def test_state_specs_match_reference():
    specs = {"blocks": {"w": ParamSpec((3, 128, 256), ("layers", "embed", "mlp"))},
             "b": ParamSpec((4,), (None,), dtype=torch.float32)}
    ref_specs = {"blocks": {"w": RefSpec((3, 128, 256), ("layers", "embed", "mlp"))},
                 "b": RefSpec((4,), (None,), dtype=jnp.float32)}
    for name in ("adamw", "adafactor"):
        got = optim.get_optimizer(name, optim.constant(1e-3)).state_specs(specs)
        want = ref_optim.get_optimizer(name, ref_optim.constant(1e-3)).state_specs(ref_specs)
        got_l = list(leaves(got))
        want_l = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, RefSpec))[0]
        assert [p for p, _ in got_l] == [".".join(k.key for k in p) for p, _ in want_l]
        for (_, g), (_, w) in zip(got_l, want_l):
            assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init)
            assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name


def test_get_optimizer_refuses_unknown_name():
    with pytest.raises(ValueError) as port:
        optim.get_optimizer("sgd", optim.constant(0.1))
    with pytest.raises(ValueError) as ref:
        ref_optim.get_optimizer("sgd", ref_optim.constant(0.1))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    """``tests/test_substrates.py``'s quadratic, on the port."""
    params = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor(0.5)}
    opt = optim.get_optimizer(name, optim.constant(0.1), weight_decay=0.0)
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    l0 = float(loss(params))
    for _ in range(200):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = opt.update(grads, state, params)
    assert float(loss(params)) < 1e-2 * l0
    assert int(state["count"]) == 200


_COMPRESSED_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim import compress

    inp = json.loads(os.environ["PORT_INPUTS"])
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    grads = {k: jnp.asarray(np.array(v, np.float32)) for k, v in inp["grads"].items()}
    errs = {k: jnp.asarray(np.array(v, np.float32)) for k, v in inp["errs"].items()}
    specs = {"rows": P("data"), "cols": P(None, "model"), "both": P("data", "model"),
             "repl": P()}
    out = {}
    for label, gs in (("specs", specs), ("none", None)):
        fn = jax.jit(lambda g, e, gs=gs: compress.compressed_grads(g, e, mesh, "data", gs))
        mean, err = fn(grads, errs)
        out[label] = {k: [np.asarray(mean[k]).tolist(), np.asarray(err[k]).tolist()]
                      for k in grads}
    print(json.dumps(out))
    """
)


def test_compressed_grads_equal_reference_on_8_host_devices():
    """``compressed_grads`` on a 4x2 (data, model) mesh of the CPU repeated
    == the reference's on 8 forced host devices, compiled as a train step
    compiles it (under ``jax.jit``), leaves split over the data axis, the
    model axis, both, or neither (and with no specs at all)."""
    rng = np.random.default_rng(21)
    shapes = {"rows": (8, 6), "cols": (3, 10), "both": (8, 10), "repl": (5,)}
    grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    errs = {k: (0.01 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", PORT_INPUTS=json.dumps({
        "grads": {k: v.tolist() for k, v in grads.items()},
        "errs": {k: v.tolist() for k, v in errs.items()}}))
    proc = subprocess.run([sys.executable, "-c", _COMPRESSED_SCRIPT], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = make_mesh((4, 2), devices=["cpu"] * 8)
    specs = {"rows": ("data",), "cols": (None, "model"), "both": ("data", "model"), "repl": ()}
    port_g = {k: torch.as_tensor(v) for k, v in grads.items()}
    port_e = {k: torch.as_tensor(v) for k, v in errs.items()}
    for label, gs in (("specs", specs), ("none", None)):
        mean, err = compress.compressed_grads(port_g, port_e, mesh, "data", gs)
        for k in shapes:
            np.testing.assert_array_equal(mean[k].numpy(), np.array(ref[label][k][0], np.float32),
                                          err_msg=f"{label} {k} mean")
            np.testing.assert_array_equal(err[k].numpy(), np.array(ref[label][k][1], np.float32),
                                          err_msg=f"{label} {k} error")
