"""The port's LM training step (``repro_torch.models.steps``: ``value_and_grad``,
``make_train_step``, ``auto_microbatches``, the input specs) against
``repro`` on the CPU.

Each reduced arch runs on the reference's carried weights (every zeros and
ones leaf seeded, the VLM's gates non-zero) on a seeded 2 × 32 batch; the
reference side (``jax.value_and_grad`` of its ``loss_fn``) is computed once
per arch in a module-scoped cache.  Loss and every gradient leaf, which land
on the reference's stacked leaves, are held by ``tests/train_rule.py``.
The train step's new params and optimizer state are held through the
optimizer on the reference's own gradients (an independent step would flip
AdamW's first update g / (|g| + ε) wherever |g| ≲ ε), at a learning rate
whose update a no-op cannot pass for.  Port fault 6: Zamba's and xLSTM's
backward runs, its decays made out of place under autograd and in place
without it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_rule import depth
from repro import configs as ref_configs
from repro import optim as ref_optim
from repro.models import steps as ref_steps
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.model import get_model as ref_get_model
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch import optim
from repro_torch.models import params as PP
from repro_torch.models import ssm as S
from repro_torch.models import steps
from repro_torch.models.config import SHAPES
from repro_torch.models.model import get_model
from test_torch_lm import configs_pair
from test_torch_lm_families import gated
from test_torch_lm_ssm import seeded_tree
from train_rule import gamma, hold_grads, hold_loss, hold_update, zero_leaves

ARCHS = tuple(ref_configs.ARCH_IDS)
_REF = {}


def batch_np(cfg, seed: int = 5, b: int = 2, s: int = 32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal((b, cfg.n_vision_tokens, cfg.vision_dim)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return batch


def reference(arch: str, dtype: str = "float32"):
    """(cfg_ref, cfg_port, ref params, batch, ref loss, ref grads as a flat
    {dotted path: numpy}), computed once per (arch, dtype)."""
    if (arch, dtype) not in _REF:
        cfg_ref, cfg_port = configs_pair(arch, dtype)
        params = seeded_tree(cfg_ref, 3)
        if cfg_ref.family == "vlm":
            params = gated(params, 3)
        batch = batch_np(cfg_ref)
        rb = {k: jnp.asarray(v) for k, v in batch.items()}
        if "vision" in rb or "frames" in rb:
            rb = {k: (v.astype(cfg_ref.dtype) if v.dtype == jnp.float32 else v)
                  for k, v in rb.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(ref_get_model(cfg_ref).loss_fn,
                                                      has_aux=True))(params, rb)
        flat = dict(PP.leaves(jax.tree.map(np.asarray, grads)))
        _REF[(arch, dtype)] = (cfg_ref, cfg_port, params, batch, float(loss), flat)
    return _REF[(arch, dtype)]


def port_tree(params):
    """The reference's parameter tree, bit for bit, as CPU tensors."""
    return PP.map_tree(lambda a: convert._tensor_from_reference(np.asarray(a)),
                       jax.tree.map(np.asarray, params))


def port_batch(cfg, batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ("vision", "frames"):
        if k in out:  # the reference's exact cast to the activations' dtype
            out[k] = out[k].to(PP.torch_dtype(cfg.dtype))
    return out


# ---------------------------------------------------------------------------
# port fault 6 and the gradients of every arch
# ---------------------------------------------------------------------------


def test_decays_out_of_place_under_autograd_in_place_without():
    cum = torch.cumsum(-torch.rand((2, 16, 3)), dim=1)
    above = torch.ones((16, 16), dtype=torch.bool).triu(1)
    with torch.no_grad():
        assert S._decays(cum, above)._version == 2  # exp_ and masked_fill_ in place
    leaf = cum.clone().requires_grad_(True)
    out = S._decays(leaf, above)
    assert out._version == 0 and out.requires_grad
    out.sum().backward()
    assert torch.isfinite(leaf.grad).all()
    with torch.inference_mode():  # the serve path's buffer: the same values
        served = S._decays(cum, above)
    assert torch.equal(served, out.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad(arch):
    """Every reduced arch, float32 activations: backward runs (port fault
    6 for zamba2-2.7b and xlstm-1.3b), the gradients land on the
    reference's stacked leaves, and loss and leaves hold by the rule."""
    cfg_ref, cfg_port, params, batch, ref_loss, ref_grads = reference(arch)
    (loss, metrics), grads = steps.value_and_grad(get_model(cfg_port), port_tree(params),
                                                  port_batch(cfg_port, batch))
    assert loss.dtype == torch.float32 and not loss.requires_grad
    hold_loss(float(loss), ref_loss, "float32", depth(cfg_port), arch)
    got = dict(PP.leaves(grads))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in ref_grads.items()}
    hold_grads(got, ref_grads, "float32", arch, zero_leaves(cfg_port))


def test_bf16_loss_and_gradient_norm_match_jax_grad():
    cfg_ref, cfg_port, params, batch, ref_loss, ref_grads = reference("qwen2-1.5b", "bfloat16")
    (loss, _), grads = steps.value_and_grad(get_model(cfg_port), port_tree(params),
                                            port_batch(cfg_port, batch))
    hold_loss(float(loss), ref_loss, "bfloat16", depth(cfg_port), "qwen2 bf16")
    hold_grads(dict(PP.leaves(grads)), ref_grads, "bfloat16", "qwen2 bf16")


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


def _capture(optimizer, into: list):
    """``optimizer`` with its update's gradients appended to ``into``."""
    def update(grads, state, params):
        into.append(grads)
        return optimizer.update(grads, state, params)

    return optim.Optimizer(optimizer.init, update, optimizer.state_specs)


#: The learning rate of the optimizer comparison: an update (about lr a
#: step) far above the rule's allowance, so that a no-op fails it.
LR = 1e-2


@pytest.mark.parametrize("arch,name", [("qwen2-1.5b", "adamw"),
                                       ("granite-moe-3b-a800m", "adafactor")])
def test_train_step_matches_reference_through_the_optimizer(arch, name):
    """The port's step = its optimizer on its own gradients, bit for bit;
    its loss by the loss rule; and the port's optimizer on the reference's
    gradients == the reference's optimizer on them, by the optimizer rule:
    new params, state and metrics, on the tree as it is (bf16 leaves) and on
    a float32 copy.  The clip is active: its scale carries the global norm's
    error, γ_{N−1} relative (N gradient elements), which moves AdamW's
    first update by at most that much, its m by that and its v by twice;
    Adafactor's first update is scale-free and its reductions add at most
    4γ_n (n ≤ N), its statistics 2γ_{N−1} + γ_n.  So the rule's relative
    term is 5γ_{N−1}, on each update and each state made from zero.  At
    lr 1e-2 a no-op update fails the rule on the tree as it is and on every
    float32 leaf."""
    cfg_ref, cfg_port, params, batch, ref_loss, ref_grads = reference(arch)
    model = get_model(cfg_port)
    opt = optim.get_optimizer(name, optim.constant(LR))
    tree = port_tree(params)
    state = steps.TrainState(torch.zeros((), dtype=torch.int32), tree, opt.init(tree))
    seen = []
    new, metrics = steps.make_train_step(model, _capture(opt, seen))(
        state, port_batch(cfg_port, batch))
    assert int(new.step) == 1 and int(new.opt["count"]) == 1
    assert set(metrics) == {"ce", "moe_aux", "loss", "grad_norm", "lr"}
    hold_loss(float(metrics["loss"]), ref_loss, "float32", depth(cfg_port), arch)
    again, _, _ = opt.update(seen[0], opt.init(tree), tree)
    for (k, a), (_, b) in zip(PP.leaves(new.params), PP.leaves(again)):
        assert torch.equal(a, b), k

    ref_opt = ref_optim.get_optimizer(name, ref_optim.constant(LR))
    n = sum(v.size for v in ref_grads.values())
    rel = 5 * gamma(n - 1)
    decay = LR * (0.1 if name == "adamw" else 0.0)  # lr · the default weight decay

    def flat(tree_):
        return dict(PP.leaves(jax.tree.map(np.asarray, tree_)))

    for cast in (None, jnp.float32):
        p_ref, g_ref = params, ref_steps_grads(params, ref_grads)
        if cast is not None:
            p_ref, g_ref = (jax.tree.map(lambda a: a.astype(cast), t) for t in (p_ref, g_ref))
        what = f"{arch} {name} {'float32' if cast is not None else 'as is'}"
        want_p, want_s, want_m = jax.jit(ref_opt.update)(g_ref, ref_opt.init(p_ref), p_ref)
        start = port_tree(p_ref)
        got_p, got_s, got_m = opt.update(port_tree(g_ref), opt.init(start), start)
        want_pf, before, want_sf = flat(want_p), flat(p_ref), flat(want_s)
        got_sf = dict(PP.leaves(got_s))
        assert sorted(got_sf) == sorted(want_sf), what
        for k, v in PP.leaves(got_p):
            hold_update(v, want_pf[k], f"{what} {k}", rel, before=before[k], decay=decay)
        for k, v in want_sf.items():
            hold_update(got_sf[k], v, f"{what} state {k}", rel)
        hold_update(got_m["grad_norm"], np.asarray(want_m["grad_norm"]), "grad_norm", rel)
        hold_update(got_m["lr"], np.asarray(want_m["lr"]), "lr")
        assert float(got_m["grad_norm"]) > 1.0, what  # the clip is active

        def noop(k):
            return hold_update(dict(PP.leaves(start))[k], want_pf[k], f"{what} no-op {k}", rel,
                               before=before[k], decay=decay)

        if cast is None:
            with pytest.raises(AssertionError):
                for k in want_pf:
                    noop(k)
        else:
            for k in want_pf:
                with pytest.raises(AssertionError):
                    noop(k)


def ref_steps_grads(params, flat):
    """The flat {path: numpy} gradients as the reference's tree."""
    paths = [p for p, _ in PP.leaves(jax.tree.map(np.asarray, params))]
    leaves_, treedef = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[p]) for p in paths])


def test_microbatches_accumulate_in_float32_and_match_reference():
    """``microbatches=2``: the float32 gradient buffers hold the sum of the
    halves' gradients over 2, the loss their mean, the metrics the last
    half's; the loss is the reference's ``make_train_step``'s by the rule."""
    cfg_ref, cfg_port, params, batch, _, _ = reference("qwen2-1.5b")
    model = get_model(cfg_port)
    opt = optim.adamw(optim.cosine_warmup(3e-4, 2000, 100_000))
    tree = port_tree(params)
    state = steps.TrainState(torch.zeros((), dtype=torch.int32), tree, opt.init(tree))
    seen = []
    pb = port_batch(cfg_port, batch)
    _, metrics = steps.make_train_step(model, _capture(opt, seen), microbatches=2)(state, pb)
    halves = [steps.value_and_grad(model, tree, {k: v[i:i + 1] for k, v in pb.items()})
              for i in range(2)]
    assert float(metrics["loss"]) == float((halves[0][0][0] + halves[1][0][0]) / 2)
    assert float(metrics["ce"]) == float(halves[1][0][1]["ce"])
    for (k, got), (_, g0), (_, g1) in zip(PP.leaves(seen[0]), PP.leaves(halves[0][1]),
                                          PP.leaves(halves[1][1])):
        assert got.dtype == torch.float32, k
        want = (torch.zeros_like(got) + g0.float() + g1.float()) / 2
        assert torch.equal(got, want), k

    ref_model = ref_get_model(cfg_ref)
    ref_opt = ref_optim.adamw(ref_optim.cosine_warmup(3e-4, 2000, 100_000))
    ref_state = ref_steps.TrainState(jnp.int32(0), params, ref_opt.init(params))
    _, ref_metrics = jax.jit(ref_steps.make_train_step(ref_model, ref_opt, microbatches=2))(
        ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    hold_loss(float(metrics["loss"]), float(ref_metrics["loss"]), "float32",
              depth(cfg_port), "microbatches=2")
    with pytest.raises(ValueError):
        steps.make_train_step(model, opt, microbatches=3)(state, pb)


# ---------------------------------------------------------------------------
# specs and microbatch counts
# ---------------------------------------------------------------------------


def _spec_tuple(spec):
    return (spec.shape, spec.axes, spec.init, str(np.dtype(spec.dtype)) if not isinstance(
        spec.dtype, torch.dtype) else str(spec.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_specs_equal_reference(arch):
    for reduced in (False, True):
        get = "get_reduced" if reduced else "get_config"
        cfg_ref, cfg = getattr(ref_configs, get)(arch), getattr(port_configs, get)(arch)
        for name, shape in SHAPES.items():
            got = {k: _spec_tuple(v) for k, v in steps.batch_specs(cfg, shape).items()}
            want = {k: _spec_tuple(v) for k, v in
                    ref_steps.batch_specs(cfg_ref, REF_SHAPES[name]).items()}
            assert got == want, (arch, name)
            if shape.kind == "decode" and not reduced:
                cache, token, index = steps.decode_input_specs(cfg, shape, get_model(cfg))
                r_cache, r_token, r_index = ref_steps.decode_input_specs(
                    cfg_ref, REF_SHAPES[name], ref_get_model(cfg_ref))
                assert {k: _spec_tuple(v) for k, v in cache.items()} == {
                    k: _spec_tuple(v) for k, v in r_cache.items()}
                assert _spec_tuple(token) == _spec_tuple(r_token)
                assert _spec_tuple(index) == _spec_tuple(r_index)


def test_auto_microbatches_equal_reference():
    assert steps.MICROBATCH_TOKEN_TARGET == ref_steps.MICROBATCH_TOKEN_TARGET
    for name, shape in SHAPES.items():
        for dp in (0, 1, 2, 8, 32, 64, 256):
            assert steps.auto_microbatches(shape, dp) == ref_steps.auto_microbatches(
                REF_SHAPES[name], dp), (name, dp)
    assert steps.auto_microbatches(SHAPES["train_4k"], 32) == 2
    odd = dataclasses.replace(SHAPES["train_4k"], global_batch=24)
    ref_odd = dataclasses.replace(REF_SHAPES["train_4k"], global_batch=24)
    assert steps.auto_microbatches(odd, 2) == ref_steps.auto_microbatches(ref_odd, 2)
