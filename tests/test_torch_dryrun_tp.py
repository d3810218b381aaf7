"""One device's program of an LM step (``repro_torch/models/tp.py``): the
dry run's per-device count and the programs composed on a mesh.

The reference's dry run gets a per-device program from XLA's partitioner;
the port writes it out: each layer runs on the device's blocks of the
model-split leaves and calls a hook where a split contraction leaves a
partial sum or a split result.  Here, on the CPU:

* the program's parameters are each full leaf's ``params.local_shape``
  over ``"model"`` (full widths, on the meta device);
* at a model axis of 1 the count equals the replica's step exactly (the
  cells ``tests/test_torch_dryrun.py`` extrapolates);
* on reduced dense and MoE archs at model 2 and 4, the split matmuls'
  FLOPs and the collectives' counts and wire bytes equal closed forms;
* the programs of every position of a ``["cpu"] * k`` mesh, run in lock
  step with the hook as a real sum or concatenation, give the unsharded
  model's logits and loss: logits by the LM rule (``tests/lm_rule.py``;
  MoE archs by ``tests/moe_rule.py``, whose router logits each side
  records), the loss within 1e-5 relative (``tests/train_rule.py``'s
  float32 loss bound), in float32: query heads split with KV heads split
  alike, replicated (one KV head for a device's heads) and straddling two
  groups (one KV head per query head), experts split and not dividing,
  ``expert_mlp`` split, and a decode cache split over ``kv_seq``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

import numpy as np
import pytest
import torch

import lm_rule
import moe_rule
from repro_torch import configs
from repro_torch.distributed import sharding as shrules
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.models import steps, tp
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import get_model

SINGLE = {"data": 16, "model": 16}
PREFILL = ShapeConfig("prefill_32k", 64, 2, "prefill")
TRAIN = ShapeConfig("train_4k", 64, 2, "train")


def _count(cfg, shape, rules, sizes, microbatches=1):
    cell = steps.build_cell(cfg, shape, rules, microbatches=microbatches, axis_sizes=sizes,
                            per_device=True)
    hook = tp.CountHook(cell.sizes)
    with tp.use(cell.layout(hook), shared=True):
        got = dryrun.count_step(cell.step_fn, cell.abstract_args)
    return got, hook


# ---------------------------------------------------------------------------
# The program's blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_program_params_are_local_shapes_over_model(arch):
    """Full width, single-pod rules: every parameter and optimizer-state
    leaf the train program takes is the full leaf's ``local_shape`` under
    the cell's specs (its blocks over ``"model"`` and the FSDP ``"data"``),
    the same bytes the count's arguments give; the module built over them
    reads the same blocks."""
    cfg = configs.get_config(arch)
    rules = dryrun.rules_for(arch, "train_4k", False)
    cell = steps.build_cell(cfg, configs_shape("train_4k"), rules, microbatches=1,
                            axis_sizes=SINGLE, per_device=True)
    state, specs = cell.abstract_args[0], cell.in_specs[0]
    whole = steps.build_cell(cfg, configs_shape("train_4k"), rules, microbatches=1,
                             axis_sizes=SINGLE).abstract_args[0]
    split = 0
    for part in ("params", "opt"):
        local = dict(PM.leaves(getattr(state, part)))
        pspecs = dict(PM.leaves(getattr(specs, part)))
        for path, t in PM.leaves(getattr(whole, part)):
            want = PM.local_shape(tuple(t.shape), pspecs[path], SINGLE)
            assert tuple(local[path].shape) == want, (part, path)
            split += want != tuple(t.shape)
    assert split > 0
    assert tuple(specs.params["embed"]) == ("model", "data")
    assert sum(t.nbytes for _, t in PM.leaves(state._asdict())) == dryrun.device_bytes(
        whole, specs, SINGLE)


def configs_shape(name):
    from repro_torch.models.config import SHAPES
    return SHAPES[name]


# ---------------------------------------------------------------------------
# Model axis 1: the replica's step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,depth,shape", [
    ("qwen2-1.5b", {"n_layers": 5}, ShapeConfig("train_4k", 64, 3, "train")),
    ("qwen3-4b", {"n_layers": 5}, ShapeConfig("prefill_32k", 64, 3, "prefill")),
    ("qwen2-1.5b", {"n_layers": 5}, ShapeConfig("decode_32k", 64, 3, "decode")),
    ("zamba2-2.7b", {"n_layers": 6}, ShapeConfig("train_4k", 64, 3, "train")),
    ("zamba2-2.7b", {"n_layers": 6}, ShapeConfig("decode_32k", 64, 3, "decode")),
    ("whisper-large-v3", {"n_layers": 3, "n_encoder_layers": 4},
     ShapeConfig("train_4k", 64, 3, "train")),
])
def test_model_axis_one_equals_the_replica_count(arch, depth, shape):
    """At a data and a model axis of 1 the per-device program is the
    replica's step: FLOPs, bytes and the peak equal the count without rules
    to the unit, and no collective is counted."""
    cfg = dataclasses.replace(configs.get_reduced(arch), **depth)
    rules = dryrun.rules_for(arch, shape.name, False)
    split = dryrun.Split(rules, {"data": 1, "model": 1})
    kw = dict(optimizer=None, replica_batch=5, mb=1)
    got = dryrun._cost_by_extrapolation(cfg, shape, **kw, split=split)
    ref = dryrun._cost_by_extrapolation(cfg, shape, **kw)
    assert (got["flops"], got["bytes"]) == (ref["flops"], ref["bytes"])
    mem = dryrun._memory_by_extrapolation(cfg, shape, **kw, split=split)
    ref = dryrun._memory_by_extrapolation(cfg, shape, **kw)
    assert (mem["temp"], mem["peak_segment"], mem["other_outputs"]) == (
        ref["temp"], ref["peak_segment"], ref["other_outputs"])
    for side in tp.SIDES:
        assert mem["collectives"][side].counts == {} and mem["collectives"][side].bytes == {}


# ---------------------------------------------------------------------------
# Closed forms at model 2 and 4
# ---------------------------------------------------------------------------


def _wire(op, size, nbytes):
    return hlo.WIRE_FACTOR[op](size) * nbytes


@pytest.mark.parametrize("m", [2, 4])
def test_dense_prefill_closed_forms(m):
    """codeqwen (4 query and 4 KV heads, every width dividing): FLOPs split
    m ways exactly; qwen3 (2 KV heads) at m = 4 keeps its KV heads whole,
    and a prefill's cache keeps every one, so each device projects them
    all (a train step's projects only the one its query head reads).  One
    all-reduce for the embedding and two a layer (attention, MLP) of
    (B, S, D) bf16, one all-gather of the last position's (B, V) logits."""
    b, s = PREFILL.global_batch, PREFILL.seq_len
    for arch in ("codeqwen1.5-7b", "qwen3-4b"):
        cfg = configs.get_reduced(arch)
        rules = dryrun.rules_for(arch, "prefill_32k", False)
        one, _ = _count(cfg, PREFILL, rules, {"data": 1, "model": 1})
        got, hook = _count(cfg, PREFILL, rules, {"data": 1, "model": m})
        d, hd, kv = cfg.d_model, cfg.hd, cfg.n_kv_heads
        kv_whole = 2 * 2 * b * s * d * kv * hd * cfg.n_layers  # the K and V projections
        if kv % m:  # KV whole: each device projects every KV head, for its cache
            assert got["flops"] * m == one["flops"] - kv_whole + m * kv_whole
        else:
            assert got["flops"] * m == one["flops"]
        act = b * s * d * 2
        assert hook.counts == {"all-reduce": 1 + 2 * cfg.n_layers, "all-gather": 1}
        assert hook.bytes["all-reduce"] == pytest.approx(
            (1 + 2 * cfg.n_layers) * _wire("all-reduce", m, act))
        assert hook.bytes["all-gather"] == pytest.approx(
            _wire("all-gather", m, b * cfg.padded_vocab * 2))


@pytest.mark.parametrize("m", [2, 4])
def test_moe_prefill_closed_forms(m):
    """arctic (8 experts, a dense residual): the router's (B, S, E) float32
    logits gathered, the experts' combine, the dense residual's and the
    attention's outputs summed each layer; granite (experts whole, each
    expert's hidden width split): the router replicated on every device."""
    b, s = PREFILL.global_batch, PREFILL.seq_len
    arctic = configs.get_reduced("arctic-480b")
    rules = dryrun.rules_for("arctic-480b", "prefill_32k", False)
    one, _ = _count(arctic, PREFILL, rules, {"data": 1, "model": 1})
    got, hook = _count(arctic, PREFILL, rules, {"data": 1, "model": m})
    lyr, d, e = arctic.n_layers, arctic.d_model, arctic.n_experts
    act = b * s * d * 2
    assert hook.counts == {"all-reduce": 1 + 3 * lyr, "all-gather": lyr + 1}
    assert hook.bytes["all-gather"] == pytest.approx(
        lyr * _wire("all-gather", m, b * s * e * 4)
        + _wire("all-gather", m, b * arctic.padded_vocab * 2))
    assert hook.bytes["all-reduce"] == pytest.approx((1 + 3 * lyr) * _wire("all-reduce", m, act))
    if m == 2:  # every width divides: the FLOPs split exactly
        assert got["flops"] * m == one["flops"]

    granite = configs.get_reduced("granite-moe-3b-a800m")
    rules = dryrun.rules_for("granite-moe-3b-a800m", "prefill_32k", False)
    one, _ = _count(granite, PREFILL, rules, {"data": 1, "model": 1})
    got, hook = _count(granite, PREFILL, rules, {"data": 1, "model": m})
    router = 2 * b * s * granite.d_model * granite.n_experts * granite.n_layers
    kv = 2 * 2 * b * s * granite.d_model * granite.n_kv_heads * granite.hd * granite.n_layers
    kv_whole = kv if granite.n_kv_heads % m else 0  # every KV head, for the cache
    assert got["flops"] * m == one["flops"] - router - kv_whole + m * (router + kv_whole)
    assert hook.counts == {"all-reduce": 1 + 2 * granite.n_layers, "all-gather": 1}


def test_train_hooks_count_forward_recompute_and_backward():
    """A train step of reduced codeqwen at model 2, remat on: each layer's
    attention and MLP all-reduce their outputs in the forward and the
    gradients of their inputs in the backward; remat's recompute sums the
    attention's output again (the MLP's saved inputs need it) but not the
    MLP's (it follows the last saved tensor, where the recompute stops);
    the loss's chunk (always recomputed) gathers its log-sum-exp and sums
    its label logit twice, and sums its input's gradient once; the
    optimizer's global norm sums the model-split leaves' squares once."""
    cfg = dataclasses.replace(configs.get_reduced("codeqwen1.5-7b"), remat=True)
    rules = dryrun.rules_for("codeqwen1.5-7b", "train_4k", False)
    _, hook = _count(cfg, TRAIN, rules, {"data": 1, "model": 2})
    lyr = cfg.n_layers
    # embedding 1; per layer 2 forward + 1 recompute + 2 backward; loss 2 + 1
    assert hook.sides["tp"]["counts"] == {"all-reduce": 1 + 5 * lyr + 3, "all-gather": 2}
    assert hook.sides["params"]["counts"] == {"all-reduce": 1}


# ---------------------------------------------------------------------------
# Composed on a mesh
# ---------------------------------------------------------------------------


def _blocks(tree, specs, rules, sizes, ranks):
    """Each leaf's block at ``ranks`` (axis → index) under the program's
    split (:func:`tp.split_of`; a dim over several axes, major first)."""
    out = {}
    for (path, t), (_, spec) in zip(PM.leaves(tree), PM.leaves(specs)):
        sp = tp.split_of(spec, rules, sizes)
        idx = []
        for d, full in enumerate(spec.shape):
            n = full // sp.parts(d)
            r = 0
            for a in sp.axes[d]:
                r = r * sizes[a] + ranks.get(a, 0)
            idx.append(slice(r * n, (r + 1) * n))
        out[path] = t[tuple(idx)]
    return PM._rebuild(specs, out)


def _composed(sizes, fn, **groups):
    """``fn(ranks)`` on every position of a mesh of ``sizes`` (axis →
    size) in lock step (a thread each, under a ``tp.MeshHook``;
    ``groups``: the layout's ``batch`` and ``kv_seq`` axes); their results
    in row-major order of the positions."""
    axes = list(sizes)
    grid = [dict(zip(axes, idx)) for idx in itertools.product(*(range(sizes[a]) for a in axes))]
    hook = tp.MeshHook(sizes, len(grid))
    results, errors = [None] * len(grid), []

    def run(i):
        ranks = grid[i]
        try:
            with tp.use(tp.Layout(sizes, ranks, hook.bind(ranks), **groups)):
                results[i] = fn(ranks)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            hook.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(grid))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _float32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _setup(cfg, seed):
    model = get_model(cfg)
    params = PM.materialize(model.param_specs, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32))
    return model, params, tokens


def _local_module(model, params, rules, sizes, ranks):
    local = _blocks(params, model.param_specs, rules, sizes, ranks)
    return tp.annotate(model.build_params(local), tp.splits(model.param_specs, rules, sizes))


def _loss(model, module, tokens, **kw):
    loss, _ = model.loss_fn(module, {"tokens": tokens[:, :32], "labels": tokens[:, 1:], **kw})
    return float(loss)


CASES = [
    # (arch, model axis, config changes): heads and KV heads split alike;
    # KV heads whole (one KV head per device); KV heads straddling two
    # groups (12 query heads, 4 KV heads, 3 devices)
    ("codeqwen1.5-7b", 4, {}),
    ("qwen3-4b", 4, {}),
    ("qwen3-4b", 3, {"n_heads": 12, "n_kv_heads": 4, "head_dim": 16}),
    ("llama-3.2-vision-11b", 2, {}),
]


@pytest.mark.parametrize("arch,m,change", CASES)
def test_composed_dense_equals_unsharded(arch, m, change):
    cfg = dataclasses.replace(_float32(configs.get_reduced(arch)), **change)
    model, params, tokens = _setup(cfg, 3)
    rules = dryrun.rules_for(arch, "train_4k", False)
    sizes = {"data": 1, "model": m}
    kw = {}
    if cfg.family == "vlm":  # vision rows drawn, the gates (zero when drawn) opened
        gen = torch.Generator().manual_seed(4)
        kw = {"vision": torch.randn((2, cfg.n_vision_tokens, cfg.vision_dim), generator=gen)}
        params["cross_blocks"]["attn"]["gate"].fill_(0.5)
        params["cross_blocks"]["mlp_gate"].fill_(0.5)
    whole = model.build_params(params)
    with torch.no_grad():
        want = whole(tokens, **kw).float().numpy()
        want_loss = _loss(model, whole, tokens, **kw)

    def program(ranks):
        module = _local_module(model, params, rules, sizes, ranks)
        with torch.no_grad():
            return module(tokens, **kw).float().numpy(), _loss(model, module, tokens, **kw)

    got = _composed({"model": m}, program)
    for logits, loss in got:
        np.testing.assert_array_equal(logits, got[0][0])  # every position gathers alike
        lm_rule.hold(logits.argmax(-1), logits, want, "float32", lm_rule.depth(cfg), arch)
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("arch,m", [("arctic-480b", 2), ("arctic-480b", 3),
                                    ("granite-moe-3b-a800m", 2)])
def test_composed_moe_equals_unsharded(arch, m):
    """Experts split (arctic at 2), not dividing (arctic's 8 experts on 3
    devices: the MoE whole on each), and each expert's width split
    (granite): logits by the MoE rule on both sides' router logits."""
    cfg = _float32(configs.get_reduced(arch))
    model, params, tokens = _setup(cfg, 5)
    rules = dryrun.rules_for(arch, "train_4k", False)
    sizes = {"data": 1, "model": m}
    with moe_rule.recording() as ref_calls, torch.no_grad():
        want = model.build_params(params)(tokens).float().numpy()
        want_loss = _loss(model, model.build_params(params), tokens)
    ref_calls = ref_calls[:cfg.n_layers]
    seen = {}
    route = L._route

    def recorded(logits, c):
        r = route(logits, c)
        if tp.rank() == 0:
            seen.setdefault(threading.get_ident(), []).append({
                "logits": logits.numpy(), "idx": r.idx.numpy(), "pos": r.pos.numpy(),
                "keep": r.keep.numpy(), "k": c.top_k, "capacity": r.capacity})
        return r

    def program(ranks):
        module = _local_module(model, params, rules, sizes, ranks)
        with torch.no_grad():
            logits = module(tokens).float().numpy()
            return logits, _loss(model, module, tokens)

    L._route = recorded
    try:
        got = _composed({"model": m}, program)
    finally:
        L._route = route
    (calls,) = seen.values()
    calls = calls[:cfg.n_layers]  # the logits' forward (the loss's follows)
    pairs = moe_rule.pair_calls(calls, ref_calls, [0] * cfg.n_layers)
    for logits, loss in got:
        moe_rule.hold(logits.argmax(-1), logits, want, "float32", lm_rule.depth(cfg), pairs,
                      prompt_len=1, what=arch)
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("arch", ["qwen3-4b", "h2o-danube-1.8b"])
def test_composed_decode_over_a_kv_seq_split(arch):
    """The long-context rules split a decode cache's sequence over
    ``"data"``: each position writes the new key where its block holds the
    slot and scores its own slots; the softmax's maxima, normalizers and
    values combine.  Four positions against the whole cache (h2o-danube:
    its sliding-window ring)."""
    cfg = _float32(configs.get_reduced(arch))
    model, params, tokens = _setup(cfg, 7)
    whole = model.build_params(params)
    k = 4
    length = cfg.window if cfg.window else 32
    prompts = tokens[:, :16]
    with torch.no_grad():
        logits, pre = model.prefill_fn(whole, {"tokens": prompts})
        full = steps.graft_cache(PM.materialize(model.cache_specs(2, length), None, "cpu"), pre)
        index = 16 if not cfg.window else cfg.window + 5  # a slot past the ring's start
        step_tok = tokens[:, 16:17]
        want_cache = {n: t.clone() for n, t in full.items()}
        want, _ = model.decode_fn(whole, want_cache, step_tok, index)
    rules = shrules.long_context_rules(False)
    rules.update(configs.sharding_overrides(arch))
    sizes = {"data": k, "model": 1}
    specs = model.cache_specs(2, length)

    def program(ranks):
        cache = _blocks({n: t.clone() for n, t in full.items()}, specs, rules, sizes, ranks)
        module = _local_module(model, params, rules, sizes, ranks)
        with torch.no_grad():
            out, cache = model.decode_fn(module, cache, step_tok, index)
        return out.float().numpy(), cache

    got = _composed(sizes, program, kv_seq=("data",))
    for out, _ in got:
        lm_rule.hold(out.argmax(-1)[:, None], out[:, None], want.float().numpy()[:, None],
                     "float32", lm_rule.depth(cfg), arch)
    # the new key landed in the one block that holds its slot, as in the
    # whole cache (layer 0's: the later layers' inputs differ by roundings)
    slot = index % length
    n = length // k
    block = got[slot // n][1]["k"]
    np.testing.assert_array_equal(block[0, :, slot % n].numpy(),
                                  want_cache["k"][0, :, slot].numpy())
