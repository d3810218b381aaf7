"""One device's LM train program with its FSDP blocks and its optimizer's
statistics joined (``repro_torch/models/tp.py``, ``repro_torch/optim``,
``repro_torch/models/steps.py``), held on the CPU:

* **Composed train steps.**  Every position of a CPU mesh runs its own
  program in lock step (a thread each, ``tp.MeshHook``): its blocks of the
  parameters and of the optimizer's state, its replica's share of the
  batch.  Each step is held against the unsharded ``make_train_step`` on
  the same whole state (the blocks put together, every replicated copy
  bit-equal): the loss by ``tests/train_rule.py``'s float32 loss bound,
  the gradients the optimizer receives leaf by leaf by its gradient rule,
  ``grad_norm`` by the bound the gradient rule puts on the whole norm, and
  the new parameters and state by its optimizer rule on identical inputs
  (the unsharded optimizer on the composed gradients), the clip's norm a
  float32 sum of every gradient element (γ_{n−1}) and Adafactor's means
  and RMS sums over a leaf (4γ_n).  The gradients are held leaf by leaf
  where the rule's premise holds, a bf16 parameter's gradient a bf16 leaf
  on both sides (one microbatch); with float32 accumulators of several
  microbatches, by their whole norm.  The clip is active (the clip norm
  below the gradient's norm).  Steps are held one at a time on identical
  inputs, not two from the start: the unsharded step against itself with
  the batch's rows reversed already leaves bf16 elements two ulps apart
  after two AdamW steps (its normalized update turns a gradient's rounding
  near zero into a step of up to lr).
  On a model axis of 2 and 3 (port fault 10: the norm, Adafactor's factored
  means and its RMS taken over a device's blocks); on (data 2, model 2)
  with the embedding dims split over ``"data"`` (FSDP), and on (data 2,
  model 1) with a width that ``"data"`` does not divide (the leaves whole,
  the gradients summed over the replicas).
* **Counts.**  The dry run's count of a train step at (data 4, model 2),
  remat on, 2 microbatches: the hooks' parameter-side gathers,
  reduce-scatters and sums equal a closed form from the leaves' splits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from test_torch_dryrun_tp import _composed
from train_rule import (BF16_ROUNDING, GRAD_F32, gamma, hold_grads, hold_loss, hold_update,
                        zero_leaves)
from repro_torch import configs, optim
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.models import params as PM
from repro_torch.models import steps, tp
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import get_model

LR = 1e-2
CLIP = 0.05  # below every run's gradient norm: the clip scales


def _setup(arch, change, batch, seq, seed=3):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32", **change)
    model = get_model(cfg)
    params = PM.materialize(model.param_specs, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32))
    return cfg, model, params, {"tokens": tokens[:, :seq], "labels": tokens[:, 1:]}


def _optimizer(name, splits=None, capture=None):
    """The optimizer at lr 1e-2 with the clip active; ``capture`` (a list)
    records each update's inputs."""
    opt = optim.get_optimizer(name, optim.constant(LR), clip_norm=CLIP, splits=splits)
    if capture is None:
        return opt

    def update(grads, state, params):
        capture.append((grads, state, params))
        return opt.update(grads, state, params)

    return opt._replace(update=update)


def _share(data, r, dp, mb):
    """Replica ``r``'s share of the batch: its block of each microbatch (the
    microbatch is what the replicas split)."""
    b = next(iter(data.values())).shape[0]
    per, blk = b // mb, b // (mb * dp)
    rows = [i * per + r * blk + j for i in range(mb) for j in range(blk)]
    return {k: v[rows] for k, v in data.items()}


def _blocks(tree, split_tree, ranks):
    """Each leaf's block at ``ranks`` under its split (major axis first)."""
    def one(t, sp):
        idx = []
        for d, n in enumerate(t.shape):
            r = 0
            for a, s in zip(sp.axes[d], sp.sizes[d]):
                r = r * s + ranks.get(a, 0)
            k = n // sp.parts(d)
            idx.append(slice(r * k, (r + 1) * k))
        return t[tuple(idx)]

    return PM._rebuild(tree, {p: one(t, s) for (p, t), (_, s)
                              in zip(PM.leaves(tree), PM.leaves(split_tree))})


def _whole(per_position, split_tree):
    """The whole tree from every position's blocks ([(ranks, tree)]): each
    block in its place, the copies of a replicated block bit-equal."""
    out, seen = {}, {}
    splits = dict(PM.leaves(split_tree))
    for ranks, tree in per_position:
        for path, blk in PM.leaves(tree):
            sp = splits[path]
            if path not in out:
                out[path] = torch.zeros(sp.full(blk.shape), dtype=blk.dtype)
                seen[path] = torch.zeros(sp.full(blk.shape), dtype=torch.bool)
            block, filled = (_blocks({"x": t}, {"x": sp}, ranks)["x"]
                             for t in (out[path], seen[path]))
            if filled.all():
                assert torch.equal(block, blk), f"{path}: replicated copies differ at {ranks}"
            else:
                block.copy_(blk)
                filled.fill_(True)
    return PM._rebuild(per_position[0][1], out)


def _state_splits(opt, model, rules, sizes):
    full = model.param_specs
    return {"params": tp.splits(full, rules, sizes),
            "opt": tp.splits(opt.state_specs(full), rules, sizes)}


def _rels(name, whole_grads):
    """The reductions' relative error on a leaf's update: the clip's norm
    over every gradient element, and Adafactor's means and RMS over the
    leaf's own."""
    n = sum(g.numel() for _, g in PM.leaves(whole_grads))
    return {p: gamma(n - 1) + (4 * gamma(g.numel()) if name == "adafactor" else 0.0)
            for p, g in PM.leaves(whole_grads)}


def _hold_opt(got, want, before, rels, decay, what):
    """New params and optimizer state by the optimizer rule (``decay``:
    lr · weight decay, the update's part no reduction feeds)."""
    for part in ("params", "opt"):
        flat_before = dict(PM.leaves(before[part]))
        flat_want = dict(PM.leaves(want[part]))
        for path, g in PM.leaves(got[part]):
            if g.dtype == torch.int32:  # the step count
                assert torch.equal(g, flat_want[path]), (what, path)
                continue
            leaf = next((p for p in rels if path == p or path.startswith(
                tuple(f"{s}.{p}" for s in ("m", "v", "stats")))), None)
            hold_update(g, flat_want[path], f"{what} {part} {path}", rels.get(leaf, 0.0),
                        before=flat_before[path], decay=decay if part == "params" else 0.0,
                        state=part == "opt")


def _compose_steps(arch, change, name, sizes, mb=1, n_steps=2, batch=4, seq=32):
    """Two steps composed on a mesh of ``sizes``, each held against the
    unsharded step on the same whole state (module docstring)."""
    cfg, model, params, data = _setup(arch, change, batch, seq)
    rules = dryrun.rules_for(arch, "train_4k", False)
    dm, splits = steps.device_model(model, rules, sizes)
    ref_opt = _optimizer(name)
    state_splits = _state_splits(ref_opt, model, rules, sizes)
    start = {"params": params, "opt": ref_opt.init(params)}
    dp = sizes.get("data", 1)
    decay = LR * (0.1 if name == "adamw" else 0.0)  # the optimizers' default weight decay
    captured = {}

    def program(ranks):
        cap = captured.setdefault(tuple(sorted(ranks.items())), [])
        opt = _optimizer(name, splits, cap)
        step_fn = steps.make_train_step(dm, opt, mb, splits=splits)
        local = _blocks(start, state_splits, ranks)
        st = steps.TrainState(torch.zeros((), dtype=torch.int32), local["params"],
                              opt.init(local["params"]))
        # the optimizer's own init at the blocks equals the whole state's blocks
        for (p, a), (_, b) in zip(PM.leaves(st.opt), PM.leaves(local["opt"])):
            assert a.shape == b.shape and torch.equal(a, b), p
        share = _share(data, ranks.get("data", 0), dp, mb)
        out = []
        for _ in range(n_steps):
            st, metrics = step_fn(st, share)
            out.append(({k: float(v) for k, v in metrics.items() if k != "lr"},
                        {"params": st.params, "opt": st.opt}))
        return ranks, out

    got = _composed(sizes, program, batch=("data",))
    grid = [ranks for ranks, _ in got]
    state = start
    for i in range(n_steps):
        metrics = [out[i][0] for _, out in got]
        for m in metrics[1:]:  # every position reports the whole step's
            assert m["loss"] == metrics[0]["loss"] and m["grad_norm"] == metrics[0]["grad_norm"]
        new = _whole([(r, out[i][1]) for r, (_, out) in zip(grid, got)], state_splits)
        caps = [captured[tuple(sorted(r.items()))][i] for r in grid]
        grads = _whole([(r, c[0]) for r, c in zip(grid, caps)],
                       state_splits["params"])
        # the unsharded step on the same whole state
        cap = []
        ref = steps.make_train_step(model, _optimizer(name, capture=cap), mb)
        ref_state = steps.TrainState(torch.tensor(i, dtype=torch.int32), state["params"],
                                     state["opt"])
        _, ref_metrics = ref(ref_state, data)
        what = f"{arch} {sizes} step {i}"
        hold_loss(metrics[0]["loss"], float(ref_metrics["loss"]), "float32", 0, what)
        if mb == 1:  # bf16 leaves on both sides, the rule's premise
            hold_grads(dict(PM.leaves(grads)), dict(PM.leaves(cap[0][0])), "float32", what,
                       zero_leaves(cfg))
        want_norm = float(ref_metrics["grad_norm"])
        assert want_norm > CLIP
        assert abs(metrics[0]["grad_norm"] - want_norm) <= (GRAD_F32 + BF16_ROUNDING) * want_norm
        # the optimizer on identical inputs: the composed gradients
        want_p, want_s, _ = ref_opt.update(grads, state["opt"], state["params"])
        _hold_opt(new, {"params": want_p, "opt": want_s}, state, _rels(name, grads), decay, what)
        state = new


# ---------------------------------------------------------------------------
# Port fault 10: the optimizer's statistics over a device's blocks
# ---------------------------------------------------------------------------

# 12 heads over 4 KV heads (whole at 3: each device's heads read one); widths
# that 2 and 3 divide; granite's expert width and d_model at 128 and more, so
# that its expert leaves are factored whole while a block is not
DENSE3 = {"n_heads": 12, "n_kv_heads": 4, "head_dim": 16, "d_ff": 192}
GRANITE = {"d_model": 128, "d_ff": 192, "n_heads": 12, "n_kv_heads": 4, "head_dim": 16}


@pytest.mark.parametrize("arch,change,name,m", [
    ("qwen3-4b", {}, "adamw", 2),
    ("qwen3-4b", DENSE3, "adamw", 3),
    ("granite-moe-3b-a800m", GRANITE, "adafactor", 2),
    ("granite-moe-3b-a800m", GRANITE, "adafactor", 3),
])
def test_composed_train_step_equals_unsharded(arch, change, name, m):
    _compose_steps(arch, change, name, {"data": 1, "model": m})


def test_adafactor_factors_by_the_whole_leaf():
    """granite at model 3: an expert leaf (8, 128, 192) is factored whole,
    its device's (8, 128, 64) block is not; the block's state is the whole
    state's block (held in the composed test)."""
    cfg, model, params, _ = _setup("granite-moe-3b-a800m", GRANITE, 4, 32)
    rules = dryrun.rules_for("granite-moe-3b-a800m", "train_4k", False)
    _, splits = steps.device_model(model, rules, {"data": 1, "model": 3})
    local = _blocks(params, splits, {"model": 0})
    state = optim.adafactor(optim.constant(LR), splits=splits).init(local)
    wg = state["stats"]["blocks"]["moe"]["wg"]
    assert tuple(local["blocks"]["moe"]["wg"].shape) == (cfg.n_layers, 8, 128, 64)
    assert set(wg) == {"vr", "vc"} and tuple(wg["vr"].shape) == (cfg.n_layers, 8, 128)
    assert set(optim.adafactor(optim.constant(LR)).init(local)["stats"]["blocks"]["moe"]["wg"]) \
        == {"v"}


# ---------------------------------------------------------------------------
# Port fault 11: the backward of one device's program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_composed_gradients_equal_unsharded(arch):
    """Every family at model 2: the gradient of every leaf, the blocks put
    together and every replicated copy bit-equal, against the unsharded
    ``value_and_grad`` by the gradient rule.  A whole tensor that a
    device's block-wise part reads (a KV weight or a q/k norm read by its
    heads, the MoE's gates, the Mamba2 projections and per-head
    parameters, the mLSTM's cell output) enters the split region, so its
    gradient sums every device's part."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    model = get_model(cfg)
    params = PM.materialize(model.param_specs, torch.Generator().manual_seed(3), "cpu")
    seq = cfg.ssm_chunk * 2 if cfg.family in ("zamba", "xlstm") else 32
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq + 1)).astype(np.int32))
    data = {"tokens": tokens[:, :seq], "labels": tokens[:, 1:]}
    gen = torch.Generator().manual_seed(4)
    if cfg.family == "vlm":  # vision rows drawn, the gates (zero when drawn) opened
        data["vision"] = torch.randn((2, cfg.n_vision_tokens, cfg.vision_dim), generator=gen)
        params["cross_blocks"]["attn"]["gate"].fill_(0.5)
        params["cross_blocks"]["mlp_gate"].fill_(0.5)
    if cfg.family == "encdec":
        data["frames"] = torch.randn((2, seq, cfg.d_model), generator=gen)
    (_, _), want = steps.value_and_grad(model, params, data)
    rules = dryrun.rules_for(arch, "train_4k", False)
    sizes = {"model": 2}
    dm, splits = steps.device_model(model, rules, sizes)
    assert any("model" in ax for _, sp in PM.leaves(splits) for ax in sp.axes)

    def program(ranks):
        (_, _), g = steps.value_and_grad(dm, _blocks(params, splits, ranks), data)
        return ranks, g

    got = _whole(_composed(sizes, program), splits)
    hold_grads(dict(PM.leaves(got)), dict(PM.leaves(want)), "float32", arch, zero_leaves(cfg))


# ---------------------------------------------------------------------------
# FSDP: the blocks over "data"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,change,name,sizes,mb,fsdp", [
    ("qwen3-4b", {}, "adamw", {"data": 2, "model": 2}, 1, True),
    ("granite-moe-3b-a800m", GRANITE, "adafactor", {"data": 2, "model": 2}, 2, True),
    ("qwen3-4b", {"d_model": 65}, "adamw", {"data": 2, "model": 1}, 2, False),
])
def test_composed_fsdp_step_equals_unsharded(arch, change, name, sizes, mb, fsdp):
    """Each position holds its (data, model) blocks of every leaf and of the
    optimizer's state and its replica's share of the batch; the whole step
    on the whole batch.  At d_model 65 ``"data"`` divides no leaf: every
    leaf whole, the gradients summed over the replicas."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32", **change)
    _, splits = steps.device_model(get_model(cfg), dryrun.rules_for(arch, "train_4k", False),
                                   sizes)
    assert any("data" in ax for _, sp in PM.leaves(splits) for ax in sp.axes) == fsdp
    _compose_steps(arch, change, name, sizes, mb=mb)


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------

COUNT_TRAIN = ShapeConfig("train_4k", 64, 4, "train")  # the replica's 4 examples
COUNT_SIZES = {"data": 4, "model": 2}


def closed_form_param_collectives(cfg, rules, sizes, microbatches, remat):
    """The parameter side of one train step of a dense or MoE arch (each
    block leaf read once a layer inside the remat'd layer body; ``embed``,
    ``final_norm`` and ``lm_head`` once a forward outside it), AdamW or
    Adafactor: per microbatch an all-gather over a leaf's FSDP axes at each
    read and at remat's recompute of it, a reduce-scatter of its gradient
    at each read; per step a sum of each leaf's gradient over the batch
    axes that do not cut it (float32 accumulators with microbatches), one
    sum of the global norm's squares per set of axes, and Adafactor's sums:
    the row and column means over the axes that cut the dim they average,
    the row means' mean, and the RMS over every axis of the leaf."""
    model = get_model(cfg)
    counts, byts = {}, {}

    def add(op, group, nbytes, times=1):
        s = math.prod(sizes[a] for a in group)
        if s == 1 or times == 0:
            return
        counts[op] = counts.get(op, 0) + times
        byts[op] = byts.get(op, 0.0) + times * hlo.WIRE_FACTOR[op](s) * nbytes

    batch = [a for a in ("data",) if sizes.get(a, 1) > 1]
    groups = {}
    opt = "adafactor" if cfg.family == "moe" else "adamw"
    for path, spec in PM.leaves(model.param_specs):
        sp = tp.split_of(spec, rules, sizes)
        block = math.prod(n // sp.parts(d) for d, n in enumerate(spec.shape))
        fsdp = [(d, tuple(a for a in ax if a != "model")) for d, ax in enumerate(sp.axes)]
        fsdp = [(d, ax) for d, ax in fsdp if ax]
        reads = cfg.n_layers if path.startswith("blocks.") else 1
        recompute = remat and path.startswith("blocks.")
        size = spec.dtype.itemsize
        for d, ax in fsdp:
            gathered = block * sp.parts(d, ax)
            add("all-gather", ax, gathered * size // reads,
                reads * (1 + recompute) * microbatches)
            add("reduce-scatter", ax, block * size // reads, reads * microbatches)
        grad_size = 4 if microbatches > 1 else size
        add("all-reduce", tuple(a for a in batch if a not in sp.over()), block * grad_size)
        if sp.over():
            groups[sp.over()] = groups.get(sp.over(), 0) + 1
        if opt == "adafactor":
            shape = spec.shape
            factored = len(shape) >= 2 and min(shape[-2:]) >= 128
            if factored:
                rows, cols = len(shape) - 2, len(shape) - 1
                add("all-reduce", sp.over([cols]), 4 * block // (shape[-1] // sp.parts(cols)))
                add("all-reduce", sp.over([rows]), 4 * block // (shape[-2] // sp.parts(rows)))
                add("all-reduce", sp.over([rows]),
                    4 * block // (shape[-1] // sp.parts(cols)) // (shape[-2] // sp.parts(rows)))
            add("all-reduce", sp.over(), 4)
    for axes, n in groups.items():
        add("all-reduce", axes, 4 * n)
    return counts, byts


@pytest.mark.parametrize("arch", ["qwen3-4b", "codeqwen1.5-7b", "granite-moe-3b-a800m"])
def test_hooks_count_the_closed_form(arch):
    """The probe's parameter side under ``tp.CountHook`` at (data 4, model
    2), train, remat on, 2 microbatches: counts exact, bytes to float
    rounding; then the cell's JSON reports those counts."""
    cfg = dataclasses.replace(configs.get_reduced(arch), remat=True)
    rules = dryrun.rules_for(arch, "train_4k", False)
    split = dryrun.Split(rules, COUNT_SIZES)
    got = dryrun._probe(cfg, COUNT_TRAIN, {}, optimizer=None, microbatches=2,
                        accum_dtype=torch.float32, split=split)["sides"]["params"]
    counts, byts = closed_form_param_collectives(cfg, rules, COUNT_SIZES, 2, True)
    assert got["counts"] == counts
    assert got["bytes"].keys() == byts.keys()
    for op in byts:
        assert got["bytes"][op] == pytest.approx(byts[op], rel=1e-12), op


def test_cell_reports_the_hooks_count(tmp_path, monkeypatch):
    """``run_cell`` on a reduced dense arch at (data 4, model 2): the
    JSON's ``collectives_params`` is the hooks' count of the whole step
    (the memory probes at 1 and 2 layers extrapolated to the depth), equal
    to the closed form at full depth, and ``collectives`` the sum of both
    sides; the argument bytes are the program's own."""
    from repro_torch.distributed import make_mesh

    arch = "qwen3-4b"
    cfg = configs.get_reduced(arch)
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_reduced)
    mesh = make_mesh((4, 2), devices=["meta"] * 8)
    res = dryrun.run_cell(arch, "train_4k", False, mesh=mesh,
                          shape=dataclasses.replace(COUNT_TRAIN, global_batch=16),
                          microbatches=2, outdir=str(tmp_path), verbose=False)
    counts, byts = closed_form_param_collectives(cfg, dryrun.rules_for(arch, "train_4k", False),
                                                 COUNT_SIZES, 2, cfg.remat)
    assert res["collectives_params"]["counts"] == counts
    for op in byts:
        assert res["collectives_params"]["bytes"][op] == pytest.approx(byts[op], rel=1e-9)
    for op, n in res["collectives"]["counts"].items():
        assert n == (res["collectives_params"]["counts"].get(op, 0)
                     + res["collectives_tp"]["counts"].get(op, 0))
    prog = steps.build_cell(cfg, COUNT_TRAIN, dryrun.rules_for(arch, "train_4k", False),
                            microbatches=2,
                            axis_sizes=COUNT_SIZES, per_device=True)
    args = sum(t.nbytes for _, t in PM.leaves(prog.abstract_args[0]._asdict())) + sum(
        t.nbytes for t in prog.abstract_args[1].values())
    assert args == res["memory_analysis"]["argument_size_in_bytes"]
