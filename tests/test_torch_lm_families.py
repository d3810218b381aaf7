"""The port's MoE and VLM families (``repro_torch.models``: ``moe_ffn``,
``cross_attention*``, the grouped VLM, ``get_model``) against the JAX
reference on the CPU, at the reduced configs, on weights carried by
``convert.lm_params_from_reference``.

The MoE is held by the MoE rule of ``tests/moe_rule.py`` (each routing the
rule calls decided ``==`` the reference's, capacity ranks included, and the
LM rule of ``tests/lm_rule.py`` before a sequence's first tie-bound
routing); the router inputs of both sides are recorded at every MoE call
(the reference's through an ordered ``jax.debug.callback``).  The VLM is
held by the LM rule with its zero-initialized gates (``gate``,
``mlp_gate``) set to seeded non-zero values on both sides, since zero gates
make every cross layer add exactly 0.  Layer outputs are held within a
stated number of ulps of the largest magnitude of the reference's output
(float32 2⁻²³, bfloat16 2⁻⁸).
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moe_rule
from lm_rule import hold, stream_logits, tau
from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import transformer as RT
from repro.models.model import MOE_AUX_WEIGHT as REF_MOE_AUX_WEIGHT
from repro.models.model import get_model as ref_get_model
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import layers as PL
from repro_torch.models import params as PP
from repro_torch.models import transformer as PT
from repro_torch.models.model import MOE_AUX_WEIGHT, get_model
from repro_torch.models.steps import make_generate
from test_torch_lm import TORCH_DTYPE, both, close, configs_pair, ref_stream_logits, ref_tree, to_np

MOE = ("granite-moe-3b-a800m", "arctic-480b")
VLM = "llama-3.2-vision-11b"
FAMILIES = (*MOE, VLM)


def gated(params, seed: int):
    """The reference tree with the VLM's zero-initialized gates (each cross
    block's attention ``gate`` and ``mlp_gate``) drawn from a seeded normal
    (about 0.5-1.5 in size, so that tanh leaves them far from 0)."""
    rng = np.random.default_rng(seed)
    cross = dict(params["cross_blocks"])
    attn = dict(cross["attn"])
    for tree, name in ((attn, "gate"), (cross, "mlp_gate")):
        leaf = tree[name]
        values = np.sign(rng.standard_normal(leaf.shape)) * rng.uniform(0.5, 1.5, leaf.shape)
        tree[name] = jnp.asarray(values, leaf.dtype)
    cross["attn"] = attn
    return {**params, "cross_blocks": cross}


def carried_family(arch: str, dtype: str, seed: int, gates: bool = True, **overrides):
    """(reference config, port config, reference params, the port's module on
    the CPU holding them): the bias and norm leaves seeded as in
    ``test_torch_lm.ref_tree``, and a VLM's gates seeded unless ``gates``
    is False."""
    cfg_ref, cfg_port = configs_pair(arch, dtype)
    cfg_ref = dataclasses.replace(cfg_ref, **overrides)
    cfg_port = dataclasses.replace(cfg_port, **overrides)
    params = ref_tree(cfg_ref, seed)
    if cfg_ref.family == "vlm" and gates:
        params = gated(params, seed)
    lm = convert.lm_params_from_reference(cfg_port, jax.tree.map(np.asarray, params), "cpu")
    return cfg_ref, cfg_port, params, lm


def vision_pair(cfg, batch: int, seed: int, n_vision_tokens=None):
    """Seeded bf16 patch embeddings as a jax array and a CPU torch tensor."""
    n = n_vision_tokens or cfg.n_vision_tokens
    rng = np.random.default_rng(seed)
    return both(rng.standard_normal((batch, n, cfg.vision_dim)), "bfloat16")


@contextlib.contextmanager
def ref_recording():
    """Within the block, every call of the reference's ``moe_ffn`` (traced
    into a jitted program) appends its float32 router logits to the yielded
    list, in program order, as ``moe_rule.recording`` does for the port: the
    product of ``layers.py:432``, the same expression on the same operands
    in the same program as the one ``moe_ffn`` routes by."""
    calls = []
    original = RL.moe_ffn

    def record(logits):
        calls.append({"logits": np.asarray(logits)})

    def recorded(params, x, cfg):
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), params["router"])
        jax.debug.callback(record, logits, ordered=True)
        return original(params, x, cfg)

    RL.moe_ffn = recorded
    try:
        yield calls
    finally:
        RL.moe_ffn = original


def ref_routing(router, x, cfg):
    """The reference's routing lines (``layers.py:434-457``) replayed in jnp
    on ``x``: (idx, pos, keep, dst, capacity)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    capacity = int(np.ceil(cfg.capacity_factor * k * s / e))
    e_flat = idx.reshape(b, s * k)
    oh = jax.nn.one_hot(e_flat, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - 1, e_flat[..., None], axis=-1)[..., 0]
    keep = pos < capacity
    dst = jnp.where(keep, e_flat * capacity + pos, e * capacity)
    return tuple(np.asarray(a) for a in (idx, pos, keep, dst)) + (capacity,)


# ---------------------------------------------------------------------------
# specs and the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_param_specs_equal_reference(arch):
    """Paths, shapes, axes, init, scale and dtype of every leaf (the MoE
    router float32, the VLM's doubly stacked blocks, the scalar gates), and
    the counts and bytes, at full and reduced size."""
    for get in ("get_config", "get_reduced"):
        ref_specs = ref_get_model(getattr(ref_configs, get)(arch)).param_specs
        port_specs = get_model(getattr(port_configs, get)(arch)).param_specs
        assert PP.count_params(port_specs) == RP.count_params(ref_specs)
        assert PP.param_bytes(port_specs) == RP.param_bytes(ref_specs)
        ref_leaves = jax.tree_util.tree_flatten_with_path(ref_specs, is_leaf=RP.is_spec)[0]
        port_leaves = list(PP.leaves(port_specs))
        assert len(ref_leaves) == len(port_leaves)
        for (path, r), (name, p) in zip(ref_leaves, port_leaves):
            assert ".".join(k.key for k in path) == name
            assert (p.shape, p.axes, p.init, p.scale) == (r.shape, r.axes, r.init, r.scale), name
            assert str(p.dtype).removeprefix("torch.") == np.dtype(r.dtype).name, name
    full = {"granite-moe-3b-a800m": 3_374_679_552, "arctic-480b": 476_850_275_328,
            "llama-3.2-vision-11b": 9_806_614_544}
    assert PP.count_params(get_model(port_configs.get_config(arch)).param_specs) == full[arch]
    cfg = port_configs.get_reduced(arch)
    cache = get_model(cfg).cache_specs(3, 10)
    ref_cache = ref_get_model(ref_configs.get_reduced(arch)).cache_specs(3, 10)
    assert {k: v.shape for k, v in cache.items()} == {k: v.shape for k, v in ref_cache.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_converter_keeps_names_dtypes_and_bits(arch):
    """Every reference leaf lands bit for bit under its dotted name, the
    stacking axes unstacked (``blocks.{g}.{j}`` and ``cross_blocks.{g}``
    for the VLM), the MoE router float32 and the 0-d gates 0-d."""
    cfg_ref, cfg_port, params, lm = carried_family(arch, "bfloat16", seed=5)
    state = lm.state_dict()
    count = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        want = np.asarray(leaf)
        stacked = {"blocks": 2 if cfg_port.family == "vlm" else 1, "cross_blocks": 1}
        depth = stacked.get(keys[0], 0)
        for index in np.ndindex(*want.shape[:depth]):
            got = state[".".join([keys[0], *map(str, index), *keys[1:]])]
            one = want[index]
            assert got.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[one.dtype.name]
            assert tuple(got.shape) == one.shape
            if one.dtype.name == "bfloat16":
                assert np.array_equal(got.view(torch.int16).numpy(), one.view(np.int16))
            else:
                assert np.array_equal(got.numpy(), one)
            count += 1
    assert count == len(state)
    if cfg_port.family == "moe":
        assert state["blocks.1.moe.router"].dtype == torch.float32
        assert ("blocks.0.moe.dense.wg" in state) == bool(cfg_port.d_ff_dense)
    else:
        assert state["cross_blocks.1.attn.gate"].shape == ()
        assert "blocks.1.0.attn.wq" in state and "vision_proj" in state


def test_get_model_serves_every_ported_family_and_raises_for_the_rest():
    """Every reduced arch of ``ARCH_IDS`` builds, prefills and decodes (the
    enc-dec arch with frames, Zamba and xLSTM on a prompt of one SSD chunk);
    no family raises ``NotImplementedError`` any more."""
    from repro_torch.models import encdec as PE
    from repro_torch.models import hybrid as PH

    kinds = {"dense": PT.DenseLM, "moe": PT.DenseLM, "vlm": PT.VisionLM,
             "encdec": PE.EncDecLM, "zamba": PH.ZambaLM, "xlstm": PH.XLSTMLM}
    assert {port_configs.get_reduced(a).family for a in port_configs.ARCH_IDS} == set(kinds)
    for arch in port_configs.ARCH_IDS:
        cfg = port_configs.get_reduced(arch)
        model = get_model(cfg)
        lm = model.build_params(PP.materialize(model.param_specs, torch.Generator().manual_seed(0),
                                               device="cpu"))
        assert type(lm) is kinds[cfg.family], arch
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16),
                                         generator=torch.Generator().manual_seed(1))}
        if cfg.family == "vlm":
            batch["vision"] = vision_pair(cfg, 2, seed=1)[1]
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((2, 16, cfg.d_model),
                                          generator=torch.Generator().manual_seed(1))
        out, _ = make_generate(model)(lm, batch, 3)
        assert out.shape == (2, 3) and bool(((out >= 0) & (out < cfg.vocab)).all()), arch


# ---------------------------------------------------------------------------
# the MoE on identical seeded inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference_on_identical_inputs(arch, dtype, capacity_factor):
    """4 sequences of 48 tokens (capacity 15 slots an expert at cf 1.25
    against a mean load of 12 pairs, 6 at cf 0.5): the port's routing and
    the reference's (its lines replayed in jnp) by the MoE rule, every
    routing decided on these inputs, ``idx``, ranks, ``keep`` and ``dst``
    ``==`` with pairs dropped; the output within 8 ulps (float32) or 2
    (bf16) of the reference's ``moe_ffn``, ``aux`` within 16 float32 ulps."""
    cfg_ref, cfg_port, params, lm = carried_family(
        arch, dtype, seed=3, capacity_factor=capacity_factor)
    rp = jax.tree.map(lambda a: a[1], params["blocks"]["moe"])
    pp = lm.blocks[1]["moe"]
    xj, xt = both(np.random.default_rng(4).standard_normal((4, 48, cfg_port.d_model)), dtype)
    r = PL.moe_route(pp["router"], xt, cfg_port)
    idx, pos, keep, dst, capacity = ref_routing(rp["router"], xj, cfg_ref)
    assert r.capacity == capacity == int(np.ceil(capacity_factor * cfg_port.top_k * 48
                                                 / cfg_port.n_experts))
    ref_logits = np.asarray(jnp.einsum("bsd,de->bse", xj.astype(jnp.float32), rp["router"]))
    routes = moe_rule.hold_calls([moe_rule.Call(
        logits_a=r.logits.numpy(), logits_b=ref_logits, k=cfg_port.top_k, capacity=capacity,
        routing_a=(r.idx.numpy(), r.pos.numpy(), r.keep.numpy()), routing_b=(idx, pos, keep))],
        f"{arch} {dtype}")
    assert routes["route_bound"] == 0 and routes["routings"] == 4 * 48
    for got, want in ((r.idx, idx), (r.pos, pos), (r.keep, keep), (r.dst, dst)):
        assert np.array_equal(got.numpy(), want)
    assert int((~r.keep).sum()) > 0  # the drop path runs
    out, aux = PL.moe_ffn(pp, xt, cfg_port)
    ref_out, ref_aux = RL.moe_ffn(rp, xj, cfg_ref)
    assert out.dtype == TORCH_DTYPE[dtype] and aux.dtype == torch.float32
    close(out.float(), to_np(ref_out), dtype, 8 if dtype == "float32" else 2, "moe out")
    close(aux, np.asarray(ref_aux), "float32", 16, "aux")


def test_moe_padded_lane_leaves_real_lanes_bit_equal():
    """Dispatch is per example: a zero lane beside the real ones (as the
    engine pads a bucket) routes nothing of theirs, and the real lanes'
    outputs are bit-equal whatever the padded lane holds."""
    cfg_ref, cfg_port, params, lm = carried_family("granite-moe-3b-a800m", "bfloat16", seed=3)
    pp = lm.blocks[0]["moe"]
    rng = np.random.default_rng(6)
    _, real = both(rng.standard_normal((3, 20, cfg_port.d_model)), "bfloat16")
    _, other = both(rng.standard_normal((1, 20, cfg_port.d_model)), "bfloat16")
    padded, _ = PL.moe_ffn(pp, torch.cat([real, torch.zeros_like(other)]), cfg_port)
    filled, _ = PL.moe_ffn(pp, torch.cat([real, other]), cfg_port)
    assert torch.equal(padded[:3], filled[:3])
    r = PL.moe_route(pp["router"], torch.cat([real, torch.zeros_like(other)]), cfg_port)
    alone = PL.moe_route(pp["router"], real, cfg_port)
    for name in ("idx", "pos", "keep", "dst"):
        assert torch.equal(getattr(r, name)[:3], getattr(alone, name)), name


# ---------------------------------------------------------------------------
# cross-attention on an odd number of vision tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype, qk_norm):
    """37 vision tokens with a KV chunk of 32 (the padded last chunk, as
    1601 tokens take it at chunk 1024), non-zero gates; the cached form on
    the reference's un-normed K/V (no ``q_norm`` there either: reference
    fault 6)."""
    cfg_ref, cfg_port, params, lm = carried_family(VLM, dtype, seed=8, qk_norm=qk_norm)
    rp = jax.tree.map(lambda a: a[1], params["cross_blocks"]["attn"])
    pp = lm.cross_blocks[1]["attn"]
    assert ("q_norm" in pp) == qk_norm and float(pp["gate"]) != 0.0
    rng = np.random.default_rng(9)
    xj, xt = both(rng.standard_normal((2, 5, cfg_port.d_model)), dtype)
    vj, vt = both(rng.standard_normal((2, 37, cfg_port.d_model)), dtype)
    ulps = 64 if dtype == "float32" else 2
    close(PL.cross_attention(pp, xt, vt, cfg_port).float(),
          to_np(RL.cross_attention(rp, xj, vj, cfg_ref)), dtype, ulps, "cross_attention")
    kj = jnp.einsum("bnd,dhk->bnhk", vj, rp["wk"])
    vvj = jnp.einsum("bnd,dhk->bnhk", vj, rp["wv"])
    kt = torch.as_tensor(to_np(kj)).to(TORCH_DTYPE[dtype])
    vvt = torch.as_tensor(to_np(vvj)).to(TORCH_DTYPE[dtype])
    close(PL.cross_attention_cached(pp, xt[:, :1], kt, vvt, cfg_port).float(),
          to_np(RL.cross_attention_cached(rp, xj[:, :1], kj, vvj, cfg_ref)), dtype, ulps,
          "cross_attention_cached")


# ---------------------------------------------------------------------------
# the reduced archs on carried weights
# ---------------------------------------------------------------------------


def _moe_calls(port_calls, ref_calls, n_layers: int, prompt_len: int, steps: int):
    return moe_rule.pair_calls(port_calls, ref_calls,
                               moe_rule.stream_positions(n_layers, prompt_len, steps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_arch_matches_reference(arch, dtype):
    """forward_hidden, the forward loss with the MoE aux (ce + 0.01 · aux),
    and prefill + every decode step on the port's greedy stream (2 × 32-token
    prompts, 16 new tokens), on the reference's weights: the MoE by the MoE
    rule (float32: every routing decided), the VLM gated by the LM rule.  In
    bf16 the two sides' router inputs differ by bf16 roundings, and some
    prompt routings are tie-bound (5 and 4 of 188 on these inputs, granite
    and arctic): the hidden states are held at the positions before each
    row's first tie, every routing by the rule."""
    cfg_ref, cfg_port, params, lm = carried_family(arch, dtype, seed=7)
    moe = cfg_port.family == "moe"
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg_ref.vocab, size=(2, 32)).astype(np.int32)
    vis_j = vis_t = None
    if not moe:
        vis_j, vis_t = vision_pair(cfg_port, 2, seed=12)

    with moe_rule.recording() as port_fwd, ref_recording() as ref_fwd:
        hidden, aux, _ = PT.forward_hidden(lm, torch.as_tensor(tokens), cfg_port, vision=vis_t)
        ref_hidden, ref_aux, _ = jax.jit(
            lambda p, t, v: RT.forward_hidden(p, t, cfg_ref, vision=v))(
                params, jnp.asarray(tokens), vis_j)
        jax.effects_barrier()
    first_tie = np.full(2, 32)
    if moe:
        routes = moe_rule.hold_calls(_moe_calls(port_fwd, ref_fwd, cfg_port.n_layers, 32, 1),
                                     f"{arch} {dtype} forward")
        first_tie = np.minimum(routes["first_tie"], 32)
        if dtype == "float32":
            assert routes["route_bound"] == 0
        if routes["route_bound"] == 0:  # the same experts: aux moves only with the probs
            close(aux, np.asarray(ref_aux), dtype, 64 if dtype == "float32" else 2, "aux")
    else:
        assert not port_fwd and not ref_fwd and float(aux) == 0.0
    for row, n in enumerate(first_tie):  # positions before the row's first tie
        if n:
            close(hidden[row, :n].float(), to_np(ref_hidden)[row, :n], dtype,
                  64 if dtype == "float32" else 4, f"hidden row {row}")

    if dtype == "float32":
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        pbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
        rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if not moe:
            pbatch["vision"], rbatch["vision"] = vis_t, vis_j
        loss, metrics = get_model(cfg_port).loss_fn(lm, pbatch)
        ref_loss, ref_metrics = ref_get_model(cfg_ref).loss_fn(params, rbatch)
        assert MOE_AUX_WEIGHT == REF_MOE_AUX_WEIGHT == 0.01
        close(metrics["moe_aux"], np.asarray(ref_metrics["moe_aux"]), "float32", 64, "moe_aux")
        if moe:
            want = metrics["ce"] + 0.01 * metrics["moe_aux"]
            assert float(loss) == float(want) and float(metrics["moe_aux"]) > 0
        scale = float(np.abs(to_np(RT.lm_head(params, ref_hidden, cfg_ref))).max())
        assert abs(float(loss) - float(ref_loss)) <= 2 * tau(dtype, cfg_port.n_layers, scale) + (
            0.01 * 64 * 2.0**-23 * abs(float(ref_metrics["moe_aux"]))), (float(loss), float(ref_loss))

    model = get_model(cfg_port)
    batch = {"tokens": torch.as_tensor(tokens)}
    if not moe:
        batch["vision"] = vis_t
    stream, _ = make_generate(model)(lm, batch, 16)
    with moe_rule.recording() as port_calls, ref_recording() as ref_calls:
        port = stream_logits(model, lm, tokens, stream, vision=vis_t)
        ref = ref_stream_logits(cfg_ref, params, tokens, stream.numpy(), vision=vis_j)
        jax.effects_barrier()
    what = f"{arch} {dtype}"
    if moe:
        summary = moe_rule.hold(stream, port, ref, dtype, cfg_port.n_layers,
                                _moe_calls(port_calls, ref_calls, cfg_port.n_layers, 32, 16),
                                32, what)
        # prefill: 2 × 32 tokens a layer; then 15 decode steps of 2 tokens
        assert summary["routings"] == cfg_port.n_layers * (2 * 32 + 15 * 2)
        if dtype == "float32":
            assert summary["route_bound"] == 0 and summary["steps_held"] == summary["steps"]
    else:
        hold(stream, port, ref, dtype, cfg_port.n_layers, what)


def test_vlm_zero_gates_keep_vision_out_and_gates_let_it_in():
    """With the materialized zero gates every cross layer adds exactly 0: a
    changed ``vision`` leaves the logits bit-equal, on both sides.  With
    non-zero gates the same change moves them."""
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
    for gates in (False, True):
        cfg_ref, cfg_port, params, lm = carried_family(VLM, "float32", seed=2, gates=gates)
        outs = []
        for seed in (20, 21):
            vj, vt = vision_pair(cfg_port, 2, seed)
            with torch.inference_mode():
                port = lm(torch.as_tensor(tokens), vt)
            ref = RT.lm_head(params, RT.forward_hidden(params, jnp.asarray(tokens), cfg_ref,
                                                       vision=vj)[0], cfg_ref)
            outs.append((port.numpy(), to_np(ref)))
        (p0, r0), (p1, r1) = outs
        if gates:
            assert not np.array_equal(p0, p1) and not np.array_equal(r0, r1)
        else:
            assert np.array_equal(p0, p1) and np.array_equal(r0, r1)
    with pytest.raises(ValueError, match="requires vision"):
        PT.forward_hidden(lm, torch.as_tensor(tokens), cfg_port)
    with pytest.raises(AssertionError, match="requires vision"):
        RT.forward_hidden(params, jnp.asarray(tokens), cfg_ref)


def test_vlm_with_qk_norm_follows_reference_fault_6():
    """A ``qk_norm=True`` variant of the reduced VLM: the reference's
    forward normalizes the cross-attention's q and k, its decode and its
    prefilled cross K/V do not (reference fault 6, ROADMAP.md section 3), so
    its decode differs from its forward.  The port keeps this and is held to
    it by the LM rule, gated, in float32."""
    cfg_ref, cfg_port, params, lm = carried_family(VLM, "float32", seed=10, qk_norm=True)
    tokens = np.random.default_rng(14).integers(0, 256, size=(2, 16)).astype(np.int32)
    vj, vt = vision_pair(cfg_port, 2, seed=15)
    model = get_model(cfg_port)
    stream, _ = make_generate(model)(lm, {"tokens": torch.as_tensor(tokens), "vision": vt}, 6)
    port = stream_logits(model, lm, tokens, stream, vision=vt)
    hold(stream, port, ref_stream_logits(cfg_ref, params, tokens, stream.numpy(), vision=vj),
         "float32", cfg_port.n_layers, "qk_norm vlm")
    # The quirk itself: teacher-forced decode logits are not the forward's.
    full = np.concatenate([tokens, stream.numpy()], axis=1)
    with torch.inference_mode():
        fwd = lm(torch.as_tensor(full), vt)[:, 15:21].float().numpy()
    assert np.abs(fwd[:, 1:] - port[:, 1:]).max() > 1e-3


def test_lm_rule_scale_leaves_out_padded_columns():
    """granite-moe's vocabulary (49,155) pads to 49,280 columns, masked to
    −1e30 on both sides: τ scales with the largest valid logit, so a
    difference just past that τ fails the rule (with the masked columns in
    the scale, τ would be about 10²⁴ and hold anything)."""
    ref = np.full((1, 1, 8), -1e30, np.float32)
    ref[..., :6] = [1.0, -2.0, 0.5, 0.25, 0.0, 0.1]
    bound = tau("float32", 2, np.float64(2.0))
    port = ref.copy()
    port[0, 0, 2] += 0.5 * bound
    hold(np.zeros((1, 1), np.int64), port, ref, "float32", 2, "inside τ")
    port[0, 0, 2] += bound
    with pytest.raises(AssertionError, match="> τ"):
        hold(np.zeros((1, 1), np.int64), port, ref, "float32", 2, "past τ")
