"""The port's dense LM (``repro_torch.models``, ``repro_torch.configs``,
``convert.lm_params_from_reference``) against the JAX reference on the CPU.

Configs are held with ``==``; the layers on seeded numpy inputs within a
stated number of ulps of the largest magnitude of the reference's output
(float32 2⁻²³, bfloat16 2⁻⁸); each reduced dense arch on the reference's
carried weights by the LM rule of ``tests/lm_rule.py`` (logits under
teacher forcing on the port's own greedy stream, τ stated there), in
float32 and bfloat16.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_rule import hold, stream_logits, tau
from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import steps as r_steps
from repro.models import transformer as RT
from repro.models.model import get_model as ref_get_model
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import layers as PL
from repro_torch.models import params as PP
from repro_torch.models import transformer as PT
from repro_torch.models.model import get_model
from repro_torch.models.steps import make_generate

DENSE = ("qwen2-1.5b", "codeqwen1.5-7b", "h2o-danube-1.8b", "qwen3-4b")
EPS = {"float32": 2.0**-23, "bfloat16": 2.0**-8}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def close(got, want, dtype: str, ulps: float, what: str = "") -> None:
    """|got − want| ≤ ulps · ε(dtype) · max|want| elementwise."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = ulps * EPS[dtype] * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |Δ| {err} > {bound} ({ulps} ulps of {dtype})"


def to_np(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


def both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(JAX_DTYPE[dtype])
    return j, torch.as_tensor(np.array(to_np(j))).to(TORCH_DTYPE[dtype])


def ref_tree(cfg, seed: int):
    """The reference's materialized parameters with the zeros/ones leaves
    (biases, norm weights) replaced by seeded non-trivial values, so that
    every branch of the layers is exercised."""
    params = RP.materialize(ref_get_model(cfg).param_specs, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'")):
            leaf = jnp.asarray(0.05 * rng.standard_normal(leaf.shape), leaf.dtype)
        elif any(k in name for k in ("ln1", "ln2", "final_norm", "q_norm", "k_norm")):
            leaf = jnp.asarray(1.0 + 0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def carried(cfg_ref, cfg_port, seed: int):
    """(reference params, the port's DenseLM on the CPU holding them)."""
    params = ref_tree(cfg_ref, seed)
    lm = convert.lm_params_from_reference(
        cfg_port, jax.tree.map(np.asarray, params), device="cpu")
    return params, lm


def ref_stream_logits(cfg, params, prompts, stream, vision=None, frames=None) -> np.ndarray:
    """The reference's (B, T, V) logits teacher-forced on ``stream`` after
    ``prompts`` (and a VLM's ``vision``, an enc-dec model's ``frames``): its
    jitted prefill, then its
    jitted decode step on the zeroed and grafted cache, as
    ``repro.models.steps.make_generate`` runs them."""
    model = ref_get_model(cfg)
    prefill = jax.jit(model.prefill_fn)
    decode = jax.jit(model.decode_fn)
    b, length = prompts.shape
    steps = stream.shape[1]
    batch = {"tokens": jnp.asarray(prompts)}
    if vision is not None:
        batch["vision"] = jnp.asarray(vision)
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    logits, prefill_cache = prefill(params, batch)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         RP.abstract(model.cache_specs(b, length + steps)))
    cache = r_steps.graft_cache(cache, prefill_cache)
    out = [to_np(logits)]
    for t in range(1, steps):
        logits, cache = decode(params, cache, jnp.asarray(stream[:, t - 1 : t]),
                               jnp.int32(length + t - 1))
        out.append(to_np(logits))
    return np.stack(out, axis=1)


def configs_pair(arch: str, dtype: str):
    return (dataclasses.replace(ref_configs.get_reduced(arch), dtype=dtype),
            dataclasses.replace(port_configs.get_reduced(arch), dtype=dtype))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_equals_reference(arch):
    for get in ("get_config", "get_reduced"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(port_configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), (arch, get)
        for prop in ("padded_vocab", "hd", "d_inner", "ssm_heads"):
            assert getattr(port, prop) == getattr(ref, prop), (arch, get, prop)
        port.validate()
    assert port_configs.sharding_overrides(arch) == ref_configs.sharding_overrides(arch)
    from repro.models import config as ref_mc
    from repro_torch.models import config as port_mc

    cfg = port_configs.get_config(arch)
    assert port_mc.cells_for(cfg) == ref_mc.cells_for(ref_configs.get_config(arch))
    assert port_mc.supports_long_context(cfg) == ref_mc.supports_long_context(
        ref_configs.get_config(arch))


def test_registry_shapes_and_cells_equal_reference():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert port_configs.all_cells() == ref_configs.all_cells()
    from repro.models import config as ref_mc
    from repro_torch.models import config as port_mc

    assert {k: dataclasses.asdict(v) for k, v in port_mc.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_mc.SHAPES.items()}
    for name in ref_mc.SHAPES:
        assert port_configs.get_shape(name).step_name == ref_configs.get_shape(name).step_name
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# params: specs, materialize, the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_count_and_bytes_equal_reference(arch):
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
            assert (p.shape, p.axes, p.init, p.scale) == (r.shape, r.axes, r.init, r.scale)
    full = get_model(port_configs.get_config("qwen2-1.5b")).param_specs
    assert PP.count_params(full) == 1_777_088_000  # untied lm_head


def test_materialize_is_deterministic_and_in_flatten_order():
    cfg = port_configs.get_reduced("qwen3-4b")
    specs = get_model(cfg).param_specs
    a = PP.materialize(specs, torch.Generator().manual_seed(3), device="cpu")
    b = PP.materialize(specs, torch.Generator().manual_seed(3), device="cpu")
    c = PP.materialize(specs, torch.Generator().manual_seed(4), device="cpu")
    gen = torch.Generator().manual_seed(3)
    for (path, spec), (_, x), (_, y), (_, z) in zip(
            PP.leaves(specs), PP.leaves(a), PP.leaves(b), PP.leaves(c)):
        assert x.dtype == spec.dtype == torch.bfloat16 and tuple(x.shape) == spec.shape
        assert torch.equal(x, y), path
        if spec.init == "normal":
            want = (torch.randn(spec.shape, generator=gen) * spec.scale).to(spec.dtype)
            assert torch.equal(x, want), path
            assert not torch.equal(x, z), path
        else:
            assert torch.all(x == (0 if spec.init == "zeros" else 1)), path
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        PP.materialize(specs, None, device="cpu")
    cache = PP.materialize(get_model(cfg).cache_specs(2, 8), None, device="cpu")
    assert cache["k"].shape == (2, 2, 8, 2, 16) and not cache["k"].any()


def test_lm_params_from_reference_keeps_every_bf16_bit():
    cfg_ref, cfg_port = configs_pair("qwen2-1.5b", "bfloat16")
    params = ref_tree(cfg_ref, seed=5)
    lm = convert.lm_params_from_reference(cfg_port, jax.tree.map(np.asarray, params), "cpu")
    state = lm.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = 0
    for path, leaf in flat:
        keys = [k.key for k in path]
        bits = np.asarray(leaf).view(np.uint16)
        if keys[0] == "blocks":
            for i in range(cfg_port.n_layers):
                got = state[".".join(["blocks", str(i), *keys[1:]])]
                assert got.dtype == torch.bfloat16
                assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), bits[i])
                names += 1
        else:
            got = state[".".join(keys)]
            assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), bits)
            names += 1
    assert names == len(state)
    assert "blocks.1.attn.wq" in state and "lm_head" in state
    bad = jax.tree.map(np.asarray, params)
    bad["blocks"]["mlp"]["wg"] = bad["blocks"]["mlp"]["wg"][:, :, :-1]
    with pytest.raises(ValueError, match="does not match the spec tree"):
        convert.lm_params_from_reference(cfg_port, bad, "cpu")


# ---------------------------------------------------------------------------
# layers on seeded numpy inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((2, 9, 3, 16)), dtype)
    wj, wt = both(1 + 0.1 * rng.standard_normal(16), "bfloat16")
    close(PL.rms_norm(xt, wt, 1e-6).float(), to_np(RL.rms_norm(xj, wj, 1e-6)), dtype, 2, "rms")
    for pos in (np.arange(9), np.stack([np.arange(9) + 3, np.arange(9) * 7])):
        got = PL.apply_rope(xt, torch.as_tensor(pos, dtype=torch.int32), 1e6).float()
        want = to_np(RL.apply_rope(xj, jnp.asarray(pos, jnp.int32), 1e6))
        close(got, want, dtype, 16 if dtype == "float32" else 1, "rope")
    close(PL.rope_frequencies(16, 1e4), np.asarray(RL.rope_frequencies(16, 1e4)), "float32", 2)


ATTENTION_CASES = {
    # name: (Sq, Sk, kwargs); H = 4 query heads on KV = 2 (GQA groups of 2)
    "causal": (24, 24, dict(causal=True, chunk=8)),
    "causal_q_chunk": (32, 32, dict(causal=True, chunk=8, q_chunk=8)),
    "window_q_chunk": (32, 32, dict(causal=True, window=12, chunk=8, q_chunk=8)),
    "padded_last_chunk": (21, 21, dict(causal=True, chunk=8)),
    "kv_valid_len": (1, 20, dict(causal=False, q_offset=13, kv_valid_len=14, chunk=8)),
    "noncausal_full": (5, 13, dict(causal=False, chunk=16)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_attention_matches_reference(case, dtype):
    sq, sk, kw = ATTENTION_CASES[case]
    rng = np.random.default_rng(sq * 100 + sk)
    qj, qt = both(rng.standard_normal((2, sq, 4, 16)), dtype)
    kj, kt = both(rng.standard_normal((2, sk, 2, 16)), dtype)
    vj, vt = both(rng.standard_normal((2, sk, 2, 16)), dtype)
    got = PL.flash_attention(qt, kt, vt, **kw)
    want = RL.flash_attention(qj, kj, vj, **kw)
    assert got.dtype == TORCH_DTYPE[dtype]
    close(got.float(), to_np(want), dtype, 64 if dtype == "float32" else 2, case)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,cache", [("qwen2-1.5b", 24), ("h2o-danube-1.8b", 32)])
def test_decode_attention_matches_reference_on_both_branches(arch, cache, dtype):
    """A linear cache (qwen2) and the ring buffer (h2o-danube, cache ==
    window), at an index inside the first lap and one past it."""
    cfg_ref, cfg_port = configs_pair(arch, dtype)
    params, lm = carried(cfg_ref, cfg_port, seed=1)
    rp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    pp = lm.blocks[0]["attn"]
    rng = np.random.default_rng(2)
    xj, xt = both(0.5 * rng.standard_normal((2, 1, cfg_port.d_model)), dtype)
    kv_shape = (2, cache, cfg_port.n_kv_heads, cfg_port.hd)
    for index in (cache - 9, cache + 5) if cache == cfg_port.window else (cache - 9, cache - 1):
        ck, ct = both(rng.standard_normal(kv_shape), dtype)
        vk, vt = both(rng.standard_normal(kv_shape), dtype)
        y, nk, nv = RL.decode_attention(rp, xj, ck, vk, jnp.int32(index), cfg_ref,
                                        window=cfg_ref.window)
        got, gk, gv = PL.decode_attention(pp, xt, ct, vt, index, cfg_port)
        assert gk is ct and gv is vt  # written in place
        close(got.float(), to_np(y), dtype, 64 if dtype == "float32" else 2, f"{arch}@{index}")
        close(gk.float(), to_np(nk), dtype, 16 if dtype == "float32" else 1, "k cache")
        close(gv.float(), to_np(nv), dtype, 16 if dtype == "float32" else 1, "v cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_reference(dtype):
    cfg_ref, cfg_port = configs_pair("qwen3-4b", dtype)
    params, lm = carried(cfg_ref, cfg_port, seed=2)
    rp = jax.tree.map(lambda a: a[1], params["blocks"]["mlp"])
    xj, xt = both(np.random.default_rng(3).standard_normal((2, 5, cfg_port.d_model)), dtype)
    close(PL.swiglu(lm.blocks[1]["mlp"], xt).float(), to_np(RL.swiglu(rp, xj)), dtype,
          64 if dtype == "float32" else 2, "swiglu")


# ---------------------------------------------------------------------------
# the dense archs at reduced size on carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_matches_reference(arch, dtype):
    """forward_hidden, the forward loss, and prefill + every decode step by
    the LM rule, on the reference's weights.  h2o-danube's 16 new tokens
    after a 32-token prompt run its ring buffer (window 32) a lap past."""
    cfg_ref, cfg_port = configs_pair(arch, dtype)
    params, lm = carried(cfg_ref, cfg_port, seed=7)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg_ref.vocab, size=(2, 32)).astype(np.int32)

    hidden, _, _ = PT.forward_hidden(lm, torch.as_tensor(tokens), cfg_port)
    ref_hidden, _, _ = RT.forward_hidden(params, jnp.asarray(tokens), cfg_ref)
    close(hidden.float(), to_np(ref_hidden), dtype, 64 if dtype == "float32" else 4, "hidden")

    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    loss, metrics = get_model(cfg_port).loss_fn(
        lm, {k: torch.as_tensor(v) for k, v in batch.items()})
    ref_loss, _ = ref_get_model(cfg_ref).loss_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    # Every logit within τ moves the log-sum-exp and the gold logit by at most τ.
    scale = float(np.abs(to_np(RT.lm_head(params, ref_hidden, cfg_ref))).max())
    assert loss.dtype == torch.float32 and float(metrics["moe_aux"]) == 0.0
    assert abs(float(loss) - float(ref_loss)) <= 2 * tau(dtype, cfg_port.n_layers, scale), (
        float(loss), float(ref_loss))

    model = get_model(cfg_port)
    stream, _ = make_generate(model)(lm, {"tokens": torch.as_tensor(tokens)}, 16)
    port = stream_logits(model, lm, tokens, stream)
    ref = ref_stream_logits(cfg_ref, params, tokens, stream.numpy())
    hold(stream, port, ref, dtype, cfg_port.n_layers, f"{arch} {dtype}")


def test_prompt_past_the_window_follows_reference():
    """A 40-token prompt past h2o-danube's window of 32: prefill keeps the
    last 32 keys at slots 0-31, and decode writes position p at slot
    p mod 32, as the reference does; the two agree only when the window
    divides the prompt length (reference fault 5, ROADMAP.md section 3), and
    the port is held to the reference as it is, by the rule, in float32."""
    cfg_ref, cfg_port = configs_pair("h2o-danube-1.8b", "float32")
    params, lm = carried(cfg_ref, cfg_port, seed=9)
    tokens = np.random.default_rng(12).integers(0, cfg_ref.vocab, size=(2, 40)).astype(np.int32)
    model = get_model(cfg_port)
    stream, _ = make_generate(model)(lm, {"tokens": torch.as_tensor(tokens)}, 8)
    hold(stream, stream_logits(model, lm, tokens, stream),
         ref_stream_logits(cfg_ref, params, tokens, stream.numpy()), "float32",
         cfg_port.n_layers, "prompt past the window")


def test_decode_matches_forward_dense():
    """Greedy decode over a prompt reproduces the port's own teacher-forced
    logits (the counterpart of ``tests/test_arch_smoke.py``'s test of the
    same name, float32, within 2e-3 as there)."""
    cfg = dataclasses.replace(port_configs.get_reduced("codeqwen1.5-7b"), dtype="float32")
    model = get_model(cfg)
    lm = model.build_params(PP.materialize(model.param_specs, torch.Generator().manual_seed(2),
                                           device="cpu"))
    s = 16
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        full = lm(tokens)  # (1, S, V)
        cache = PP.materialize(model.cache_specs(1, s), None, device="cpu")
        steps = []
        for i in range(s):
            lg, cache = model.decode_fn(lm, cache, tokens[:, i : i + 1], i)
            steps.append(lg)
    dec = torch.stack(steps, dim=1)
    assert torch.allclose(dec, full, atol=2e-3, rtol=2e-3), (dec - full).abs().max()


@pytest.mark.parametrize("new_tokens", [0, 1, 5])
def test_generate_token_accounting(new_tokens):
    """Exactly ``max_new_tokens`` columns: token 0 from the prefill logits,
    token i from decode step i; ``(b, 0)`` for 0; timings present."""
    cfg = port_configs.get_reduced("qwen2-1.5b")
    model = get_model(cfg)
    lm = model.build_params(PP.materialize(model.param_specs, torch.Generator().manual_seed(0),
                                           device="cpu"))
    prompts = torch.randint(0, cfg.vocab, (3, 8), generator=torch.Generator().manual_seed(1))
    out, timing = make_generate(model)(lm, {"tokens": prompts}, new_tokens)
    assert out.shape == (3, new_tokens) and out.dtype == torch.int32 and out.device.type == "cpu"
    assert set(timing) == {"prefill_s", "decode_s"}
    if new_tokens:
        logits, _ = model.prefill_fn(lm, {"tokens": prompts})
        assert torch.equal(out[:, 0], logits.argmax(-1).to(torch.int32))
        longer, _ = make_generate(model)(lm, {"tokens": prompts}, new_tokens + 2)
        assert torch.equal(longer[:, :new_tokens], out)  # a prefix of a longer stream


def test_padded_vocab_columns_are_masked_like_reference():
    """A vocab that is not a multiple of 128 masks the pad columns to −1e30
    in the served dtype (none of the ten configs pads)."""
    cfg_ref = dataclasses.replace(ref_configs.get_reduced("qwen2-1.5b"), vocab=250)
    cfg_port = dataclasses.replace(port_configs.get_reduced("qwen2-1.5b"), vocab=250)
    assert cfg_port.padded_vocab == 256
    params, lm = carried(cfg_ref, cfg_port, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 3, cfg_port.d_model))
    xj, xt = both(x, "bfloat16")
    got = PT.lm_head(lm, xt, cfg_port)
    want = to_np(RT.lm_head(params, xj, cfg_ref))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got[..., 250:].float().numpy(), want[..., 250:])
    close(got.float()[..., :250], want[..., :250], "bfloat16", 1, "lm_head")


@pytest.mark.parametrize("arch", [a for a in ref_configs.ARCH_IDS
                                  if ref_configs.get_reduced(a).family in ("encdec", "zamba", "xlstm")])
def test_other_families_raise_with_roadmap_pointer(arch):
    """The enc-dec, Zamba and xLSTM archs build (they raised
    ``NotImplementedError`` until they were ported); what they refuse still
    raises: a prompt of part of an SSD chunk (Zamba, xLSTM: ``ValueError``
    naming ``ssm_chunk``, at the length where the reference asserts) and a
    batch without ``frames`` (enc-dec)."""
    cfg = port_configs.get_reduced(arch)
    model = get_model(cfg)
    lm = model.build_params(PP.materialize(model.param_specs, torch.Generator().manual_seed(0),
                                           device="cpu"))
    tokens = torch.zeros((1, cfg.ssm_chunk + 1), dtype=torch.int32)
    if cfg.family == "encdec":
        with pytest.raises(KeyError, match="frames"):
            model.prefill_fn(lm, {"tokens": tokens})
    else:
        with pytest.raises(ValueError, match=f"multiple of ssm_chunk={cfg.ssm_chunk}"):
            model.prefill_fn(lm, {"tokens": tokens})
