"""The port's enc-dec family (``repro_torch.models.encdec``, the shared
``layer_norm``/``gelu_mlp``, ``get_model``, the ``"lm"`` workload and
``launch.serve`` with ``frames``) against the JAX reference on the CPU, at
the reduced whisper-large-v3, on weights carried by
``convert.lm_params_from_reference``.

Tolerances as in ``tests/test_torch_lm_ssm.py``: a single layer within 2⁻¹⁸
(float32) or 2⁻⁶ (bfloat16) of the largest magnitude of the reference's
output, the whole arch by the LM rule of ``tests/lm_rule.py`` at
``depth(cfg)`` (encoder and decoder layers), integer outputs with ``==``.
Reference fault 7 (the decode's cross-attention over zero-padded memory
slots) is reproduced, not repaired.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lm_rule import depth, hold, stream_logits
from repro.engine.adapters import LMEngineSolver as RefLMEngineSolver
from repro.launch import serve as ref_serve
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models.model import ENCDEC_DECODE_MEMORY_LEN as REF_MEMORY_LEN
from repro.models.model import ENCDEC_PREFILL_PROMPT_LEN as REF_PROMPT_LEN
from repro.models.model import get_model as ref_get_model
from repro_torch import configs as port_configs
from repro_torch import convert, engine
from repro_torch.launch import serve as port_serve
from repro_torch.models import encdec as PE
from repro_torch.models import layers as PL
from repro_torch.models import params as PP
from repro_torch.models.model import (ENCDEC_DECODE_MEMORY_LEN, ENCDEC_PREFILL_PROMPT_LEN,
                                      get_model)
from repro_torch.models.steps import make_generate
from test_torch_lm import TORCH_DTYPE, both, close, ref_stream_logits, to_np
from test_torch_lm_serve import held_stream, port_solver_on
from test_torch_lm_ssm import (BLOCK_ULPS, FULL_PARAMS, carried_arch, converter_keeps_bits,
                               held_arch, spec_leaves_equal)

ARCH = "whisper-large-v3"


def reference_frames(batch: int, prompt_len: int, d_model: int, seed: int) -> np.ndarray:
    """The frames ``repro.launch.serve.serve`` draws for an enc-dec arch:
    one (prompt_len, d_model) bf16 normal per request from the fourth of its
    five seed keys."""
    _, _, _, k_frames, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    return np.stack([np.asarray(jax.random.normal(key, (prompt_len, d_model), jnp.bfloat16))
                     for key in jax.random.split(k_frames, batch)])


def frames_pair(batch: int, t_enc: int, d_model: int, seed: int):
    """Seeded bf16 frames as a jax array and a CPU torch tensor."""
    return both(np.random.default_rng(seed).standard_normal((batch, t_enc, d_model)), "bfloat16")


# ---------------------------------------------------------------------------
# specs and the converter
# ---------------------------------------------------------------------------


def test_param_and_cache_specs_equal_reference():
    """Every parameter leaf (the cross-attention without biases, the LayerNorm
    ``w``/``b`` pairs, no ``lm_head``) and every cache leaf (the cross cache
    of ``ENCDEC_DECODE_MEMORY_LEN`` slots), at full and reduced size."""
    from repro import configs as ref_configs
    from repro.models import params as RP

    assert (ENCDEC_DECODE_MEMORY_LEN, ENCDEC_PREFILL_PROMPT_LEN) == (REF_MEMORY_LEN,
                                                                     REF_PROMPT_LEN) == (1500, 16)
    for get in ("get_config", "get_reduced"):
        ref_model = ref_get_model(getattr(ref_configs, get)(ARCH))
        model = get_model(getattr(port_configs, get)(ARCH))
        spec_leaves_equal(ref_model.param_specs, model.param_specs)
        assert PP.param_bytes(model.param_specs) == RP.param_bytes(ref_model.param_specs)
        for b, s in ((3, 48), (32, 80)):
            spec_leaves_equal(ref_model.cache_specs(b, s), model.cache_specs(b, s))
    specs = get_model(port_configs.get_config(ARCH)).param_specs
    assert PP.count_params(specs) == FULL_PARAMS[ARCH] == 1_535_595_520
    assert "lm_head" not in specs and "bq" not in specs["dec_blocks"]["cross_attn"]


def test_converter_keeps_names_dtypes_and_bits():
    cfg_ref, cfg_port, params, lm = carried_arch(ARCH, "bfloat16", seed=5)
    converter_keeps_bits(params, lm, {"enc_blocks": 1, "dec_blocks": 1})
    state = lm.state_dict()
    assert isinstance(lm, PE.EncDecLM) and "dec_blocks.1.cross_attn.wk" in state
    assert "enc_norm.b" in state and "dec_blocks.0.self_attn.bq" in state


# ---------------------------------------------------------------------------
# the layers on seeded inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_sinusoid_match_reference(dtype):
    """``layer_norm`` on rows with a large mean (where E[x²] − μ² cancels),
    and ``sinusoid`` (its frequencies divide by d/2 − 1) at offsets 0 and 1499
    for one decode position.  The sinusoid is held within 2⁻¹⁸ of its largest
    angle (position × frequency): XLA's and torch's float32 ``exp`` differ by
    an ulp on some frequencies, which moves sin and cos by up to the
    position times that ulp (1.2e-4 at position 1499 of 1280 columns)."""
    rng = np.random.default_rng(0)
    xj, xt = both(3.0 + rng.standard_normal((2, 9, 64)), dtype)
    wj, wt = both(1 + 0.1 * rng.standard_normal(64), "bfloat16")
    bj, bt = both(0.1 * rng.standard_normal(64), "bfloat16")
    got = PL.layer_norm(xt, wt, bt)
    assert got.dtype == TORCH_DTYPE[dtype]
    close(got.float(), to_np(RL.layer_norm(xj, wj, bj)), dtype, BLOCK_ULPS[dtype], "layer_norm")
    for seq, d, offset in ((32, 64, 0), (1500, 1280, 0), (1, 64, 1499)):
        got, want = PE.sinusoid(seq, d, offset).numpy(), np.asarray(RE.sinusoid(seq, d, offset))
        assert got.shape == want.shape == (seq, d)
        bound = BLOCK_ULPS["float32"] * 2.0**-23 * (offset + seq - 1)
        assert np.abs(got - want).max() <= bound, (seq, d, offset, np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference_and_needs_the_tanh_gelu(dtype):
    """The biased GELU MLP against the reference's; the same MLP with
    torch's default (exact erf) GELU misses the float32 tolerance."""
    cfg_ref, cfg_port, params, lm = carried_arch(ARCH, dtype, seed=2)
    rp = jax.tree.map(lambda a: a[1], params["dec_blocks"]["mlp"])
    pp = lm.dec_blocks[1]["mlp"]
    xj, xt = both(np.random.default_rng(3).standard_normal((2, 5, cfg_port.d_model)), dtype)
    want = to_np(RL.gelu_mlp(rp, xj))
    close(PL.gelu_mlp(pp, xt).float(), want, dtype, BLOCK_ULPS[dtype], "gelu_mlp")
    if dtype == "float32":
        h = PL.dot(xt, pp["w1"]) + pp["b1"].to(xt.dtype)
        exact = PL.dot(F.gelu(h), pp["w2"]) + pp["b2"].to(xt.dtype)
        with pytest.raises(AssertionError, match="ulps of float32"):
            close(exact, want, dtype, BLOCK_ULPS[dtype], "erf gelu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_decoder_blocks_match_reference(dtype):
    """The encoder (non-causal, no RoPE, 2 layers) on 40 frames, and the
    decoder over 24 tokens with the self and cross K/V it collects: within
    the single-layer tolerance for each layer passed (2 for the memory, 4
    for the decoder's outputs)."""
    cfg_ref, cfg_port, params, lm = carried_arch(ARCH, dtype, seed=3)
    fj, ft = frames_pair(2, 40, cfg_port.d_model, seed=4)
    tol = BLOCK_ULPS[dtype] * cfg_port.n_encoder_layers
    memory = PE.encode(lm, ft, cfg_port)
    ref_memory = jax.jit(RE.encode, static_argnums=2)(params, fj, cfg_ref)
    close(memory.float(), to_np(ref_memory), dtype, tol, "encoder memory")
    tokens = np.random.default_rng(5).integers(0, cfg_port.vocab, (2, 24)).astype(np.int32)
    x, kv = PE.decode_sequence(lm, memory, torch.as_tensor(tokens), cfg_port, collect_kv=True)
    ref_x, ref_kv = jax.jit(RE.decode_sequence, static_argnums=(3, 4))(
        params, ref_memory, jnp.asarray(tokens), cfg_ref, True)
    close(x.float(), to_np(ref_x), dtype, tol * 2, "decoder hidden")
    for name, got, want in zip(("k", "v", "cross_k", "cross_v"), kv, ref_kv):
        assert tuple(got.shape) == want.shape and got.dtype == TORCH_DTYPE[dtype]
        close(got.float(), to_np(want), dtype, tol * 2, name)


# ---------------------------------------------------------------------------
# the reduced arch on carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arch_matches_reference(dtype):
    """The forward's logits and loss, then prefill and every decode step on
    the port's greedy stream (2 × 32-token prompts, 32 frames, 16 new
    tokens), by the LM rule at ``depth(cfg)`` = 4 (2 encoder, 2 decoder
    layers); the decode runs against the 1500-slot cross cache of reference
    fault 7 on both sides."""
    cfg_ref, cfg_port, params, lm = carried_arch(ARCH, dtype, seed=7)
    assert depth(cfg_port) == 4
    fj, ft = frames_pair(2, 32, cfg_port.d_model, seed=8)
    summary = held_arch(cfg_ref, cfg_port, params, lm, dtype, extra_ref={"frames": fj},
                        extra_port={"frames": ft})
    assert summary["steps"] == 2 * 16


def test_encdec_padded_cross_cache_follows_reference_fault_7():
    """At T_enc = 32 the decode cache grafts the frames' cross K/V into the
    first 32 of 1500 slots, and the cached cross-attention masks none: the
    zero slots take softmax weight.  The port's teacher-forced decode equals
    the reference's decode (by the rule), and both differ from their own
    forward.  At T_enc = 1500, the cache's length, decode equals the forward
    within float32 rounding (|Δ| ≤ 1e-6)."""
    cfg_ref, cfg_port, params, lm = carried_arch(ARCH, "float32", seed=9)
    model = get_model(cfg_port)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg_port.vocab, (2, 16)).astype(np.int32)
    for t_enc in (32, ENCDEC_DECODE_MEMORY_LEN):
        fj, ft = frames_pair(2, t_enc, cfg_port.d_model, seed=t_enc)
        stream, _ = make_generate(model)(lm, {"tokens": torch.as_tensor(tokens), "frames": ft}, 6)
        port = stream_logits(model, lm, tokens, stream, frames=ft)
        full = np.concatenate([tokens, stream.numpy()], axis=1)
        with torch.inference_mode():
            fwd = lm(torch.as_tensor(full), ft)[:, 15:21].float().numpy()
        gap = np.abs(fwd[:, 1:] - port[:, 1:]).max()  # the decode steps
        assert np.abs(fwd[:, 0] - port[:, 0]).max() <= 1e-6  # prefill sees the true memory
        if t_enc == 32:
            ref = ref_stream_logits(cfg_ref, params, tokens, stream.numpy(), frames=fj)
            hold(stream, port, ref, "float32", depth(cfg_port), "fault 7")
            ref_fwd = to_np(RE.lm_logits(params, RE.decode_sequence(
                params, RE.encode(params, fj, cfg_ref), jnp.asarray(full), cfg_ref)[0], cfg_ref))
            assert np.abs(ref_fwd[:, 16:21] - ref[:, 1:]).max() > 1e-3
            assert gap > 1e-3
        else:
            assert gap <= 1e-6, gap


# ---------------------------------------------------------------------------
# the serving path against repro.launch.serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
def test_serve_matches_reference_by_the_rule(once):
    """The reference's serve at its defaults (4 × 32-token prompts with 32
    frames each, 16 new tokens, seed 0) and the port's serve of its prompts
    and frames on its weights: the report's fields, and the streams by the
    LM rule at ``depth(cfg)``."""
    from test_torch_lm_serve import reference_draws

    ref_report = ref_serve.serve(ARCH, once=once)
    ref_lm, prompts, _ = reference_draws(ARCH, 4, 32, seed=0)
    frames = reference_frames(4, 32, ref_lm.cfg.d_model, seed=0)
    lm = port_solver_on(ref_lm)
    report, tokens = port_serve.serve_prompts(
        lm, torch.as_tensor(np.array(prompts)), 16, torch.Generator().manual_seed(0),
        frames=convert._tensor_from_reference(frames), once=once)
    assert set(report) == set(ref_report) | {"device"} and report["device"] == "cpu"
    for key in ("arch", "batch", "prompt_len", "new_tokens", "engine"):
        assert report[key] == ref_report[key], key
    rule = held_stream(lm, ref_lm.cfg, ref_lm.params, prompts, tokens, frames=frames,
                       what="whisper serve")
    if rule["tokens_not_ref_argmax"] == 0:
        assert report["sample"] == ref_report["sample"]


def test_lm_adapter_packs_frames_and_zero_pads_like_a_direct_generate():
    """Through the registry: a 1-D request and a 2-lane request with their
    frames share one 4-lane slab, the padded lane's tokens and frames zero;
    each result is its rows of a direct generate of the bucket, and the
    signature carries ``("frames",)`` as the reference's does.  Frames reach
    the logits."""
    ref_lm = RefLMEngineSolver(ARCH, jax.random.PRNGKey(1))
    lm = port_solver_on(ref_lm)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, 256, (3, 9), generator=gen, dtype=torch.int32)
    frames = port_serve.draw_frames(9, lm.cfg.d_model, 3, gen)
    payloads = [{"tokens": toks[0], "frames": frames[0], "max_new_tokens": 5},
                {"tokens": toks[1:], "frames": frames[1:], "max_new_tokens": 5}]
    assert lm.signature(payloads[0]) == (9, 5, ("frames",)) == ref_lm.signature(
        {"tokens": toks[0].numpy(), "frames": frames[0].float().numpy(), "max_new_tokens": 5})
    seen = []
    generate = lm._generate
    lm._generate = lambda params, batch_in, n: (seen.append(batch_in), generate(
        params, batch_in, n))[1]
    eng = engine.Engine(torch.Generator().manual_seed(0), device="cpu")
    eng.install("lm", lm)
    futs = [eng.submit(engine.Request("lm", p)) for p in payloads]
    stats = eng.drain()
    assert stats["slabs_per_bucket"] == {"lm:(9, 5, ('frames',)):batch4": 1}
    batch = {"tokens": torch.cat([toks, torch.zeros((1, 9), dtype=torch.int32)]),
             "frames": torch.cat([frames, torch.zeros_like(frames[:1])])}
    assert len(seen) == 1 and seen[0].keys() == batch.keys()
    for name in batch:
        assert seen[0][name].dtype == batch[name].dtype and torch.equal(seen[0][name], batch[name])
    direct, _ = make_generate(lm.model)(lm.params, batch, 5)
    assert torch.equal(futs[0].result(), direct[0])
    assert torch.equal(futs[1].result(), direct[1:3])
    with torch.inference_mode():
        moved = lm.params(batch["tokens"], batch["frames"].flip(-1))[:, -1]
        base = lm.params(batch["tokens"], batch["frames"])[:, -1]
    assert not torch.equal(moved, base)
    with pytest.raises(ValueError, match="requires frames"):
        lm.signature({"tokens": toks[0], "max_new_tokens": 5})


def test_serve_draws_frames_after_the_prompts():
    """``serve`` draws the weights, then the prompts, then (prompt_len,
    d_model) bf16 frames per request from one generator; the CLI's report
    for whisper equals ``serve``'s, and its float32 variant serves too."""
    cfg = port_configs.get_reduced(ARCH)
    gen = torch.Generator().manual_seed(0)
    model = get_model(cfg)
    PP.materialize(model.param_specs, gen, "cpu")
    prompts = port_serve.draw_prompts(cfg.vocab, 2, 12, gen)
    frames = port_serve.draw_frames(12, cfg.d_model, 2, gen)
    assert frames.shape == (2, 12, cfg.d_model) and frames.dtype == torch.bfloat16
    lm = port_serve.LMEngineSolver(ARCH, torch.Generator().manual_seed(0), device="cpu")
    _, tokens = port_serve.serve_prompts(lm, prompts, 4, gen, frames=frames)
    report = port_serve.serve(ARCH, batch=2, prompt_len=12, max_new_tokens=4, device="cpu")
    assert report["sample"] == tokens[0].tolist()
    f32 = dataclasses.replace(cfg, dtype="float32")
    out, _ = make_generate(get_model(f32))(
        get_model(f32).build_params(PP.materialize(get_model(f32).param_specs,
                                                   torch.Generator().manual_seed(0), "cpu")),
        {"tokens": prompts, "frames": frames}, 3)
    assert out.shape == (2, 3)
