"""The port's Zamba and xLSTM families (``repro_torch.models.ssm``,
``xlstm``, ``hybrid``, ``get_model``, the ``"lm"`` workload and
``launch.serve``) against the JAX reference on the CPU, at the reduced
configs, on weights carried by ``convert.lm_params_from_reference``.

Every zeros- or ones-initialized leaf (norms, biases, ``a_log``,
``d_skip``, ``dt_bias``, the gate biases) is seeded to a non-trivial value
on both sides.  Module outputs on seeded numpy inputs are held within 2⁻¹⁸
(float32) or 2⁻⁶ (bfloat16) of the largest magnitude of the reference's
output; whole archs by the LM rule of ``tests/lm_rule.py`` at
``depth(cfg)``; integer outputs (tokens where the rule demands, shapes,
counts) with ``==``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_rule import depth, hold, stream_logits, tau
from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import hybrid as RH
from repro.models import params as RP
from repro.models import ssm as RS
from repro.models import xlstm as RX
from repro.models.model import get_model as ref_get_model
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.engine.adapters import LMEngineSolver
from repro_torch.launch import serve as port_serve
from repro_torch.models import hybrid as PH
from repro_torch.models import params as PP
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.models import xlstm as PX
from repro_torch.models.model import get_model
from repro_torch.models.steps import make_generate
from test_torch_lm import TORCH_DTYPE, both, close, configs_pair, ref_stream_logits, to_np
from test_torch_lm_serve import held_stream, port_solver_on, reference_draws

ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-1.3b"
ARCHS = (ZAMBA, XLSTM)
#: A single block's tolerance in ulps of ``close`` (2⁻¹⁸ float32, 2⁻⁶ bf16).
BLOCK_ULPS = {"float32": 32, "bfloat16": 4}
FULL_PARAMS = {"whisper-large-v3": 1_535_595_520, ZAMBA: 2_422_711_200, XLSTM: 2_552_244_560}


def seeded_tree(cfg_ref, seed: int):
    """The reference's materialized parameters with every zeros-initialized
    leaf drawn as 0.1 · N(0, 1) and every ones-initialized leaf as 1 + 0.1 ·
    N(0, 1), in the leaf's dtype, so that every term of the layers runs."""
    specs = ref_get_model(cfg_ref).param_specs
    params = RP.materialize(specs, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for spec, leaf in zip(jax.tree_util.tree_leaves(specs, is_leaf=RP.is_spec), leaves):
        if spec.init in ("zeros", "ones"):
            base = 1.0 if spec.init == "ones" else 0.0
            leaf = jnp.asarray(base + 0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def carried_arch(arch: str, dtype: str, seed: int):
    """(reference config, port config, reference params, the port's module
    on the CPU holding them)."""
    cfg_ref, cfg_port = configs_pair(arch, dtype)
    params = seeded_tree(cfg_ref, seed)
    lm = convert.lm_params_from_reference(cfg_port, jax.tree.map(np.asarray, params), "cpu")
    return cfg_ref, cfg_port, params, lm


def spec_leaves_equal(ref_specs, port_specs) -> int:
    """Path, shape, axes, init, scale and dtype of every leaf equal; returns
    the leaf count."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_specs, is_leaf=RP.is_spec)[0]
    port_leaves = list(PP.leaves(port_specs))
    assert len(ref_leaves) == len(port_leaves)
    for (path, r), (name, p) in zip(ref_leaves, port_leaves):
        assert ".".join(k.key for k in path) == name
        assert (p.shape, p.axes, p.init, p.scale) == (r.shape, r.axes, r.init, r.scale), name
        assert str(p.dtype).removeprefix("torch.") == np.dtype(r.dtype).name, name
    return len(port_leaves)


def converter_keeps_bits(params, lm, stacked) -> None:
    """Every reference leaf lands bit for bit under its dotted name, the
    leading ``stacked[key]`` axes of each stacked key unstacked."""
    state = lm.state_dict()
    count = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        want = np.asarray(leaf)
        for index in np.ndindex(*want.shape[: stacked.get(keys[0], 0)]):
            got = state[".".join([keys[0], *map(str, index), *keys[1:]])]
            one = want[index]
            assert tuple(got.shape) == one.shape
            assert str(got.dtype).removeprefix("torch.") == one.dtype.name
            if one.dtype.name == "bfloat16":
                assert np.array_equal(got.view(torch.int16).numpy(), one.view(np.int16))
            else:
                assert np.array_equal(got.numpy(), one)
            count += 1
    assert count == len(state)


def held_arch(cfg_ref, cfg_port, params, lm, dtype, extra_ref=None, extra_port=None):
    """forward_hidden's logits and the forward loss, then prefill and every
    decode step on the port's greedy stream (2 × 32-token prompts, 16 new
    tokens), by the LM rule at ``depth(cfg)``; returns the rule's summary.
    ``extra_*``: further batch entries (an enc-dec model's frames)."""
    extra_ref, extra_port = extra_ref or {}, extra_port or {}
    n = depth(cfg_port)
    tokens = np.random.default_rng(11).integers(0, cfg_ref.vocab, size=(2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    pbatch = {**{k: torch.as_tensor(v) for k, v in batch.items()}, **extra_port}
    rbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, **extra_ref}
    model, ref_model = get_model(cfg_port), ref_get_model(cfg_ref)

    with torch.inference_mode():
        logits = lm(pbatch["tokens"], *extra_port.values()).float().numpy()
    ref_logits = to_np(jax.jit(ref_forward_logits, static_argnums=2)(params, rbatch, cfg_ref))
    scale = np.abs(ref_logits).max(axis=-1)
    assert np.all(np.abs(logits - ref_logits).max(axis=-1) <= tau(dtype, n, scale)), "forward"

    loss, metrics = model.loss_fn(lm, pbatch)
    ref_loss, _ = jax.jit(ref_model.loss_fn)(params, rbatch)
    assert loss.dtype == torch.float32 and float(metrics["moe_aux"]) == 0.0
    assert abs(float(loss) - float(ref_loss)) <= 2 * tau(dtype, n, float(scale.max())), (
        float(loss), float(ref_loss))

    prompt = {"tokens": pbatch["tokens"], **extra_port}
    stream, _ = make_generate(model)(lm, prompt, 16)
    frames = extra_port.get("frames")
    port = stream_logits(model, lm, tokens, stream, frames=frames)
    ref = ref_stream_logits(cfg_ref, params, tokens, stream.numpy(), frames=extra_ref.get("frames"))
    return hold(stream, port, ref, dtype, n, f"{cfg_port.name} {dtype}")


def ref_forward_logits(params, batch, cfg):
    """The reference's every-position logits (the hidden states of its
    family's forward through its head)."""
    from repro.models import encdec as RE
    from repro.models import transformer as RT

    if cfg.family == "encdec":
        memory = RE.encode(params, batch["frames"], cfg)
        hidden = RE.decode_sequence(params, memory, batch["tokens"], cfg)[0]
        return RE.lm_logits(params, hidden, cfg)
    forward = RH.zamba_forward_hidden if cfg.family == "zamba" else RH.xlstm_forward_hidden
    return RT.lm_head(params, forward(params, batch["tokens"], cfg)[0], cfg)


# ---------------------------------------------------------------------------
# specs and the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_reference(arch):
    """Every parameter and decode-cache leaf (path, shape, axes, init, scale,
    dtype), the counts and bytes, at full and reduced size."""
    for get in ("get_config", "get_reduced"):
        ref_model = ref_get_model(getattr(ref_configs, get)(arch))
        model = get_model(getattr(port_configs, get)(arch))
        spec_leaves_equal(ref_model.param_specs, model.param_specs)
        assert PP.count_params(model.param_specs) == RP.count_params(ref_model.param_specs)
        assert PP.param_bytes(model.param_specs) == RP.param_bytes(ref_model.param_specs)
        for b, s in ((3, 32), (128, 576)):
            spec_leaves_equal(ref_model.cache_specs(b, s), model.cache_specs(b, s))
    full = get_model(port_configs.get_config(arch)).param_specs
    assert PP.count_params(full) == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_keeps_names_dtypes_and_bits(arch):
    """Zamba's ``blocks`` unstack on (group, block), its ``shared`` block and
    ``shared_ln1``/``shared_ln2`` (G, D) stay whole; xLSTM's ``mblocks`` on
    (group, block), ``sblocks`` on group; float32 leaves stay float32."""
    cfg_ref, cfg_port, params, lm = carried_arch(arch, "bfloat16", seed=5)
    if arch == ZAMBA:
        converter_keeps_bits(params, lm, {"blocks": 2})
        state = lm.state_dict()
        assert state["shared_ln1"].shape == (2, cfg_port.d_model)
        assert state["blocks.1.0.mamba.a_log"].dtype == torch.float32
        assert isinstance(lm, PH.ZambaLM) and "shared.attn.wq" in state
    else:
        converter_keeps_bits(params, lm, {"mblocks": 2, "sblocks": 1})
        state = lm.state_dict()
        assert state["mblocks.1.0.mlstm.w_if"].dtype == torch.float32
        assert isinstance(lm, PH.XLSTMLM) and "sblocks.1.slstm.r_gates" in state


# ---------------------------------------------------------------------------
# the blocks on seeded inputs
# ---------------------------------------------------------------------------


def _block(params, lm, arch: str):
    """(reference block params, port block params) of group 1, block 0's
    Mamba or mLSTM and group 1's sLSTM (None for Zamba)."""
    if arch == ZAMBA:
        return (jax.tree.map(lambda a: a[1, 0], params["blocks"]["mamba"]),
                lm.blocks[1][0]["mamba"], None, None)
    return (jax.tree.map(lambda a: a[1, 0], params["mblocks"]["mlstm"]),
            lm.mblocks[1][0]["mlstm"],
            jax.tree.map(lambda a: a[1], params["sblocks"]["slstm"]), lm.sblocks[1]["slstm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_gated_norm_match_reference(dtype):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((2, 20, 24)), dtype)
    wj, wt = both(rng.standard_normal((4, 24)), "bfloat16")
    bj, bt = both(0.1 * rng.standard_normal(24), "bfloat16")
    got = PS._causal_conv(xt, wt, bt)
    assert got.dtype == TORCH_DTYPE[dtype]
    close(got.float(), to_np(RS._causal_conv(xj, wj, bj)), dtype, BLOCK_ULPS[dtype], "conv")
    close(PX._causal_conv(xt, wt, bt).float(), to_np(RX._causal_conv_silu(xj, wj, bj)), dtype,
          BLOCK_ULPS[dtype], "xlstm conv")
    zj, zt = both(rng.standard_normal((2, 20, 24)), dtype)
    nj, nt = both(1 + 0.1 * rng.standard_normal(24), "bfloat16")
    close(PS._gated_norm(xt, zt, nt, 1e-6).float(), to_np(RS._gated_norm(xj, zj, nj, 1e-6)), dtype,
          BLOCK_ULPS[dtype], "gated_norm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_and_decode_match_reference(dtype):
    """``mamba_forward`` over 3 SSD chunks with its cache (conv tail, final
    state), then ``mamba_decode_step`` from a seeded cache: the output and
    the new conv buffer and state (written in place)."""
    cfg_ref, cfg_port, params, lm = carried_arch(ZAMBA, dtype, seed=2)
    rp, pp, _, _ = _block(params, lm, ZAMBA)
    rng = np.random.default_rng(3)
    xj, xt = both(rng.standard_normal((2, 48, cfg_port.d_model)), dtype)
    tol = BLOCK_ULPS[dtype]
    out, cache = PS.mamba_forward(pp, xt, cfg_port, return_cache=True)
    ref_out, ref_cache = RS.mamba_forward(rp, xj, cfg_ref, return_cache=True)
    close(out.float(), to_np(ref_out), dtype, tol, "mamba out")
    assert cache.conv.dtype == TORCH_DTYPE[dtype] and cache.state.dtype == torch.float32
    close(cache.conv.float(), to_np(ref_cache.conv), dtype, tol, "conv tail")
    close(cache.state, np.asarray(ref_cache.state), dtype, tol, "state")

    init, ref_init = PS.mamba_init_cache(cfg_port, 2), RS.mamba_init_cache(cfg_ref, 2)
    assert [(tuple(t.shape), str(t.dtype)) for t in init] == [
        (r.shape, f"torch.{r.dtype}") for r in ref_init] and not any(t.any() for t in init)
    cj, ct = both(rng.standard_normal(cache.conv.shape), dtype)
    sj, st = both(rng.standard_normal(cache.state.shape), "float32")
    x1j, x1t = both(rng.standard_normal((2, 1, cfg_port.d_model)), dtype)
    conv_t, state_t = ct.clone(), st.clone()
    got, new = PS.mamba_decode_step(pp, x1t, PS.MambaCache(conv_t, state_t), cfg_port)
    want, ref_new = RS.mamba_decode_step(rp, x1j, RS.MambaCache(cj, sj), cfg_ref)
    assert new.conv is conv_t and new.state is state_t  # in place
    close(got.float(), to_np(want), dtype, tol, "mamba decode")
    close(conv_t.float(), to_np(ref_new.conv), dtype, tol, "conv buffer")
    close(state_t, np.asarray(ref_new.state), dtype, tol, "decode state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_and_slstm_forward_and_decode_match_reference(dtype):
    """The chunkwise mLSTM over 2 chunks and the sequential sLSTM over 32
    steps with their caches; each decode step from a seeded cache (the
    sLSTM's n positive, as its recurrence keeps it)."""
    cfg_ref, cfg_port, params, lm = carried_arch(XLSTM, dtype, seed=4)
    rm, pm, rs, ps = _block(params, lm, XLSTM)
    rng = np.random.default_rng(5)
    tol = BLOCK_ULPS[dtype]
    xj, xt = both(rng.standard_normal((2, 32, cfg_port.d_model)), dtype)
    out, cache = PX.mlstm_forward(pm, xt, cfg_port, return_cache=True)
    ref_out, ref_cache = RX.mlstm_forward(rm, xj, cfg_ref, return_cache=True)
    close(out.float(), to_np(ref_out), dtype, tol, "mlstm out")
    close(cache.conv.float(), to_np(ref_cache.conv), dtype, tol, "mlstm conv tail")
    close(cache.state, np.asarray(ref_cache.state), dtype, tol, "mlstm state")

    inits = ((PX.mlstm_init_cache(cfg_port, 2), RX.mlstm_init_cache(cfg_ref, 2)),
             (PX.slstm_init_cache(cfg_port, 2), RX.slstm_init_cache(cfg_ref, 2)))
    for port_init, ref_init in inits:
        got_leaves = jax.tree_util.tree_leaves(port_init)
        want_leaves = jax.tree_util.tree_leaves(ref_init)
        assert [(tuple(t.shape), str(t.dtype), float(t.sum())) for t in got_leaves] == [
            (w.shape, f"torch.{w.dtype}", float(np.asarray(w, np.float32).sum()))
            for w in want_leaves]  # zeros, and the sLSTM's n ones
    x1j, x1t = both(rng.standard_normal((2, 1, cfg_port.d_model)), dtype)
    cj, ct = both(rng.standard_normal(cache.conv.shape), dtype)
    sj, st = both(rng.standard_normal(cache.state.shape), "float32")
    got, _ = PX.mlstm_decode_step(pm, x1t, PX.MLSTMCache(ct, st), cfg_port)
    want, ref_new = RX.mlstm_decode_step(rm, x1j, RX.MLSTMCache(cj, sj), cfg_ref)
    close(got.float(), to_np(want), dtype, tol, "mlstm decode")
    close(ct.float(), to_np(ref_new.conv), dtype, tol, "mlstm conv buffer")
    close(st, np.asarray(ref_new.state), dtype, tol, "mlstm decode state")

    out, (tail, cell) = PX.slstm_forward(ps, xt, cfg_port, return_cache=True)
    ref_out, (ref_tail, ref_cell) = RX.slstm_forward(rs, xj, cfg_ref, return_cache=True)
    close(out.float(), to_np(ref_out), dtype, tol, "slstm out")
    assert torch.equal(tail, xt[:, -3:])
    for name in ("c", "n", "h"):
        close(getattr(cell, name), np.asarray(getattr(ref_cell, name)), dtype, tol,
              f"slstm {name}")
    h_shape = cell.c.shape
    cells = [both(rng.standard_normal(h_shape), "float32"),
             both(1 + np.abs(rng.standard_normal(h_shape)), "float32"),
             both(rng.standard_normal(h_shape), "float32")]
    bj, bt = both(rng.standard_normal(tail.shape), dtype)
    port_cell = PX.SLSTMCache(*(t for _, t in cells))
    got, (new_buf, new_cell) = PX.slstm_decode_step(ps, x1t, (bt, port_cell), cfg_port)
    want, (ref_buf, ref_new_cell) = RX.slstm_decode_step(
        rs, x1j, (bj, RX.SLSTMCache(*(j for j, _ in cells))), cfg_ref)
    assert new_buf is bt and new_cell is port_cell  # in place
    close(got.float(), to_np(want), dtype, tol, "slstm decode")
    close(bt.float(), to_np(ref_buf), dtype, 0, "slstm conv buffer")
    for name in ("c", "n", "h"):
        close(getattr(port_cell, name), np.asarray(getattr(ref_new_cell, name)), dtype, tol,
              f"slstm decode {name}")


# ---------------------------------------------------------------------------
# the reduced archs on carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_reference(arch, dtype):
    """The forward's logits and loss, and prefill + every decode step on the
    port's greedy stream, by the LM rule at ``depth(cfg)`` (6 for the
    reduced Zamba: 4 Mamba layers, 2 shared invocations; 4 for xLSTM)."""
    cfg_ref, cfg_port, params, lm = carried_arch(arch, dtype, seed=7)
    assert depth(cfg_port) == (6 if arch == ZAMBA else 4)
    summary = held_arch(cfg_ref, cfg_port, params, lm, dtype)
    assert summary["steps"] == 2 * 16


def test_prompt_chunk_refusal_on_both_sides():
    """A prompt of part of an SSD chunk: the reference asserts (``ssm.py:81``,
    ``xlstm.py:95``), the port raises ``ValueError`` naming ``ssm_chunk``,
    at the same lengths; whole chunks pass on both sides.  The ``"lm"``
    adapter refuses such a request at submission."""
    for arch in ARCHS:
        cfg_ref, cfg_port, params, lm = carried_arch(arch, "float32", seed=8)
        model, ref_model = get_model(cfg_port), ref_get_model(cfg_ref)
        for length in (8, 16, 24, 33):
            tokens = np.zeros((1, length), np.int32)
            whole = length % cfg_port.ssm_chunk == 0
            if whole:
                model.prefill_fn(lm, {"tokens": torch.as_tensor(tokens)})
                ref_model.prefill_fn(params, {"tokens": jnp.asarray(tokens)})
                continue
            with pytest.raises(ValueError, match=f"multiple of ssm_chunk={cfg_port.ssm_chunk}"):
                model.prefill_fn(lm, {"tokens": torch.as_tensor(tokens)})
            with pytest.raises(AssertionError):
                ref_model.prefill_fn(params, {"tokens": jnp.asarray(tokens)})
        solver = LMEngineSolver(arch, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(ValueError, match="ssm_chunk"):
            solver.signature({"tokens": np.zeros(24, np.int32), "max_new_tokens": 2})


def test_decode_cache_is_in_place_and_o1():
    """Decode writes the cache's tensors in place (no new (G, E, B, H, P, N)
    state per step), and only Zamba's shared-block KV grows with the
    context."""
    for arch in ARCHS:
        cfg = port_configs.get_reduced(arch)
        model = get_model(cfg)
        lm = model.build_params(PP.materialize(model.param_specs,
                                               torch.Generator().manual_seed(0), "cpu"))
        short, long = model.cache_specs(2, 32), model.cache_specs(2, 4096)
        grows = {k for k in short if short[k].shape != long[k].shape}
        assert grows == ({"k", "v"} if arch == ZAMBA else set())
        cache = PP.materialize(model.cache_specs(2, 20), None, "cpu")
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        before = {k: v.clone() for k, v in cache.items()}
        with torch.inference_mode():
            _, out = model.decode_fn(lm, cache, torch.ones((2, 1), dtype=torch.int32), 3)
        assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
        changed = {k for k in cache if not torch.equal(before[k], cache[k])}
        assert changed == ({"conv", "state", "k", "v"} if arch == ZAMBA else set(cache)), changed


# ---------------------------------------------------------------------------
# the serving path against repro.launch.serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_by_the_rule(arch, once):
    """The reference's serve at its defaults (4 × 32-token prompts: two SSD
    chunks of the reduced config; 16 new tokens; seed 0) and the port's serve
    of its prompts on its weights: the report's fields, and the streams by
    the LM rule at ``depth(cfg)``."""
    ref_report = ref_serve.serve(arch, once=once)
    ref_lm, prompts, _ = reference_draws(arch, 4, 32, seed=0)
    lm = port_solver_on(ref_lm)
    report, tokens = port_serve.serve_prompts(
        lm, torch.as_tensor(np.array(prompts)), 16, torch.Generator().manual_seed(0), once=once)
    assert set(report) == set(ref_report) | {"device"} and report["device"] == "cpu"
    for key in ("arch", "batch", "prompt_len", "new_tokens", "engine"):
        assert report[key] == ref_report[key], key
    rule = held_stream(lm, ref_lm.cfg, ref_lm.params, prompts, tokens, what=f"{arch} serve")
    if rule["tokens_not_ref_argmax"] == 0:
        assert report["sample"] == ref_report["sample"]
    assert isinstance(lm.params, (PH.ZambaLM, PH.XLSTMLM)) and not isinstance(lm.params, PT.DenseLM)
