"""The port's LM serving path (the ``"lm"`` engine workload,
``repro_torch.launch.serve``) against ``repro.launch.serve`` on the CPU.

The reference's prompts and weights (its key split in ``serve``) are carried
across; the port serves them through the daemon and through ``--once``, and
every served stream is held to the reference by the LM rule of
``tests/lm_rule.py`` (bfloat16, τ stated there), a MoE's by the MoE rule of
``tests/moe_rule.py``.  A VLM's requests carry the reference's vision
draws.  The serve cases of
``tests/test_launchers.py`` are mirrored on the port's own draws.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moe_rule
from lm_rule import depth, hold, stream_logits
from repro.engine.adapters import LMEngineSolver as RefLMEngineSolver
from repro.engine.bucketing import bucket_batch
from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro_torch import configs as port_configs
from repro_torch import convert, engine
from repro_torch.engine.adapters import LMEngineSolver
from repro_torch.launch import serve as port_serve
from repro_torch.models.steps import make_generate
from test_torch_lm import ref_stream_logits
from test_torch_lm_families import gated, ref_recording

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def reference_draws(arch: str, batch: int, prompt_len: int, seed: int):
    """The weights, prompts and (for a VLM) vision rows
    ``repro.launch.serve.serve`` draws for these arguments (its five-way key
    split), as (reference adapter, prompts, vision or None)."""
    k_model, k_prompts, k_vision, _, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    ref_lm = RefLMEngineSolver(arch, k_model, reduced=True)
    cfg = ref_lm.cfg
    prompts = jax.random.randint(k_prompts, (batch, prompt_len), 0, cfg.vocab, dtype=jnp.int32)
    vision = None
    if cfg.family == "vlm":
        vision = np.stack([np.asarray(jax.random.normal(
            key, (cfg.n_vision_tokens, cfg.vision_dim), jnp.bfloat16))
            for key in jax.random.split(k_vision, batch)])
    return ref_lm, np.asarray(prompts), vision


def port_solver_on(ref_lm, params=None) -> LMEngineSolver:
    params = convert.lm_params_from_reference(
        port_configs.get_reduced(ref_lm.arch),
        jax.tree.map(np.asarray, ref_lm.params if params is None else params), "cpu")
    return LMEngineSolver(ref_lm.arch, params=params)


def held_stream(lm, ref_cfg, ref_params, prompts, tokens, vision=None, what="", frames=None):
    """The port's served ``tokens`` held to the reference on the same
    weights (and a VLM's ``vision``, an enc-dec model's ``frames``, as
    reference arrays): by the MoE rule for a MoE (router inputs recorded on
    both sides), else by the LM rule at ``depth(cfg)``; returns the rule's
    summary."""
    vis_t = None if vision is None else convert._tensor_from_reference(vision)
    frames_t = None if frames is None else convert._tensor_from_reference(frames)
    with moe_rule.recording() as port_calls, ref_recording() as ref_calls:
        port = stream_logits(lm.model, lm.params, prompts, tokens, vision=vis_t, frames=frames_t)
        ref = ref_stream_logits(ref_cfg, ref_params, prompts, tokens.numpy(), vision=vision,
                                frames=frames)
        jax.effects_barrier()
    cfg = lm.cfg
    if cfg.family != "moe":
        return hold(tokens, port, ref, cfg.dtype, depth(cfg), what)
    b, length = prompts.shape
    calls = moe_rule.pair_calls(port_calls, ref_calls, moe_rule.stream_positions(
        cfg.n_layers, length, tokens.shape[1]))
    return moe_rule.hold(tokens, port, ref, cfg.dtype, cfg.n_layers, calls, length, what)


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
def test_serve_matches_reference_by_the_rule(once):
    """The reference's serve at its defaults (4 × 32-token prompts, 16 new
    tokens, seed 0) and the port's serve of its prompts on its weights."""
    ref_report = ref_serve.serve("qwen2-1.5b", once=once)
    ref_lm, prompts, _ = reference_draws("qwen2-1.5b", 4, 32, seed=0)
    lm = port_solver_on(ref_lm)
    report, tokens = port_serve.serve_prompts(
        lm, torch.as_tensor(np.array(prompts)), 16, torch.Generator().manual_seed(0), once=once)
    assert set(report) == set(ref_report) | {"device"} and report["device"] == "cpu"
    for key in ("arch", "batch", "prompt_len", "new_tokens", "engine"):
        assert report[key] == ref_report[key], key
    assert tokens.shape == (4, 16) and report["sample"] == tokens[0, :8].tolist()
    rule = hold(tokens, stream_logits(lm.model, lm.params, prompts, tokens),
                ref_stream_logits(ref_lm.cfg, ref_lm.params, prompts, tokens.numpy()), "bfloat16",
                lm.cfg.n_layers, "serve")
    if rule["tokens_not_ref_argmax"] == 0:
        assert report["sample"] == ref_report["sample"]


def test_daemon_and_once_serve_equal_tokens():
    gen = torch.Generator().manual_seed(3)
    lm = LMEngineSolver("qwen3-4b", gen, device="cpu")
    prompts = port_serve.draw_prompts(lm.cfg.vocab, 5, 12, gen)
    daemon, a = port_serve.serve_prompts(lm, prompts, 6, torch.Generator().manual_seed(0))
    once, b = port_serve.serve_prompts(lm, prompts, 6, torch.Generator().manual_seed(0), once=True)
    assert torch.equal(a, b)
    assert daemon["engine"] == once["engine"] == {"slabs": 1, "pad_fraction": 0.375}
    direct, _ = make_generate(lm.model)(
        lm.params, {"tokens": torch.cat([prompts, torch.zeros((3, 12), dtype=torch.int32)])}, 6)
    assert torch.equal(a, direct[:5])  # the same 8-lane bucket


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "codeqwen1.5-7b", "h2o-danube-1.8b", "qwen3-4b"])
def test_serve_loop(arch):
    out = port_serve.serve(arch, batch=2, prompt_len=16, max_new_tokens=4, device="cpu")
    assert out["new_tokens"] == 4
    assert len(out["sample"]) >= 4
    assert all(0 <= t < port_configs.get_reduced(arch).vocab for t in out["sample"])


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b", "llama-3.2-vision-11b"])
def test_family_serve_matches_reference_by_the_rules(arch, once):
    """The reference's serve of a MoE or VLM arch at its defaults (4 ×
    32-token prompts, 16 new tokens, seed 0; the VLM's requests with its
    vision draws) and the port's serve of its prompts and vision rows on its
    weights: the report's fields, and the streams by the MoE rule (MoE) or
    the LM rule (VLM, its gates as materialized: zero)."""
    ref_report = ref_serve.serve(arch, once=once)
    ref_lm, prompts, vision = reference_draws(arch, 4, 32, seed=0)
    lm = port_solver_on(ref_lm)
    vis_t = None if vision is None else convert._tensor_from_reference(vision)
    report, tokens = port_serve.serve_prompts(
        lm, torch.as_tensor(np.array(prompts)), 16, torch.Generator().manual_seed(0),
        vision=vis_t, once=once)
    assert set(report) == set(ref_report) | {"device"} and report["device"] == "cpu"
    for key in ("arch", "batch", "prompt_len", "new_tokens", "engine"):
        assert report[key] == ref_report[key], key
    rule = held_stream(lm, ref_lm.cfg, ref_lm.params, prompts, tokens, vision, f"{arch} serve")
    if rule.get("steps_held", 64) == 64 and rule["tokens_not_ref_argmax"] == 0:
        assert report["sample"] == ref_report["sample"]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b", "whisper-large-v3"])
def test_serve_of_unported_family_raises(arch):
    """The last three families ported serve (they raised
    ``NotImplementedError`` until then); what they refuse raises: a Zamba or
    xLSTM prompt of part of an SSD chunk (``ValueError`` naming
    ``ssm_chunk``, at full width before any weight is drawn) and an enc-dec
    request without ``frames``."""
    out = port_serve.serve(arch, batch=2, prompt_len=16, max_new_tokens=4, device="cpu")
    assert out["new_tokens"] == 4 and out["engine"]["slabs"] == 1
    if port_configs.get_reduced(arch).family == "encdec":
        lm = LMEngineSolver(arch, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(ValueError, match="requires frames"):
            lm.signature({"tokens": np.zeros(16, np.int32), "max_new_tokens": 1})
    else:
        with pytest.raises(ValueError, match="multiple of ssm_chunk=256"):
            port_serve.serve(arch, reduced=False, device="cpu")
        with pytest.raises(ValueError, match="multiple of ssm_chunk=16"):
            port_serve.serve(arch, batch=2, prompt_len=8, max_new_tokens=4, device="cpu")


@pytest.mark.parametrize("tokens", [1, 5])
def test_serve_token_accounting_is_exact(tokens):
    """Exactly max_new_tokens tokens: token 0 from the prefill logits, token
    i from the i-th decode step."""
    out = port_serve.serve("qwen2-1.5b", batch=2, prompt_len=8, max_new_tokens=tokens,
                           device="cpu")
    assert out["new_tokens"] == tokens


def test_serve_seed_changes_prompts_not_shape():
    a = port_serve.serve("qwen2-1.5b", batch=2, prompt_len=8, max_new_tokens=3, seed=0,
                         device="cpu")
    b = port_serve.serve("qwen2-1.5b", batch=2, prompt_len=8, max_new_tokens=3, seed=1,
                         device="cpu")
    assert a["new_tokens"] == b["new_tokens"] == 3
    assert a["sample"] != b["sample"]  # independent draws
    c = port_serve.serve("qwen2-1.5b", batch=2, prompt_len=8, max_new_tokens=3, seed=0,
                         device="cpu")
    assert c["sample"] == a["sample"]


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.serve("qwen2-1.5b", batch=1, prompt_len=4, max_new_tokens=1)


def test_lm_adapter_packs_lanes_and_pads_like_a_direct_generate():
    """Through the registry: a 1-D, a 3-lane and a 1-D request share one
    8-lane slab (3 zero-prompt pad lanes); another prompt length gets its
    own slab.  Each result is its rows of a direct generate of the bucket."""
    eng = engine.Engine(torch.Generator().manual_seed(0), device="cpu")
    lm = eng.install("lm", arch="h2o-danube-1.8b", generator=torch.Generator().manual_seed(1),
                     device="cpu")
    assert isinstance(lm, LMEngineSolver)
    gen = torch.Generator().manual_seed(2)
    p0, p1, p2 = (torch.randint(0, 256, shape, generator=gen, dtype=torch.int32)
                  for shape in ((10,), (3, 10), (10,)))
    other = torch.randint(0, 256, (7,), generator=gen, dtype=torch.int32)
    futs = [eng.submit(engine.Request("lm", {"tokens": p, "max_new_tokens": 4}))
            for p in (p0, p1, p2)]
    fut_other = eng.submit(engine.Request("lm", {"tokens": other, "max_new_tokens": 4}))
    stats = eng.drain()
    assert stats["slabs_per_bucket"] == {"lm:(7, 4, ()):batch1": 1, "lm:(10, 4, ()):batch8": 1}
    batch = torch.cat([p0[None], p1, p2[None], torch.zeros((3, 10), dtype=torch.int32)])
    direct, _ = make_generate(lm.model)(lm.params, {"tokens": batch}, 4)
    assert torch.equal(futs[0].result(), direct[0])
    assert torch.equal(futs[1].result(), direct[1:4])
    assert torch.equal(futs[2].result(), direct[4])
    alone, _ = make_generate(lm.model)(lm.params, {"tokens": other[None]}, 4)
    assert torch.equal(fut_other.result(), alone[0])
    assert len(lm.timings) == 2 and lm.last_timing is lm.timings[-1]


def test_lm_adapter_surface_equals_reference():
    """Signature, bucket, lane count, cost units and the FPGA quote equal
    the reference adapter's; payload keys of other families are refused."""
    ref = RefLMEngineSolver("qwen2-1.5b", jax.random.PRNGKey(0))
    port = LMEngineSolver("qwen2-1.5b", torch.Generator().manual_seed(0), device="cpu")
    for toks in (np.zeros(9, np.int32), np.zeros((3, 5), np.int32)):
        payload = {"tokens": toks, "max_new_tokens": 7}
        sig = port.signature(payload)
        assert sig == ref.signature(payload)
        assert port.bucket(sig, "pow2") == ref.bucket(sig, "pow2")
        assert port.lane_count(payload) == ref.lane_count(payload)
        for bb in (1, 4, bucket_batch(3)):
            assert port.cost_units(sig, bb) == ref.cost_units(sig, bb)
        assert port.fpga_seconds(sig) is None is ref.fpga_seconds(sig)
    with pytest.raises(ValueError, match="belongs to the enc-dec family"):
        port.signature({"tokens": np.zeros(4, np.int32), "max_new_tokens": 1, "frames": 0})
    with pytest.raises(ValueError, match="exactly one of"):
        LMEngineSolver("qwen2-1.5b", device="cpu")
    whisper = LMEngineSolver("whisper-large-v3", torch.Generator(), device="cpu")
    payload = {"tokens": np.zeros(9, np.int32), "frames": np.zeros((9, 64), np.float32),
               "max_new_tokens": 7}
    assert whisper.signature(payload) == RefLMEngineSolver(
        "whisper-large-v3", jax.random.PRNGKey(0)).signature(payload) == (9, 7, ("frames",))


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
def test_serve_cli(once):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
           "--arch", "qwen2-1.5b", "--tokens", "5"] + (["--once"] if once else [])
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["new_tokens"] == 5 and report["batch"] == 4 and report["prompt_len"] == 32
    assert report["device"] == "cpu" and report["engine"] == {"slabs": 1, "pad_fraction": 0.0}
    want = port_serve.serve("qwen2-1.5b", max_new_tokens=5, device="cpu")
    assert report["sample"] == want["sample"]


def test_lm_adapter_packs_vision_and_zero_pads_like_a_direct_generate():
    """A gated VLM (non-zero gates, so that vision moves the logits) through
    the registry: a 1-D request and a 2-lane request with their vision rows
    share one 4-lane slab, the padded lane's tokens and vision zero; each
    result is its rows of a direct generate of the bucket, and the signature
    carries ``("vision",)`` as the reference's does.  A VLM request without
    vision and a ``frames`` request (frames belong to the enc-dec family)
    are refused."""
    cfg_ref = ref_configs.get_reduced("llama-3.2-vision-11b")
    ref_lm = RefLMEngineSolver("llama-3.2-vision-11b", jax.random.PRNGKey(1))
    lm = port_solver_on(ref_lm, gated(ref_lm.params, seed=3))
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, 256, (3, 9), generator=gen, dtype=torch.int32)
    vis = port_serve.draw_vision(cfg_ref.n_vision_tokens, cfg_ref.vision_dim, 3, gen)
    payloads = [{"tokens": toks[0], "vision": vis[0], "max_new_tokens": 5},
                {"tokens": toks[1:], "vision": vis[1:], "max_new_tokens": 5}]
    sig = lm.signature(payloads[0])
    assert sig == (9, 5, ("vision",)) == ref_lm.signature(
        {"tokens": toks[0].numpy(), "vision": vis[0].float().numpy(), "max_new_tokens": 5})
    seen = []
    generate = lm._generate
    lm._generate = lambda params, batch_in, n: (seen.append(batch_in), generate(
        params, batch_in, n))[1]
    eng = engine.Engine(torch.Generator().manual_seed(0), device="cpu")
    eng.install("lm", lm)
    futs = [eng.submit(engine.Request("lm", p)) for p in payloads]
    stats = eng.drain()
    assert stats["slabs_per_bucket"] == {"lm:(9, 5, ('vision',)):batch4": 1}
    batch = {"tokens": torch.cat([toks, torch.zeros((1, 9), dtype=torch.int32)]),
             "vision": torch.cat([vis, torch.zeros_like(vis[:1])])}
    assert len(seen) == 1 and seen[0].keys() == batch.keys()
    for name in batch:  # packed in submission order, the padded lane zero
        assert seen[0][name].dtype == batch[name].dtype and torch.equal(seen[0][name], batch[name])
    direct, _ = make_generate(lm.model)(lm.params, batch, 5)
    assert torch.equal(futs[0].result(), direct[0])
    assert torch.equal(futs[1].result(), direct[1:3])
    with torch.inference_mode():
        moved = lm.params(batch["tokens"], batch["vision"].flip(-1))[:, -1]
        base = lm.params(batch["tokens"], batch["vision"])[:, -1]
    assert not torch.equal(moved, base)  # the vision rows reach the logits
    with pytest.raises(ValueError, match="requires vision"):
        lm.signature({"tokens": toks[0], "max_new_tokens": 5})
    with pytest.raises(ValueError, match="belongs to the enc-dec family"):
        lm.signature({**payloads[0], "frames": vis[0]})
