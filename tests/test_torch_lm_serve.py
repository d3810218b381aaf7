"""The port's LM serving path (the ``"lm"`` engine workload,
``repro_torch.launch.serve``) against ``repro.launch.serve`` on the CPU.

The reference's prompts and weights (its key split in ``serve``) are carried
across; the port serves them through the daemon and through ``--once``, and
every served stream is held to the reference by the LM rule of
``tests/lm_rule.py`` (bfloat16, τ stated there).  The serve cases of
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

from lm_rule import hold, stream_logits
from repro.engine.adapters import LMEngineSolver as RefLMEngineSolver
from repro.engine.bucketing import bucket_batch
from repro.launch import serve as ref_serve
from repro_torch import configs as port_configs
from repro_torch import convert, engine
from repro_torch.engine.adapters import LMEngineSolver
from repro_torch.launch import serve as port_serve
from repro_torch.models.steps import make_generate
from test_torch_lm import ref_stream_logits

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def reference_draws(arch: str, batch: int, prompt_len: int, seed: int):
    """The weights and prompts ``repro.launch.serve.serve`` draws for these
    arguments (its five-way key split), as (reference adapter, prompts)."""
    k_model, k_prompts, _, _, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    ref_lm = RefLMEngineSolver(arch, k_model, reduced=True)
    prompts = jax.random.randint(k_prompts, (batch, prompt_len), 0, ref_lm.cfg.vocab,
                                 dtype=jnp.int32)
    return ref_lm, np.asarray(prompts)


def port_solver_on(ref_lm) -> LMEngineSolver:
    params = convert.lm_params_from_reference(
        port_configs.get_reduced(ref_lm.arch), jax.tree.map(np.asarray, ref_lm.params), "cpu")
    return LMEngineSolver(ref_lm.arch, params=params)


@pytest.mark.parametrize("once", [False, True], ids=["daemon", "once"])
def test_serve_matches_reference_by_the_rule(once):
    """The reference's serve at its defaults (4 × 32-token prompts, 16 new
    tokens, seed 0) and the port's serve of its prompts on its weights."""
    ref_report = ref_serve.serve("qwen2-1.5b", once=once)
    ref_lm, prompts = reference_draws("qwen2-1.5b", 4, 32, seed=0)
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


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b", "whisper-large-v3"])
def test_serve_of_unported_family_raises(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section 1, item 5"):
        port_serve.serve(arch, batch=2, prompt_len=16, max_new_tokens=4, device="cpu")


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
    with pytest.raises(ValueError, match="item 5"):
        port.signature({"tokens": np.zeros(4, np.int32), "max_new_tokens": 1, "vision": 0})
    with pytest.raises(ValueError, match="exactly one of"):
        LMEngineSolver("qwen2-1.5b", device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        LMEngineSolver("granite-moe-3b-a800m", torch.Generator(), device="cpu")


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
