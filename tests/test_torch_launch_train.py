"""The port's LM training launcher (``repro_torch.launch.train``), its CLI and
the LM examples on the CPU, and the three calls of port fault 7.

Held: the loss falls on the learnable stream; a run preempted mid-way
(SIGTERM, delivered at a fixed step) and resumed from its checkpoint gives
losses ``==`` an uninterrupted run's; the port resumes from a checkpoint
directory that ``repro.launch.train`` wrote — the step, the data cursor and
the first batch after the resume ``==`` the reference's, the restored
weights its own bit for bit.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data.tokens import TokenStream as RefStream
from repro.launch.train import train as ref_train
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.distributed import ft
from repro_torch.launch import train as launch_train
from repro_torch.models.model import get_model
from repro_torch.models.steps import make_generate, make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
KW = dict(reduced=True, batch=4, seq_len=64, log_every=0, device="cpu")


def preempt_at(monkeypatch, step: int) -> None:
    """Deliver SIGTERM to this process as step ``step`` finishes."""
    stop = ft.StepMonitor.stop

    def stop_and_signal(self, i):
        if i == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return stop(self, i)

    monkeypatch.setattr(ft.StepMonitor, "stop", stop_and_signal)


def test_loss_decreases(tmp_path):
    out = launch_train.train("qwen2-1.5b", steps=30, ckpt_dir=str(tmp_path), ckpt_every=10,
                             lr=1e-3, **KW)
    assert out["status"] == "completed" and out["final_step"] == 30
    assert len(out["losses"]) == len(out["step_s"]) == 30
    assert out["last_loss"] < out["first_loss"], out
    assert ckpt.all_steps(str(tmp_path)) == [10, 20, 30]
    assert os.path.exists(tmp_path / "heartbeat")


def test_preempted_and_resumed_losses_equal_uninterrupted(tmp_path, monkeypatch):
    whole = launch_train.train("qwen2-1.5b", steps=8, lr=1e-3, **KW)
    d = str(tmp_path)
    preempt_at(monkeypatch, 2)
    first = launch_train.train("qwen2-1.5b", steps=8, ckpt_dir=d, ckpt_every=5, lr=1e-3, **KW)
    monkeypatch.undo()
    assert first["status"] == "preempted" and first["final_step"] == 3
    assert ckpt.latest_step(d) == 3
    assert ckpt.load_meta(d, 3)["data_state"] == {"cursor": 3, "seed": 0}
    second = launch_train.train("qwen2-1.5b", steps=8, ckpt_dir=d, ckpt_every=5, lr=1e-3, **KW)
    assert second["status"] == "completed" and second["final_step"] == 8
    assert first["losses"] + second["losses"] == whole["losses"]


def test_resumes_from_a_reference_checkpoint_directory(tmp_path, monkeypatch, capsys):
    """``repro.launch.train`` writes steps 2 and 4; the port resumes at 4:
    its restored weights are the checkpoint's bit for bit, its first batch
    is the reference stream's at cursor 4, and it runs steps 5 and 6."""
    d = str(tmp_path)
    ref_train("qwen2-1.5b", reduced=True, steps=4, batch=4, seq_len=64, ckpt_dir=d,
              ckpt_every=2, log_every=0)
    assert ckpt.all_steps(d) == [2, 4]
    seen, restored = [], []
    orig_next, orig_restore = launch_train.TokenStream.next, launch_train.ckpt_lib.restore

    def next_batch(self):
        out = orig_next(self)
        seen.append(out)
        return out

    def restore(*args, **kwargs):
        state = orig_restore(*args, **kwargs)
        restored.append(state)
        return state

    monkeypatch.setattr(launch_train.TokenStream, "next", next_batch)
    monkeypatch.setattr(launch_train.ckpt_lib, "restore", restore)
    out = launch_train.train("qwen2-1.5b", steps=6, ckpt_dir=d, ckpt_every=2, **KW)
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert out["final_step"] == 6 and len(out["losses"]) == 2
    assert int(restored[0].step) == 4 and int(restored[0].opt["count"]) == 4
    with np.load(os.path.join(d, "step_4", "arrays.npz")) as data:
        embed = restored[0].params["embed"]
        assert np.array_equal(embed.view(torch.int16).numpy().view(np.uint16),
                              data["params//embed"])
    ref_stream = RefStream(configs.get_reduced("qwen2-1.5b").vocab, 4, 64, seed=0)
    ref_stream.restore({"cursor": 4, "seed": 0})
    try:
        want = ref_stream.next()
    finally:
        ref_stream.close()
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(seen[0][k], want[k])
    assert ckpt.latest_step(d) == 6


def test_cli_trains_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         "qwen2-1.5b", "--steps", "10", "--batch", "2", "--seq", "32"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["final_step"] == 10 and report["status"] == "completed"
    assert report["last_loss"] < report["first_loss"]


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train("qwen2-1.5b", steps=1, reduced=True)


@pytest.mark.parametrize("example,args,expect", [
    ("torch_train_lm.py", ["--steps", "12"], "OK: loss decreased across a checkpoint/restart"),
    ("torch_serve_lm.py", ["--tokens", "4"], '"new_tokens": 4'),
])
def test_example_runs_on_cpu(example, args, expect):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", example), "--device", "cpu", *args],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout


# ---------------------------------------------------------------------------
# port fault 7
# ---------------------------------------------------------------------------


def test_step_factories_accept_sample():
    model = get_model(configs.get_reduced("qwen2-1.5b"))
    from repro_torch.models import params as PM

    lm = model.build_params(PM.materialize(model.param_specs, torch.Generator().manual_seed(0),
                                           "cpu"))
    prompts = {"tokens": torch.randint(0, 100, (2, 8), generator=torch.Generator())}
    greedy, _ = make_generate(model)(lm, prompts, 3)
    sampled, _ = make_generate(model, sample="greedy")(lm, prompts, 3)
    other, _ = make_generate(model, sample="top_k")(lm, prompts, 3)
    assert torch.equal(greedy, sampled) and torch.equal(greedy, other)
    assert callable(make_serve_step(model, sample="greedy"))
    assert callable(make_serve_step(model, "top_k"))


def test_expected_cycles_accepts_block():
    from repro_torch.api import RetrievalSolver
    from repro_torch.core import dynamics as dyn

    cfg = dyn.ONNConfig(n=20, max_cycles=16)
    rng = np.random.default_rng(0)
    w = rng.integers(-3, 4, (20, 20)).astype(np.int8)
    w = np.triu(w, 1) + np.triu(w, 1).T
    solver = RetrievalSolver(cfg, dyn.make_params(cfg, w, device="cpu")).as_engine_solver()
    assert solver.expected_cycles() == solver.expected_cycles(block=False) == 16.0
    assert solver.expected_cycles(block=True) == 16.0


def test_batch_mesh_is_deprecated_data_major(monkeypatch):
    from repro.launch.retrieve import batch_mesh as ref_batch_mesh
    from repro_torch.distributed import plan
    from repro_torch.launch.retrieve import batch_mesh

    assert "Deprecated" in batch_mesh.__doc__ and "ShardPlan" in batch_mesh.__doc__
    if torch.cuda.device_count() < 2:
        assert batch_mesh() is None and ref_batch_mesh() is None  # one device each
    monkeypatch.setattr(plan.torch.cuda, "device_count", lambda: 4)
    mesh = batch_mesh()
    assert mesh.shape == {"data": 4, "model": 1}
    assert [str(d) for d in mesh.devices[:, 0]] == [f"cuda:{i}" for i in range(4)]
