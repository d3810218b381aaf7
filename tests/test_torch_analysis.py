"""repro_torch.analysis: the bucket grid, the launch plans' budget, the
build/plan/launch/sync gate and the port's lint, on the CPU.

The lint fixtures under ``tests/fixtures/torch_analysis`` are the executable
spec of the port's rule set: one bad file per rule, each tripping exactly its
own rule.  The budget's figures are integers from the planners, asserted
exactly.  The compiled kernels' attributes and the gate's card counts are
checked on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 19).
"""

from __future__ import annotations

import copy
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import RULES
from repro_torch.analysis import core as lint_core
from repro_torch.analysis import tracegate, vmem
from repro_torch.kernels import autotune

REPO_ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_analysis"


# ---------------------------------------------------------------------------
# The bucket grid
# ---------------------------------------------------------------------------


def test_iter_buckets_covers_every_kind_and_the_port_sizes():
    buckets = list(autotune.iter_buckets())
    assert {k for k, _, _ in buckets} == set(autotune.KINDS)
    assert len(buckets) == len(autotune.KINDS) * len(autotune.N_BUCKETS) * len(
        autotune.BATCH_BUCKETS)
    reference_n = {16, 32, 48, 64, 128, 256, 506, 512, 1024, 2048, 4096}
    assert reference_n | {autotune.MULTI_CLUSTER_MAX_N, 8192, autotune.MULTI_KERNEL_MAX_N} \
        == set(autotune.N_BUCKETS)
    assert (autotune.MULTI_CLUSTER_MAX_N, autotune.MULTI_KERNEL_MAX_N) == (1280, 17801)
    assert set(autotune.BATCH_BUCKETS) == {1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024}


def test_iter_buckets_multi_respects_kernel_ceiling(monkeypatch):
    monkeypatch.setattr(autotune, "N_BUCKETS", autotune.N_BUCKETS + (20_000,))
    multi = {n for _, n, _ in autotune.iter_buckets(("multi",))}
    assert max(multi) == autotune.MULTI_KERNEL_MAX_N
    assert 20_000 in {n for _, n, _ in autotune.iter_buckets(("step",))}
    with pytest.raises(ValueError, match="unknown autotune kind"):
        list(autotune.iter_buckets(("nope",)))


# ---------------------------------------------------------------------------
# The static budget
# ---------------------------------------------------------------------------


def _plan(reports, kind, n, batch, kernel):
    (r,) = [r for r in reports if (r.kind, r.n, r.batch) == (kind, n, batch)]
    return [p for p in r.plans if p.kernel == kernel]


def test_vmem_covers_every_bucket_within_budget():
    reports = vmem.check_all()
    assert len(reports) == sum(1 for _ in autotune.iter_buckets())
    assert {r.kind for r in reports} == set(autotune.KINDS)
    assert sum(len(r.plans) for r in reports) == 1386
    bad = [r.render() for r in reports if not r.ok]
    assert not bad, bad


def test_vmem_expected_figures():
    reports = vmem.check_all()
    top = vmem.tightest(reports)
    (r0, p0), (r1, p1) = top[:2]
    # the stream regime at its ceiling: every byte of the dynamic budget
    assert (r0.kind, r0.n, p0.kernel) == ("multi", 17801, "phase_step_multi/stream")
    assert (p0.smem, p0.budget, p0.static) == (231_424, 231_424, 1024)
    # the GEMV at B <= 4: 48,656 of the 49,152 bytes that need no opt-in
    assert (r1.kind, r1.n, p1.kernel) == ("matvec", 17801, "quantized_matvec/gemv")
    for b in (1, 2, 4):
        (g,) = _plan(reports, "matvec", 17801, b, "quantized_matvec/gemv")
        assert (g.smem, g.budget, g.blocks_per_sm, g.max_registers) == (48_656, 49_152, 2, 128)
    for b in autotune.BATCH_BUCKETS:
        (s,) = _plan(reports, "multi", 17801, b, "phase_step_multi/stream")
        assert (s.smem, s.budget) == (231_424, 231_424)
    # the main path's cluster plan
    (c,) = _plan(reports, "multi", 506, 1024, "phase_step_multi/cluster")
    assert (c.plan, c.smem, c.threads, c.cluster) == ("C=2 L=16 R=256", 152_576, 512, 2)
    wide = _plan(reports, "step", 506, 1024, "coupling_gemm/wide")
    assert {(p.smem, p.blocks_per_sm, p.sm_bytes, p.max_registers) for p in wide} == {
        (69_120, 2, 2 * (69_120 + 1024), 128)}
    split = _plan(reports, "step", 506, 1, "coupling_gemm/split")
    assert {(p.smem, p.blocks_per_sm, p.max_registers) for p in split} == {(27_648, 1, 255)}


def test_vmem_flags_a_grid_past_cuda_limits():
    # 4.2 M lanes on the wide tile: the grid's y (lane tiles) passes 65,535
    plan = autotune.coupling_plan.__wrapped__(1, 4_200_000, 32, 32)
    rep = vmem.plan_report(plan)
    assert plan.tile.name == "wide" and plan.grid[1] > vmem.MAX_GRID_YZ
    assert not rep.ok and "grid" in rep.render()


def test_vmem_report_flags_a_smaller_limit_and_leaves_the_caches(monkeypatch):
    before = autotune.cache_info()
    monkeypatch.setattr(autotune, "SMEM_PER_BLOCK", 200_000)
    buf = io.StringIO()
    failures = vmem.report(buf)
    assert failures > 0
    assert "OVER" in buf.getvalue() and "REFUSED" in buf.getvalue()
    assert autotune.cache_info() == before


def test_vmem_check_all_leaves_cache_info():
    before = autotune.cache_info()
    vmem.check_all()
    assert autotune.cache_info() == before


def test_check_compiled_needs_the_card():
    with pytest.raises(ValueError, match="compiled for the card"):
        vmem.check_compiled("cpu")


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_budget_file_matches_pinned_order_and_steady_builds_nothing():
    budget = json.loads(tracegate.DEFAULT_BUDGET_PATH.read_text())
    assert budget["_meta"]["order"] == list(tracegate.WORKLOAD_ORDER)
    assert budget["_meta"]["smoke"] is False
    assert "H100" in budget["_meta"]["device"]
    assert set(budget["workloads"]) == set(tracegate.WORKLOAD_ORDER)
    for name, entry in budget["workloads"].items():
        for key in tracegate.PLAN_KEYS:
            assert entry["steady"].get(key, 0) == 0, (name, key)
    # the kernel route launches kernel 5 in both passes
    assert budget["workloads"]["retrieve"]["steady"]["ops.phase_step_multi"] > 0


def test_missing_or_broken_budget_is_actionable(tmp_path):
    with pytest.raises(FileNotFoundError, match="--update"):
        tracegate.load_budget(tmp_path / "absent.json")
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    with pytest.raises(ValueError, match="regenerate"):
        tracegate.load_budget(broken)
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    with pytest.raises(ValueError, match="'workloads'"):
        tracegate.load_budget(empty)
    assert tracegate.main(["--device", "cpu", "--smoke", "--budget",
                           str(tmp_path / "absent.json")]) == 2


def _budget_as_observed():
    budget = tracegate.load_budget()
    return {n: copy.deepcopy(e) for n, e in budget["workloads"].items()}


def test_run_gate_names_workload_and_pass_on_synthetic_observations():
    obs = _budget_as_observed()
    assert tracegate.run_gate(device="cuda", observed=obs).passed

    leak = _budget_as_observed()
    leak["hot_swap"]["steady"]["build.loaded"] = 1
    res = tracegate.run_gate(device="cuda", observed=leak)
    assert not res.passed and any(d.startswith("hot_swap.steady") for d in res.diffs)

    sync = _budget_as_observed()
    steady = sync["serving_tick"]["steady"]
    steady["cuda.syncs"] = steady.get("cuda.syncs", 0) + 1
    res = tracegate.run_gate(device="cuda", observed=sync)
    assert [d.split(":")[0] for d in res.diffs] == ["serving_tick.steady"]

    launch = _budget_as_observed()
    warm = launch["retrieve"]["warm"]
    warm["ops.phase_step_multi"] = warm.get("ops.phase_step_multi", 0) + 1
    res = tracegate.run_gate(device="cuda", observed=launch)
    assert [d.split(":")[0] for d in res.diffs] == ["retrieve.warm"]
    # a smoke run on the card and a CPU run gate builds and plans alone
    assert tracegate.run_gate(device="cuda", smoke=True, observed=launch).passed
    assert tracegate.run_gate(device="cpu", observed=launch).passed


def test_measure_on_cpu_builds_and_plans_nothing_and_injection_fails_the_gate():
    obs = tracegate.measure(device="cpu", smoke=True)
    assert list(obs) == list(tracegate.WORKLOAD_ORDER)
    for entry in obs.values():
        assert entry["warm"] == {} and entry["steady"] == {}
    report = obs["serving_tick"]["report"]
    assert report["chunks"] > 0 and report["syncs_per_slab_tick"] == 0.0
    assert tracegate.run_gate(device="cpu", smoke=True, observed=obs).passed

    injected = tracegate.measure(device="cpu", smoke=True, inject=True)
    assert injected["retrieve"]["steady"] == {"autotune.miss": 1}
    res = tracegate.run_gate(device="cpu", smoke=True, observed=injected)
    assert not res.passed
    assert {d.split(":")[0] for d in res.diffs} == {"retrieve.steady"}


def test_tracegate_cli_exit_codes(tmp_path, capsys):
    out = tmp_path / "gate.json"
    assert tracegate.main(["--device", "cpu", "--smoke", "--out", str(out)]) == 0
    written = json.loads(out.read_text())
    assert written["passed"] and written["device"] == "cpu"
    assert tracegate.main(["--device", "cpu", "--smoke", "--inject-retrace"]) == 1
    assert "retrieve.steady" in capsys.readouterr().out
    assert tracegate.main(["--device", "cpu", "--update", "--budget",
                           str(tmp_path / "b.json")]) == 2
    assert not (tmp_path / "b.json").exists()


# ---------------------------------------------------------------------------
# The lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code", sorted(RULES))
def test_each_rule_trips_exactly_on_its_fixture(code):
    path = FIXTURES / f"bad_{code.lower()}.py"
    assert path.exists(), f"missing fixture for {code}"
    findings, errors = lint_core.lint_paths([str(path)])
    assert not errors
    assert {f.code for f in findings} == {code}, [f.render() for f in findings]


def test_escape_hatch_pragma_suppresses():
    findings, errors = lint_core.lint_paths([str(FIXTURES / "escape_hatch.py")])
    assert not errors
    assert findings == []


def test_escape_hatch_only_covers_named_rule(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import torch\n"
        "G = torch.Generator().manual_seed(0)  # repro-lint: disable=RPT002\n"
        "\n"
        "X = torch.randn(3)  # repro-lint: disable=RPL002\n"
    )
    findings, _ = lint_core.lint_paths([str(bad)])
    assert [(f.line, f.code) for f in findings] == [(2, "RPT001"), (4, "RPT002")]


def test_test_paths_are_exempt_unless_fixtures(tmp_path):
    body = "import torch\ntorch.manual_seed(0)\nX = torch.randn(3)\n"
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_x.py").write_text(body)
    findings, _ = lint_core.lint_paths([str(tmp_path / "tests")])
    assert findings == []
    (tmp_path / "tests" / "fixtures").mkdir()
    (tmp_path / "tests" / "fixtures" / "bad.py").write_text(body)
    findings, _ = lint_core.lint_paths([str(tmp_path / "tests")])
    assert findings == []  # a walk skips fixtures
    findings, _ = lint_core.lint_paths([str(tmp_path / "tests" / "fixtures" / "bad.py")])
    assert {f.code for f in findings} == {"RPT001", "RPT002"}


def test_select_restricts_rules():
    path = FIXTURES / "bad_rpt001.py"
    findings, _ = lint_core.lint_paths([str(path)], select=["RPT002"])
    assert findings == []
    with pytest.raises(ValueError, match="unknown rule"):
        lint_core.lint_paths([str(path)], select=["RPT999"])


def test_clean_tree_lints_zero():
    paths = lint_core.clean_tree()
    assert str(REPO_ROOT / "src" / "repro_torch") in paths
    assert str(REPO_ROOT / "chip_smoke.py") in paths
    assert str(REPO_ROOT / "tests" / "test_torch_analysis.py") in paths
    findings, errors = lint_core.lint_paths(paths)
    assert not errors
    assert findings == [], [f.render() for f in findings]


def test_cli_exit_codes_and_rule_table(capsys):
    assert lint_core.main([str(FIXTURES / "bad_rpt001.py")]) == 1
    assert lint_core.main([str(FIXTURES / "escape_hatch.py")]) == 0
    out = capsys.readouterr().out
    assert "RPT001" in out and "repro-torch-lint: clean" in out
    assert lint_core.main(["--select", "RPT999", str(FIXTURES)]) == 2
    assert lint_core.main(["--list-rules"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in table] == sorted(RULES)
    assert lint_core.main(["--vmem", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "phase_step_multi/stream" in out and "quantized_matvec/gemv" in out


def test_core_and_rules_import_without_torch_or_jax():
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.analysis import core, rules\n"
        "findings, errors = core.lint_paths([sys.argv[1]])\n"
        "assert not errors and {f.code for f in findings} == {'RPT004'}, findings\n"
        "assert 'torch' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(rules.RULES))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code, str(FIXTURES / "bad_rpt004.py")],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(RULES))]
