"""Build, plan, launch and sync budget gate: pinned workloads, committed counts.

The counterpart of ``repro.analysis.tracegate``, which counts JAX traces.
The port traces nothing; what it must keep flat in a steady serving loop is
what a retrace cost the reference: a kernel library built or loaded, a new
launch plan.  And what it pays for on every tick is its launches and its
waits on the card.  This gate runs the reference's four pinned workloads on
the port's APIs (one-shot retrieval on the kernel route, Max-Cut, a
continuous-serving tick loop, a mid-stream hot swap), each twice in one
process (the **warm** pass, then an identical **steady** pass), and for
each pass records the movement of:

* ``build.loaded``: kernel libraries built or loaded (``build.loaded()``);
* ``autotune.miss``: new launch plans (``autotune.cache_info()["misses"]``);
* ``ops.<kernel>``: kernel launches (``ops.LAUNCHES``);
* ``cuda.syncs``: calls that wait on the card.  They are counted under
  ``torch.cuda.set_sync_debug_mode("warn")``, one per warning whose text is
  torch's own ("called a synchronizing CUDA operation"); the mode is put
  back afterwards.  Torch flags a device-to-host copy (``.cpu()``, ``.item()``,
  ``bool()`` of a card tensor) and an upload from pageable host memory; it
  flags neither ``torch.cuda.synchronize()`` nor a non-blocking upload from
  pinned memory, nor a kernel launch (so measured by :func:`probe_syncs` on
  an H100 with torch 2.11; phase 19 of ``chip_smoke.py`` prints it).

The gate, against the committed ``TRACE_BUDGET_TORCH.json`` at the root:

* on the card the warm and steady passes equal the budget exactly; the
  steady pass's ``build.loaded`` and ``autotune.miss`` are 0 (a steady loop
  that builds or plans is a leak), its launches and syncs are the budget's
  (the steady loop does real work, so they are counted, not zero);
* on the CPU (``device="cpu"``) nothing is built, planned, launched or
  synced, so only the steady ``build.loaded`` and ``autotune.miss`` are
  compared (both 0);
* ``--smoke`` shortens the settle horizon, as the reference's does.  That
  changes how many chunks run, so a smoke run's launches and syncs differ
  from the budget's: a smoke run gates ``build.loaded`` and
  ``autotune.miss`` alone.  The budget is written from, and phase 19 gates,
  the full matrix.

Workloads run in the pinned order and share one process; the budget is only
meaningful against that order and a fresh process.  Regenerate it after an
intentional change with ``python -m repro_torch.analysis.tracegate --update``
on the card and commit the diff.  ``--inject-retrace`` demonstrates the
failure: one new plan inside ``retrieve``'s steady window (and, on the card,
kernel 1 launched at that shape and read back).

The ``serving_tick`` workload's report holds the scheduler's waits:
``syncs_per_slab_tick`` (the steady pass's syncs over its chunks) and the
syncs of each tick, apart for ticks that harvest and ticks that do not.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: Root seed of every generator the workloads make; each use adds its own
#: offset, so the matrix is reproducible and no generator is used twice.
_SEED = 0

#: Committed budget, at the repository root beside the reference's.
DEFAULT_BUDGET_PATH = Path(__file__).resolve().parents[3] / "TRACE_BUDGET_TORCH.json"

#: Pinned execution order (see module docstring).
WORKLOAD_ORDER = ("retrieve", "maxcut", "serving_tick", "hot_swap")

#: The counters that a CPU run and a smoke run gate.
PLAN_KEYS = ("build.loaded", "autotune.miss")

#: Torch's text for a call that waits on the card, under the sync debug mode.
SYNC_WARNING = "called a synchronizing CUDA operation"

Delta = Dict[str, int]


def snapshot() -> Delta:
    """Every counter the gate reads, under stable dotted names."""
    from repro_torch.kernels import autotune, build, ops

    merged: Delta = {
        "build.loaded": len(build.loaded()),
        "autotune.miss": autotune.cache_info()["misses"],
    }
    for name, count in ops.LAUNCHES.items():
        merged[f"ops.{name}"] = int(count)
    return merged


def counter_delta(before: Delta, after: Delta) -> Delta:
    """Nonzero counter movements between two snapshots, sorted by key."""
    keys = sorted(set(before) | set(after))
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
    return {k: v for k, v in moved.items() if v != 0}


class SyncCounter:
    """Counts the calls that wait on the card while it is open (torch's sync
    debug mode ``"warn"``, matched on torch's warning text).  On the CPU it
    counts nothing and touches no CUDA state."""

    def __init__(self, device: torch.device):
        self.device = device
        self._records: List[warnings.WarningMessage] = []
        self._catch: Optional[warnings.catch_warnings] = None
        self._mode = 0

    def __enter__(self) -> "SyncCounter":
        if self.device.type == "cuda":
            self._catch = warnings.catch_warnings(record=True)
            self._records = self._catch.__enter__()
            warnings.simplefilter("always")
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    @property
    def count(self) -> int:
        return sum(SYNC_WARNING in str(w.message) for w in self._records)

    def __exit__(self, *exc) -> None:
        if self._catch is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._catch.__exit__(*exc)
            self._catch = None


def probe_syncs(device=None) -> Dict[str, int]:
    """Which calls torch counts as waits on ``device`` (the GPU unless
    given): the warnings each raises under the sync debug mode."""
    from repro_torch.core.checks import resolve_device

    dev = resolve_device(device)
    x = torch.ones((4,), dtype=torch.int32, device=dev)
    host = np.ones((4,), dtype=np.int32)
    pinned = torch.ones((4,), dtype=torch.int32).pin_memory() if dev.type == "cuda" else None
    calls: Dict[str, Callable[[], Any]] = {
        "to_cpu": lambda: x.cpu(),
        "item": lambda: x.sum().item(),
        "bool": lambda: bool(x.all()),
        "upload_pageable": lambda: torch.as_tensor(host).to(dev),
        "upload_pinned_non_blocking": lambda: (pinned.to(dev, non_blocking=True)
                                                if pinned is not None else None),
        "synchronize": lambda: torch.cuda.synchronize(dev) if dev.type == "cuda" else None,
        "kernel_launch": lambda: x + 1,
    }
    out = {}
    for name, call in calls.items():
        with SyncCounter(dev) as syncs:
            call()
            out[name] = syncs.count
    return out


# ---------------------------------------------------------------------------
# Workloads.  Each factory returns a pass: the first call builds the engine
# and serves (warm), the second serves the identical request stream on the
# same engine (steady).  A pass takes the open SyncCounter and returns its
# report (empty but for serving_tick's).
# ---------------------------------------------------------------------------

Pass = Callable[[SyncCounter], Dict[str, Any]]


def _generator(offset: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_SEED + offset)


def _patterns(seed: int, p: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 1], dtype=np.int8), (p, n))


def _corrupt(xi: np.ndarray, row: int, flips: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    v = xi[row].copy()
    idx = rng.choice(v.size, flips, replace=False)
    v[idx] = -v[idx]
    return torch.as_tensor(v)


def _wl_retrieve(dev: torch.device, smoke: bool) -> Pass:
    """One-shot engine, kernel route (kernel 5), two batch buckets.

    ``smoke`` shortens the settle horizon only: the request stream, and so
    the plans and builds, are those of the full run."""
    from repro_torch import engine as engine_lib

    xi = _patterns(1, 4, 64)
    singles = [_corrupt(xi, i % 4, 6, 30 + i) for i in range(4)]
    pair = torch.stack(singles[:2])
    state: Dict[str, Any] = {}

    def run(syncs: SyncCounter) -> Dict[str, Any]:
        if "eng" not in state:
            eng = engine_lib.Engine(_generator(0), device=dev, batch_buckets=(1, 2, 4))
            eng.install("mem", "retrieval", xi=xi, max_cycles=20 if smoke else 40,
                        settle_chunk=1, backend="kernel", device=dev)
            state["eng"] = eng
        eng = state["eng"]
        futs = [eng.submit(engine_lib.Request("mem", s)) for s in singles]
        futs.append(eng.submit(engine_lib.Request("mem", pair)))
        eng.drain()
        for f in futs:
            f.result()
        return {}

    return run


def _wl_maxcut(dev: torch.device, smoke: bool) -> Pass:
    """One-shot engine, Max-Cut sweeps on two graph sizes."""
    from repro_torch import engine as engine_lib
    from repro_torch.core.ising import random_graph

    graphs = [random_graph(_generator(1 + i), n, 0.5) for i, n in enumerate((20, 24))]
    state: Dict[str, Any] = {}

    def run(syncs: SyncCounter) -> Dict[str, Any]:
        if "eng" not in state:
            eng = engine_lib.Engine(_generator(7), device=dev, batch_buckets=(1, 2, 4))
            eng.install("cuts", "maxcut", sweeps=4 if smoke else 8, device=dev)
            state["eng"] = eng
        eng = state["eng"]
        futs = [
            eng.submit(engine_lib.Request("cuts", adj, key=_generator(100 + i, dev)))
            for i, adj in enumerate(graphs)
        ]
        eng.drain()
        for f in futs:
            f.result()
        return {}

    return run


def _wl_serving_tick(dev: torch.device, smoke: bool) -> Pass:
    """Continuous-batching tick loop: admit, step per arrival, then tick
    until idle (``flush``'s loop, one tick at a time, so that each tick's
    syncs are seen)."""
    from repro_torch import serving
    from repro_torch.engine import Request

    xi = _patterns(2, 3, 32)
    reqs = [_corrupt(xi, i % 3, 4, 50 + i) for i in range(6)]
    state: Dict[str, Any] = {}

    def run(syncs: SyncCounter) -> Dict[str, Any]:
        if "eng" not in state:
            eng = serving.ContinuousEngine(_generator(8), device=dev, batch_buckets=(1, 2, 4),
                                           slab_lanes=4)
            eng.install("mem", "retrieval", xi=xi, max_cycles=20 if smoke else 40,
                        settle_chunk=1, device=dev)
            state["eng"] = eng
        eng = state["eng"]
        ticks: List[List[int]] = []

        def tick() -> None:
            before = syncs.count
            rep = eng.step()
            ticks.append([syncs.count - before, len(rep["slab_seconds"]), rep["admitted"],
                          rep["harvested"]])

        futs = []
        for i, r in enumerate(reqs):
            futs.append(eng.submit(Request("mem", r, key=_generator(200 + i, dev))))
            tick()  # serve as they arrive: varying slab packings
        while not eng.idle:
            tick()
        for f in futs:
            f.result()
        return {"ticks": ticks}

    return run


def _wl_hot_swap(dev: torch.device, smoke: bool) -> Pass:
    """Train fresh weights and swap them into a live serving engine.

    Every pass trains on *different* patterns of the *same* shape: the
    steady pass shows a weight refresh builds and plans nothing."""
    from repro_torch import serving, train
    from repro_torch.engine import Request

    n = 24
    xi_old = _patterns(3, 3, n)
    probes = [_corrupt(xi_old, i, 5, 70 + i) for i in range(2)]
    state: Dict[str, Any] = {"swaps": 0}

    def run(syncs: SyncCounter) -> Dict[str, Any]:
        if "eng" not in state:
            eng = serving.ContinuousEngine(_generator(9), device=dev, batch_buckets=(1, 2, 4),
                                           slab_lanes=4)
            # serving_tick's settle horizon and slab: its plans are shared.
            eng.install("mem", "retrieval", xi=xi_old, max_cycles=20 if smoke else 40,
                        settle_chunk=1, device=dev)
            state["eng"] = eng
        eng = state["eng"]
        cfg = eng.solver("mem").config
        state["swaps"] += 1
        xi_new = _patterns(10 + state["swaps"], xi_old.shape[0], n)
        res = train.train_doi(xi_new, train.TrainConfig(qat_bits=cfg.weight_bits), device=dev)
        params, _ = train.trained_params(cfg, res.weights)
        eng.hot_swap("mem", params)
        futs = [eng.submit(Request("mem", p, key=_generator(300 + i, dev)))
                for i, p in enumerate(probes)]
        eng.flush()
        for f in futs:
            f.result()
        return {}

    return run


_FACTORIES: Dict[str, Callable[[torch.device, bool], Pass]] = {
    "retrieve": _wl_retrieve,
    "maxcut": _wl_maxcut,
    "serving_tick": _wl_serving_tick,
    "hot_swap": _wl_hot_swap,
}


def inject_retrace(device) -> None:
    """One new launch plan at a shape no workload uses (the reference's
    off-bucket shape), made by a direct ``autotune.coupling_plan`` call as
    kernel 1's wrapper makes it; on the card kernel 1 also runs at that
    shape and its result is read on the host.  The shape steps past any
    that this process planned already, so each call makes one plan."""
    from repro_torch.kernels import autotune, ops

    misses = autotune.cache_info()["misses"]
    n = 152  # off every bucket
    while True:
        autotune.coupling_plan(1, 3, n, n, None)
        if autotune.cache_info()["misses"] > misses:
            break
        n += 8
    if torch.device(device).type == "cuda":
        w = torch.zeros((n, n), dtype=torch.int8, device=device)
        sigma = torch.ones((3, n), dtype=torch.int8, device=device)
        ops.coupling_sum(w, sigma).cpu()


def _serving_report(steady: Delta, ticks: List[List[int]]) -> Dict[str, Any]:
    """The scheduler's waits in the steady pass: syncs over chunks, and the
    syncs of ticks that harvest and of ticks that do not ([syncs, chunks,
    admitted, harvested] a tick)."""
    chunks = sum(t[1] for t in ticks)
    harvest = [t[0] for t in ticks if t[3] > 0]
    other = [t[0] for t in ticks if t[3] == 0 and t[1] > 0]
    return {
        "chunks": chunks,
        "ticks": ticks,
        "syncs_per_slab_tick": steady.get("cuda.syncs", 0) / chunks if chunks else 0.0,
        "syncs_harvest_ticks": harvest,
        "syncs_other_ticks": other,
    }


def measure(
    *, device=None, smoke: bool = False, inject: bool = False
) -> Dict[str, Dict[str, Any]]:
    """Run the pinned matrix on ``device`` (the GPU unless ``"cpu"``); per
    workload, the warm and steady deltas (and ``serving_tick``'s report)."""
    from repro_torch.core.checks import resolve_device

    dev = resolve_device(device)
    observed: Dict[str, Dict[str, Any]] = {}
    for name in WORKLOAD_ORDER:
        run = _FACTORIES[name](dev, smoke)
        entry: Dict[str, Any] = {}
        for label in ("warm", "steady"):
            before = snapshot()
            with SyncCounter(dev) as syncs:
                report = run(syncs)
                if inject and name == "retrieve" and label == "steady":
                    inject_retrace(dev)
                n_syncs = syncs.count
            delta = counter_delta(before, snapshot())
            if n_syncs:
                delta["cuda.syncs"] = n_syncs
            entry[label] = dict(sorted(delta.items()))
        if name == "serving_tick":
            entry["report"] = _serving_report(entry["steady"], report["ticks"])
        observed[name] = entry
    return observed


class GateResult(NamedTuple):
    passed: bool
    observed: Dict[str, Dict[str, Any]]
    diffs: List[str]


def load_budget(path: Path = DEFAULT_BUDGET_PATH) -> Dict:
    if not path.exists():
        raise FileNotFoundError(
            f"trace budget {path} is missing; generate it on the card with "
            "`python -m repro_torch.analysis.tracegate --update` and commit it"
        )
    try:
        budget = json.loads(path.read_text())
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"trace budget {path} is not valid JSON ({exc}); regenerate it on the card "
            "with `python -m repro_torch.analysis.tracegate --update`"
        ) from exc
    if not isinstance(budget, dict) or "workloads" not in budget:
        raise ValueError(
            f"trace budget {path} has no 'workloads' table; regenerate it on the card "
            "with `python -m repro_torch.analysis.tracegate --update`"
        )
    return budget


def gated(device_type: str, smoke: bool) -> Tuple[Tuple[str, ...], Optional[Tuple[str, ...]]]:
    """(passes, counters) a run compares with the budget; counters None:
    every counter.  The card's full run compares both passes whole; a smoke
    run on the card compares both passes' builds and plans; a CPU run the
    steady pass's builds and plans."""
    if device_type != "cuda":
        return ("steady",), PLAN_KEYS
    return ("warm", "steady"), (PLAN_KEYS if smoke else None)


def run_gate(
    budget_path: Path = DEFAULT_BUDGET_PATH,
    *,
    device=None,
    smoke: bool = False,
    inject: bool = False,
    observed: Optional[Dict[str, Dict[str, Any]]] = None,
) -> GateResult:
    """Measure the matrix on ``device`` (or take ``observed``, measured
    there) and diff it against the committed budget (see :func:`gated`)."""
    budget = load_budget(budget_path)
    if observed is None:
        observed = measure(device=device, smoke=smoke, inject=inject)
    passes, keys = gated(torch.device("cuda" if device is None else device).type, smoke)
    diffs: List[str] = []
    for name in WORKLOAD_ORDER:
        budgeted = budget["workloads"].get(name)
        if budgeted is None:
            diffs.append(f"{name}: not in budget (regenerate with --update)")
            continue
        got = observed[name]
        leaked = {k: got["steady"].get(k, 0) for k in PLAN_KEYS if got["steady"].get(k, 0)}
        if leaked:
            diffs.append(f"{name}.steady: {leaked} — a steady pass built or planned")
        for label in passes:
            want, have = budgeted.get(label, {}), got[label]
            if keys is not None:
                want = {k: want.get(k, 0) for k in keys}
                have = {k: have.get(k, 0) for k in keys}
            if have != want:
                diffs.append(f"{name}.{label}: expected {want}, observed {have}")
    return GateResult(passed=not diffs, observed=observed, diffs=diffs)


def _nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _write_budget(path: Path, observed: Dict[str, Dict[str, Any]]) -> None:
    payload = {
        "_meta": {
            "order": list(WORKLOAD_ORDER),
            "note": (
                "Warm = first-pass deltas per workload (pinned order, one fresh "
                "process, on the card); steady = the identical second pass, whose "
                "build.loaded and autotune.miss must be 0 and whose launches and "
                "cuda.syncs are the steady loop's real work. A CPU run compares "
                "only the steady build.loaded and autotune.miss; a --smoke run "
                "only build.loaded and autotune.miss. Regenerate on the card: "
                "python -m repro_torch.analysis.tracegate --update"
            ),
            "smoke": False,
            "device": _nvidia_smi_line(),
        },
        "workloads": {
            name: {"warm": entry["warm"], "steady": entry["steady"]}
            for name, entry in observed.items()
        },
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tracegate",
        description="Diff observed build/plan/launch/sync deltas against "
                    "TRACE_BUDGET_TORCH.json.",
    )
    ap.add_argument("--budget", type=Path, default=DEFAULT_BUDGET_PATH,
                    help="budget file (default: repo-root TRACE_BUDGET_TORCH.json)")
    ap.add_argument("--smoke", action="store_true",
                    help="shorter settle horizon: gates builds and plans only")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the budget from this run (on the card) instead of gating")
    ap.add_argument("--inject-retrace", action="store_true",
                    help="make one new plan inside retrieve's steady window "
                         "(the gate must fail)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the observed deltas, reports and diffs as JSON")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    dev = torch.device("cuda" if args.device is None else args.device)
    if args.update and (dev.type != "cuda" or args.smoke or args.inject_retrace):
        print("tracegate: --update records the card's full run; run it on the GPU without "
              "--smoke or --inject-retrace", file=sys.stderr)
        return 2
    observed = measure(device=args.device, smoke=args.smoke, inject=args.inject_retrace)
    if args.update:
        leaked = [n for n, e in observed.items() if any(e["steady"].get(k) for k in PLAN_KEYS)]
        if leaked:
            print(f"tracegate: steady passes built or planned in {leaked}; not budgeted",
                  file=sys.stderr)
            return 1
        _write_budget(args.budget, observed)
        print(f"tracegate: wrote {args.budget}")
        return 0

    try:
        result = run_gate(args.budget, device=args.device, smoke=args.smoke,
                          observed=observed)
    except (FileNotFoundError, ValueError) as exc:
        print(f"tracegate: {exc}", file=sys.stderr)
        return 2

    if args.out is not None:
        args.out.write_text(json.dumps(
            {"passed": result.passed, "diffs": result.diffs, "device": str(dev),
             "smoke": args.smoke, "observed": result.observed,
             "sync_probe": probe_syncs(dev)},
            indent=2, sort_keys=True) + "\n")

    for diff in result.diffs:
        print(f"tracegate: {diff}")
    if result.passed:
        print(f"tracegate: {len(WORKLOAD_ORDER)} workloads within budget")
        return 0
    print("tracegate: budget violated — a build, plan, launch or wait that the committed "
          "TRACE_BUDGET_TORCH.json does not account for. If the change is intentional, "
          "regenerate it on the card with --update and commit the diff.", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
