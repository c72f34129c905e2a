"""What every cell shares: finding its files by name, the run's record,
the readers of its metrics, the output line and the module check.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness loads ``configs/<config>.json``, ``mixes/<traffic>.json`` and
``cells/<workload>.json``, runs ``drivers/<kind>.py`` (the mix's
``kind``), then calls the reader ``metrics/<metric>.py`` of each metric
the cell reports. Nothing here names a cell, a configuration or a metric:
a later cell or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level modules that must not be loaded in a run: the JAX package
# and JAX itself (compared by whole top-level name: ``repro_torch`` is
# the program, ``repro`` the JAX package)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """One run of one cell: what it was asked, and what the driver and
    the trace recorded. Metric readers read it."""
    workload: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                       # perf_counter at the process's start
    setup_s: Optional[float] = None
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    host: Dict[str, Any] = dataclasses.field(default_factory=dict)
    segments: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: Optional[Dict[str, Any]] = None):
    """(workload entry, configuration, mix, limits) of the cell ``name``."""
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / conf["file"])
    mix = load_json(BENCH / "mixes" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "cells" / f"{name}.json")["limits"]
    return w, config, mix, limits


def driver(kind: str):
    """``drivers/<kind>.py``: runs one entry kind of the program."""
    return importlib.import_module(f"bench.drivers.{kind}")


def reference(family: str):
    """``reference/<family>.py``: the plain model of one family."""
    return importlib.import_module(f"bench.reference.{family}")


def roofline(name: str):
    """``roofline/<name>.py``: a kernel's (or a model's) operations and
    bytes."""
    return importlib.import_module(f"bench.roofline.{name}")


def reader(metric: str):
    """``metrics/<metric>.py``, loaded by path: a metric's name may hold
    dots, which a module name may not."""
    name = "bench_metric_" + metric.replace(".", "_")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name, BENCH / "metrics" / f"{metric}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod


def cell_metrics(bench: Dict[str, Any], name: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``name`` reports: those that list it, and those without a
    ``workloads`` key that move (or are) an end-to-end metric it
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if section == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def read_metrics(run: Run, entries: list, required: bool) -> Dict[str, Any]:
    """Each entry's reading by its reader. A reader that finds nothing
    returns None and the metric is left out, unless ``required`` (an
    end-to-end metric), which raises."""
    out = {}
    for m in entries:
        value = reader(m["name"]).read(run)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of
    ``FORBIDDEN_MODULES`` (the whole name before the first dot)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): each number the cell's limits name within its
    limit, each beside it (a number with no limit is not compared: see
    ``cells/<workload>.json``). A number that is missing or not finite
    fails."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = values.get(name, float("nan"))
        ok = ok and value == value and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def _power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi`` (None where it cannot be
    read): rates are stated against peaks at 700 W."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(run: Run) -> Dict[str, Any]:
    import torch
    rec: Dict[str, Any] = {"platform": "gpu" if run.device == "cuda"
                           else run.device,
                           "kind": torch.cuda.get_device_name(0)
                           if run.device == "cuda" else run.device,
                           "count": run.workload["chips"],
                           "memory_peak_bytes": max(run.memory.values(),
                                                    default=0)}
    if run.trace:
        from bench import tracing
        rec["busy_s"] = sum(tracing.busy_s(s["events"])
                            for s in run.segments)
        rec["window_s"] = sum(s["wall_s"] for s in run.segments)
    if run.device == "cuda":
        rec["power_limit_w"] = _power_limit_w()
    return rec


def execute(run: Run, bench: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Drive the cell, read its metrics, judge its outputs: the result
    line as a dict, or None where a forbidden module was loaded."""
    driver(run.mix["kind"]).run(run)
    bad = forbidden_loaded()
    if bad:
        print(f"bench: modules of the JAX package or JAX are loaded: {bad}",
              file=sys.stderr)
        return None
    name = run.workload["name"]
    section = "per_layer" if run.trace else "end_to_end"
    entries = cell_metrics(bench, name, section)
    metrics = read_metrics(run, entries,
                           required=not run.trace and run.device == "cuda")
    for s in run.segments:
        if s["faults"]:
            print(f"bench: trace segment {s['name']} not whole: "
                  f"{s['faults'][:8]}", file=sys.stderr)
    out: Dict[str, Any] = {"correct": bool(run.correct),
                           "attempted": run.attempted, "failed": run.failed,
                           "metrics": metrics, "device": device_record(run)}
    if run.trace:
        from bench import tracing
        out["breakdown"] = tracing.breakdown(run.segments)
    out["checks"] = run.checks
    return out
