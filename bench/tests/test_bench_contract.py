"""BENCHMARK.json against the rules its runs are held to, and the files
each cell is found by."""

import json
import math
import re

import pytest

import tiny  # noqa: F401  (puts the checkout on the import path)
from bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\t" not in word and "\n" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("entry", METRICS + BENCH["workloads"]
                         + BENCH["configs"], ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("bench/")
    cfg = harness.load_json(harness.ROOT / conf["file"])
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert 1 <= len(conf["source"]) <= 200 and 1 <= len(conf["why"]) <= 200
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found(cell):
    w, cfg, mix, limits = harness.cell_files(cell, BENCH)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert (harness.BENCH / "drivers" / f"{mix['kind']}.py").is_file()
    assert (harness.BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    assert limits and all(v > 0 for v in limits.values())


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda e: e["name"])
def test_metric_entry(m):
    e2e = m in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert keys <= set(m) <= keys | {"workloads"}
    assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in m.get("workloads", []):
        assert c in CELLS
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_setup_bound():
    (setup,) = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
    per = harness.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda e: e["name"])
def test_per_layer_moves_reported_in_its_cells(m):
    for cell in m.get("workloads", CELLS):
        e2e = {x["name"] for x in
               harness.cell_metrics(BENCH, cell, "end_to_end")}
        if "workloads" in m:
            assert m["moves"] in e2e


def test_model_cells_report_a_step_share_of_peak():
    for cell in CELLS:
        per = harness.cell_metrics(BENCH, cell, "per_layer")
        moved = {m["moves"] for m in per if m["name"].endswith("_roofline")}
        for e in moved:
            assert any("mfu" in m["name"] and m["moves"] == e for m in per)


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layers_are_named_alike():
    for m in BENCH["per_layer"]:
        assert m["layer"] == m["layer"].strip()
    assert math.isfinite(len(json.dumps(BENCH)))
