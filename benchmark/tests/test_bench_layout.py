"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files: configurations, traffic and its driver, limits, and
each metric's reader."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word or (ROOT / word).exists():
            assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"]), word
    # A full check fits with 24 cells at this length.
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == CONFIG_KEYS
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == CELL_KEYS
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_metric_entries():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        layers.add(m["layer"])
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline_pct") and m["unit"] == "%"
    assert 1 <= len(BENCH["per_layer"]) <= 128


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"]), w["name"]


def test_moves_names_a_metric_each_of_its_cells_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert w["config"] in configs
    cfg_path = ROOT / configs[w["config"]]["file"]
    assert cfg_path.is_file() and cfg_path.is_relative_to(ROOT / "benchmark")
    cfg = json.loads(cfg_path.read_text())
    assert cfg["name"] == w["config"] and cfg["reduced"] == configs[w["config"]]["reduced"]
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    assert limits["checks"] and all("limit" in c for c in limits["checks"].values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if _reports(m, cell):
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
