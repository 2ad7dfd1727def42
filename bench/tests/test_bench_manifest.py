"""``BENCHMARK.json`` against the rules the benchmark is written to: names,
units, keys, bounds, files found by name, and every per-layer metric
reported in each of its cells beside the end-to-end metric it moves."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"][:2] == ["python3", "-m"] and len(M["command"]) <= 32
    assert M["paths"] == ["bench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in M[group]:
            assert NAME.match(x["name"]), x["name"]
            assert x["name"] not in names
            names.add(x["name"])


def test_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in M["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_what_its_metrics_move(cell):
    from bench import run
    e2e = {m["name"] for m in run.cell_metrics(M, cell, "end_to_end")}
    layer = run.cell_metrics(M, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert run.reader_path(m["name"]).is_file(), m["name"]


def test_one_layer_name_a_layer():
    seen = {}
    for m in M["per_layer"]:
        base = m["name"].split(".")[0]
        assert seen.setdefault(base, m["layer"]) == m["layer"]
