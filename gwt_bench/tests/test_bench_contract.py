"""BENCHMARK.json against the harness's files and the contract's limits
on names, units and sizes."""

import json
import re
from pathlib import Path

from gwt_bench import specs

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gwt_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_are_their_files():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        f = json.loads((REPO / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert c["file"] == f"gwt_bench/configs/{c['name']}.json"


def test_cells_are_their_files():
    names = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        spec = specs.workload(w["name"])
        assert (spec["config"], spec["chips"], spec["why"],
                spec["traffic_name"]) == (w["config"], w["chips"], w["why"],
                                          w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        used.add(w["config"])
    assert used == names


def test_metrics_are_their_files():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        f = specs.metric(m["name"])
        for key in ("unit", "better", "source"):
            assert f[key] == m[key], (m["name"], key)
        assert set(m.get("workloads", cells)) <= cells
        if "workloads" in m or "workloads" in f:
            assert m.get("workloads") == f.get("workloads")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        f = specs.metric(m["name"])
        assert (f["layer"], f["moves"]) == (m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (REPO / "gwt_bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        spec = specs.workload(w["name"])
        assert "setup_s" in spec["end_to_end"]
        assert set(specs.metrics_of(w["name"]))
