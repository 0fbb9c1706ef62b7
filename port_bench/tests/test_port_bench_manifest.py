"""BENCHMARK.json against the benchmark contract's static rules, and the
loaders finding each piece by name."""

import json
import re

import pytest

from conftest import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200
        assert 1 <= len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])


def test_metrics():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in m["workloads"]}
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
        assert set(x.get("workloads", cells)) <= cells
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[x["moves"]]
        # every cell the metric lists reports the metric it moves
        assert set(x["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for w in cells:
        reported = [x for x in m["end_to_end"]
                    if w in x.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in x["workloads"] for x in m["per_layer"])


def test_run_budget():
    """A full check of 24 cells fits in 43,200 s."""
    m = manifest()
    s = m["run_seconds"]
    assert 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 180 + 1200 <= 43200


def test_loaders_find_each_piece_by_name():
    from port_bench import bench

    m = manifest()
    for w in m["workloads"]:
        entry, cfg, traffic = bench.cell(w["name"])
        assert cfg["name"] == w["config"]
        kind = bench.load_kind(traffic["kind"])
        assert kind.Inputs and kind.Cell and callable(kind.control)
        limits = bench.load_json("limits", w["name"])
        assert limits["limits"]
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for x in m["per_layer"]:
        assert callable(bench.load_metric(x["name"]).read)
    for x in m["end_to_end"]:
        assert callable(bench.load_end_to_end(x["name"]).read)


def test_command_and_paths():
    m = manifest()
    assert m["command"] == ["python3", "port_bench/run.py"]
    for p in m["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
        assert ".." not in p.split("/")


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest()["workloads"]])
def test_cell_reports_its_metrics(workload):
    from port_bench import bench

    e2e = bench.cell_metrics(workload, False)
    per_layer = bench.cell_metrics(workload, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
