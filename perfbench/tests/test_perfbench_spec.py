"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import os
import re

import pytest

from perfbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(spec.BENCHMARK) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert len(set(c["name"] for c in BENCH["configs"])) == len(
        BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(
        BENCH["configs"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_contract():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        got = spec.load_cell(cell)
        names = {m["name"] for m in got.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert got.per_layer
        # a per-layer metric's cell reports the metric it moves
        for m in got.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_loads_by_name(cell):
    c = spec.load_cell(cell)
    gen = spec.generator(c.config["generator"])
    assert callable(gen.build)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["rhs"] >= 1 and c.traffic["iters_per_set"] >= 1
    for name in ("product_err", "x_err"):
        assert c.limits[name]["limit"] > 0
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")
