"""A whole run at a tiny size on the CPU (the plain versions of the
program's kernels): the last line's schema, the window, the exit without
a card."""
import json
import os
import subprocess
import sys
import time

import pytest

from perfbench.harness import runner, spec

SEED = 2**31 + 11


def _run(cell, trace=False, seconds=0.3, **kw):
    return runner.run(cell, SEED, seconds, trace, time.perf_counter(),
                      device="cpu", **kw)


@pytest.mark.parametrize("name", ["hpcg-pencil56.cg8", "hpcg-cube112.cg1",
                                  "hpcg-pencil56.cg32"])
def test_result_schema(tiny_cell, name):
    cell = tiny_cell(name)
    code, res = _run(cell)
    assert code == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    for name_, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(res, allow_nan=False)


def test_traced_run_reports_per_layer_metrics_only(tiny_cell):
    cell = tiny_cell("hpcg-pencil56.cg1")
    code, res = _run(cell, trace=True)
    assert code == 0 and res["correct"]
    per_layer = {m["name"] for m in cell.per_layer}
    # on the CPU there is no device trace: only the host's metric is read
    assert set(res["metrics"]) <= per_layer
    assert "register_s" in res["metrics"]
    assert list(res)[-1] == "checks"


def test_window_is_whole_sets(tiny_cell, monkeypatch):
    """The intervals tile the window: each set's prologue and each of its
    iterations, so cg_iter_ms is their sum over the iterations alone."""
    cell = tiny_cell("hpcg-pencil56.cg1")
    seen = []
    real = runner.TimedOperator.iteration_times

    def spy(self):
        t = real(self)
        seen.append(t)
        return t
    monkeypatch.setattr(runner.TimedOperator, "iteration_times", spy)
    code, res = _run(cell, seconds=0.5)
    iters = cell.traffic["iters_per_set"]
    assert seen[0].size == res["attempted"] * (iters + 1)
    assert (seen[0] > 0).all()
    assert res["metrics"]["cg_iter_ms"]["value"] == pytest.approx(
        seen[0].sum() * 1e3 / (res["attempted"] * iters))


def test_set_prologue_reaches_the_tail():
    """A stall before a set's first iteration lands in an interval of its
    own, so it can move the p95."""
    op = runner.TimedOperator(lambda x: x, None)
    op.reset(start=0.0)
    for _ in range(3):
        op.begin_set()
        time.sleep(0.02)            # the prologue stalls
        op(None)                    # A·x0: no stamp
        for _ in range(4):
            op(None)
        op.end_set()
    t = op.iteration_times()
    assert t.size == 3 * 5
    assert t[0] >= 0.02 and t[5] >= 0.02 and t[10] >= 0.02


def test_unreadable_trace_gives_no_result(tiny_cell, monkeypatch):
    def broken(*a, **kw):
        raise runner.devtrace.UnmatchedActivity("stray kernel")
    monkeypatch.setattr(runner, "_trace_slice", broken)
    code, res = _run(tiny_cell("hpcg-pencil56.cg1"), trace=True)
    assert code == 4 and res is None


def test_run_py_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.PERFBENCH, "run.py"),
         "--workload", "hpcg-pencil56.cg8", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA" in out.stderr


def test_forbidden_modules_by_top_level_name(monkeypatch):
    before = set(runner.forbidden_modules())
    for name in ("repro", "repro.core", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert set(runner.forbidden_modules()) - before == (
        {"flax", "jax", "jaxlib.xla", "repro", "repro.core"} - before)
    assert "repro_torch" not in runner.forbidden_modules()


def test_run_refuses_a_result_with_jax_loaded(tiny_cell, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    code, res = _run(tiny_cell("hpcg-pencil56.cg1"))
    assert code != 0 and res is None
