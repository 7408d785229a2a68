"""The port's spans and counters inside the solver and the product, on the
CPU: the hot-path ranges (``obs.trace_range``) exist only while
``torch.profiler`` records, ``obs.span`` reaches the profiler's trace as
well as the ring, and the ``solver_*`` counters move by what a solve did."""
import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import csrc, solvers
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.tuner import PlanCache
from repro_torch.kernels.ops import SpmvOperator
from repro_torch.serve.engine import SpmvServingEngine

HOT = ("solver.iteration", "solver.residual_sync", "spmv.product",
       "spmv.accumulate")
ITERS = 4
PLANS = {
    "segment": dict(path="segment"),
    "kernel": dict(path="kernel", tm=32, k_step_sublanes=2),
    "kernel_stream": dict(path="kernel", tm=32, k_step_sublanes=2,
                          variant="stream"),
    "flat": dict(path="flat", tm=32, k_step_sublanes=2),
    "nnzsplit": dict(path="nnzsplit"),
}


class Counting:
    """The operator, counting its calls."""

    def __init__(self, op):
        self.op, self.calls = op, 0

    def __call__(self, x):
        self.calls += 1
        return self.op(x)


def _operator(name="kernel"):
    M = csrc.poisson2d(12)
    plan = ExecutionPlan(**PLANS[name])
    return M, Counting(SpmvOperator.from_plan(M, plan, device="cpu"))


def _rhs(M, nrhs=1):
    g = torch.Generator().manual_seed(7)
    shape = (M.n,) if nrhs == 1 else (M.n, nrhs)
    return torch.randn(shape, generator=g)


def _solve(solver, op, M, b):
    if solver == "cg":
        return solvers.cg(op, b, tol=0.0, maxiter=ITERS, diag=M.ad)
    return solvers.bicgstab(op, b, tol=0.0, maxiter=ITERS)


def _profiled(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; its result and the chrome trace's
    user annotations as (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, ranges


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiler_off_the_hot_path_enters_no_range_and_writes_nothing(
        monkeypatch):
    M, op = _operator("kernel")
    b = _rhs(M)
    entered = []

    def spy(name, *args, **kw):
        entered.append(name)
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(autograd_profiler, "record_function", spy)
    obs.clear_trace()
    res = solvers.cg(op, b, tol=0.0, maxiter=ITERS, diag=M.ad)
    assert res.iters == ITERS and not entered
    assert not [r for r in obs.trace() if r["name"] in HOT]
    assert obs.trace_range("solver.iteration") is obs.trace_range("x")


@pytest.mark.parametrize("path", sorted(PLANS))
@pytest.mark.parametrize("nrhs", [1, 3])
def test_cg_ranges_under_the_profiler(path, nrhs, tmp_path):
    """One iteration range per iteration, one residual sync per iteration
    plus the prologue's, one product range per operator call, and the
    accumulation inside each product."""
    M, op = _operator(path)
    b = _rhs(M, nrhs)
    obs.clear_trace()
    res, ranges = _profiled(lambda: _solve("cg", op, M, b), tmp_path)
    assert res.iters == ITERS
    iters = _named(ranges, "solver.iteration")
    syncs = _named(ranges, "solver.residual_sync")
    products = _named(ranges, "spmv.product")
    accums = _named(ranges, "spmv.accumulate")
    assert len(iters) == ITERS
    assert len(syncs) == ITERS + 1
    assert len(products) == op.calls == ITERS + 1
    assert sum(any(_inside(s, it) for it in iters) for s in syncs) == ITERS
    assert all(any(_inside(p, it) for it in iters) for p in products[1:])
    assert accums and all(any(_inside(a, p) for p in products)
                          for a in accums)
    assert all(any(_inside(a, p) for a in accums) for p in products)
    # the ranges never reach the ring
    assert not [r for r in obs.trace() if r["name"] in HOT]


def test_bicgstab_ranges_under_the_profiler(tmp_path):
    M, op = _operator("segment")
    b = _rhs(M)
    res, ranges = _profiled(lambda: _solve("bicgstab", op, M, b), tmp_path)
    assert res.iters == ITERS
    assert len(_named(ranges, "solver.iteration")) == ITERS
    assert len(_named(ranges, "solver.residual_sync")) == ITERS + 1
    assert len(_named(ranges, "spmv.product")) == op.calls == 2 * ITERS + 1


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_solver_counters_move_by_the_solve(solver):
    M, op = _operator("segment")
    b = _rhs(M, 2)
    before = obs.snapshot()
    res = _solve(solver, op, M, b)
    d = obs.snapshot().diff(before)
    assert d.value("solver_iterations_total", solver=solver) == res.iters
    sync = d.value("solver_sync_seconds_total", solver=solver)
    total = d.value("solver_seconds_total", solver=solver)
    assert 0 < sync <= total


def test_nothing_moves_under_obs_disabled():
    M, op = _operator("kernel")
    b = _rhs(M)
    solvers.cg(op, b, tol=0.0, maxiter=1, diag=M.ad)   # children exist
    before = obs.snapshot()
    obs.clear_trace()
    with obs.disabled():
        res = solvers.cg(op, b, tol=0.0, maxiter=ITERS, diag=M.ad)
        with obs.span("outside.the.hot.path"):
            pass
    assert res.iters == ITERS
    d = obs.snapshot().diff(before)
    for name in ("solver_iterations_total", "solver_seconds_total",
                 "solver_sync_seconds_total"):
        assert d.value(name, solver="cg") == 0
    assert obs.trace() == []


def test_an_obs_span_keeps_its_ring_record_and_reaches_the_profiler(
        tmp_path):
    obs.clear_trace()

    def spans():
        with obs.span("schedule.outer", k=1):
            with obs.span("schedule.inner"):
                torch.ones(4).sum()

    _, ranges = _profiled(spans, tmp_path)
    outer, inner = (_named(ranges, n) for n in ("schedule.outer",
                                                "schedule.inner"))
    assert len(outer) == len(inner) == 1 and _inside(inner[0], outer[0])
    rec = {r["name"]: r for r in obs.trace()}
    assert rec["schedule.inner"]["parent"] == "schedule.outer"
    assert rec["schedule.outer"]["labels"] == {"k": "1"}
    # after the profiler, a span writes its ring record and nothing else
    obs.clear_trace()
    with obs.span("schedule.after"):
        pass
    assert [r["name"] for r in obs.trace()] == ["schedule.after"]


def test_an_obs_span_reaches_the_profiler_when_it_raises(tmp_path):
    def failing():
        with pytest.raises(ValueError):
            with obs.span("schedule.failing"):
                raise ValueError("boom")

    _, ranges = _profiled(failing, tmp_path)
    assert len(_named(ranges, "schedule.failing")) == 1
    assert obs.trace("schedule.failing")[-1]["ok"] is False


def test_register_spans_digests_reload_and_copies(tmp_path):
    """``register`` marks each digest (repeated where it is repeated), the
    schedule's npz reload in a second process's cache, and the copies to
    the device."""
    M = csrc.poisson2d(12)
    path = str(tmp_path / "plans.json")
    obs.clear_trace()
    SpmvServingEngine(cache=PlanCache(path=path),
                      device="cpu").register("m", M)
    first = [r["name"] for r in obs.trace()]
    assert first.count("schedule.digest") >= 3
    assert "schedule.to_device" in first and "schedule.load" not in first
    obs.clear_trace()
    SpmvServingEngine(cache=PlanCache(path=path),
                      device="cpu").register("m", M)
    second = obs.trace()
    names = [r["name"] for r in second]
    assert "schedule.load" in names and "schedule.build_artifact" not in names
    labels = {r["labels"]["of"] for r in second
              if r["name"] == "schedule.digest"}
    assert {"fingerprint", "value"} <= labels
