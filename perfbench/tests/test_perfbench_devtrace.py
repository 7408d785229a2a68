"""The trace reduction on a hand-made chrome trace."""
import pytest

from perfbench.harness import devtrace


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    ev = [X(devtrace.SLICE, "user_annotation", 0, 1000)]
    # two products, each a launch (by correlation) of one kernel
    ev += [X(devtrace.PRODUCT, "user_annotation", 10, 20),
           X("cudaLaunchKernel", "cuda_runtime", 15, 2, correlation=1),
           X("k4", "kernel", 20, 100, correlation=1),
           X(devtrace.PRODUCT, "user_annotation", 500, 20),
           X("cuLaunchKernel", "cuda_driver", 505, 2, correlation=2),
           X("k4", "kernel", 510, 100, correlation=2)]
    # a vector op launched outside the products
    ev += [X("aten::mul", "cpu_op", 200, 10),
           X("cudaLaunchKernel", "cuda_runtime", 202, 2, correlation=4),
           X("mul_kernel", "kernel", 205, 50, correlation=4),
           # a copy to the host, by correlation
           X("aten::item", "cpu_op", 300, 200),
           X("cudaMemcpyAsync", "cuda_runtime", 301, 2, correlation=3),
           X("Memcpy DtoH", "gpu_memcpy", 310, 10, correlation=3)]
    # outside the slice: ignored
    ev += [X("late", "kernel", 2000, 10, correlation=9)]
    return {"traceEvents": ev}


def test_reduce():
    s = devtrace.reduce(_trace())
    assert s.window_s == pytest.approx(1e-3)
    assert s.product_calls == 2
    assert s.product_device_s == pytest.approx(200e-6)
    assert s.other_device_s == pytest.approx(60e-6)
    assert s.busy_s == pytest.approx(260e-6)
    assert s.device_ops[0] == ("k4", pytest.approx(200e-6))
    gaps = dict(s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 260e-6)
    # the gap from 320 to 510 has its middle inside aten::item's host time
    assert "aten::item" in gaps


def test_overlapping_activities_count_once_in_busy():
    t = _trace()
    t["traceEvents"] += [
        X("cudaMemcpyAsync", "cuda_runtime", 25, 2, correlation=5),
        X("copy", "gpu_memcpy", 30, 60, correlation=5)]
    s = devtrace.reduce(t)
    assert s.busy_s == pytest.approx(260e-6)


@pytest.mark.parametrize("orphan", [
    {"correlation": 77},            # its launch is not in the trace
    {"External id": 7},             # no correlation id at all
])
def test_an_activity_without_its_launch_reads_nothing(orphan):
    """Device time that cannot be placed is neither product nor vector
    time: the reduction refuses the trace."""
    t = _trace()
    t["traceEvents"].append(X("stray", "kernel", 700, 10, **orphan))
    with pytest.raises(devtrace.UnmatchedActivity, match="1 of 5"):
        devtrace.reduce(t)


def test_no_slice_or_no_device_reads_nothing():
    assert devtrace.reduce({"traceEvents": []}) is None
    cpu_only = [X(devtrace.SLICE, "user_annotation", 0, 100),
                X("aten::mul", "cpu_op", 10, 5)]
    assert devtrace.reduce({"traceEvents": cpu_only}) is None


def test_breakdown_names_are_short():
    long = "void at::native::elementwise_kernel<" + "x" * 500 + ">(int)"
    ev = [X(devtrace.SLICE, "user_annotation", 0, 100),
          X("cudaLaunchKernel", "cuda_runtime", 8, 1, correlation=1),
          X(long, "kernel", 10, 5, correlation=1),
          X("cudaLaunchKernel", "cuda_runtime", 18, 1, correlation=2),
          X(long[:-1], "kernel", 20, 5, correlation=2)]
    s = devtrace.reduce({"traceEvents": ev})
    name, secs = s.device_ops[0]
    assert len(name) <= devtrace.NAME_CHARS and not name.startswith("void")
    # two kernels that differ past the cut are summed under one name
    assert secs == pytest.approx(10e-6) and len(s.device_ops) == 1
