"""Bytes, flops and bounds pinned to their closed forms, and the readers
that turn them into shares."""
import numpy as np
import pytest

from perfbench.harness import devtrace, roofline, spec
from perfbench.harness.runner import Run

H100 = roofline.peaks_of("NVIDIA H100 80GB HBM3")
SIZES = {  # n, k, nnz
    "hpcg-pencil56": (1404928, 17787612, 36980152),
    "hpcg-cube112": (1404928, 17927388, 37259704),
}


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("nrhs", [1, 8])
def test_counts_closed_forms(name, nrhs):
    n, k, nnz = SIZES[name]
    # values: ad and one off-diagonal array (al = au); int32 columns;
    # x read and y written once
    assert roofline.product_bytes(n, k, nrhs, True) == (
        4 * (n + k) + 4 * k + 4 * n * nrhs + 4 * n * nrhs)
    assert roofline.product_bytes(n, k, nrhs, False) == (
        4 * (n + 2 * k) + 4 * k + 8 * n * nrhs)
    assert roofline.product_flops(n, nnz, nrhs) == nrhs * (2 * nnz - n)
    assert roofline.iteration_bytes(n, k, nrhs, True) == (
        roofline.product_bytes(n, k, nrhs, True) + 6 * 4 * n * nrhs)
    assert roofline.iteration_flops(n, nnz, nrhs) == (
        nrhs * (2 * nnz - n) + 13 * n * nrhs)


def test_pencil_numbers():
    n, k, nnz = SIZES["hpcg-pencil56"]
    assert roofline.product_bytes(n, k, 8, True) == 237836000
    assert roofline.iteration_bytes(n, k, 8, True) == 507582176
    assert roofline.product_bytes(n, k, 1, True) == 159160032
    # bytes bind: 237.8 MB over 3.35 TB/s against 0.58 GFLOP over 67 TFLOP/s
    b = roofline.bound_s(237836000, roofline.product_flops(n, nnz, 8), H100)
    assert b == pytest.approx(237836000 / 3.35e12)
    assert b * 1e3 == pytest.approx(0.07100, abs=1e-5)


def test_peaks_table():
    assert H100 == {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
    assert roofline.peaks_of("some other card") is None


def _run(**kw):
    n, k, nnz = SIZES["hpcg-pencil56"]
    base = dict(n=n, k=k,
                nnz=nnz, nrhs=8, numerically_symmetric=True, peaks=H100,
                setup_s=12.5, register_s=2.5, window_s=10.0, sets=100,
                iterations=5000,
                iteration_s=np.linspace(1e-3, 3e-3, 5000))
    base.update(kw)
    return Run(**base)


def _slice(**kw):
    base = dict(window_s=1.0, busy_s=0.9, product_calls=306,
                product_device_s=0.306 * 0.85, other_device_s=0.3 * 0.7,
                device_ops=[], idle_gaps=[])
    base.update(kw)
    return devtrace.DeviceSlice(**base)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_readers():
    run = _run(slice=_slice(), slice_iterations=300)
    assert _read("cg_iter_ms", run) == pytest.approx(2.0)
    assert _read("cg_iter_p95_ms", run) == pytest.approx(
        np.percentile(run.iteration_s, 95) * 1e3)
    assert _read("setup_s", run) == 12.5
    assert _read("register_s", run) == 2.5
    assert _read("product_ms", run) == pytest.approx(0.85)
    assert _read("vector_ms", run) == pytest.approx(0.7)
    assert _read("device_idle_frac", run) == pytest.approx(0.1)
    assert _read("product_roofline", run) == pytest.approx(
        100 * 237836000 / 3.35e12 / 0.85e-3)
    assert _read("cg_step_mfu", run) == pytest.approx(
        100 * 507582176 / 3.35e12 / 2e-3)


def test_readers_find_nothing_without_a_device_trace():
    """A reader with nothing to read returns None, never 0."""
    run = _run(slice=None)
    for name in ("product_ms", "product_roofline", "vector_ms",
                 "device_idle_frac"):
        assert _read(name, run) is None
    cpu = _run(peaks=None)
    assert _read("cg_step_mfu", cpu) is None
    assert _read("product_roofline", _run(peaks=None, slice=_slice())) is None
    assert _read("product_ms", _run(slice=_slice(product_device_s=0.0))) \
        is None
