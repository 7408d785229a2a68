"""The assembly schedule's de-duplication by sort (``conflict.sorted_unique``)
against ``np.unique``: equal arrays on random keys, and the element
adjacency and the whole assembly schedule array for array equal to the
ones built with ``np.unique`` in its place."""
import dataclasses

import numpy as np
import pytest

from repro_torch.assembly import conflict, mesh, scatter


@pytest.mark.parametrize("n,hi", [(0, 10), (1, 10), (7, 3), (5000, 100),
                                  (20000, 2 ** 40)])
def test_sorted_unique_equals_np_unique(n, hi):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, hi, size=n, dtype=np.int64)
    got = conflict.sorted_unique(keys)
    want = np.unique(keys)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _with_np_unique(monkeypatch):
    monkeypatch.setattr(conflict, "sorted_unique", np.unique)
    monkeypatch.setattr(scatter, "sorted_unique", np.unique)


@pytest.mark.parametrize("cubes", [(2, 2, 2), (4, 3, 2)])
def test_element_adjacency_equal_before_and_after(cubes, monkeypatch):
    conn = mesh.grid_tet(*cubes).conn
    after = conflict.element_adjacency(conn)
    _with_np_unique(monkeypatch)
    before = conflict.element_adjacency(conn)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndof", [1, 3])
def test_assembly_schedule_equal_before_and_after(ndof, monkeypatch):
    m = mesh.grid_tet(4, 3, 2)
    after = scatter.build_assembly_schedule(m, ndof)
    _with_np_unique(monkeypatch)
    before = scatter.build_assembly_schedule(m, ndof)
    for f in dataclasses.fields(scatter.AssemblySchedule):
        a, b = getattr(after, f.name), getattr(before, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif dataclasses.is_dataclass(a):
            for g in dataclasses.fields(a):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=g.name)
        elif isinstance(a, (int, str)):
            assert a == b, f.name
