"""The two HPCG configurations: closed forms, symmetry, HPCG's layout."""
import numpy as np
import pytest

from perfbench.harness import spec

# n, nnz, k and bandwidth as the benchmark's design states them
EXPECTED = {
    "hpcg-pencil56": {"grid": [56, 56, 448], "n": 1404928, "nnz": 36980152,
                      "k": 17787612, "bandwidth": 3193},
    "hpcg-cube112": {"grid": [112, 112, 112], "n": 1404928,
                     "nnz": 37259704, "k": 17927388, "bandwidth": 12657},
}
SMALL_GRIDS = [(3, 3, 3), (4, 5, 6), (8, 8, 24), (16, 16, 16), (7, 2, 9)]


def _gen():
    return spec.generator("hpcg27")


def _build(grid, **kw):
    cfg = spec._json("configs", "hpcg-pencil56.json")
    return _gen().build(dict(cfg, grid=list(grid), **kw))


def _dense(a):
    n = a["n"]
    A = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(a["ia"]))
    A[rows, a["ja"]] = a["al"]
    A[a["ja"], rows] = a["au"]
    A[np.arange(n), np.arange(n)] = a["ad"]
    return A


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_config_closed_forms(name):
    cfg = spec._json("configs", name + ".json")
    exp = EXPECTED[name]
    assert cfg["grid"] == exp["grid"]
    forms = _gen().closed_forms(*cfg["grid"])
    for key in ("n", "nnz", "k", "bandwidth"):
        assert forms[key] == exp[key] == cfg["closed_forms"][key], key
    assert forms["nnz"] == forms["n"] + 2 * forms["k"]
    # HPCG's rules on the local grid: every dimension >= 16, divisible by
    # 8 (main.cpp), and CheckAspectRatio(0.125, nx, ny, nz)
    assert all(g >= 16 and g % 8 == 0 for g in cfg["grid"])
    assert min(cfg["grid"]) / max(cfg["grid"]) >= 0.125


def test_window_routes():
    """The pencil's band fits the windowed kernels (w_cap 4,096 at tm 128),
    the cube's does not: round_up(128 + bandwidth, 128)."""
    def window(b):
        return -(-(128 + b) // 128) * 128
    assert window(EXPECTED["hpcg-pencil56"]["bandwidth"]) == 3328 <= 4096
    assert window(EXPECTED["hpcg-cube112"]["bandwidth"]) > 4096


@pytest.mark.parametrize("grid", SMALL_GRIDS)
def test_generator_matches_closed_forms(grid):
    a = _build(grid)
    forms = _gen().closed_forms(*grid)
    rows = np.repeat(np.arange(a["n"]), np.diff(a["ia"]))
    assert a["n"] == forms["n"]
    assert a["ja"].shape[0] == forms["k"]
    assert a["n"] + 2 * a["ja"].shape[0] == forms["nnz"]
    assert int((rows - a["ja"]).max()) == forms["bandwidth"]
    assert (a["ja"] < rows).all()
    # columns ascend inside each row
    same = rows[1:] == rows[:-1]
    assert (a["ja"][1:][same] > a["ja"][:-1][same]).all()


@pytest.mark.parametrize("grid", SMALL_GRIDS)
def test_stencil_is_symmetric_hpcg(grid):
    a = _build(grid)
    A = _dense(a)
    np.testing.assert_array_equal(A, A.T)
    np.testing.assert_array_equal(a["al"], a["au"])
    assert a["numerically_symmetric"]
    nx, ny, nz = grid
    for i in range(a["n"]):
        ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
        want = {jx + nx * (jy + ny * jz)
                for jz in range(iz - 1, iz + 2)
                for jy in range(iy - 1, iy + 2)
                for jx in range(ix - 1, ix + 2)
                if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz}
        got = set(np.nonzero(A[i])[0])
        assert got == want
        assert A[i, i] == 26.0
        assert all(A[i, j] == -1.0 for j in want - {i})


def test_generator_reads_the_configuration():
    """Diagonal, off-diagonal and precision come from the file; a file that
    calls the stencil numerically non-symmetric is refused."""
    a = _build((4, 5, 6), diagonal=30.0, off_diagonal=-2.0,
               precision="float64")
    assert a["ad"].dtype == a["al"].dtype == np.float64
    assert (a["ad"] == 30.0).all() and (a["al"] == -2.0).all()
    assert a["au"] is a["al"]
    with pytest.raises(ValueError):
        _build((4, 5, 6), numerically_symmetric=False)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_config_values_are_hpcgs(name):
    cfg = spec._json("configs", name + ".json")
    assert (cfg["diagonal"], cfg["off_diagonal"]) == (26.0, -1.0)
    assert cfg["numerically_symmetric"] is True
    assert (cfg["precision"], cfg["preconditioner"]) == ("float32", "jacobi")
