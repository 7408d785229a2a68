"""CSRC container, generators and the segment-path oracles of the port held
against the JAX package: every field array for array, every product on the
same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import csrc as jcsrc
from repro.kernels import ref as jref
from repro_torch.core import csrc as tcsrc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_parity_helpers import (assert_csrc_equal, dyadic, dyadic_x,
                                       np32, to_torch_csrc)

GENERATORS = {
    "poisson2d": ("poisson2d", (7, 5), {}),
    "fem_band": ("fem_band", (120, 9), {"seed": 3}),
    "fem_band_sym": ("fem_band", (120, 9),
                     {"seed": 4, "numeric_symmetric": True}),
    "skewed_band": ("skewed_band", (150, 20), {"seed": 2}),
    "random_symmetric_pattern": ("random_symmetric_pattern", (90, 6),
                                 {"seed": 1}),
    "powerlaw_laplacian": ("powerlaw_laplacian", (96,), {"seed": 7}),
    "paper_example": ("paper_example", (), {}),
    "dense_matrix": ("dense_matrix", (24,), {"seed": 5}),
    "rectangular_fem": ("rectangular_fem", (60, 11, 5), {"seed": 6}),
}


def _both(name):
    fn, args, kw = GENERATORS[name]
    return getattr(jcsrc, fn)(*args, **kw), getattr(tcsrc, fn)(*args, **kw)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_fields_equal(name):
    Mj, Mt = _both(name)
    assert_csrc_equal(Mj, Mt)
    assert (Mj.k, Mj.nnz, Mj.is_square) == (Mt.k, Mt.nnz, Mt.is_square)
    assert Mj.working_set_bytes() == Mt.working_set_bytes()


@pytest.mark.parametrize("name", list(GENERATORS))
def test_host_helpers_equal(name):
    Mj, Mt = _both(name)
    np.testing.assert_array_equal(jcsrc.to_dense(Mj), tcsrc.to_dense(Mt))
    np.testing.assert_array_equal(jcsrc.row_of_slot(Mj),
                                  tcsrc.row_of_slot(Mt))
    np.testing.assert_array_equal(jcsrc.nnz_per_row(Mj),
                                  tcsrc.nnz_per_row(Mt))
    assert jcsrc.bandwidth(Mj) == tcsrc.bandwidth(Mt)


def test_constructors_equal():
    rng = np.random.default_rng(0)
    n, m = 40, 47
    rows = rng.integers(0, n, 300)
    cols = rng.integers(0, m, 300)
    vals = rng.standard_normal(300)
    assert_csrc_equal(jcsrc.from_coo(rows, cols, vals, n=n, m=m),
                      tcsrc.from_coo(rows, cols, vals, n=n, m=m))
    A = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.2)
    assert_csrc_equal(jcsrc.from_dense(A), tcsrc.from_dense(A))
    import scipy.sparse as sp
    S = sp.csr_matrix(A)
    assert_csrc_equal(jcsrc.from_scipy(S), tcsrc.CSRC.from_scipy(S))
    sq = cols < n
    r = np.concatenate([rows[sq], cols[sq]])
    c = np.concatenate([cols[sq], rows[sq]])
    v = np.concatenate([vals[sq], vals[sq] * 2])
    assert_csrc_equal(jcsrc.from_coo_symmetric(r, c, v, n=n),
                      tcsrc.from_coo_symmetric(r, c, v, n=n))
    Mj = jcsrc.fem_band(50, 4, seed=9)
    parts = [np.asarray(getattr(Mj, f)) for f in ("ia", "ja", "ad", "al",
                                                   "au")]
    assert_csrc_equal(jcsrc.from_assembly(50, *parts),
                      tcsrc.from_assembly(50, *parts))


def test_transpose_swaps_streams():
    Mj, Mt = _both("fem_band")
    assert_csrc_equal(jcsrc.transpose(Mj), tcsrc.transpose(Mt))


def test_convert_from_arrays_matches_native_construction():
    Mj, Mt = _both("rectangular_fem")
    assert_csrc_equal(Mj, to_torch_csrc(Mj))
    for f in ("ad", "ja", "ar"):
        assert torch.equal(getattr(Mt, f), getattr(to_torch_csrc(Mj), f))


def test_to_keeps_or_moves():
    _, Mt = _both("fem_band")
    assert Mt.to("cpu") is Mt
    assert Mt.device == torch.device("cpu")


ORACLE_MATRICES = ["poisson2d", "fem_band", "fem_band_sym", "skewed_band",
                   "powerlaw_laplacian", "rectangular_fem"]


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", ORACLE_MATRICES)
def test_segment_oracle_bit_identical_on_dyadic(name, nrhs):
    """``index_add_`` on float32 against ``segment_sum``: exact on dyadic
    values, whatever order either sums in."""
    Mj = dyadic(_both(name)[0])
    Mt = to_torch_csrc(Mj)
    x = dyadic_x(Mj.m, nrhs, seed=nrhs)
    if nrhs == 1:
        yj = jref.csrc_spmv(Mj, jnp.asarray(x))
        yt = tref.csrc_spmv(Mt, torch.from_numpy(x))
    else:
        yj = jref.csrc_spmm(Mj, jnp.asarray(x))
        yt = tref.csrc_spmm(Mt, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ x.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("name", ["fem_band", "powerlaw_laplacian"])
def test_segment_oracle_general_values(name):
    """General values: the two packages sum in different orders, so agree
    to float32 rounding of the row sums (rtol 1e-5, atol 1e-5)."""
    Mj, Mt = _both(name)
    x = np.random.default_rng(1).standard_normal(Mj.m).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jref.csrc_spmv(Mj, jnp.asarray(x))),
        tref.csrc_spmv(Mt, torch.from_numpy(x)).numpy(),
        rtol=1e-5, atol=1e-5)


def test_transpose_product_and_numeric_symmetry_switch():
    Mj = dyadic(_both("fem_band")[0])
    Mt = to_torch_csrc(Mj)
    x = dyadic_x(Mj.n, 1, seed=4)
    np.testing.assert_array_equal(
        np.asarray(jref.csrc_spmv_transpose(Mj, jnp.asarray(x))),
        tref.csrc_spmv_transpose(Mt, torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(
        tops.spmv_transpose(Mt, torch.from_numpy(x), device="cpu").numpy(),
        (jcsrc.to_dense(Mj).T.astype(np.float64) @ x).astype(np.float32))
    Ms = to_torch_csrc(dyadic(_both("fem_band_sym")[0]))
    np.testing.assert_array_equal(
        tref.csrc_spmv(Ms, torch.from_numpy(x[:Ms.n]),
                       use_numeric_symmetry=False).numpy(),
        tref.csrc_spmv(Ms, torch.from_numpy(x[:Ms.n])).numpy())


def test_csr_baseline_equal():
    Mj, Mt = _both("rectangular_fem")
    for a, b in zip(jref.csr_from_csrc(Mj), tref.csr_from_csrc(Mt)):
        np.testing.assert_array_equal(a, b)
    rows, cols, vals = tref.csr_from_csrc(Mt)
    x = dyadic_x(Mt.m, 1)
    y = tref.csr_spmv_arrays(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(vals), torch.from_numpy(x),
                             Mt.n)
    np.testing.assert_allclose(y.numpy(), tcsrc.to_dense(Mt) @ x,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np32(tops.spmm(Mt, torch.from_numpy(dyadic_x(Mt.m, 2)),
                       device="cpu")).shape,
        (Mt.n, 2))
