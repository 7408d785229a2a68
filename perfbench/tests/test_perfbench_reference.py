"""The plain reference against dense products and a dense PCG."""
import numpy as np
import pytest
import torch

from perfbench.harness import spec
from perfbench.reference import csrc_ref


def _arrays(grid=(5, 4, 6)):
    cfg = spec._json("configs", "hpcg-pencil56.json")
    return spec.generator("hpcg27").build(dict(cfg, grid=list(grid)))


def _dense(a):
    n = a["n"]
    A = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(a["ia"]))
    A[rows, a["ja"]] = a["al"]
    A[a["ja"], rows] = a["au"]
    A[np.arange(n), np.arange(n)] = a["ad"]
    return A


@pytest.mark.parametrize("shape", [(), (3,), (8,)])
def test_product_against_dense(shape):
    a = _arrays()
    A = _dense(a)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((a["n"],) + shape, generator=g, dtype=torch.float64)
    ref = csrc_ref.Csrc64(a, "cpu")
    np.testing.assert_allclose(ref.apply(x).numpy(), A @ x.numpy(),
                               rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(ref.abs_apply(x).numpy(),
                               np.abs(A) @ np.abs(x.numpy()), rtol=1e-13)


def test_product_in_blocks(monkeypatch):
    """Slot blocks smaller than k give the same product."""
    a = _arrays()
    x = torch.randn(a["n"], 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    whole = csrc_ref.Csrc64(a, "cpu").apply(x)
    monkeypatch.setattr(csrc_ref, "SLOT_BLOCK", 7)
    np.testing.assert_allclose(csrc_ref.Csrc64(a, "cpu").apply(x).numpy(),
                               whole.numpy(), rtol=1e-14, atol=1e-13)


@pytest.mark.parametrize("nrhs", [1, 4])
def test_pcg_against_dense(nrhs):
    a = _arrays()
    A = _dense(a)
    b = torch.randn((a["n"], nrhs) if nrhs > 1 else (a["n"],),
                    dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    iters = 7
    x = csrc_ref.pcg(csrc_ref.Csrc64(a, "cpu"), b, iters).numpy()
    B = b.numpy().reshape(a["n"], -1)
    d = np.diag(A)
    for c in range(B.shape[1]):
        xc = np.zeros(a["n"])
        r = B[:, c].copy()
        z = r / d
        p = z.copy()
        rz = r @ z
        for _ in range(iters):
            ap = A @ p
            alpha = rz / (p @ ap)
            xc += alpha * p
            r -= alpha * ap
            z = r / d
            rz_new = r @ z
            p = z + rz_new / rz * p
            rz = rz_new
        np.testing.assert_allclose(x.reshape(a["n"], -1)[:, c], xc,
                                   rtol=1e-10, atol=1e-12)


def test_control_is_one_precision_down():
    """The control's product is off by bfloat16 rounding of x: far more
    than float32 rounding, far less than a wrong product."""
    a = _arrays((8, 8, 8))
    x = torch.randn(a["n"], dtype=torch.float32,
                    generator=torch.Generator().manual_seed(4))
    exact = csrc_ref.Csrc64(a, "cpu")
    low = csrc_ref.LowPrecision(a, "cpu")(x)
    assert low.dtype == torch.float32
    err = ((low.double() - exact.apply(x)).abs()
           / exact.abs_apply(x)).max().item()
    assert 1e-4 < err < 1e-2



def _skewed(grid=(5, 4, 6)):
    """HPCG's pattern with al and au apart, so that a transpose put in the
    wrong place shows."""
    a = dict(_arrays(grid))
    g = np.random.default_rng(4)
    a["al"] = g.standard_normal(a["al"].shape).astype(np.float32)
    a["au"] = g.standard_normal(a["au"].shape).astype(np.float32)
    return a


@pytest.mark.parametrize("make", [_arrays, _skewed])
@pytest.mark.parametrize("shape", [(), (3,)])
def test_csr_against_dense(make, shape):
    """The solves' CSR form is the same matrix: every lower slot, its
    transpose and the diagonal."""
    a = make()
    A = _dense(a)
    x = torch.randn((a["n"],) + shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    csr = csrc_ref.Csrc64(a, "cpu").csr()
    np.testing.assert_allclose(csr.apply(x).numpy(), A @ x.numpy(),
                               rtol=1e-13, atol=1e-12)
    np.testing.assert_array_equal(csr.matrix.to_dense().numpy(), A)


@pytest.mark.parametrize("nrhs", [1, 4])
def test_pcg_through_csr_as_through_csrc(nrhs):
    """The comparison's solve through the CSR form reads as through the
    two index_add_ products."""
    a = _arrays()
    ref = csrc_ref.Csrc64(a, "cpu")
    b = torch.randn((a["n"], nrhs) if nrhs > 1 else (a["n"],),
                    dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(csrc_ref.pcg(ref.csr(), b, 9).numpy(),
                               csrc_ref.pcg(ref, b, 9).numpy(),
                               rtol=1e-12, atol=1e-13)
