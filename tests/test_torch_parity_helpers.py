"""Shared helpers of the ``tests/test_torch_*.py`` parity suite (no tests).

The suite feeds the same inputs, made from a numpy seed, through a function
of the JAX package (``repro``, Pallas kernels in interpret mode) and through
its counterpart in the PyTorch port (``repro_torch``, ``device="cpu"``), and
compares.  Objects cross between the packages as numpy arrays only
(``repro_torch.convert``).
"""
import dataclasses

import numpy as np

from repro.core import csrc as jcsrc
from repro_torch import convert

CSRC_ARRAYS = ("ad", "ia", "ja", "al", "au", "iar", "jar", "ar")
PACK_ARRAYS = ("vals_l", "vals_u", "col_local", "row_in_win", "ad")


def np32(a):
    """A JAX or torch array as numpy; bfloat16 widened to float32."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        if str(a.dtype) == "torch.bfloat16":
            a = a.float()
        return a.numpy()
    if str(a.dtype) == "bfloat16":
        return np.asarray(a, dtype=np.float32)
    return np.asarray(a)


def to_torch_csrc(Mj):
    """The port's CSRC for a JAX-package matrix, via numpy arrays."""
    return convert.csrc_from_arrays(
        n=Mj.n, m=Mj.m,
        numerically_symmetric=bool(Mj.numerically_symmetric),
        **{f: np.asarray(getattr(Mj, f)) for f in CSRC_ARRAYS})


def to_torch_pack(pj):
    """The port's BlockEll for a JAX-package pack, via numpy arrays."""
    return convert.blockell_from_arrays(
        n=pj.n, tm=pj.tm, nt=pj.nt, w_pad=pj.w_pad, s=pj.s,
        num_symmetric=pj.num_symmetric, pad_ratio=pj.pad_ratio,
        value_dtype=str(pj.vals_l.dtype),
        **{f: np32(getattr(pj, f)) for f in PACK_ARRAYS})


def assert_csrc_equal(Mj, Mt):
    assert (Mj.n, Mj.m) == (Mt.n, Mt.m)
    assert bool(Mj.numerically_symmetric) == bool(Mt.numerically_symmetric)
    for f in CSRC_ARRAYS:
        a, b = np.asarray(getattr(Mj, f)), np32(getattr(Mt, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_pack_equal(pj, pt):
    for f in ("n", "tm", "nt", "w_pad", "s", "num_symmetric", "pad_ratio"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in PACK_ARRAYS:
        a, b = getattr(pj, f), getattr(pt, f)
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), f
        np.testing.assert_array_equal(np32(a), np32(b), err_msg=f)


def dyadic(Mj):
    """Quantize values to multiples of 1/64: float32 sums become exact in
    any order, so kernels can be compared with ``assert_array_equal``."""
    def q(a):
        return np.round(np.asarray(a) * 64.0) / 64.0
    return dataclasses.replace(Mj, ad=q(Mj.ad), al=q(Mj.al), au=q(Mj.au),
                               ar=q(Mj.ar))


def dyadic_x(m, nrhs, seed=0):
    r = np.random.default_rng(seed)
    shape = (m,) if nrhs == 1 else (m, nrhs)
    return (np.round(r.uniform(-1.0, 1.0, shape) * 8.0) / 8.0
            ).astype(np.float32)


def empty_rows(n):
    i = np.arange(0, n, 2)
    return jcsrc.from_coo(i, i, np.ones(i.size), n=n)


# name -> JAX-package matrix factory; small enough for interpret mode
MATRICES = {
    "fem_band": lambda: jcsrc.fem_band(200, 12, seed=5),
    "fem_band_sym": lambda: jcsrc.fem_band(200, 12, seed=5,
                                           numeric_symmetric=True),
    "tail_tile": lambda: jcsrc.fem_band(130, 5, seed=3),    # n % tm != 0
    "empty_rows": lambda: empty_rows(64),
    "poisson2d": lambda: jcsrc.poisson2d(12),
}
