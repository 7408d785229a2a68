"""The plain reference: y = A·X and Jacobi-PCG, from the benchmark's own
CSRC arrays, in plain PyTorch.

Nothing here comes from the program: the arrays are the generator's
(``perfbench/generators``).  A product the comparison judges is two
``index_add_`` over the strict lower triangle plus the diagonal, in
float64, in blocks of slots so that the gathered terms fit beside the
answers.  The reference's own solves apply the same matrix many
times, so they go through ``Csr64``: the lower slots, their transposes and
the diagonal sorted into one float64 CSR tensor, applied by PyTorch's
sparse product.

``Csrc64`` is what the program is judged against.  ``LowPrecision`` is the
comparison's control: the same product with the values and the operand
rounded to bfloat16 (accumulated in float32), put in the program's place to
show that a product one precision below the configuration's float32 fails
the comparison.
"""
from __future__ import annotations

import warnings
from typing import Dict

import torch

SLOT_BLOCK = 1 << 22              # slots gathered at once


class Csrc64:
    """A structurally symmetric matrix from its CSRC arrays, applied in
    float64 on ``device``."""

    dtype = torch.float64

    def __init__(self, arrays: Dict[str, object], device):
        dev = torch.device(device)
        n = int(arrays["n"])
        ia = torch.as_tensor(arrays["ia"]).to(dev, torch.int64)
        self.n = n
        self.row = torch.repeat_interleave(
            torch.arange(n, device=dev), ia[1:] - ia[:-1])
        self.col = torch.as_tensor(arrays["ja"]).to(dev, torch.int64)
        self.ad = self._values(arrays["ad"], dev)
        self.al = self._values(arrays["al"], dev)
        self.au = self._values(arrays["au"], dev)
        self._csr = None

    def csr(self) -> "Csr64":
        """The same matrix as one CSR tensor, built at the first call."""
        if self._csr is None:
            self._csr = Csr64(self)
        return self._csr

    def _values(self, a, dev):
        return torch.as_tensor(a).to(dev, self.dtype)

    def _operand(self, x):
        return x.to(self.dtype)

    def _out(self, y):
        return y

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x for x of shape (n,) or (n, B)."""
        return self._out(self._product(self._operand(x), self.ad, self.al,
                                       self.au))

    def abs_apply(self, x: torch.Tensor) -> torch.Tensor:
        """|A|·|x|: the scale each row's rounding error is measured by."""
        return self._product(self._operand(x).abs(), self.ad.abs(),
                             self.al.abs(), self.au.abs())

    def _product(self, x, ad, al, au):
        shape = (-1,) + (1,) * (x.ndim - 1)
        y = ad.reshape(shape) * x
        for s in range(0, self.col.shape[0], SLOT_BLOCK):
            e = s + SLOT_BLOCK
            row, col = self.row[s:e], self.col[s:e]
            y.index_add_(0, row, al[s:e].reshape(shape) * x[col])
            y.index_add_(0, col, au[s:e].reshape(shape) * x[row])
        return y


class LowPrecision(Csrc64):
    """The control: values and operand rounded to bfloat16, products and
    sums in float32, answer in float32 (the solver's precision)."""

    dtype = torch.float32

    def _values(self, a, dev):
        return torch.as_tensor(a).to(dev, torch.bfloat16).to(self.dtype)

    def _operand(self, x):
        return x.to(torch.bfloat16).to(self.dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x).to(x.dtype)


class Csr64:
    """The matrix of a ``Csrc64`` as one float64 CSR tensor on its device:
    every lower slot (row, col, al), its transpose (col, row, au) and the
    diagonal, sorted by row and column."""

    def __init__(self, A: Csrc64):
        n = A.n
        diag = torch.arange(n, device=A.ad.device)
        rows = torch.cat([A.row, A.col, diag])
        cols = torch.cat([A.col, A.row, diag])
        vals = torch.cat([A.al, A.au, A.ad])
        order = torch.argsort(rows * n + cols)
        crow = torch.zeros(n + 1, dtype=torch.int64, device=diag.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # "beta state"
            self.matrix = torch.sparse_csr_tensor(
                crow, cols[order], vals[order], (n, n))
        self.ad = A.ad

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x in float64 for x of shape (n,) or (n, B)."""
        x = x.to(torch.float64)
        if x.ndim == 1:
            return (self.matrix @ x[:, None])[:, 0]
        return self.matrix @ x


def pcg(A, b: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` steps of Jacobi-preconditioned CG from x0 = 0, each column
    of a block with its own step lengths, in float64; ``A`` a ``Csrc64``
    or a ``Csr64``."""
    b = b.to(torch.float64)
    inv_d = 1.0 / A.ad
    if b.ndim == 2:
        inv_d = inv_d[:, None]
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_d * r
    p = z.clone()
    rz = (r * z).sum(dim=0)
    for _ in range(iters):
        ap = A.apply(p)
        alpha = rz / (p * ap).sum(dim=0)
        x += alpha * p
        r -= alpha * ap
        z = inv_d * r
        rz_new = (r * z).sum(dim=0)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x
