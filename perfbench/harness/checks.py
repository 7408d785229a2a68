"""How ``correct`` is decided: the timed path's answers against the plain
reference, after the window.

Two numbers are compared, each with the limit in ``limits/<cell>.json``:

  product_err  over the products the wrapper kept (drawn from the seed):
               the largest |y - A·p| of a row, over that row's |A|·|p|,
               with A·p and |A|·|p| from the float64 reference.  It covers
               the operator's whole product: path, kernels and
               accumulation.
  x_err        over the sets kept (drawn from the seed): the largest
               ||x - x_ref|| / ||x_ref|| of a column, x_ref from the
               reference's own float64 Jacobi-PCG on the same right-hand
               sides and the same number of iterations (through the
               reference's CSR form, ``Csrc64.csr``).

Every cell's limits file holds both numbers; one that lacks either is
refused (``KeyError``), so no cell is judged on one number alone.

A non-finite answer reads as infinity, so it fails any limit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.reference import csrc_ref

NAMES = ("product_err", "x_err")


def _finite_max(t: torch.Tensor) -> float:
    v = float(t.max())
    return v if math.isfinite(v) else math.inf


def product_err(ref: csrc_ref.Csrc64, p: torch.Tensor,
                y: torch.Tensor) -> float:
    exact = ref.apply(p)
    scale = ref.abs_apply(p).clamp_min(1e-300)
    if not bool(torch.isfinite(y).all()):
        return math.inf
    return _finite_max((y.to(torch.float64) - exact).abs() / scale)


def x_err(ref: csrc_ref.Csrc64, b: torch.Tensor, x: torch.Tensor,
          iters: int) -> float:
    if not bool(torch.isfinite(x).all()):
        return math.inf
    x_ref = csrc_ref.pcg(ref.csr(), b, iters)
    diff = torch.linalg.vector_norm(x.to(torch.float64) - x_ref, dim=0)
    norm = torch.linalg.vector_norm(x_ref, dim=0).clamp_min(1e-300)
    return _finite_max(diff / norm)


def compare(ref: csrc_ref.Csrc64,
            products: List[Tuple[torch.Tensor, torch.Tensor]],
            sets: List[Tuple[torch.Tensor, torch.Tensor, int]],
            limits: Dict) -> Tuple[Dict[str, Dict[str, float]], int]:
    """The largest reading of each number beside its limit (and under
    ``each`` every reading), and how many answers failed.  ``products``
    holds (p, y) pairs, ``sets`` (b, x, iterations)."""
    readings: Dict[str, List[float]] = {name: [] for name in NAMES}
    for p, y in products:
        readings["product_err"].append(product_err(ref, p, y))
    for b, x, iters in sets:
        readings["x_err"].append(x_err(ref, b, x, iters))
    out: Dict[str, Dict[str, float]] = {}
    failed = 0
    for name in NAMES:
        limit = float(limits[name]["limit"])
        vals = readings[name]
        failed += sum(1 for v in vals if not v <= limit)
        out[name] = {"value": max(vals) if vals else math.inf,
                     "limit": limit, "each": vals}
    return out, failed
