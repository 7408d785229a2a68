"""Iterative solvers on top of the CSRC SpMV engine.

The paper motivates SpMV as the dominant kernel of FEM iterative solvers
("a thousand products ... a reasonable value for iterative solvers like the
preconditioned conjugate gradient method and the generalized minimum
residual method").  Two solver families:

  * cg        — preconditioned conjugate gradient (numerically symmetric
                positive-definite matrices; Jacobi preconditioner);
  * bicgstab  — for structurally-symmetric but numerically non-symmetric
                matrices.

Both accept any ``spmv`` callable on tensors and run where ``b`` lives.
The iteration is a Python loop; the stopping test reads the relative
residual on the host every iteration, which is one device-to-host sync per
iteration (a known cost, left to a later change: check every few
iterations, or capture the loop body in a CUDA graph).

Multi-RHS: ``b`` may be (n,) or (n, r).  With a block of right-hand sides
the iterations run per column (independent alpha/beta per RHS) but share
one batched SpMM per step — the memory-bound matrix pass is amortized
across the block exactly as in block-Krylov methods.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float               # max over RHS columns for block solves
    converged: bool


def _dot(a, b):
    """Per-column vdot: () for (n,) operands, (r,) for (n, r)."""
    return torch.sum(a * b, dim=0)


def _norm(v):
    return torch.sqrt(_dot(v, v))


def cg(spmv: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-6, maxiter: int = 1000,
       diag: Optional[torch.Tensor] = None) -> SolveResult:
    """Jacobi-preconditioned CG.  ``diag`` enables the preconditioner.
    ``b`` of shape (n, r) solves all r systems with one SpMM per step."""
    x = torch.zeros_like(b) if x0 is None else x0
    inv_d = None
    if diag is not None:
        diag = diag.to(b.device)
        inv_d = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))
        if b.ndim == 2:
            inv_d = inv_d[:, None]

    def prec(r):
        return r if inv_d is None else inv_d * r

    r = b - spmv(x)
    z = prec(r)
    p = z
    rz = _dot(r, z)
    bnorm = torch.clamp(_norm(b), min=1e-30)

    def res_of(r):
        return float(torch.max(_norm(r) / bnorm))

    k = 0
    res = res_of(r)
    while res > tol and k < maxiter:
        ap = spmv(p)
        alpha = rz / torch.clamp(_dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
        res = res_of(r)
    return SolveResult(x=x, iters=k, residual=res, converged=res <= tol)


def bicgstab(spmv: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-6,
             maxiter: int = 1000) -> SolveResult:
    """BiCGSTAB for non-symmetric systems; per-column scalars on (n, r)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - spmv(x)
    rh = r
    bnorm = torch.clamp(_norm(b), min=1e-30)
    ones = torch.ones(b.shape[1:2], dtype=b.dtype, device=b.device)
    rho, alpha, omega = ones, ones, ones
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)

    def safe_div(a, d):
        # sign-preserving guard: BiCGSTAB denominators may be negative
        tiny = torch.where(d < 0, torch.full_like(d, -1e-30),
                           torch.full_like(d, 1e-30))
        return a / torch.where(torch.abs(d) < 1e-30, tiny, d)

    k = 0
    res = float(torch.max(_norm(r) / bnorm))
    while res > tol and k < maxiter:
        rho_new = _dot(rh, r)
        beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        v = spmv(p)
        alpha = safe_div(rho_new, _dot(rh, v))
        s_vec = r - alpha * v
        t = spmv(s_vec)
        omega = safe_div(_dot(t, s_vec), _dot(t, t))
        x = x + alpha * p + omega * s_vec
        r = s_vec - omega * t
        rho = rho_new
        k += 1
        res = float(torch.max(_norm(r) / bnorm))
    return SolveResult(x=x, iters=k, residual=res, converged=res <= tol)


def cg_solve(M, b: torch.Tensor, *, plan=None, cache=None,
             autotune: bool = False, device=None,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-6,
             maxiter: int = 1000,
             precondition: bool = True) -> Tuple[SolveResult, object]:
    """Matrix-level CG: builds the SpMV operator through the plan/tuner
    subsystem instead of a hard-coded path.

    Resolution order: an explicit ``plan`` wins; else the plan cache /
    heuristic (a cache hit skips everything, including the schedule
    artifact — no re-pack).  ``b`` of shape (n, r) runs block CG through
    one batched SpMM per iteration.  ``b`` and ``x0`` are moved to
    ``device`` (default: the card).  Returns ``(SolveResult, operator)`` —
    the operator exposes the concrete plan it ran as ``op.plan`` and the
    artifact as ``op.schedule``.
    """
    from repro_torch.core import tuner as _tuner
    from repro_torch.kernels.ops import SpmvOperator

    if plan is None:
        plan = _tuner.plan_for(M, cache=cache, autotune=autotune)
    op = SpmvOperator.from_plan(M, plan, device=device, cache=cache)
    b = b.to(op.device)
    res = cg(op, b, x0=None if x0 is None else x0.to(op.device), tol=tol,
             maxiter=maxiter, diag=M.ad if precondition else None)
    return res, op
