"""Quickstart on the PyTorch/CUDA port: the CSRC sparse engine in seven
steps.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]

``--device cpu`` runs the plain PyTorch versions of the kernels on the
host; the default is the card.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import csrc, solvers, tuner
from repro_torch.core.coloring import color_rows
from repro_torch.device import resolve
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=32,
                    help="grid side of the 2-D Laplacian")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # 1. Build a structurally-symmetric sparse matrix (CSRC format: only
    #    the lower triangle's indices are stored — half the index memory of
    #    CSR).
    M = csrc.poisson2d(args.side)
    print(f"n={M.n} nnz={M.nnz} lower-slots k={M.k} "
          f"numerically_symmetric={M.numerically_symmetric}")
    print(f"working set: {M.working_set_bytes() / 1024:.0f} KiB")

    # 2. One product — auto path selection (the block-ELL CUDA kernels for
    #    banded matrices, index_add_ segment sums otherwise).
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(M.n)
                         .astype(np.float32)).to(dev)
    op = ops.SpmvOperator(M, path="auto", device=dev)
    y = op(x)
    print(f"path={op.path}  y[:4]={y[:4].cpu().numpy().round(3)}")

    # 3. The transpose product is O(1) to set up (swap al/au — paper §5).
    yt = ops.spmv_transpose(M, x, device=dev)
    symmetric = bool(torch.allclose(y, yt))
    print(f"A symmetric => Ax == A^T x: {symmetric}")

    # 4. The colorful method (paper §3.2): conflict-free row groups.
    col = color_rows(M)
    print(f"coloring: {col.num_colors} colors for bandwidth "
          f"{csrc.bandwidth(M)}")

    # 5. Solve Ax = b with preconditioned CG — every iteration runs the
    #    kernel.
    b = op(torch.ones(M.n, device=dev))
    res = solvers.cg(op, b, tol=1e-6, maxiter=2000, diag=M.ad.to(dev))
    print(f"CG: converged={bool(res.converged)} iters={int(res.iters)} "
          f"residual={float(res.residual):.2e}")

    # 6. Multi-RHS (batched serving path).
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (M.n, 8)).astype(np.float32)).to(dev)
    Y = ops.spmm(M, X, device=dev)
    print("SpMM out:", tuple(Y.shape))

    # 7. Autotune: rank every feasible ExecutionPlan by card pricing,
    #    measure the cheapest, cache the argmin by matrix fingerprint.
    cache = tuner.PlanCache()
    result = tuner.tune(M, cache=cache, device=dev)
    print(f"tuned plan: {result.plan.key()}  "
          f"({len(result.timings_s)} candidates measured)")
    res2, op2 = solvers.cg_solve(M, b, cache=cache, maxiter=2000,
                                 device=dev)
    print(f"cg_solve via cached plan: converged={bool(res2.converged)} "
          f"plan={op2.plan.key()} cache_hits={cache.hits}")
    return {"M": M, "path": op.path, "y": y, "symmetric": symmetric,
            "colors": col.num_colors, "cg": res, "spmm_shape": tuple(Y.shape),
            "tune": result, "cg_cached": res2, "cache_hits": cache.hits}


if __name__ == "__main__":
    main()
