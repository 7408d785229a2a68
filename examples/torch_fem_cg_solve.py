"""End-to-end run on the PyTorch/CUDA port (the paper's own workload):
assemble an FEM-style system, then run ~1000 CSRC matrix-vector products
inside preconditioned CG / BiCGSTAB — "a reasonable value for iterative
solvers" (paper §4).

Compares the engine's ``segment`` and ``kernel`` paths and reports the
per-product cost + the paper's bandwidth accounting.

  PYTHONPATH=src python examples/torch_fem_cg_solve.py [--n 96] \\
      [--products 1000] [--device cuda]

``--device cpu`` runs the plain PyTorch versions of the kernels on the
host; the default is the card, where a product is timed with CUDA events.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import csrc, solvers
from repro_torch.device import resolve
from repro_torch.kernels import ops


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96,
                    help="grid side (n^2 unknowns)")
    ap.add_argument("--products", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # --- assembly (5-point Laplacian = the canonical FEM band matrix) ---
    M = csrc.poisson2d(args.n)
    print(f"[assemble] n={M.n} nnz={M.nnz} band={csrc.bandwidth(M)} "
          f"ws={M.working_set_bytes()/1024:.0f}KiB")

    rng = np.random.default_rng(0)
    x_true = torch.from_numpy(rng.standard_normal(M.n).astype(np.float32)
                              ).to(dev)

    # --- the paper's benchmark loop: the products on both engine paths ---
    x = torch.from_numpy(rng.standard_normal(M.n).astype(np.float32)
                         ).to(dev)
    per_product = {}
    for path in ("segment", "kernel"):
        op = ops.SpmvOperator(M, path=path, tm=64, device=dev)
        y = op(x)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.products):
            y = op(x)
        _sync(dev)
        dt = (time.perf_counter() - t0) / args.products
        per_product[path] = dt
        mflops = op.flops_per_call / dt / 1e6
        print(f"[spmv:{path:8s}] {dt*1e6:8.1f} us/product "
              f"{mflops:8.0f} Mflop/s  "
              f"bytes/call={op.bytes_per_call/1024:.0f}KiB")

    # --- PCG solve using the engine ---
    op = ops.SpmvOperator(M, path="segment", device=dev)
    b = op(x_true)
    t0 = time.perf_counter()
    res = solvers.cg(op, b, tol=1e-7, maxiter=4000, diag=M.ad.to(dev))
    _sync(dev)
    dt = time.perf_counter() - t0
    err = float((res.x - x_true).abs().max())
    print(f"[cg] converged={bool(res.converged)} iters={int(res.iters)} "
          f"res={float(res.residual):.1e} err={err:.1e} ({dt:.2f}s)")

    # --- non-symmetric variant via BiCGSTAB ---
    Mn = csrc.fem_band(M.n, 8, seed=3)
    opn = ops.SpmvOperator(Mn, path="segment", device=dev)
    bn = opn(x_true)
    resn = solvers.bicgstab(opn, bn, tol=1e-6, maxiter=4000)
    print(f"[bicgstab] converged={bool(resn.converged)} "
          f"iters={int(resn.iters)} res={float(resn.residual):.1e}")

    # --- the paper's load/flop accounting ---
    flops = 2 * M.nnz - M.n
    loads = {"csr": 3 * M.nnz / flops,
             "csrc": (2.5 * M.nnz - 0.5 * M.n) / flops,
             "csrc_sym": 2 * M.nnz / flops}
    print(f"[paper-math] CSR loads/flop = {loads['csr']:.2f}  "
          f"CSRC = {loads['csrc']:.2f}  "
          f"CSRC(sym) = {loads['csrc_sym']:.2f}")
    return {"M": M, "per_product_s": per_product, "cg": res, "cg_err": err,
            "bicgstab": resn, "loads_per_flop": loads}


if __name__ == "__main__":
    main()
