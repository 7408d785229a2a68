"""End-to-end FEM pipeline on the PyTorch/CUDA port: mesh → element
stiffness → conflict-free CSRC assembly (strategy tuned by measurement) →
measured SpMV plan → CG solve through the shared plan cache, then a
time-stepping loop that re-assembles values each step and refreshes the
operator without any structural rebuild.

  PYTHONPATH=src python examples/torch_assemble_tune_solve.py \\
      [--n 24] [--steps 4] [--device cuda]

``--device cpu`` runs the plain PyTorch versions of the kernels on the
host; the default is the card.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.assembly import (assemble, assembly_schedule_for,
                                  mesh as amesh, scatter_serial,
                                  tune_assembly)
from repro_torch.core import csrc, schedule as S, tuner
from repro_torch.core.solvers import cg_solve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24, help="grid side (cells)")
    ap.add_argument("--steps", type=int, default=4,
                    help="time steps (value refreshes)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    mesh = amesh.grid_tri(args.n)
    cache = tuner.PlanCache()

    # --- one-time structural precompute: slot maps + element coloring ---
    t0 = time.perf_counter()
    sched = assembly_schedule_for(mesh, cache=cache)
    print(f"[schedule] ne={sched.ne} n={sched.n} k={sched.k} "
          f"colors={sched.coloring.num_colors} "
          f"({(time.perf_counter()-t0)*1e3:.1f} ms)")

    # --- pick the scatter executor, assemble, check against the oracle ---
    ke = amesh.poisson_stiffness(mesh, mass=1.0)
    ares = tune_assembly(sched, ke, cache=cache, device=args.device)
    frac = ares.roofline_fraction.get(ares.key(), 0.0)
    print(f"[tune_assembly] winner={ares.key()} "
          f"roofline_fraction={frac:.2f} "
          f"({len(ares.timings_s)} candidates measured)")
    M = assemble(sched, ke, strategy=ares.strategy, variant=ares.variant,
                 device=args.device)
    oracle = scatter_serial(sched, ke)
    exact = np.array_equal(
        torch.cat([M.ad, M.al, M.au]).cpu().numpy(), oracle)
    print(f"[assemble] nnz={M.nnz} band={csrc.bandwidth(M)} "
          f"{ares.key()}==serial: {exact}")

    # --- tune, then solve through the shared cache ---
    res = tuner.tune(M, cache=cache, device=args.device)
    print(f"[tune] plan={res.plan.key()} "
          f"({len(res.timings_s)} of {len(res.predictions_s)} candidates "
          f"measured)")
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(M.n)
    b = torch.from_numpy((csrc.to_dense(M).astype(np.float64) @ x_true
                          ).astype(np.float32))
    sol, op = cg_solve(M, b, cache=cache, device=args.device, tol=1e-7,
                       maxiter=4000)
    err = float(np.abs(sol.x.cpu().numpy().astype(np.float64)
                       - x_true).max())
    print(f"[solve] converged={bool(sol.converged)} iters={int(sol.iters)} "
          f"res={float(sol.residual):.1e} err={err:.1e}")

    # --- time stepping: new values, same structure, zero rebuilds ---
    steps = []
    for step in range(1, args.steps + 1):
        before = dict(S.BUILD_COUNTS.items())
        ke_t = amesh.poisson_stiffness(mesh, mass=1.0 + 0.5 * step)
        M_t = assemble(sched, ke_t, strategy=ares.strategy,
                       variant=ares.variant, device=args.device)
        op.update_values(M_t)
        delta = {k: v - before.get(k, 0) for k, v in S.BUILD_COUNTS.items()
                 if v - before.get(k, 0)}
        sol_t, _ = cg_solve(M_t, b, plan=op.plan, cache=cache,
                            device=args.device, tol=1e-6, maxiter=4000)
        print(f"[step {step}] rebuilds={delta} iters={int(sol_t.iters)} "
              f"converged={bool(sol_t.converged)}")
        steps.append((delta, sol_t))
    return {"assembly": ares, "exact": exact, "tune": res, "solve": sol,
            "steps": steps}


if __name__ == "__main__":
    main()
