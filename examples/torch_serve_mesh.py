"""Mesh-backed serving on the PyTorch/CUDA port: two matrices served from
an 8-shard mesh emulated on one device, each tuned on that mesh, mixed
traffic coalesced per tick, and one in-place value refresh (the FEM
time-stepping shape) with no structural rebuild.

  PYTHONPATH=src python examples/torch_serve_mesh.py [--requests 12]
      [--mesh-p 8] [--device cuda]

The shards live on ``--device`` (default the card; ``cpu`` runs the plain
PyTorch versions of the kernels on the host).  Drop the mesh
(``--no-mesh``) to watch placement degrade to the local executor when the
device count cannot hold ``--mesh-p`` shards.
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import csrc, tuner
from repro_torch.core.distributed import ShardMesh
from repro_torch.serve import SpmvServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--mesh-p", type=int, default=8)
    ap.add_argument("--n", type=int, default=2048,
                    help="rows of the band matrix (the skewed one: n/2)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--no-mesh", action="store_true",
                    help="no emulated mesh: placement decides by devices")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    matrices = {
        "fem_band": csrc.fem_band(args.n, 16, seed=2),
        "skew_band": csrc.skewed_band(args.n // 2, 32, 3, seed=6),
    }
    mesh = None if args.no_mesh else ShardMesh(args.mesh_p, args.device)

    cache = tuner.PlanCache()
    tuned = {}
    if mesh is not None:
        # mesh-aware tuning: measure the distributed candidates per matrix
        # on the mesh; winners land in the cache under <fingerprint>@p<p>
        for name, M in matrices.items():
            t0 = time.perf_counter()
            res = tuner.tune_mesh(M, args.mesh_p, cache=cache, mesh=mesh,
                                  repeats=1)
            tuned[name] = res
            print(f"tuned {name} @p{args.mesh_p}: {res.plan.key()} "
                  f"({len(res.timings_s)} candidates, "
                  f"{time.perf_counter() - t0:.1f}s)")

    engine = SpmvServingEngine(cache=cache, mesh_p=args.mesh_p, mesh=mesh,
                               device=args.device)
    plans = {}
    for name, M in matrices.items():
        plans[name] = engine.register(name, M)
        print(f"registered {name}: strategy={plans[name].strategy} "
              f"mesh_p={plans[name].mesh_p} via "
              f"{engine.executor(name).kind} executor")

    # mixed traffic: interleaved requests against both matrices, answered
    # in coalesced per-matrix SpMM ticks
    expected = {}
    for i in range(args.requests):
        name = "fem_band" if i % 3 else "skew_band"
        M = matrices[name]
        x = rng.standard_normal(M.m).astype(np.float32)
        uid = engine.submit(name, x)
        expected[uid] = np.asarray(csrc.to_dense(M), np.float64) @ x
    t0 = time.perf_counter()
    out = engine.run_until_drained()
    dt = time.perf_counter() - t0
    worst = max(float(np.abs(np.asarray(r, np.float64) - expected[u]).max())
                for u, r in out.items())
    by_exec = {}
    for r in out.values():
        key = (r.matrix_id, r.executor, r.batched)
        by_exec[key] = by_exec.get(key, 0) + 1
    print(f"served {len(out)} requests in {dt:.2f}s "
          f"(max abs err {worst:.2e})")
    for (mid, ex, batched), cnt in sorted(by_exec.items()):
        print(f"  {mid}: {cnt} results via {ex} executor, "
              f"coalesced {batched}/tick")

    # value refresh: same structure, new values — no re-pack or partition
    M = matrices["fem_band"]
    M2 = dataclasses.replace(M, ad=M.ad * 1.5, al=M.al * 1.5,
                             au=M.au * 1.5)
    engine.update_values("fem_band", M2)
    x = rng.standard_normal(M2.m).astype(np.float32)
    uid = engine.submit("fem_band", x)
    y = engine.step()[uid]
    err = float(np.abs(np.asarray(y, np.float64)
                       - np.asarray(csrc.to_dense(M2), np.float64) @ x
                       ).max())
    print(f"value refresh on {y.executor} executor: max abs err {err:.2e}")
    return {"tuned": tuned, "plans": plans, "results": out,
            "max_err": worst, "refresh_err": err,
            "refresh_executor": y.executor}


if __name__ == "__main__":
    main()
