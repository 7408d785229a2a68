"""The process-group backend of the port's mesh on the CPU: two ranks on
gloo, one shard each, against the emulated backend (both shards in one
process) on the same dyadic data, bit for bit — every strategy (halo on a
banded matrix) for each shard-local path, at B = 1 and 3, and the serving
``MeshExecutor`` on a process-group mesh.

Each test starts its two ranks as subprocesses on a free localhost port and
gives them 120 s.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, port, path, acc = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    import dataclasses
    from repro_torch.core import csrc
    from repro_torch.core import distributed as D
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.serve import MeshExecutor

    def q(a):
        return torch.round(a * 64.0) / 64.0
    M = csrc.fem_band(512, 8, seed=1)
    M = dataclasses.replace(M, ad=q(M.ad), al=q(M.al), au=q(M.au))
    emulated = D.ShardMesh(2, "cpu")
    group = D.ShardMesh(2, "cpu", backend="process_group")
    assert group.shards == [rank]
    rng = np.random.default_rng(7)
    if path == "executor":
        plan = ExecutionPlan(path="flat", tm=32, strategy="mesh", mesh_p=2,
                             accumulation=acc, variant="stream")
        want = MeshExecutor(M, plan, mesh=emulated)
        got = MeshExecutor(M, plan, mesh=group)
    else:
        plan = ExecutionPlan(path=path, tm=32, strategy="mesh", mesh_p=2,
                             accumulation=acc)
        want = D.build_sharded_spmv(M, emulated, plan=plan)
        pg = D.build_sharded_spmv(M, group, plan=plan)

        def got(x):
            part = pg(x)
            rows = {"allreduce": M.n, "reduce_scatter": pg.n_pad // 2,
                    "halo": pg.ns}[acc]
            assert part.shape[0] == rows, (part.shape, rows)
            return pg.gather(part)
    for nrhs in (1, 3):
        shape = (M.n,) if nrhs == 1 else (M.n, nrhs)
        x = torch.from_numpy((rng.integers(-64, 64, shape) / 32.0
                              ).astype(np.float32))
        a, b = want(x), got(x)
        assert a.shape == b.shape and torch.equal(a, b), (
            path, acc, nrhs, float((a - b).abs().max()))
    dist.barrier()
    dist.destroy_process_group()
    print("OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(path: str, acc: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), port, path, acc],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"OK {r}" in out, err[-3000:]


@pytest.mark.parametrize("acc", ["allreduce", "reduce_scatter", "halo"])
@pytest.mark.parametrize("path", ["segment", "flat", "nnzsplit"])
def test_gloo_backend_equals_emulated(path, acc):
    _run_ranks(path, acc)


@pytest.mark.parametrize("acc", ["reduce_scatter", "halo"])
def test_mesh_executor_on_a_process_group(acc):
    _run_ranks("executor", acc)
