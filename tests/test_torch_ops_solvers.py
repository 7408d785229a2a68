"""``SpmvOperator``, the one-shot wrappers and the solvers of the port held
against the JAX package on the same numpy inputs (``device="cpu"``)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import csrc as jcsrc
from repro.core import plan as jplan
from repro.core import solvers as jsolvers
from repro.kernels import ops as jops
from repro_torch import device as tdevice
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import ops as tops

from test_torch_parity_helpers import (MATRICES, dyadic, dyadic_x,
                                       to_torch_csrc)


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name", ["fem_band", "fem_band_sym", "tail_tile"])
def test_operator_from_plan_bit_identical(name, variant, nrhs):
    Mj = dyadic(MATRICES[name]())
    Mt = to_torch_csrc(Mj)
    kw = dict(path="kernel", tm=32, k_step_sublanes=2, variant=variant)
    opj = jops.SpmvOperator.from_plan(Mj, jplan.ExecutionPlan(**kw))
    opt = tops.SpmvOperator.from_plan(Mt, tplan.ExecutionPlan(**kw),
                                      device="cpu")
    x = dyadic_x(Mj.n, nrhs, seed=nrhs)
    np.testing.assert_array_equal(np.asarray(opj(jnp.asarray(x))),
                                  opt(torch.from_numpy(x)).numpy())
    assert opt.plan.key() == opj.plan.key()
    assert opt.schedule.key() == opj.schedule.key()
    assert (opt.flops_per_call, opt.bytes_per_call) == (
        opj.flops_per_call, opj.bytes_per_call)


def test_operator_auto_resolution_matches_reference():
    band = MATRICES["fem_band"]()
    wide = jcsrc.fem_band(300, 200, seed=1, fill=0.1)
    rect = jcsrc.rectangular_fem(60, 11, 5, seed=6)
    for Mj, w_cap in ((band, 4096), (wide, 256), (rect, 4096)):
        opj = jops.SpmvOperator(Mj, w_cap=w_cap)
        opt = tops.SpmvOperator(to_torch_csrc(Mj), w_cap=w_cap, device="cpu")
        assert opt.plan.key() == opj.plan.key()
        x = np.random.default_rng(0).standard_normal(Mj.m).astype(np.float32)
        np.testing.assert_allclose(np.asarray(opj(jnp.asarray(x))),
                                   opt(torch.from_numpy(x)).numpy(),
                                   rtol=1e-5, atol=1e-4)
    assert tops.SpmvOperator(to_torch_csrc(rect), device="cpu").pack is None


def test_one_shot_spmv_paths_agree():
    Mj = dyadic(MATRICES["fem_band"]())
    Mt = to_torch_csrc(Mj)
    x = dyadic_x(Mj.n, 1, seed=9)
    want = np.asarray(jops.spmv(Mj, jnp.asarray(x)))
    for kw in ({}, {"path": "segment"}, {"path": "kernel"},
               {"plan": tplan.ExecutionPlan(path="kernel",
                                            variant="stream")}):
        got = tops.spmv(Mt, torch.from_numpy(x), device="cpu", **kw)
        np.testing.assert_array_equal(want, got.numpy())


def test_update_values_counts_one_refresh_and_matches_reference():
    Mj = dyadic(MATRICES["fem_band"]())
    Mj2 = dataclasses.replace(Mj, al=np.asarray(Mj.al) * 0.5,
                              au=np.asarray(Mj.au) * 0.5)
    plan_kw = dict(path="kernel", tm=32, k_step_sublanes=2, variant="stream")
    opj = jops.SpmvOperator.from_plan(Mj, jplan.ExecutionPlan(**plan_kw))
    opt = tops.SpmvOperator.from_plan(to_torch_csrc(Mj),
                                      tplan.ExecutionPlan(**plan_kw),
                                      device="cpu")
    before = dict(tsched.BUILD_COUNTS.items())
    opj.update_values(Mj2)
    opt.update_values(to_torch_csrc(Mj2))
    delta = {k: v - before.get(k, 0)
             for k, v in tsched.BUILD_COUNTS.items() if v != before.get(k, 0)}
    assert delta == {"value_refresh": 1}
    x = dyadic_x(Mj.n, 3, seed=5)
    np.testing.assert_array_equal(np.asarray(opj(jnp.asarray(x))),
                                  opt(torch.from_numpy(x)).numpy())
    assert opt.schedule.value_digest == opj.schedule.value_digest
    other = to_torch_csrc(MATRICES["tail_tile"]())
    with pytest.raises(ValueError, match="structure"):
        opt.update_values(other)


def test_entry_points_default_to_the_card_and_raise_without_one():
    """No quiet CPU fallback: without ``device="cpu"`` a machine with no
    card refuses, whichever entry point is asked."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    Mt = to_torch_csrc(MATRICES["fem_band"]())
    x = torch.zeros(Mt.n)
    with pytest.raises(RuntimeError, match="cuda"):
        tops.SpmvOperator(Mt)
    with pytest.raises(RuntimeError, match="cuda"):
        tops.spmv(Mt, x)
    with pytest.raises(RuntimeError, match="cuda"):
        tsolvers.cg_solve(Mt, x)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve(None)
    with pytest.raises(RuntimeError, match="cuda"):
        tops.spmm(Mt, x[:, None])
    with pytest.raises(RuntimeError, match="cuda"):
        tops.spmv_transpose(Mt, x)
    with pytest.raises(ValueError, match="unsupported"):
        tdevice.resolve("meta")
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.describe("cpu")["platform"] == "cpu"


def test_operator_refuses_what_is_not_ported_yet():
    """Every local path is registered now; a mesh plan, a square-only path
    on a rectangular matrix and a schedule of another plan are refused."""
    Mt = to_torch_csrc(MATRICES["fem_band"]())
    rect = to_torch_csrc(jcsrc.rectangular_fem(40, 8, 6, seed=0))
    for path in ("colorful", "nnzsplit", "flat", "kernel"):
        with pytest.raises(ValueError, match="square"):
            tops.SpmvOperator(rect, path=path, device="cpu")
    mesh = tplan.ExecutionPlan(path="segment", strategy="mesh", mesh_p=2)
    with pytest.raises(ValueError, match="local"):
        tops.SpmvOperator.from_plan(Mt, mesh, device="cpu")
    op = tops.SpmvOperator(Mt, device="cpu")
    wrong = tsched.build_schedule(Mt, tplan.ExecutionPlan(path="kernel",
                                                          tm=32))
    with pytest.raises(ValueError, match="cannot execute"):
        tops.SpmvOperator.from_plan(Mt, op.plan, device="cpu", schedule=wrong)


def _spd(n=144):
    return jcsrc.poisson2d(12)


@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("precondition", [True, False])
def test_cg_same_iterations_and_residual(nrhs, precondition):
    """Same recurrence, same stopping test: equal iteration count, residual
    and solution to float32 rounding of the matrix-vector sums."""
    Mj = _spd()
    Mt = to_torch_csrc(Mj)
    b = np.random.default_rng(1).standard_normal(
        (Mj.n,) if nrhs == 1 else (Mj.n, nrhs)).astype(np.float32)
    opj = jops.SpmvOperator(Mj)
    opt = tops.SpmvOperator(Mt, device="cpu")
    diag_j = Mj.ad if precondition else None
    diag_t = Mt.ad if precondition else None
    rj = jsolvers.cg(opj, jnp.asarray(b), tol=1e-6, diag=diag_j)
    rt = tsolvers.cg(opt, torch.from_numpy(b), tol=1e-6, diag=diag_t)
    assert rt.iters == int(rj.iters) and rt.converged and bool(rj.converged)
    assert abs(rt.residual - float(rj.residual)) <= 1e-6
    np.testing.assert_allclose(np.asarray(rj.x), rt.x.numpy(), rtol=1e-4,
                               atol=1e-5)
    A = jcsrc.to_dense(Mj).astype(np.float64)
    true = np.linalg.norm(b - A @ rt.x.numpy().astype(np.float64), axis=0)
    assert np.max(true / np.linalg.norm(b, axis=0)) < 1e-5


@pytest.mark.parametrize("nrhs", [1, 3])
def test_bicgstab_same_iterations_and_residual(nrhs):
    Mj = MATRICES["fem_band"]()
    Mt = to_torch_csrc(Mj)
    b = np.random.default_rng(2).standard_normal(
        (Mj.n,) if nrhs == 1 else (Mj.n, nrhs)).astype(np.float32)
    rj = jsolvers.bicgstab(jops.SpmvOperator(Mj), jnp.asarray(b), tol=1e-6)
    rt = tsolvers.bicgstab(tops.SpmvOperator(Mt, device="cpu"),
                           torch.from_numpy(b), tol=1e-6)
    assert rt.iters == int(rj.iters) and rt.converged
    assert abs(rt.residual - float(rj.residual)) <= 1e-6
    np.testing.assert_allclose(np.asarray(rj.x), rt.x.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_solver_maxiter_and_x0():
    Mt = to_torch_csrc(_spd())
    op = tops.SpmvOperator(Mt, device="cpu")
    b = torch.ones(Mt.n)
    r = tsolvers.cg(op, b, maxiter=2)
    assert r.iters == 2 and not r.converged
    full = tsolvers.cg(op, b, diag=Mt.ad)
    again = tsolvers.cg(op, b, x0=full.x, diag=Mt.ad)
    assert again.iters < full.iters and again.converged


def test_cg_solve_through_plan_and_cache():
    Mj = _spd()
    Mt = to_torch_csrc(Mj)
    b = np.random.default_rng(3).standard_normal((Mj.n, 2)).astype(np.float32)
    rj, opj = jsolvers.cg_solve(Mj, jnp.asarray(b))
    cache = ttuner.PlanCache()
    rt, opt = tsolvers.cg_solve(Mt, torch.from_numpy(b), cache=cache,
                                device="cpu")
    assert opt.plan.key() == opj.plan.key()
    assert rt.iters == int(rj.iters)
    before = dict(tsched.BUILD_COUNTS.items())
    stream = tplan.ExecutionPlan(path="kernel", variant="stream")
    rs, ops_ = tsolvers.cg_solve(Mt, torch.from_numpy(b), cache=cache,
                                 plan=stream, device="cpu")
    assert dict(tsched.BUILD_COUNTS.items()) == before   # same artifact
    assert ops_.plan.variant == "stream" and rs.iters == rt.iters
    # autotune=True measures on the CPU and solves with the argmin
    rt2, opt2 = tsolvers.cg_solve(
        Mt, torch.from_numpy(b), autotune=True, device="cpu",
        measure=lambda op, x: 1.0 if op.plan.path == "segment" else 2.0)
    assert opt2.plan.path == "segment" and rt2.converged
