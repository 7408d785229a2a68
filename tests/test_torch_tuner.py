"""The port's measured tuner held against the JAX package's: the same
matrices (made from numpy seeds) through ``enumerate_plans`` and ``tune``
of both, with one deterministic injected ``measure``; plan caches written
by either package read by the other; the predict-then-measure properties
under the port's card pricing; and the entry points that autotune
(``plan_for``, ``resolve_plan``, ``SpmvServingEngine``, ``cg_solve``), all
on ``device="cpu"``."""
import dataclasses
import hashlib
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import csrc as jcsrc
from repro.core import plan as jplan
from repro.core import schedule as jsched
from repro.core import solvers as jsolvers
from repro.core import tuner as jtuner
from repro.kernels import ops as jops
from repro_torch import device as tdevice
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.core.distributed import ShardMesh
from repro_torch.kernels import ops as tops
from repro_torch.roofline import cost_model as tcost
from repro_torch.serve import SpmvServingEngine, placement

from test_torch_parity_helpers import dyadic, dyadic_x, to_torch_csrc

CPU = "cpu"

# the classes the tuner tells apart: band (kernel), Poisson (symmetric:
# bf16 candidates), skewed band (flat), unstructured (nnzsplit), a
# rectangular tail (segment only)
ENUM_MATRICES = {
    "fem_band": lambda: jcsrc.fem_band(300, 9, seed=2),
    "skewed_band": lambda: jcsrc.skewed_band(400, 40, seed=3),
    "poisson2d": lambda: jcsrc.poisson2d(14),
    "random_symmetric_pattern":
        lambda: jcsrc.random_symmetric_pattern(200, 4, seed=4),
    "rectangular_fem": lambda: jcsrc.rectangular_fem(120, 30, 4, seed=5),
}


@pytest.mark.parametrize("colorings", [("greedy", "race"), ("race",)],
                         ids=["both_colorings", "race"])
@pytest.mark.parametrize("index_dtypes", [("int32", "int16"), ("int32",)],
                         ids=["both_index_dtypes", "int32"])
@pytest.mark.parametrize("nrhs_options", [(1,), (1, 8)],
                         ids=["r1", "r1_r8"])
@pytest.mark.parametrize("name", list(ENUM_MATRICES))
def test_enumerate_plans_equals_reference(name, nrhs_options, index_dtypes,
                                          colorings):
    Mj = ENUM_MATRICES[name]()
    kw = dict(nrhs_options=nrhs_options, index_dtypes=index_dtypes,
              colorings=colorings)
    want = jtuner.enumerate_plans(jtuner.stats_of(Mj), **kw)
    got = ttuner.enumerate_plans(ttuner.stats_of(to_torch_csrc(Mj)), **kw)
    assert [p.to_json() for p in got] == [p.to_json() for p in want]
    assert got and all(isinstance(p, tplan.ExecutionPlan) for p in got)


def test_enumerated_paths_cover_every_class():
    paths = {name: {p.path for p in ttuner.enumerate_plans(
        ttuner.stats_of(to_torch_csrc(make())))}
        for name, make in ENUM_MATRICES.items()}
    assert paths["rectangular_fem"] == {"segment"}
    assert {"kernel", "flat"} <= paths["skewed_band"]
    assert "nnzsplit" in paths["random_symmetric_pattern"]
    assert "colorful" in paths["fem_band"]


def test_candidate_source_registration():
    marker = tplan.ExecutionPlan(path="segment", w_cap=1234)

    def source(stats):
        return [marker]

    ttuner.register_candidate_source(source)
    try:
        Mt = to_torch_csrc(jcsrc.poisson2d(6))
        plans = ttuner.enumerate_plans(ttuner.stats_of(Mt))
        assert plans.count(marker) == 1
        calls = []
        res = ttuner.tune(Mt, device=CPU, predict=False,
                          measure=_fake_measure(calls))
        assert marker.key() in res.timings_s and marker.key() in calls
    finally:
        ttuner._CANDIDATE_SOURCES.remove(source)


def _fake_measure(calls=None):
    """Deterministic seconds from the plan key, with ties (seven values),
    growing slower than the RHS width: the same in both packages."""
    def measure(op, x):
        key = op.plan.key()
        if calls is not None:
            calls.append(key)
        h = int(hashlib.sha1(key.encode()).hexdigest()[:6], 16)
        return 1e-3 * (1 + h % 7) * float(np.sqrt(max(op.plan.nrhs, 1)))
    return measure


TUNE_MATRICES = {
    "fem_band": lambda: jcsrc.fem_band(160, 6, seed=7),
    "skewed_band": lambda: jcsrc.skewed_band(300, 40, seed=8),
    "random_symmetric_pattern":
        lambda: jcsrc.random_symmetric_pattern(160, 4, seed=9),
}


@pytest.mark.parametrize("nrhs_options", [(1,), (1, 8)],
                         ids=["r1", "r1_r8"])
@pytest.mark.parametrize("name", list(TUNE_MATRICES))
def test_tune_full_pool_equals_reference_and_caches_cross_load(
        tmp_path, name, nrhs_options):
    Mj = TUNE_MATRICES[name]()
    Mt = to_torch_csrc(Mj)
    jpath = os.path.join(tmp_path, "j", "plans.json")
    tpath = os.path.join(tmp_path, "t", "plans.json")
    jres = jtuner.tune(Mj, cache=jtuner.PlanCache(jpath), predict=False,
                       measure=_fake_measure(), nrhs_options=nrhs_options)
    tres = ttuner.tune(Mt, cache=ttuner.PlanCache(tpath), predict=False,
                       measure=_fake_measure(), nrhs_options=nrhs_options,
                       device=CPU)
    assert tres.plan.to_json() == jres.plan.to_json()
    assert tres.timings_s == jres.timings_s
    assert not tres.cached and tres.predictions_s == {}
    for a, b in ((jpath, tpath), (tpath, jpath)):
        ea = json.load(open(a))["entries"][jres.fingerprint]
        eb = json.load(open(b))["entries"][jres.fingerprint]
        assert ea["timings_us"] == eb["timings_us"]
        assert ea["best_us"] == eb["best_us"] and ea["measured"]

    def boom(op, x):
        raise AssertionError("re-measured a cached matrix")

    # the reference reads the port's cache, and the schedule beside it
    jc = jtuner.PlanCache(tpath)
    assert jtuner.tune(Mj, cache=jc, measure=boom).plan == jres.plan
    before = dict(jsched.BUILD_COUNTS.items())
    jops.SpmvOperator.from_plan(Mj, jres.plan, cache=jc)
    assert dict(jsched.BUILD_COUNTS.items()) == before
    # the port reads the reference's
    tc = ttuner.PlanCache(jpath)
    hit = ttuner.tune(Mt, cache=tc, measure=boom, device=CPU)
    assert hit.cached and hit.plan == tres.plan
    before = dict(tsched.BUILD_COUNTS.items())
    op = tops.SpmvOperator.from_plan(Mt, hit.plan, cache=tc, device=CPU)
    assert dict(tsched.BUILD_COUNTS.items()) == before
    x = dyadic_x(Mt.m, 1, seed=1)
    want = tops.SpmvOperator(Mt, path="segment", device=CPU)(
        torch.from_numpy(x))
    torch.testing.assert_close(op(torch.from_numpy(x)), want, rtol=2e-4,
                               atol=2e-4)


PREDICT_MATRICES = {
    "fem_band": lambda: jcsrc.fem_band(300, 9, seed=2),
    "skewed_band": lambda: jcsrc.skewed_band(400, 40, seed=3),
    "poisson2d": lambda: jcsrc.poisson2d(14),
    "random_symmetric_pattern":
        lambda: jcsrc.random_symmetric_pattern(200, 4, seed=4),
}


@pytest.mark.parametrize("nrhs_options", [(1,), (1, 8)],
                         ids=["r1", "r1_r8"])
@pytest.mark.parametrize("name", list(PREDICT_MATRICES))
def test_predict_then_measure_properties(name, nrhs_options):
    Mt = to_torch_csrc(PREDICT_MATRICES[name]())
    stats = ttuner.stats_of(Mt)
    pool = ttuner.enumerate_plans(stats, nrhs_options=nrhs_options)
    cache = ttuner.PlanCache()
    calls = []
    res = ttuner.tune(Mt, cache=cache, measure=_fake_measure(calls),
                      nrhs_options=nrhs_options, device=CPU)
    assert set(res.predictions_s) == {p.key() for p in pool}
    assert set(calls) == set(res.timings_s) <= set(res.predictions_s)
    if len(pool) >= 10:
        assert 2 * len(calls) <= len(pool), (len(calls), len(pool))
    ranked = tcost.rank_card_plans(stats, pool, tcost.calibrate(CPU))
    best_of_path = {}
    for p, est in ranked:
        best_of_path.setdefault(p.path, (p, est))
    for path, (p, est) in best_of_path.items():
        assert p.key() in res.timings_s, path
        # a stream plan and its one-hot twin are priced alike and measured
        # together
        if path in ("kernel", "flat", "nnzsplit"):
            twin = dataclasses.replace(
                p, variant="onehot" if p.variant == "stream" else "stream")
            assert est.predicted_s == tcost.card_plan_cost(
                stats, twin, tcost.calibrate(CPU)).predicted_s
            assert twin.key() in res.timings_s
    # the winner is the measured argmin per column
    by_key = {p.key(): p for p in pool}
    per_col = {k: t / by_key[k].nrhs for k, t in res.timings_s.items()}
    assert per_col[res.plan.key()] == min(per_col.values())
    entry = cache.entries[res.fingerprint]
    assert entry["denominators"] == tcost.DATA_SHEET.to_dict()
    assert entry["predicted_us"].keys() == res.predictions_s.keys()
    assert entry["roofline_fraction"] == pytest.approx(
        res.predictions_s[res.plan.key()] / res.timings_s[res.plan.key()])
    # a cache hit measures nothing
    hit = ttuner.tune(Mt, cache=cache, device=CPU,
                      measure=lambda op, x: pytest.fail("re-measured"))
    assert hit.cached and hit.plan == res.plan and hit.timings_s == {}


def test_tune_winner_is_the_per_column_argmin_in_pool_order():
    Mt = to_torch_csrc(TUNE_MATRICES["fem_band"]())
    res = ttuner.tune(Mt, measure=lambda op, x: 1e-3 * op.plan.nrhs,
                      predict=False, nrhs_options=(1, 8), device=CPU)
    pool = ttuner.enumerate_plans(ttuner.stats_of(Mt), nrhs_options=(1, 8))
    assert res.plan == pool[0]               # every plan ties per column
    assert len(res.timings_s) == len(pool)


@pytest.mark.parametrize("case", ["onehot_faster_r1", "stream_faster_r1",
                                  "not_level"])
def test_level_variants_at_the_serve_width_are_ordered_by_one_column(case):
    """Predict-then-measure at (1, 8) measures the r8 groups; the winner's
    r1 twins are then timed on its schedule, and variants level with it at
    r8 are ordered by their r1 times (single requests run the r1 twin)."""
    Mt = to_torch_csrc(TUNE_MATRICES["fem_band"]())
    r1_faster = "stream" if case == "stream_faster_r1" else "onehot"
    if case == "not_level":
        r1_faster = "stream"

    def measure(op, x):
        p = op.plan
        if p.path not in ("kernel", "flat", "nnzsplit"):
            return 1.0
        if p.nrhs > 1:
            # 0.5 ms a column; in "not_level" the stream plans are 10 %
            # slower, beyond LEVEL_TOL
            slow = case == "not_level" and p.variant == "stream"
            return 4e-3 * (1.1 if slow else 1.0)
        return 1e-3 if p.variant == r1_faster else 2e-3

    res = ttuner.tune(Mt, measure=measure, nrhs_options=(1, 8), device=CPU)
    assert res.plan.nrhs == 8
    assert res.plan.variant == ("onehot" if case == "not_level"
                                else r1_faster)
    art = tsched.plan_artifact_fields(res.plan)
    pool = ttuner.enumerate_plans(ttuner.stats_of(Mt), nrhs_options=(1, 8))
    twins = {p.key() for p in pool
             if p.nrhs == 1 and tsched.plan_artifact_fields(p) == art}
    assert {"stream", "onehot"} == {
        p.variant for p in pool if p.key() in twins}
    assert twins <= set(res.timings_s)
    # only the winner's r1 twins joined the r8 groups
    assert all(p.nrhs == 8 or p.key() in twins
               for p in pool if p.key() in res.timings_s)


def test_tune_shares_one_build_per_artifact():
    Mt = to_torch_csrc(TUNE_MATRICES["fem_band"]())
    pool = ttuner.enumerate_plans(ttuner.stats_of(Mt), nrhs_options=(1, 8))
    artifacts = {tsched.plan_artifact_fields(p) for p in pool}
    before = dict(tsched.BUILD_COUNTS.items())
    ttuner.tune(Mt, measure=_fake_measure(), predict=False,
                nrhs_options=(1, 8), device=CPU)
    delta = {k: v - before.get(k, 0)
             for k, v in tsched.BUILD_COUNTS.items()}
    assert delta["schedule"] == len(artifacts) < len(pool)


def test_heuristic_cache_entry_does_not_satisfy_tune():
    cache = ttuner.PlanCache()
    Mt = to_torch_csrc(jcsrc.poisson2d(6))
    ttuner.plan_for(Mt, cache=cache, autotune=False)
    calls = []
    res = ttuner.tune(Mt, cache=cache, measure=_fake_measure(calls),
                      device=CPU)
    assert not res.cached and len(calls) >= 2
    res2 = ttuner.tune(Mt, cache=cache, device=CPU,
                       measure=lambda op, x: pytest.fail("re-measured"))
    assert res2.cached and res2.plan == res.plan
    assert ttuner.plan_for(Mt, cache=cache, autotune=False) == res.plan


def test_plan_for_autotune_counts_one_miss():
    cache = ttuner.PlanCache()
    Mt = to_torch_csrc(jcsrc.poisson2d(6))
    ttuner.plan_for(Mt, cache=cache, autotune=True, device=CPU,
                    measure=lambda op, x: 1.0)
    assert cache.misses == 1 and cache.hits == 0


def test_tune_refuses_the_mesh_mode():
    """The mesh mode without a mesh of the width asked for is refused (the
    CPU counts one device); given one, it records the per-p winner."""
    Mt = to_torch_csrc(jcsrc.poisson2d(6))
    with pytest.raises(ValueError, match="devices"):
        ttuner.tune(Mt, mesh_ps=(2,), device=CPU,
                    measure=lambda op, x: 1.0)
    res = ttuner.tune(Mt, mesh_ps=(2,), device=CPU,
                      mesh=ShardMesh(2, CPU), measure=lambda op, x: 1.0)
    assert res.mesh_plans[2].strategy == "mesh"


def test_bf16_candidates_pass_the_accuracy_gate_against_segment():
    Mt = to_torch_csrc(jcsrc.poisson2d(10))
    seen = []

    def measure(op, x):
        seen.append(op.plan.value_dtype)
        return 0.5 if op.plan.value_dtype == "bfloat16" else 1.0

    res = ttuner.tune(Mt, measure=measure, predict=False, device=CPU)
    assert "bfloat16" in seen and res.plan.value_dtype == "bfloat16"
    # a tolerance no bf16 product meets rejects every bf16 candidate
    seen.clear()
    res = ttuner.tune(Mt, measure=measure, predict=False, device=CPU,
                      value_dtype_tol=0.0)
    assert "bfloat16" not in seen and res.plan.value_dtype == "float32"


def test_rhs_pool_uses_the_reference_seeds():
    Mt = to_torch_csrc(jcsrc.poisson2d(6))
    x_for = ttuner._rhs_pool(Mt, None, torch.device(CPU))
    np.testing.assert_array_equal(
        x_for(1).numpy(),
        np.random.default_rng(0).standard_normal(Mt.m).astype(np.float32))
    np.testing.assert_array_equal(
        x_for(8).numpy(), np.random.default_rng(8).standard_normal(
            (Mt.m, 8)).astype(np.float32))
    assert x_for(8) is x_for(8)


def test_time_fn_takes_the_median_on_the_host():
    calls = []
    t = tdevice.time_fn(lambda a, b: calls.append((a, b)), torch.zeros(2),
                        3, warmup=2, repeats=5)
    assert len(calls) == 7 and t >= 0.0


# ---------------------------------------------------------------------------
# Twins of the reference's nnz-split and integration tuner tests
# ---------------------------------------------------------------------------

def _unstructured(seed):
    return dyadic(jcsrc.random_symmetric_pattern(200, 5, seed=seed))


def _prefer(path, calls=None):
    def measure(op, x):
        if calls is not None:
            calls.append(op.plan.key())
        return 1.0 if op.plan.path == path else 2.0
    return measure


class TestNnzSplitTuning:
    def test_tune_selects_and_caches_nnzsplit(self):
        Mt = to_torch_csrc(_unstructured(12))
        cache = ttuner.PlanCache()
        res = ttuner.tune(Mt, cache=cache, measure=_prefer("nnzsplit"),
                          device=CPU)
        assert res.plan.path == "nnzsplit"
        assert any(k.startswith("nnzsplit:") for k in res.timings_s)
        res2 = ttuner.tune(Mt, cache=cache, device=CPU,
                           measure=lambda op, x: pytest.fail("re-measured"))
        assert res2.cached and res2.plan == res.plan

    def test_tuned_schedule_reused_with_zero_packs(self):
        Mt = to_torch_csrc(_unstructured(13))
        cache = ttuner.PlanCache()
        res = ttuner.tune(Mt, cache=cache, measure=_prefer("nnzsplit"),
                          device=CPU)
        before = dict(tsched.BUILD_COUNTS.items())
        tops.SpmvOperator.from_plan(Mt, res.plan, cache=cache, device=CPU)
        assert dict(tsched.BUILD_COUNTS.items()) == before

    def test_serving_engine_runs_nnzsplit_plan_bit_identical(self):
        Mj = _unstructured(14)
        Mt = to_torch_csrc(Mj)
        A = np.asarray(jcsrc.to_dense(Mj), np.float64)
        cache = ttuner.PlanCache()
        ttuner.tune(Mt, cache=cache, measure=_prefer("nnzsplit"),
                    device=CPU)
        eng = SpmvServingEngine(cache=cache, autotune=True, device=CPU)
        assert eng.register("unstructured", Mt).path == "nnzsplit"
        xs = [dyadic_x(Mt.m, 1, seed=i) for i in range(4)]
        uids = [eng.submit("unstructured", x) for x in xs]
        out = eng.run_until_drained()
        for uid, x in zip(uids, xs):
            assert out[uid].path == "nnzsplit"
            np.testing.assert_array_equal(
                np.asarray(out[uid]), (A @ x).astype(np.float32))


def test_spmv_serving_engine_tuned_batching():
    Mj = jcsrc.fem_band(80, 4, seed=2)
    Mt = to_torch_csrc(Mj)
    A = jcsrc.to_dense(Mj)
    cache = ttuner.PlanCache()
    calls = []
    ttuner.tune(Mt, cache=cache, measure=_prefer("kernel", calls),
                device=CPU)
    eng = SpmvServingEngine(cache=cache, autotune=True, device=CPU)
    plan = eng.register("fem", Mt)
    assert calls and cache.hits >= 1 and plan.path == "kernel"
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(Mt.m).astype(np.float32) for _ in range(4)]
    uids = [eng.submit("fem", x) for x in xs]
    out = eng.run_until_drained()
    assert set(out) == set(uids)
    for uid, x in zip(uids, xs):
        np.testing.assert_allclose(out[uid], A @ x, rtol=2e-4, atol=2e-4)
    assert eng.plan("fem") == plan


def test_engine_tunes_at_serve_nrhs_and_a_second_engine_reuses_it():
    from repro_torch import obs
    Mt = to_torch_csrc(jcsrc.fem_band(120, 5, seed=4))
    cache = ttuner.PlanCache()
    eng = SpmvServingEngine(cache=cache, autotune=True, device=CPU,
                            serve_nrhs=8)
    plan = eng.register("fem", Mt)
    entry = cache.entries[ttuner.fingerprint(Mt)]
    # both widths were priced; the cheaper per column were measured
    assert any(k.endswith(":r8") for k in entry["timings_us"])
    assert any(not k.endswith(":r8") for k in entry["predicted_us"])
    snap = obs.snapshot()
    before = dict(tsched.BUILD_COUNTS.items())
    eng2 = SpmvServingEngine(cache=cache, autotune=True, device=CPU,
                             serve_nrhs=8)
    assert eng2.register("fem", Mt) == plan
    assert dict(tsched.BUILD_COUNTS.items()) == before
    assert obs.snapshot().diff(snap).total(
        "tuner_candidates_measured_total") == 0
    # placement passes the batched width to the tuner
    cache3 = ttuner.PlanCache()
    placement.resolve_plan(Mt, cache=cache3, autotune=True, nrhs=8,
                           device=CPU)
    keys = cache3.entries[ttuner.fingerprint(Mt)]["predicted_us"]
    assert any(k.endswith(":r8") for k in keys)


def test_tune_measures_best_colorful_provider_and_persists(tmp_path):
    path = os.path.join(tmp_path, "plans.json")
    Mt = to_torch_csrc(jcsrc.fem_band(96, 8, seed=2))
    cache = ttuner.PlanCache(path=path)
    res = ttuner.tune(Mt, cache=cache, measure=_prefer("colorful"),
                      device=CPU)
    assert res.plan.path == "colorful"
    stats = ttuner.stats_of(Mt)
    colorful_keys = [k for k in res.timings_s if k.startswith("colorful")]
    want = tcost.rank_card_plans(
        stats, [tplan.ExecutionPlan(path="colorful"),
                tplan.ExecutionPlan(path="colorful", coloring="race")])[0][0]
    prefix = "colorful:race" if want.coloring == "race" else "colorful:nnz"
    assert len(colorful_keys) == 1 and colorful_keys[0].startswith(prefix)
    res2 = ttuner.tune(Mt, cache=ttuner.PlanCache(path=path), device=CPU,
                       measure=lambda op, x: pytest.fail("re-measured"))
    assert res2.cached and res2.plan == res.plan
    assert res2.plan.coloring == res.plan.coloring


def test_cg_solve_autotunes_and_reuses_the_decision():
    Mj = jcsrc.poisson2d(12)
    Mt = to_torch_csrc(Mj)
    A = jcsrc.to_dense(Mj).astype(np.float64)
    x_true = np.random.default_rng(0).standard_normal(Mt.n)
    b = torch.from_numpy((A @ x_true).astype(np.float32))
    cache = ttuner.PlanCache()
    res, op = tsolvers.cg_solve(Mt, b, cache=cache, autotune=True,
                                device=CPU, maxiter=2000,
                                measure=_prefer("kernel"))
    assert res.converged and op.plan.path == "kernel"
    assert np.abs(res.x.numpy() - x_true).max() < 1e-3
    assert cache.get(ttuner.fingerprint(Mt), require_measured=True) \
        == op.plan
    res2, op2 = tsolvers.cg_solve(
        Mt, b, cache=cache, autotune=True, device=CPU, maxiter=2000,
        measure=lambda op, x: pytest.fail("re-measured"))
    assert op2.plan == op.plan and res2.iters == res.iters
    # the reference's solve on the same plan
    rj, _ = jsolvers.cg_solve(
        Mj, jnp.asarray(b.numpy()), maxiter=2000,
        plan=jplan.ExecutionPlan.from_json(op.plan.to_json()))
    assert abs(int(rj.iters) - res.iters) <= 1
