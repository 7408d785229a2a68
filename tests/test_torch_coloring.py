"""The port's coloring (paper §3.2) and ``colorful`` path held against the
JAX package on the CPU: greedy and RACE colorings equal move for move,
``verify_coloring`` and the stats helpers, the paper example's 12 direct and
7 indirect conflicts, the slot batches, ``colorful_apply`` on (n,) and
(n, r), plan keys and candidates, schedule npz files across the two
packages, serving and CG through a colorful plan.

Dyadic values make float32 sums exact in any order, so the products are
compared with ``assert_array_equal``.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import coloring as jcol
from repro.core import csrc as jcsrc
from repro.core import paths as jpaths
from repro.core import plan as jplan
from repro.core import schedule as jsched
from repro.core import solvers as jsolvers
from repro.core import tuner as jtuner
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import SpmvServingEngine as JEngine
from repro_torch import convert
from repro_torch.core import coloring as tcol
from repro_torch.core import paths as tpaths
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serve import SpmvServingEngine

from test_torch_parity_helpers import dyadic as _dyadic
from test_torch_parity_helpers import dyadic_x, to_torch_csrc


def dyadic(Mj):
    """Dyadic values kept as JAX arrays: the JAX package's jitted colorful
    executor indexes ``M.al`` / ``M.au`` with traced slot ids."""
    q = _dyadic(Mj)
    return dataclasses.replace(q, ad=jnp.asarray(q.ad), al=jnp.asarray(q.al),
                               au=jnp.asarray(q.au), ar=jnp.asarray(q.ar))

# the JAX package's coloring suite, plus a power-law graph (hub rows)
SUITE = {
    "poisson2d": lambda: jcsrc.poisson2d(6),
    "fem_band": lambda: jcsrc.fem_band(80, 3, seed=0),
    "skewed_band": lambda: jcsrc.skewed_band(64, 12, 2, seed=1),
    "random": lambda: jcsrc.random_symmetric_pattern(48, 3, seed=3),
    "paper_example": jcsrc.paper_example,
    "powerlaw": lambda: jcsrc.powerlaw_laplacian(120, seed=2),
}
COLORING_ARRAYS = ("color_of_row", "rows_by_color", "color_ptr",
                   "level_of_row", "group_of_row")


def assert_coloring_equal(cj, ct):
    assert cj.num_colors == ct.num_colors and cj.provider == ct.provider
    for f in COLORING_ARRAYS:
        a, b = getattr(cj, f), getattr(ct, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _both(name):
    Mj = SUITE[name]()
    return Mj, to_torch_csrc(Mj)


# ---------------------------------------------------------------------------
# Colorings, move for move
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("indirect", [True, False])
@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("name", list(SUITE))
def test_color_rows_equal(name, provider, indirect):
    Mj, Mt = _both(name)
    cj = jcol.color_rows(Mj, include_indirect=indirect, provider=provider)
    ct = tcol.color_rows(Mt, include_indirect=indirect, provider=provider)
    assert_coloring_equal(cj, ct)
    valid = tcol.verify_coloring(Mt, ct)
    assert valid == jcol.verify_coloring(Mj, cj)
    assert valid or not indirect      # distance 2 is what the writes need


@pytest.mark.parametrize("name", list(SUITE))
def test_adjacency_and_greedy_internals_equal(name):
    """The direct graph, both greedy orders at both distances, the balance
    pass and the distance-2 closure: identical arrays."""
    Mj, Mt = _both(name)
    aj, at = jcol.direct_adjacency(Mj), tcol.direct_adjacency(Mt)
    assert len(aj) == len(at)
    for a, b in zip(aj, at):
        np.testing.assert_array_equal(a, b)
    deg = np.asarray([len(a) for a in aj])
    for order in (np.arange(Mj.n), np.argsort(-deg, kind="stable")):
        for indirect in (False, True):
            gj = jcol._greedy(aj, order, indirect)
            gt = tcol._greedy(at, order, indirect)
            np.testing.assert_array_equal(gj, gt)
            np.testing.assert_array_equal(
                jcol._balance(aj, gj.copy(), indirect),
                tcol._balance(at, gt.copy(), indirect))
    for a, b in zip(jcol._conflict_closure(aj), tcol._conflict_closure(at)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("order", ["degree", "natural"])
def test_color_graph_options_equal(order, balance):
    Mj, Mt = _both("fem_band")
    adj = jcol.direct_adjacency(Mj)
    for indirect in (False, True):
        assert_coloring_equal(
            jcol.color_graph(adj, include_indirect=indirect, order=order,
                             balance=balance),
            tcol.color_graph(adj, include_indirect=indirect, order=order,
                             balance=balance))
    cadj = jcol._conflict_closure(adj)
    assert_coloring_equal(
        jcol.race_color_graph(cadj, balance=balance),
        tcol.race_color_graph(cadj, balance=balance))


def test_race_cuts_palette_on_wide_band_as_reference():
    Mj = jcsrc.fem_band(600, 24, seed=3)
    Mt = to_torch_csrc(Mj)
    for provider in ("greedy", "race"):
        assert_coloring_equal(jcol.color_rows(Mj, provider=provider),
                              tcol.color_rows(Mt, provider=provider))
    greedy = tcol.color_rows(Mt, provider="greedy")
    race = tcol.color_rows(Mt, provider="race")
    assert race.num_colors * 2 <= greedy.num_colors
    assert (tcol.reuse_stats(race)["mean_stride"]
            < tcol.reuse_stats(greedy)["mean_stride"])


def test_unknown_provider_and_order_raise():
    adj = jcol.direct_adjacency(SUITE["paper_example"]())
    with pytest.raises(ValueError, match="provider"):
        tcol.color_graph(adj, provider="dsatur")
    with pytest.raises(ValueError, match="order"):
        tcol.color_graph(adj, order="random")
    assert tcol.PROVIDERS == jcol.PROVIDERS
    assert (tcol.RACE_P_TARGET, tcol.RACE_MAX_DEPTH) == (
        jcol.RACE_P_TARGET, jcol.RACE_MAX_DEPTH)


# ---------------------------------------------------------------------------
# verify_coloring and the stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("name", list(SUITE))
def test_verify_and_stats_equal(name, provider):
    Mj, Mt = _both(name)
    cj = jcol.color_rows(Mj, provider=provider)
    ct = tcol.color_rows(Mt, provider=provider)
    for fn in ("balance_stats", "reuse_stats", "group_stats"):
        assert getattr(jcol, fn)(cj) == getattr(tcol, fn)(ct), fn
    assert jcol.conflict_stats(Mj) == tcol.conflict_stats(Mt)
    # a coloring that merges every class breaks the invariant in both
    merged = dataclasses.replace(
        ct, color_of_row=np.zeros_like(ct.color_of_row), num_colors=1,
        rows_by_color=np.arange(Mt.n), color_ptr=np.array([0, Mt.n]),
        group_of_row=None)
    want = jcol.verify_coloring(Mj, dataclasses.replace(
        cj, color_of_row=merged.color_of_row, num_colors=1,
        rows_by_color=merged.rows_by_color, color_ptr=merged.color_ptr,
        group_of_row=None))
    assert tcol.verify_coloring(Mt, merged) == want
    assert want is (Mj.k == 0)


def test_paper_example_conflict_counts():
    """The §3.2 illustration: 12 direct and 7 indirect conflicts, and both
    providers valid at distance 1 and 2 (ROADMAP A1)."""
    Mj, Mt = _both("paper_example")
    assert tcol.conflict_stats(Mt) == {"direct": 12, "indirect": 7}
    assert tcol.conflict_stats(to_torch_csrc(jcsrc.poisson2d(3)))[
        "direct"] == 12
    adj = tcol.direct_adjacency(Mt)
    for provider in ("greedy", "race"):
        d1 = tcol.color_graph(adj, include_indirect=False, provider=provider)
        for c in range(d1.num_colors):
            members = set(d1.rows(c).tolist())
            grp = d1.group_of_row
            for v in d1.rows(c).tolist():
                for u in adj[v].tolist():
                    if u in members:
                        assert grp is not None and grp[u] == grp[v]
        d2 = tcol.color_rows(Mt, include_indirect=True, provider=provider)
        assert tcol.verify_coloring(Mt, d2)
        assert sorted(np.concatenate([d2.rows(c) for c in range(
            d2.num_colors)]).tolist()) == list(range(Mt.n))


# ---------------------------------------------------------------------------
# Slot batches and colorful_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("name", list(SUITE))
def test_color_slot_batches_equal(name, provider):
    Mj, Mt = _both(name)
    cj = jcol.color_rows(Mj, provider=provider)
    ct = tcol.color_rows(Mt, provider=provider)
    sj, pj = jsched.color_slot_batches(Mj, cj)
    st, pt = tsched.color_slot_batches(Mt, ct)
    assert sj.dtype == st.dtype and pj.dtype == pt.dtype
    np.testing.assert_array_equal(sj, st)
    np.testing.assert_array_equal(pj, pt)


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("name", list(SUITE))
def test_colorful_apply_bit_identical(name, provider, nrhs):
    Mj = dyadic(SUITE[name]())
    Mt = to_torch_csrc(Mj)
    ct = tcol.color_rows(Mt, provider=provider)
    slots, ptr = tsched.color_slot_batches(Mt, ct)
    x = dyadic_x(Mj.n, nrhs, seed=nrhs)
    yj = jsched.colorful_apply(Mj, jnp.asarray(x), slots, ptr)
    yt = tsched.colorful_apply(Mt, torch.from_numpy(x), slots, ptr)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ x.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jref.colorful_spmv(Mj, jnp.asarray(x), ct)),
        tref.colorful_spmv(Mt, torch.from_numpy(x), ct).numpy())


# ---------------------------------------------------------------------------
# The colorful path: plans, candidates, schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"path": "colorful"}, {"path": "colorful", "coloring": "race"},
    {"path": "colorful", "partition": "count", "nrhs": 4}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_colorful_plan_keys_equal(kw):
    pj, pt = jplan.ExecutionPlan(**kw), tplan.ExecutionPlan(**kw)
    assert pj.key() == pt.key() and pj.to_json() == pt.to_json()
    assert (jsched.plan_artifact_fields(pj)
            == tsched.plan_artifact_fields(pt))
    assert (jsched.schedule_key("fp", "vd", pj, 8)
            == tsched.schedule_key("fp", "vd", pt, 8))
    assert tplan.feasible(pt, n=9, m=9, bandwidth=3)
    assert not tplan.feasible(pt, n=9, m=12, bandwidth=3)


@pytest.mark.parametrize("max_n", [2048, 30])
@pytest.mark.parametrize("name", list(SUITE) + ["rectangular", "diag"])
def test_colorful_candidates_equal(name, max_n):
    factory = SUITE.get(name) or {
        "rectangular": lambda: jcsrc.rectangular_fem(40, 8, 3, seed=1),
        "diag": lambda: jcsrc.from_coo(np.arange(5), np.arange(5),
                                       np.ones(5), n=5)}[name]
    Mj = factory()
    sj, st = jtuner.stats_of(Mj), ttuner.stats_of(to_torch_csrc(Mj))
    cj = jpaths.get_path("colorful").candidates(
        sj, jpaths.CandidateSpace(colorful_max_n=max_n))
    ct = tpaths.get_path("colorful").candidates(
        st, tpaths.CandidateSpace(colorful_max_n=max_n))
    assert [p.to_json() for p in cj] == [p.to_json() for p in ct]


def test_registry_order_matches_reference():
    assert ([p.name for p in tpaths.registered_paths()]
            == [p.name for p in jpaths.registered_paths()])
    assert tplan.PATHS == jplan.PATHS


@pytest.mark.parametrize("provider", ["greedy", "race"])
def test_build_schedule_equal_and_binds(provider):
    Mj = dyadic(SUITE["fem_band"]())
    Mt = to_torch_csrc(Mj)
    kw = dict(path="colorful", coloring=provider)
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(**kw), p=4)
    st = tsched.build_schedule(Mt, tplan.ExecutionPlan(**kw), p=4)
    assert sj.key() == st.key()
    assert_coloring_equal(sj.coloring, st.coloring)
    np.testing.assert_array_equal(sj.color_slots, st.color_slots)
    np.testing.assert_array_equal(sj.color_slot_ptr, st.color_slot_ptr)
    assert st.pack is None and st.nnzsplit_pack is None
    assert st.to("cpu") is st
    op = tops.SpmvOperator.from_plan(Mt, st.plan, device="cpu", schedule=st)
    assert op.pack is None and op.bytes_per_call == Mt.working_set_bytes()
    x = dyadic_x(Mj.n, 3, seed=2)
    yj = jops.SpmvOperator.from_plan(Mj, sj.plan, schedule=sj)(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(yj),
                                  op(torch.from_numpy(x)).numpy())


def test_explicit_coloring_override_and_refusals():
    Mj = dyadic(SUITE["powerlaw"]())
    Mt = to_torch_csrc(Mj)
    col = tcol.color_rows(Mt, include_indirect=True, order="natural",
                          balance=False)
    before = dict(tsched.BUILD_COUNTS.items())
    op = tops.SpmvOperator.from_plan(Mt, tplan.ExecutionPlan(path="colorful"),
                                     device="cpu", coloring=col)
    assert tsched.BUILD_COUNTS["coloring"] == before.get("coloring", 0)
    assert op.schedule.coloring is col
    x = dyadic_x(Mj.n, 1, seed=3)
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        op(torch.from_numpy(x)).numpy(),
        (A @ x.astype(np.float64)).astype(np.float32))
    rect = to_torch_csrc(jcsrc.rectangular_fem(40, 8, 6, seed=0))
    with pytest.raises(ValueError, match="square"):
        tops.SpmvOperator.from_plan(rect, tplan.ExecutionPlan(path="colorful"),
                                    device="cpu")


@pytest.mark.parametrize("provider", ["greedy", "race"])
def test_schedule_npz_written_by_reference_loads_in_port(tmp_path, provider):
    Mj = dyadic(SUITE["skewed_band"]())
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(path="colorful",
                                                       coloring=provider))
    f = str(tmp_path / "col.npz")
    sj.save_npz(f)
    st = tsched.SpmvSchedule.load_npz(f)
    assert st.key() == sj.key()
    assert_coloring_equal(sj.coloring, st.coloring)
    np.testing.assert_array_equal(sj.color_slots, st.color_slots)
    Mt = to_torch_csrc(Mj)
    before = dict(tsched.BUILD_COUNTS.items())
    op = tops.SpmvOperator.from_plan(Mt, st.plan, device="cpu", schedule=st)
    assert dict(tsched.BUILD_COUNTS.items()) == before       # nothing rebuilt
    x = dyadic_x(Mj.n, 2, seed=1)
    yj = jops.SpmvOperator.from_plan(Mj, sj.plan, schedule=sj)(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(yj),
                                  op(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("provider", ["greedy", "race"])
def test_schedule_npz_written_by_port_loads_in_reference(tmp_path, provider):
    Mj = dyadic(SUITE["random"]())
    Mt = to_torch_csrc(Mj)
    st = tsched.build_schedule(Mt, tplan.ExecutionPlan(path="colorful",
                                                       coloring=provider))
    f = str(tmp_path / "col.npz")
    st.save_npz(f)
    sj = jsched.SpmvSchedule.load_npz(f)
    assert sj.key() == st.key()
    assert_coloring_equal(sj.coloring, st.coloring)
    assert jcol.verify_coloring(Mj, sj.coloring)
    x = dyadic_x(Mj.n, 1, seed=2)
    yj = jops.SpmvOperator.from_plan(Mj, sj.plan, schedule=sj)(jnp.asarray(x))
    yt = tops.SpmvOperator.from_plan(Mt, st.plan, device="cpu",
                                     schedule=st)(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def test_coloring_from_arrays_roundtrip():
    Mj = SUITE["poisson2d"]()
    cj = jcol.color_rows(Mj, provider="race")
    ct = convert.coloring_from_arrays(
        color_of_row=cj.color_of_row, num_colors=cj.num_colors,
        rows_by_color=cj.rows_by_color, color_ptr=cj.color_ptr,
        provider=cj.provider, level_of_row=cj.level_of_row,
        group_of_row=cj.group_of_row)
    assert_coloring_equal(cj, ct)
    assert tcol.verify_coloring(to_torch_csrc(Mj), ct)
    with pytest.raises(ValueError, match="provider"):
        convert.coloring_from_arrays(
            color_of_row=cj.color_of_row, num_colors=cj.num_colors,
            rows_by_color=cj.rows_by_color, color_ptr=cj.color_ptr,
            provider="dsatur")


def test_cache_hit_and_refresh_build_zero_colorings(tmp_path):
    Mj = dyadic(SUITE["fem_band"]())
    Mt = to_torch_csrc(Mj)
    plan = tplan.ExecutionPlan(path="colorful", coloring="race")
    cache = ttuner.PlanCache(path=str(tmp_path / "plans.json"))
    before = dict(tsched.BUILD_COUNTS.items())
    op = tops.SpmvOperator.from_plan(Mt, plan, cache=cache, device="cpu")
    assert tsched.BUILD_COUNTS["coloring"] == before.get("coloring", 0) + 1
    mid = dict(tsched.BUILD_COUNTS.items())
    tops.SpmvOperator.from_plan(Mt, plan, cache=ttuner.PlanCache(
        path=str(tmp_path / "plans.json")), device="cpu")
    assert dict(tsched.BUILD_COUNTS.items()) == mid          # disk hit
    scaled = dataclasses.replace(Mj, ad=2.0 * Mj.ad, al=0.5 * Mj.al,
                                 au=-Mj.au)
    op.update_values(to_torch_csrc(scaled))
    delta = {k: v - mid.get(k, 0) for k, v in tsched.BUILD_COUNTS.items()
             if v != mid.get(k, 0)}
    assert delta == {"value_refresh": 1}
    x = dyadic_x(Mj.n, 1, seed=6)
    A = jcsrc.to_dense(scaled).astype(np.float64)
    np.testing.assert_array_equal(
        op(torch.from_numpy(x)).numpy(),
        (A @ x.astype(np.float64)).astype(np.float32))


# ---------------------------------------------------------------------------
# Serving and solving through a colorful plan
# ---------------------------------------------------------------------------

def test_serving_engine_answers_through_a_colorful_plan():
    Mj = dyadic(SUITE["poisson2d"]())
    kw = dict(path="colorful", coloring="race")
    ej, et = JEngine(), SpmvServingEngine(device="cpu")
    pj = ej.register("p2d", Mj, plan=jplan.ExecutionPlan(**kw))
    pt = et.register("p2d", to_torch_csrc(Mj), plan=tplan.ExecutionPlan(**kw))
    assert pj.to_json() == pt.to_json()
    uids = []
    for i in range(3):
        x = dyadic_x(Mj.n, 1, seed=30 + i)
        uids.append(et.submit("p2d", x))
        assert ej.submit("p2d", x) == uids[-1]
    outj, outt = ej.run_until_drained(), et.run_until_drained()
    for u in uids:
        np.testing.assert_array_equal(np.asarray(outj[u]),
                                      np.asarray(outt[u]))
        assert outt[u].meta()["path"] == "colorful"


@pytest.mark.parametrize("provider", ["greedy", "race"])
def test_cg_solve_colorful_plan_same_iterations(provider):
    Mj = jcsrc.poisson2d(12)
    b = np.random.default_rng(4).standard_normal((Mj.n, 2)).astype(
        np.float32)
    kw = dict(path="colorful", coloring=provider)
    rj, opj = jsolvers.cg_solve(Mj, jnp.asarray(b),
                                plan=jplan.ExecutionPlan(**kw))
    rt, opt = tsolvers.cg_solve(to_torch_csrc(Mj), torch.from_numpy(b),
                                plan=tplan.ExecutionPlan(**kw), device="cpu")
    assert opt.plan.key() == opj.plan.key() and opt.path == "colorful"
    assert rt.converged and rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                               atol=1e-6)


def test_colorful_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    Mt = to_torch_csrc(SUITE["paper_example"]())
    with pytest.raises(RuntimeError, match="cuda"):
        tops.SpmvOperator.from_plan(Mt, tplan.ExecutionPlan(path="colorful"))
