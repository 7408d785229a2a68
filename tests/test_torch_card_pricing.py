"""Card pricing (``roofline/cost_model.py``): each path priced as the port
runs it.  A one-hot plan streams its stream twin's bytes and is priced by
its own body (the run-and-bucket pass of K3/K4, K7/K8, K11/K12), so on a
skewed matrix it is priced above its twin, as the card runs it (ROADMAP
C36); the rectangular padding comes from the pack's tiles when a pack
exists, else from an estimate of the widest tile; the kernel's own bytes on
a built pack are what ``chip_smoke.py``'s bound column counts; ``segment``
is priced as the torch ops it is; the colored one-hot assembly (K14) is
memory-bound and measured by ``tune_assembly``.  The JAX package's formulas
stay beside card pricing, unchanged (their parity tests are in
``test_torch_assembly.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import csrc as jcsrc
from repro_torch.assembly import mesh as tmesh
from repro_torch.assembly import scatter as tscatter
from repro_torch.core import blockell as tbe
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import tuner as ttuner
from repro_torch.roofline import cost_model as tcost

from test_torch_parity_helpers import to_torch_csrc

CPU = "cpu"

MATRICES = {
    "fem_band": lambda: jcsrc.fem_band(600, 9, seed=2),
    "skewed_band": lambda: jcsrc.skewed_band(800, 40, seed=3),
    "poisson2d": lambda: jcsrc.poisson2d(24),
    "random_symmetric_pattern":
        lambda: jcsrc.random_symmetric_pattern(400, 4, seed=4),
}

PATH_PLANS = [
    dict(path="kernel"), dict(path="kernel", tm=32, index_dtype="int16"),
    dict(path="kernel", value_dtype="bfloat16"),
    dict(path="flat"), dict(path="flat", tm=32, index_dtype="int16"),
    dict(path="nnzsplit"), dict(path="nnzsplit", k_step_sublanes=2),
    dict(path="nnzsplit", value_dtype="bfloat16"),
]


@pytest.mark.parametrize("nrhs", [1, 8])
@pytest.mark.parametrize("kw", PATH_PLANS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_onehot_plan_is_memory_bound_at_its_stream_twins_bytes(kw, nrhs):
    """A one-hot plan moves its stream twin's bytes with its twin's
    launches; its kernel takes the longer of those bytes and its own body,
    the run-and-bucket pass (C36)."""
    stats = ttuner.stats_of(to_torch_csrc(MATRICES["fem_band"]()))
    stream = tplan.ExecutionPlan(variant="stream", nrhs=nrhs, **kw)
    onehot = dataclasses.replace(stream, variant="onehot")
    a = tcost.card_plan_cost(stats, stream)
    b = tcost.card_plan_cost(stats, onehot)
    for field in ("bytes", "kernel_bytes", "layout_bytes",
                  "accumulation_bytes", "flops", "launches", "memory_s"):
        assert getattr(b, field) == getattr(a, field), field
    assert b.bytes == (b.kernel_bytes + b.layout_bytes
                       + b.accumulation_bytes)
    g = tcost._estimate_geometry(stats, onehot)
    for est, plan in ((a, stream), (b, onehot)):
        assert est.body_s == tcost.body_seconds(plan, g, nrhs) > 0
        assert est.predicted_s == pytest.approx(
            max(max((est.kernel_bytes + est.layout_bytes) / tcost.HBM_BW,
                    est.body_s)
                + est.accumulation_bytes / tcost.HBM_BW, est.compute_s)
            + est.launches * tcost.DATA_SHEET.launch_s)
    assert b.body_s != a.body_s
    # the reference formula prices the TPU body's masks on top
    assert tcost.plan_cost(stats, onehot).flops > b.flops


def _skew_ns(n=8192):
    """A matrix of ``chip_smoke.py``'s ``skew_ns`` shape (half-band 512 on
    the first 6 % of rows, 3 on the rest, numerically non-symmetric)."""
    from repro_torch.core import csrc
    from _smoke import chip_smoke
    cs = chip_smoke()
    return csrc.from_assembly(n, *cs.skew_arrays(n, cs.SKEW_WIDE,
                                                 cs.SKEW_NARROW, 5, False))


@pytest.mark.parametrize("nrhs", [1, 8])
@pytest.mark.parametrize("path", ["kernel", "flat", "nnzsplit"],
                         ids=["K3K4", "K7K8", "K11K12"])
def test_onehot_priced_above_its_stream_twin_on_skew_ns_packs(path, nrhs):
    """On the card the one-hot kernels run 2.9-4.8x their stream twins on
    ``skew_ns``'s windowed packs and 1.07-1.22x on nnz-split chunks
    (PERF.md §6); card pricing orders each pair the same way, from the
    statistics and on the built pack."""
    Mt = _skew_ns()
    stats = ttuner.stats_of(Mt)
    stream = tplan.ExecutionPlan(path=path, variant="stream", nrhs=nrhs)
    onehot = dataclasses.replace(stream, variant="onehot")
    geom = tcost.pack_geometry(_pack(Mt, stream))
    for g in (None, geom):
        a = tcost.card_plan_cost(stats, stream, geometry=g)
        b = tcost.card_plan_cost(stats, onehot, geometry=g)
        assert b.predicted_s > a.predicted_s and b.body_s > a.body_s
        assert b.bytes == a.bytes
    ranked = tcost.rank_card_plans(stats, [onehot, stream])
    assert [p.variant for p, _ in ranked] == ["stream", "onehot"]


def test_rectangular_padding_is_read_off_the_pack_or_the_widest_tile():
    """The priced rectangular padding on a built pack is the pack's own;
    without a pack the skewed matrix's fullest tile is estimated from its
    widest rows, not from the nnz-per-row spread the reference uses."""
    Mt = _skew_ns()
    stats = ttuner.stats_of(Mt)
    plan = tplan.ExecutionPlan(path="kernel", variant="onehot")
    pack = _pack(Mt, plan)
    built = tcost.card_plan_cost(stats, plan,
                                 geometry=tcost.pack_geometry(pack))
    assert built.layout_bytes == tbe.padding_bytes(pack)
    assert tcost.pack_geometry(pack).slots == pack.col_local.numel()
    est = tcost._estimate_geometry(stats, plan)
    ref_slots = tcost._windowed_geometry(stats, plan)[2]
    real = pack.col_local.numel()
    assert ref_slots < real / 4 < est.slots <= real


def _pack(Mt, plan):
    sched = tsched.build_schedule(Mt, plan)
    return next(p for p in (sched.pack, sched.flat_pack,
                            sched.nnzsplit_pack) if p is not None)


def _bound_bytes(pack, nrhs):
    """The bytes chip_smoke.py's bound column counts, written out."""
    if hasattr(pack, "num_chunks"):
        b = sum(a.numel() * a.element_size()
                for a in (pack.vals, pack.lrow, pack.src))
        return b + (pack.num_chunks * pack.r_pad + pack.n) * 4 * nrhs
    return pack.streamed_bytes(nrhs) - tbe.padding_bytes(pack)


@pytest.mark.parametrize("nrhs", [1, 11])
@pytest.mark.parametrize("kw", PATH_PLANS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("name", ["skewed_band", "random_symmetric_pattern"])
def test_kernel_bytes_equal_the_bound_columns_on_built_packs(name, kw, nrhs):
    Mt = to_torch_csrc(MATRICES[name]())
    stats = ttuner.stats_of(Mt)
    plan = tplan.ExecutionPlan(nrhs=nrhs, **kw)
    pack = _pack(Mt, plan)
    want = _bound_bytes(pack, nrhs)
    assert tcost.pack_kernel_bytes(pack, nrhs) == want
    built = tcost.card_plan_cost(stats, plan,
                                 geometry=tcost.pack_geometry(pack))
    assert built.kernel_bytes == want
    if plan.path == "nnzsplit":
        assert built.layout_bytes == 0
    else:
        # the windowed estimate knows every term but the padding exactly
        est = tcost.card_plan_cost(stats, plan)
        assert est.kernel_bytes == want
        assert built.layout_bytes == tbe.padding_bytes(pack)


@pytest.mark.parametrize("nrhs", [1, 8])
@pytest.mark.parametrize("name", ["fem_band", "poisson2d"])
def test_segment_priced_above_the_kernel_stream_plan(name, nrhs):
    stats = ttuner.stats_of(to_torch_csrc(MATRICES[name]()))
    seg = tcost.card_plan_cost(stats, tplan.ExecutionPlan(
        path="segment", nrhs=nrhs))
    ker = tcost.card_plan_cost(stats, tplan.ExecutionPlan(
        path="kernel", variant="stream", nrhs=nrhs))
    assert seg.predicted_s > ker.predicted_s
    assert seg.launches > ker.launches and seg.kernel_bytes == 0
    # the reference prices segment as one unpadded stream, below the
    # kernel plan on this matrix
    assert tcost.plan_cost(stats, tplan.ExecutionPlan(
        path="segment", nrhs=nrhs)).bytes < seg.bytes


def test_colorful_launches_grow_with_the_palette():
    stats = ttuner.stats_of(to_torch_csrc(jcsrc.fem_band(512, 24, seed=3)))
    greedy = tcost.card_plan_cost(stats, tplan.ExecutionPlan(
        path="colorful"))
    race = tcost.card_plan_cost(stats, tplan.ExecutionPlan(
        path="colorful", coloring="race"))
    assert race.launches == 1 + 12 * 4 < greedy.launches
    assert race.predicted_s < greedy.predicted_s
    ranked = tcost.rank_card_plans(stats, [
        tplan.ExecutionPlan(path="colorful"),
        tplan.ExecutionPlan(path="colorful", coloring="race")])
    assert ranked[0][0].coloring == "race"


def test_rank_card_plans_is_stable_on_ties():
    stats = ttuner.stats_of(to_torch_csrc(MATRICES["fem_band"]()))
    pool = ttuner.enumerate_plans(stats, nrhs_options=(1, 8))
    ranked = tcost.rank_card_plans(stats, pool)
    per_col = [e.predicted_s / p.nrhs for p, e in ranked]
    assert per_col == sorted(per_col)
    pos = {p: i for i, p in enumerate(pool)}
    for (p, _), (q, _), a, b in zip(ranked, ranked[1:], per_col,
                                    per_col[1:]):
        if a == b:
            assert pos[p] < pos[q]
    assert tcost.rank_card_plans(stats, pool[::-1]) != ranked


def test_calibrate_on_the_cpu_is_the_data_sheet():
    den = tcost.calibrate(CPU)
    assert den is tcost.DATA_SHEET and den.source == "data sheet"
    assert den.to_dict() == {"hbm_bw": tcost.HBM_BW,
                             "peak_flops": tcost.PEAK_FLOPS,
                             "launch_s": tcost.COLOR_LAUNCH_S,
                             "source": "data sheet"}
    slow = dataclasses.replace(den, hbm_bw=den.hbm_bw / 2)
    stats = ttuner.stats_of(to_torch_csrc(MATRICES["fem_band"]()))
    plan = tplan.ExecutionPlan(path="kernel")
    assert tcost.card_plan_cost(stats, plan, slow).memory_s == \
        pytest.approx(2 * tcost.card_plan_cost(stats, plan).memory_s)


@pytest.fixture(scope="module")
def tet16():
    mesh = tmesh.grid_tet(16)
    return (tscatter.build_assembly_schedule(mesh, 1),
            tmesh.synthetic_stiffness(mesh, 1, seed=0))


def test_card_assembly_cost_prices_k14_memory_bound_first(tet16):
    sched, _ = tet16
    ranked = tcost.rank_card_assembly_candidates(
        sched, tscatter.ASSEMBLY_CANDIDATES)
    priced = dict(ranked)
    onehot = priced[("colored", "onehot")]
    assert all(est.bound == "memory" for est in priced.values())
    assert ranked[0][0] == ("colored", "onehot")
    stream = priced[("colored", "stream")]
    assert stream.kernel_bytes == onehot.kernel_bytes
    assert stream.launches == 1 + sched.coloring.num_colors
    assert onehot.launches == 1
    # the reference formula still prices the TPU body compute-bound
    assert tcost.assembly_cost(sched, "colored", "onehot").bound == "compute"
    with pytest.raises(ValueError, match="serial"):
        tcost.card_assembly_cost(sched, "serial", "numpy")


def test_tune_assembly_measures_k14_and_records_denominators(tet16):
    sched, ke = tet16
    cache = ttuner.PlanCache()
    seen = []

    def measure(fn, k):
        out = fn(k)
        seen.append(out)
        return float(out.numel())

    res = tscatter.tune_assembly(sched, ke, cache=cache, measure=measure,
                                 device=CPU)
    assert "colored/onehot" in res.timings_s
    assert {k.split("/")[0] for k in res.timings_s} == {
        "colored", "sorted", "private"}
    want = tscatter.scatter_serial(sched, ke)
    for out in seen:
        np.testing.assert_array_equal(out.numpy(), want)
    rec = cache.get_assembly_plan("asmplan-" + sched.key())
    assert rec["denominators"] == tcost.DATA_SHEET.to_dict()
    assert res.predictions_s["colored/onehot"] == min(
        res.predictions_s.values())


def test_time_scatter_is_the_tuners_timer():
    calls = []
    t = tscatter._time_scatter(lambda k: calls.append(k), torch.zeros(3),
                               warmup=2, repeats=3)
    assert len(calls) == 5 and t >= 0.0
