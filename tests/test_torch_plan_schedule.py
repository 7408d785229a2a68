"""Plans, fingerprints, digests, schedules and the plan cache of the port
held against the JAX package: keys and JSON byte for byte, and artifacts
written by one package loaded and executed by the other."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as jplan
from repro.core import schedule as jsched
from repro.core import tuner as jtuner
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import partition as tpart
from repro_torch.core import paths as tpaths
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import ops as tops

from test_torch_parity_helpers import (MATRICES, assert_pack_equal, dyadic,
                                       dyadic_x, to_torch_csrc)

PLAN_KW = [
    {},
    {"path": "kernel"},
    {"path": "kernel", "variant": "stream", "tm": 32, "k_step_sublanes": 2},
    {"path": "kernel", "index_dtype": "int16", "value_dtype": "bfloat16",
     "nrhs": 8},
    {"path": "kernel", "partition": "count", "accumulation": "halo"},
    {"path": "segment", "accumulation": "reduce_scatter", "nrhs": 3},
    {"path": "kernel", "strategy": "mesh", "mesh_p": 4, "variant": "stream"},
    {"path": "colorful", "coloring": "race"},
]


@pytest.mark.parametrize("kw", PLAN_KW, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_plan_key_dict_json_byte_identical(kw):
    pj, pt = jplan.ExecutionPlan(**kw), tplan.ExecutionPlan(**kw)
    assert pj.key() == pt.key()
    assert pj.to_dict() == pt.to_dict()
    assert pj.to_json() == pt.to_json()
    assert pj.k_step == pt.k_step
    assert tplan.ExecutionPlan.from_json(pj.to_json()) == pt
    assert convert.plan_from_dict(pj.to_dict()) == pt
    assert jplan.ExecutionPlan.from_json(pt.to_json()) == pj


def test_plan_validation_and_registry_names():
    assert tplan.PATHS == ["kernel", "segment", "colorful", "flat",
                           "nnzsplit"]
    assert [p.name for p in tpaths.registered_paths()] == [
        "segment", "kernel", "colorful", "flat", "nnzsplit"]
    for bad in ({"path": "mxu"}, {"tm": 0},
                {"variant": "mxu"}, {"index_dtype": "int8"},
                {"strategy": "local", "mesh_p": 2}, {"partition": "rows"}):
        with pytest.raises(ValueError):
            tplan.ExecutionPlan(**bad)
    assert tplan.kernel_window(128, 24) == jplan.kernel_window(128, 24) == 256
    assert tplan.feasible(tplan.ExecutionPlan(path="kernel"), n=10, m=10,
                          bandwidth=5000) is False
    assert tplan.feasible(tplan.ExecutionPlan(path="segment"), n=10, m=12,
                          bandwidth=5000) is True


@pytest.mark.parametrize("name", list(MATRICES))
def test_stats_fingerprint_digests_heuristic_equal(name):
    Mj = MATRICES[name]()
    Mt = to_torch_csrc(Mj)
    assert jtuner.stats_of(Mj).__dict__ == ttuner.stats_of(Mt).__dict__
    assert jtuner.fingerprint(Mj) == ttuner.fingerprint(Mt)
    assert jsched.value_digest(Mj) == tsched.value_digest(Mt)
    assert jsched.structure_digest(Mj) == tsched.structure_digest(Mt)
    hj = jtuner.heuristic_plan(jtuner.stats_of(Mj))
    ht = ttuner.heuristic_plan(ttuner.stats_of(Mt))
    assert hj.to_json() == ht.to_json()
    assert ht.variant == "onehot"             # the default serving body
    for kw in PLAN_KW[1:5]:
        assert (jsched.schedule_key("fp", "vd", jplan.ExecutionPlan(**kw), 8)
                == tsched.schedule_key("fp", "vd",
                                       tplan.ExecutionPlan(**kw), 8))


@pytest.mark.parametrize("name", ["fem_band", "fem_band_sym"])
def test_registry_candidates_equal(name):
    """The ``segment`` and ``kernel`` enumerators propose the reference's
    plans, in its order."""
    from repro.core import paths as jpaths
    Mj = MATRICES[name]()
    sj, st = jtuner.stats_of(Mj), ttuner.stats_of(to_torch_csrc(Mj))
    for path in ("segment", "kernel"):
        cj = jpaths.get_path(path).candidates(sj, jpaths.CandidateSpace())
        ct = tpaths.get_path(path).candidates(st, tpaths.CandidateSpace())
        assert [p.to_json() for p in cj] == [p.to_json() for p in ct]
        assert ct and all(tplan.feasible(p, n=st.n, m=st.m,
                                         bandwidth=st.bandwidth) for p in ct)


@pytest.mark.parametrize("partition", ["nnz", "count"])
@pytest.mark.parametrize("name", ["fem_band", "tail_tile", "poisson2d"])
def test_build_schedule_equal(name, partition):
    Mj = MATRICES[name]()
    kw = dict(path="kernel", tm=32, k_step_sublanes=2, partition=partition)
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(**kw), p=4)
    st = tsched.build_schedule(to_torch_csrc(Mj), tplan.ExecutionPlan(**kw),
                               p=4)
    assert sj.key() == st.key()
    assert (sj.fingerprint, sj.value_digest, sj.structure_digest, sj.p) == (
        st.fingerprint, st.value_digest, st.structure_digest, st.p)
    for f in ("starts", "eff_lo", "eff_hi", "nnz_per_part"):
        np.testing.assert_array_equal(getattr(sj.partition, f),
                                      getattr(st.partition, f))
    np.testing.assert_array_equal(sj.halo, st.halo)
    assert_pack_equal(sj.pack, st.pack)
    assert st.coloring is None and st.flat_pack is None


def test_partition_helpers():
    Mt = to_torch_csrc(MATRICES["fem_band"]())
    part = tpart.partition_rows_by_nnz(Mt, 4)
    assert part.p == 4 and part.rows(0)[0] == 0 and part.rows(3)[1] == Mt.n
    assert tpart.load_imbalance(part) >= 1.0
    assert len(tpart.halo_widths(part)) == 4
    assert tpart.interval_boundaries(part)[0] == 0


@pytest.mark.parametrize("dtypes", [("int32", "float32"),
                                    ("int16", "bfloat16")])
def test_schedule_npz_written_by_reference_loads_in_port(tmp_path, dtypes):
    Mj = dyadic(MATRICES["fem_band_sym"]())
    kw = dict(path="kernel", tm=32, k_step_sublanes=2, variant="stream",
              index_dtype=dtypes[0], value_dtype=dtypes[1])
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(**kw))
    f = str(tmp_path / "sched.npz")
    sj.save_npz(f)
    st = tsched.SpmvSchedule.load_npz(f)
    assert st.key() == sj.key() and st.plan.to_json() == sj.plan.to_json()
    assert_pack_equal(sj.pack, st.pack)
    Mt = to_torch_csrc(Mj)
    x = dyadic_x(Mj.n, 3, seed=1)
    before = dict(tsched.BUILD_COUNTS.items())
    op = tops.SpmvOperator.from_plan(Mt, st.plan, device="cpu", schedule=st)
    assert dict(tsched.BUILD_COUNTS.items()) == before       # nothing rebuilt
    yj = jops.SpmvOperator.from_plan(Mj, sj.plan, schedule=sj)(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(yj),
                                  op(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("dtypes", [("int32", "float32"),
                                    ("int16", "bfloat16")])
def test_schedule_npz_written_by_port_loads_in_reference(tmp_path, dtypes):
    Mj = dyadic(MATRICES["fem_band_sym"]())
    Mt = to_torch_csrc(Mj)
    kw = dict(path="kernel", tm=32, k_step_sublanes=2,
              index_dtype=dtypes[0], value_dtype=dtypes[1])
    st = tsched.build_schedule(Mt, tplan.ExecutionPlan(**kw))
    f = str(tmp_path / "sched.npz")
    st.save_npz(f)
    sj = jsched.SpmvSchedule.load_npz(f)
    assert sj.key() == st.key()
    assert_pack_equal(sj.pack, st.pack)
    x = dyadic_x(Mj.n, 1, seed=2)
    yj = jops.SpmvOperator.from_plan(Mj, sj.plan, schedule=sj)(jnp.asarray(x))
    yt = tops.SpmvOperator.from_plan(Mt, st.plan, device="cpu",
                                     schedule=st)(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def test_schedule_version_gate(tmp_path, monkeypatch):
    st = tsched.build_schedule(to_torch_csrc(MATRICES["fem_band"]()),
                               tplan.ExecutionPlan(path="segment"))
    f = str(tmp_path / "s.npz")
    st.save_npz(f)
    assert tsched.SCHEDULE_VERSION == jsched.SCHEDULE_VERSION == 6
    monkeypatch.setattr(tsched, "SCHEDULE_VERSION", 7)
    with pytest.raises(ValueError, match="version"):
        tsched.SpmvSchedule.load_npz(f)


def test_plan_cache_written_by_reference_serves_port(tmp_path):
    """Plan JSON + schedule npz layer written by the JAX package: the port
    re-registers the matrix with zero pack / partition work."""
    Mj = dyadic(MATRICES["fem_band"]())
    path = str(tmp_path / "plans.json")
    cj = jtuner.PlanCache(path)
    pj = jtuner.plan_for(Mj, cache=cj)
    opj = jops.SpmvOperator.from_plan(Mj, pj, cache=cj)
    Mt = to_torch_csrc(Mj)
    ct = ttuner.PlanCache(path)
    before = dict(tsched.BUILD_COUNTS.items())
    pt = ttuner.plan_for(Mt, cache=ct)
    assert (ct.hits, ct.misses) == (1, 0) and pt.to_json() == pj.to_json()
    opt = tops.SpmvOperator.from_plan(Mt, pt, device="cpu", cache=ct)
    assert dict(tsched.BUILD_COUNTS.items()) == before
    assert ct.schedule_hits == 1
    x = dyadic_x(Mj.n, 1, seed=3)
    np.testing.assert_array_equal(np.asarray(opj(jnp.asarray(x))),
                                  opt(torch.from_numpy(x)).numpy())


def test_plan_cache_written_by_port_serves_reference(tmp_path):
    Mj = dyadic(MATRICES["fem_band"]())
    Mt = to_torch_csrc(Mj)
    path = str(tmp_path / "plans.json")
    ct = ttuner.PlanCache(path)
    pt = ttuner.plan_for(Mt, cache=ct)
    tops.SpmvOperator.from_plan(Mt, pt, device="cpu", cache=ct)
    entry = json.load(open(path))["entries"][ttuner.fingerprint(Mt)]
    assert entry["measured"] is False
    assert {"python", "git_sha", "backend", "device_kind", "device_count",
            "torch", "cuda", "sm_count"} <= set(entry["env"])
    cj = jtuner.PlanCache(path)
    before = dict(jsched.BUILD_COUNTS.items())
    pj = jtuner.plan_for(Mj, cache=cj)
    assert pj.to_json() == pt.to_json() and cj.hits == 1
    opj = jops.SpmvOperator.from_plan(Mj, pj, cache=cj)
    assert dict(jsched.BUILD_COUNTS.items()) == before
    x = dyadic_x(Mj.n, 1, seed=4)
    A = np.asarray(jops.SpmvOperator(Mj, path="segment")(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(opj(jnp.asarray(x))), A)


def test_plan_for_caches_heuristic_and_refuses_autotune():
    Mt = to_torch_csrc(MATRICES["fem_band"]())
    cache = ttuner.PlanCache()
    p1 = ttuner.plan_for(Mt, cache=cache)
    p2 = ttuner.plan_for(Mt, cache=cache)
    assert p1 == p2 and (cache.hits, cache.misses, len(cache)) == (1, 1, 1)
    assert cache.get(ttuner.fingerprint(Mt), require_measured=True) is None
    with pytest.raises(NotImplementedError, match="tun"):
        ttuner.plan_for(Mt, autotune=True)


def test_schedule_for_refreshes_same_structure(tmp_path):
    import dataclasses
    Mj = MATRICES["fem_band"]()
    Mt = to_torch_csrc(Mj)
    Mt2 = to_torch_csrc(dataclasses.replace(
        Mj, al=np.asarray(Mj.al) * 2, au=np.asarray(Mj.au) * 2))
    plan = tplan.ExecutionPlan(path="kernel", tm=32, k_step_sublanes=2)
    cache = ttuner.PlanCache(str(tmp_path / "p.json"))
    s1 = tsched.schedule_for(Mt, plan, cache=cache)
    before = dict(tsched.BUILD_COUNTS.items())
    s2 = tsched.schedule_for(Mt2, plan, cache=cache)
    after = dict(tsched.BUILD_COUNTS.items())
    assert after["value_refresh"] == before.get("value_refresh", 0) + 1
    assert after["pack"] == before["pack"]
    assert after["partition"] == before["partition"]
    assert s2.structure_digest == s1.structure_digest
    assert s2.value_digest != s1.value_digest
    assert list(cache.schedules) == [s2.key()]     # superseded generation
    assert tsched.schedule_for(Mt2, plan, cache=cache) is s2
