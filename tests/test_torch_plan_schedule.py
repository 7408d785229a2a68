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
from repro_torch.core import blockell as tbe
from repro_torch.core import partition as tpart
from repro_torch.core import paths as tpaths
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import ops as tops

from test_torch_parity_helpers import (MATRICES, PACK_ARRAYS,
                                       assert_pack_equal, dyadic, dyadic_x,
                                       np32, to_torch_csrc)

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


# (tm, k_step_sublanes, values, indices) of the packs whose slot order the
# one-hot kernels K3/K4 rely on
PACK_SHAPES = [(128, 8, "float32", "int32"), (32, 2, "bfloat16", "int16"),
               (8, 1, "float32", "int16")]
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32, "int16": torch.int16}


def _reference_kernel_npz(path, tm, ks, vdt, idt):
    """A ``kernel``-path schedule npz written by the JAX package."""
    Mj = dyadic(MATRICES["fem_band"]())
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(
        path="kernel", tm=tm, k_step_sublanes=ks, index_dtype=idt,
        value_dtype=vdt))
    sj.save_npz(path)
    return sj


def _assert_slot_order(pack):
    rows = pack.row_in_win.to(torch.int64)
    assert bool((rows[:, 1:] >= rows[:, :-1]).all())
    real = pack.col_local.to(torch.int64) < pack.w_pad
    assert not bool((real[:, 1:] & ~real[:, :-1]).any())


@pytest.mark.parametrize("source", ["pack", "load_npz",
                                    "blockell_from_arrays"])
def test_rows_never_decrease_inside_a_tile(source, tmp_path):
    """K3/K4 find a window row's real slots as one run of the staged k-step:
    every rectangular pack built, loaded from a reference-written npz or
    converted keeps its rows non-decreasing inside each tile (so inside
    every k-step a plan may pick) and its padding after its real slots."""
    packs = []
    for tm, ks, vdt, idt in PACK_SHAPES:
        if source == "pack":
            packs += [tbe.pack(to_torch_csrc(make()), tm=tm, k_step=ks * 128,
                               dtype=_TORCH_DTYPES[vdt],
                               index_dtype=_TORCH_DTYPES[idt])
                      for make in MATRICES.values()]
        elif source == "load_npz":
            f = str(tmp_path / f"kernel_{tm}_{ks}.npz")
            _reference_kernel_npz(f, tm, ks, vdt, idt)
            packs.append(tsched.SpmvSchedule.load_npz(f).pack)
        else:
            f = str(tmp_path / f"kernel_{tm}_{ks}.npz")
            pj = _reference_kernel_npz(f, tm, ks, vdt, idt).pack
            packs.append(convert.blockell_from_arrays(
                n=pj.n, tm=pj.tm, nt=pj.nt, w_pad=pj.w_pad, s=pj.s,
                num_symmetric=pj.num_symmetric, pad_ratio=pj.pad_ratio,
                value_dtype=str(pj.vals_l.dtype),
                **{f: np32(getattr(pj, f)) for f in PACK_ARRAYS}))
    assert len(packs) >= 3
    for pack in packs:
        assert (pack.col_local == pack.w_pad).any()        # padding present
        _assert_slot_order(pack)


def _malformed(pj, defect):
    """The arrays of reference pack ``pj`` with one tile broken: its rows
    shuffled, or one padding slot (row W-1) moved in front of the real
    slots of the tile's last row W-1, its rows still non-decreasing."""
    arrays = {f: np32(getattr(pj, f)) for f in PACK_ARRAYS}
    rows, cols = arrays["row_in_win"], arrays["col_local"]
    last = (rows == pj.w_pad - 1) & (cols < pj.w_pad)
    t = int(np.flatnonzero(last.any(1) & (cols == pj.w_pad).any(1))[0])
    if defect == "rows_shuffled":
        perm = np.random.default_rng(0).permutation(pj.s)
    else:
        pad = int(np.flatnonzero(cols[t] == pj.w_pad)[0])
        at = int(np.flatnonzero(last[t])[0])
        perm = np.insert(np.delete(np.arange(pj.s), pad), at, pad)
    for f in ("row_in_win", "col_local", "vals_l", "vals_u"):
        arrays[f] = arrays[f].copy()
        arrays[f][t] = arrays[f][t][perm]
    decreasing = (np.diff(arrays["row_in_win"][t].astype(np.int64)) < 0)
    assert decreasing.any() == (defect == "rows_shuffled")
    return arrays


@pytest.mark.parametrize("defect", ["rows_shuffled", "padding_first"])
@pytest.mark.parametrize("source", ["blockell_from_arrays", "load_npz"])
def test_malformed_tile_raises_before_any_launch(source, defect, tmp_path):
    """A pack with one tile's rows shuffled, or a padding slot before a real
    one, raises ValueError where it is converted or loaded — on the CPU,
    before a kernel could take it.  The pack does not depend on the
    variant, so this guards K1 (whose warps sum runs of equal rows) as it
    guards K3/K4."""
    f = str(tmp_path / "kernel.npz")
    pj = _reference_kernel_npz(f, 32, 2, "float32", "int32").pack
    arrays = _malformed(pj, defect)
    match = "non-decreasing" if defect == "rows_shuffled" else "padding"
    with pytest.raises(ValueError, match=match):
        if source == "blockell_from_arrays":
            convert.blockell_from_arrays(
                n=pj.n, tm=pj.tm, nt=pj.nt, w_pad=pj.w_pad, s=pj.s,
                num_symmetric=pj.num_symmetric, pad_ratio=pj.pad_ratio,
                **arrays)
        else:
            with np.load(f) as z:
                saved = dict(z)
            saved.update({"pack_" + k: v for k, v in arrays.items()})
            np.savez(f, **saved)
            tsched.SpmvSchedule.load_npz(f)


def test_refresh_and_device_move_do_not_recheck_slot_order(monkeypatch):
    """The slot order is checked once, where the pack is built: a value
    refresh changes no index stream, and neither does ``.to()``."""
    import dataclasses
    calls = []
    check = tbe.check_slot_order
    monkeypatch.setattr(tbe, "check_slot_order",
                        lambda *a: calls.append(1) or check(*a))
    Mj = MATRICES["fem_band"]()
    pack = tbe.pack(to_torch_csrc(Mj), tm=32, k_step=256)
    assert len(calls) == 1
    Mt2 = to_torch_csrc(dataclasses.replace(Mj, al=np.asarray(Mj.al) * 2,
                                            au=np.asarray(Mj.au) * 2))
    refreshed = tbe.refresh_values(pack, Mt2)
    moved = refreshed.to("meta")
    assert moved.row_in_win.device.type == "meta"
    assert torch.equal(refreshed.row_in_win, pack.row_in_win)
    assert len(calls) == 1
