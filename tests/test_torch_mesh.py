"""The mesh layer of the port held against the JAX package on the CPU: the
six shard layouts array for array, the padded flat steps, cache keys, the
mesh-aware enumeration and heuristic, the collective-bytes model and
shard-layout npz files across the two packages; each shard's partial
against the JAX package's shard-local function on the same slice; every
strategy against the dense float64 oracle; value refresh, memo and cache
hits; serving, tuning and CG through a mesh of p shards emulated on the
CPU (``ShardMesh(p, "cpu")``).

The JAX package's own sharded builders fail under the installed jax
(ROADMAP C1), so the reference is its host-side layout builders and its
shard-local function (Pallas in interpret mode) called on ``arr[t:t+1]``
outside any mesh; the whole product is held against the dense oracle.  Dyadic values make
float32 sums exact in any order, so the comparisons are
``assert_array_equal``.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import csrc as jcsrc
from repro.core import distributed as jdist
from repro.core import partition as jpart
from repro.core import paths as jpaths
from repro.core import schedule as jsched
from repro.core import tuner as jtuner
from repro.core.plan import ExecutionPlan as JPlan
from repro.kernels import csrc_spmv_flat as jflat
from repro_torch import convert
from repro_torch.core import distributed as tdist
from repro_torch.core import partition as tpart
from repro_torch.core import paths as tpaths
from repro_torch.core import schedule as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import csrc_spmv_flat as tflat
from repro_torch.kernels import csrc_spmv_nnzsplit as tnz
from repro_torch.serve import (LocalExecutor, MeshExecutor, SpmvResult,
                               SpmvServingEngine)
from repro_torch.serve import placement

from test_torch_parity_helpers import dyadic, dyadic_x, np32, to_torch_csrc

CPU = "cpu"
PS = (1, 2, 4, 8)
STRUCTURAL_KEYS = ("pack", "flat_pack", "nnzsplit_pack", "partition",
                   "coloring", "schedule", "sharded_slots", "halo_layout",
                   "flat_shards", "flat_halo", "nnzsplit_shards",
                   "nnzsplit_halo")
PART_FIELDS = ("starts", "eff_lo", "eff_hi", "nnz_per_part")

# name -> JAX-package matrix factory (dyadic values)
MATRICES = {
    "band": lambda: dyadic(jcsrc.fem_band(512, 8, seed=1)),
    "band_sym": lambda: dyadic(jcsrc.fem_band(512, 8, seed=4,
                                              numeric_symmetric=True)),
    "skew": lambda: dyadic(jcsrc.skewed_band(512, 24, 3, seed=2)),
    "powerlaw": lambda: dyadic(jcsrc.powerlaw_laplacian(1024, seed=3)),
    "random": lambda: dyadic(jcsrc.random_symmetric_pattern(2048, 6,
                                                            seed=5)),
}
_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        Mj = MATRICES[name]()
        _CACHE[name] = (Mj, to_torch_csrc(Mj))
    return _CACHE[name]


def _builds(fn):
    """Run fn; return (result, the build counters that moved)."""
    before = dict(tsched.BUILD_COUNTS.items())
    out = fn()
    after = dict(tsched.BUILD_COUNTS.items())
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def _ref_fields(lay):
    """A JAX-package layout's fields as convert takes them (numpy)."""
    out = {}
    for f in dataclasses.fields(lay):
        v = getattr(lay, f.name)
        if f.name == "part":
            out["part"] = {k: np.asarray(getattr(v, k)) for k in PART_FIELDS}
        elif isinstance(v, (bool, int, float)):
            out[f.name] = v
        else:
            out[f.name] = np32(v)
    return out


def _value_dtype(lay) -> str:
    return ("bfloat16" if any(str(getattr(getattr(lay, f.name), "dtype", ""))
                              == "bfloat16"
                              for f in dataclasses.fields(lay))
            else "float32")


def assert_layout_equal(lj, lt):
    """Field for field: scalars equal, arrays equal with equal dtypes (the
    port's streams compared in the JAX package's shapes)."""
    assert [f.name for f in dataclasses.fields(lj)] == \
        [f.name for f in dataclasses.fields(lt)]
    shapes = lt.reference_shapes()
    for f in dataclasses.fields(lj):
        a, b = getattr(lj, f.name), getattr(lt, f.name)
        if f.name == "part":
            for k in PART_FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                              np.asarray(getattr(b, k)))
        elif isinstance(a, (bool, int, float)):
            assert a == b, f.name
        else:
            bt = np32(b)
            bt = bt.reshape(shapes[f.name]) if f.name in shapes else bt
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), \
                (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(np32(a), bt, err_msg=f.name)


def _layouts(name, kind, p, plan_kw=None):
    """(JAX-package layout, port layout) of one kind, built from scratch."""
    Mj, Mt = _pair(name)
    kw = dict(tm=32, **(plan_kw or {}))
    if kind == "sharded_slots":
        return (jsched.build_sharded_slots(Mj, jpart.partition_rows_by_nnz(
                    Mj, p)),
                tsched.build_sharded_slots(Mt, tpart.partition_rows_by_nnz(
                    Mt, p)))
    if kind == "halo":
        return jsched.build_halo_layout(Mj, p), tsched.build_halo_layout(Mt, p)
    path = kind.split("_")[0]
    if kind.endswith("_shards"):
        return (jsched.build_path_shards(
                    Mj, jpart.partition_rows_by_nnz(Mj, p),
                    JPlan(path=path, **kw)),
                tsched.build_path_shards(
                    Mt, tpart.partition_rows_by_nnz(Mt, p),
                    ExecutionPlan(path=path, **kw)))
    return (jsched.build_path_halo(Mj, p, JPlan(path=path, **kw)),
            tsched.build_path_halo(Mt, p, ExecutionPlan(path=path, **kw)))


LAYOUT_CASES = (
    [("band", kind, p) for kind in ("sharded_slots", "halo", "flat_shards",
                                    "flat_halo", "nnzsplit_shards",
                                    "nnzsplit_halo") for p in PS]
    + [("skew", kind, p) for kind in ("flat_shards", "flat_halo")
       for p in (2, 4)]
    + [("band_sym", kind, 4) for kind in ("flat_shards", "nnzsplit_halo")]
    + [(name, kind, p) for name in ("powerlaw", "random")
       for kind in ("sharded_slots", "nnzsplit_shards") for p in (2, 8)])


@pytest.mark.parametrize("name,kind,p", LAYOUT_CASES)
def test_layouts_equal_reference(name, kind, p):
    lj, lt = _layouts(name, kind, p)
    assert_layout_equal(lj, lt)
    # the JAX package's layout handed over as numpy becomes the port's
    back = convert.shard_layout_from_arrays(kind, value_dtype=_value_dtype(lj),
                                            **_ref_fields(lj))
    assert type(back) is type(lt)
    assert_layout_equal(lj, back)


@pytest.mark.parametrize("kind", ["flat_shards", "flat_halo",
                                  "nnzsplit_shards", "nnzsplit_halo"])
def test_narrow_layouts_equal_reference(kind):
    """bf16 value streams and int16 index streams, array for array."""
    lj, lt = _layouts("band_sym", kind, 4,
                      dict(value_dtype="bfloat16", index_dtype="int16"))
    assert_layout_equal(lj, lt)
    assert lt.ad.dtype == torch.bfloat16
    back = convert.shard_layout_from_arrays(kind, value_dtype="bfloat16",
                                            **_ref_fields(lj))
    assert_layout_equal(lj, back)


@pytest.mark.parametrize("kind", ["halo", "flat_halo", "nnzsplit_halo"])
@pytest.mark.parametrize("name", ["powerlaw", "random"])
def test_halo_gate_raises_like_reference(name, kind):
    with pytest.raises(ValueError, match="exceeds shard rows"):
        _layouts(name, kind, 8)[0]
    with pytest.raises(ValueError, match="exceeds shard rows"):
        Mt = _pair(name)[1]
        if kind == "halo":
            tsched.build_halo_layout(Mt, 8)
        else:
            tsched.build_path_halo(Mt, 8, ExecutionPlan(
                path=kind.split("_")[0], tm=32))


@pytest.mark.parametrize("pad", [0, 1, 7])
def test_flat_arrays_pad_steps_to_equal_reference(pad):
    Mj, Mt = _pair("skew")
    ros = np.asarray(jcsrc.row_of_slot(Mj))
    args = (ros, np.asarray(Mj.ja), np.asarray(Mj.al), np.asarray(Mj.au))
    kw = dict(nt=16, tm=32, w_pad=128, step=128)
    *_, total = jflat._flat_arrays(*args, **kw)
    want = jflat._flat_arrays(*args, **kw, pad_steps_to=total + pad)
    got = tflat._flat_arrays(*args, **kw, pad_steps_to=total + pad)
    assert got[-1] == want[-1] == total
    for a, b in zip(want[:-1], got[:-1]):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b)
    with pytest.raises(ValueError):
        tflat._flat_arrays(*args, **kw, pad_steps_to=total - 1)


def test_shard_layout_keys_equal_reference():
    Mj, Mt = _pair("band")
    fp = jtuner.fingerprint(Mj)
    assert ttuner.fingerprint(Mt) == fp
    assert tsched.value_digest(Mt) == jsched.value_digest(Mj)
    for geo in ((), (32, 8, 4096, "int32", "float32", 0, 128, 512)):
        assert (tsched.shard_layout_key("flat_shards", fp, "d", 4, geo)
                == jsched.shard_layout_key("flat_shards", fp, "d", 4, geo))
    for path in ("flat", "nnzsplit"):
        plan_j, plan_t = JPlan(path=path), ExecutionPlan(path=path)
        assert (tpaths.get_path(path).shard_support.geometry(plan_t)
                == jpaths.get_path(path).shard_support.geometry(plan_j))
    assert ttuner.mesh_fingerprint(fp, 8) == jtuner.mesh_fingerprint(fp, 8)
    assert set(tsched._layout_kinds()) == set(jsched._layout_kinds())


MESH_ENUM = {
    "band": lambda: jcsrc.fem_band(512, 8, seed=1),
    "narrow_band": lambda: jcsrc.fem_band(4096, 1, seed=1),
    "wide_band": lambda: jcsrc.fem_band(64, 32, seed=0),
    "skew": lambda: jcsrc.skewed_band(512, 24, 3, seed=2),
    "powerlaw": lambda: jcsrc.powerlaw_laplacian(1024, seed=3),
    "rectangular": lambda: jcsrc.rectangular_fem(64, 16, 4, seed=5),
}


@pytest.mark.parametrize("p", [1, 4, 8, 64])
@pytest.mark.parametrize("name", list(MESH_ENUM))
def test_mesh_plans_and_collective_bytes_equal_reference(name, p):
    Mj = MESH_ENUM[name]()
    Mt = to_torch_csrc(Mj)
    sj, st = jtuner.stats_of(Mj), ttuner.stats_of(Mt)
    for kw in ({}, {"nrhs_options": (1, 8)}):
        want = jtuner.enumerate_mesh_plans(sj, p, **kw)
        got = ttuner.enumerate_mesh_plans(st, p, **kw)
        assert [q.to_json() for q in got] == [q.to_json() for q in want]
    if Mj.n == Mj.m:
        assert (ttuner.heuristic_mesh_plan(st, p).to_json()
                == jtuner.heuristic_mesh_plan(sj, p).to_json())
    else:
        with pytest.raises(ValueError):
            ttuner.heuristic_mesh_plan(st, p)
    for acc in tdist.STRATEGIES:
        for r in (1, 3):
            assert (tdist.collective_bytes_estimate(Mt, p, acc, nrhs=r)
                    == jdist.collective_bytes_estimate(Mj, p, acc, nrhs=r))


@pytest.mark.parametrize("kind", ["sharded_slots", "halo", "flat_shards",
                                  "flat_halo", "nnzsplit_shards",
                                  "nnzsplit_halo"])
def test_shard_layout_npz_cross_loads(tmp_path, kind):
    lj, lt = _layouts("band", kind, 4)
    f_t, f_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tsched.save_shard_layout_npz(f_t, lt)
    jsched.save_shard_layout_npz(f_j, lj)
    assert_layout_equal(jsched.load_shard_layout_npz(f_t), lt)
    assert_layout_equal(lj, tsched.load_shard_layout_npz(f_j))
    assert_layout_equal(lj, tsched.load_shard_layout_npz(f_t))


@pytest.mark.parametrize("kind", ["flat_halo", "nnzsplit_shards"])
def test_bf16_shard_layout_npz_keeps_dtype(tmp_path, kind):
    lj, lt = _layouts("band_sym", kind, 2, dict(value_dtype="bfloat16"))
    f_t, f_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tsched.save_shard_layout_npz(f_t, lt)
    jsched.save_shard_layout_npz(f_j, lj)
    for f in (f_t, f_j):
        back = tsched.load_shard_layout_npz(f)
        assert back.ad.dtype == torch.bfloat16
        assert_layout_equal(lj, back)
    assert str(jsched.load_shard_layout_npz(f_t).ad.dtype) == "bfloat16"


def test_shard_layout_npz_version_gate(tmp_path):
    _, lt = _layouts("band", "sharded_slots", 4)
    f = str(tmp_path / "lay.npz")
    tsched.save_shard_layout_npz(f, lt)
    ver = tsched.SHARD_LAYOUT_VERSION
    try:
        tsched.SHARD_LAYOUT_VERSION = ver + 1
        with pytest.raises(ValueError):
            tsched.load_shard_layout_npz(f)
    finally:
        tsched.SHARD_LAYOUT_VERSION = ver


# ---------------------------------------------------------------------------
# Products: each shard's partial, and the whole against the dense oracle
# ---------------------------------------------------------------------------

def _ref_local(lj, kind, t, xj):
    """The JAX package's shard-local product of shard t, outside a mesh."""
    sup = jpaths.get_path(kind.split("_")[0]).shard_support
    n_local = (sup.halo_dims(lj)[2] if kind.endswith("_halo") else lj.n)
    fn = sup.local_fn(lj, n_local, True)
    return np.asarray(fn(*[a[t:t + 1] for a in sup.shard_arrays(lj)], xj))


@pytest.mark.parametrize("kind", ["flat_shards", "flat_halo",
                                  "nnzsplit_shards", "nnzsplit_halo"])
def test_shard_partials_equal_reference_local_fn(kind):
    lj, lt = _layouts("band", kind, 4)
    sup = tpaths.get_path(kind.split("_")[0]).shard_support
    n_local = (sup.halo_dims(lt)[2] if kind.endswith("_halo") else lt.n)
    fns = {v: sup.local_fn(lt, n_local, v) for v in ("stream", "onehot")}
    for t in range(lt.p):
        for nrhs in (1, 3):
            x = dyadic_x(n_local, nrhs, seed=10 * t + nrhs)
            want = _ref_local(lj, kind, t, jnp.asarray(x))
            for v, fn in fns.items():
                got = fn(t, torch.from_numpy(x)).numpy()
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{v} shard {t}")


PRODUCT_CASES = (
    [("band", path, acc, p) for path in ("segment", "flat", "nnzsplit")
     for acc in tdist.STRATEGIES for p in PS]
    + [("skew", "flat", acc, p) for acc in tdist.STRATEGIES for p in (2, 8)]
    + [("powerlaw", path, acc, p) for path in ("segment", "nnzsplit")
       for acc in ("allreduce", "reduce_scatter") for p in (2, 8)])


@pytest.mark.parametrize("name,path,acc,p", PRODUCT_CASES)
def test_every_strategy_equals_dense_oracle(name, path, acc, p):
    Mj, Mt = _pair(name)
    A = np.asarray(jcsrc.to_dense(Mj), np.float64)
    mesh = tdist.ShardMesh(p, CPU)
    for variant in ("stream", "onehot"):
        plan = ExecutionPlan(path=path, tm=32, variant=variant,
                             strategy="mesh", mesh_p=p, accumulation=acc)
        fn = tdist.build_sharded_spmv(Mt, mesh, plan=plan)
        assert fn.strategy == acc and fn.p == p
        for nrhs in (1, 3):
            x = dyadic_x(Mt.n, nrhs, seed=nrhs)
            y = fn(torch.from_numpy(x))
            rows = fn.n_pad if acc == "reduce_scatter" else Mt.n
            assert y.shape[0] == rows and y.dtype == torch.float32
            want = (A @ x.astype(np.float64)).astype(np.float32)
            np.testing.assert_array_equal(y[:Mt.n].numpy(), want)


def test_auto_strategy_and_halo_gate():
    _, Mt = _pair("band")
    assert tdist.build_sharded_spmv(Mt, tdist.ShardMesh(4, CPU)
                                    ).strategy == "halo"
    _, Mp = _pair("powerlaw")
    mesh = tdist.ShardMesh(8, CPU)
    assert tdist.build_sharded_spmv(Mp, mesh).strategy == "reduce_scatter"
    with pytest.raises(ValueError, match="exceeds shard rows"):
        tdist.build_sharded_spmv(Mp, mesh, strategy="halo")
    with pytest.raises(ValueError, match="unknown strategy"):
        tdist.build_sharded_spmv(Mt, mesh, strategy="ring")
    with pytest.raises(ValueError):
        tdist.ShardMesh(0, CPU)
    with pytest.raises(ValueError):
        tdist.ShardMesh(2, CPU, backend="process_group")   # no group


@pytest.mark.parametrize("path,plain", [
    ("flat", ("flat_windows_stream_plain", "flat_windows_onehot_plain")),
    ("nnzsplit", ("nnzsplit_partials_stream_plain",
                  "nnzsplit_partials_onehot_plain"))])
def test_variant_reaches_its_own_plain_version(monkeypatch, path, plain):
    """ROADMAP C2: the shard-local product runs the plan's variant (the JAX
    package runs one-hot whatever the plan says)."""
    mod = tflat if path == "flat" else tnz
    calls = []
    for name in plain:
        orig = getattr(mod, name)

        def spy(*a, _name=name, _orig=orig):
            calls.append(_name)
            return _orig(*a)
        monkeypatch.setattr(mod, name, spy)
    _, Mt = _pair("band")
    x = torch.from_numpy(dyadic_x(Mt.n, 1))
    for variant, want in zip(("stream", "onehot"), plain):
        for acc in ("allreduce", "halo"):
            calls.clear()
            plan = ExecutionPlan(path=path, tm=32, variant=variant,
                                 strategy="mesh", mesh_p=2,
                                 accumulation=acc)
            tdist.build_sharded_spmv(Mt, tdist.ShardMesh(2, CPU),
                                     plan=plan)(x)
            assert calls == [want, want], (variant, acc, calls)


def test_unbalanced_partition_long_inert_tail():
    """A partition with three one-row shards: their packs are nearly all
    inert trailing steps, which the derived step count ends before; the
    product is still the oracle's."""
    Mj, Mt = _pair("skew")
    starts = np.array([0, 1, 2, 3, Mt.n])
    fs = tflat.pack_flat_shards(Mt, starts, tm=128, ks=1)
    for t in range(3):
        pk = fs.shard_pack(t)
        # one step per tile, then the inert tail
        assert int(pk.step_start[-1]) == fs.nt < fs.steps // 2
    assert int(fs.shard_pack(3).step_start[-1]) == fs.steps
    fn = tflat.flat_local_fn(fs, Mt.n, "stream")
    A = np.asarray(jcsrc.to_dense(Mj), np.float64)
    x = dyadic_x(Mt.n, 3, seed=2)
    y = sum(fn(t, torch.from_numpy(x)) for t in range(4)).numpy()
    np.testing.assert_array_equal(y, (A @ x).astype(np.float32))
    # a tail that carries a value is refused
    bad = dataclasses.replace(fs, vals_l=fs.vals_l.clone())
    bad.vals_l[0, -1, 0] = 1.0
    with pytest.raises(ValueError, match="inert trailing steps"):
        bad.shard_pack(0)


# ---------------------------------------------------------------------------
# Value refresh and the memo / cache layers
# ---------------------------------------------------------------------------

def _scaled(Mt, s):
    return dataclasses.replace(Mt, ad=Mt.ad * s, al=Mt.al * s, au=Mt.au * s,
                               ar=Mt.ar * s)


@pytest.mark.parametrize("kind", ["sharded_slots", "halo", "flat_shards",
                                  "flat_halo", "nnzsplit_shards",
                                  "nnzsplit_halo"])
def test_refresh_equals_fresh_layout_without_structural_builds(kind):
    _, Mt = _pair("skew")
    M2 = _scaled(Mt, 3.0)
    part = tpart.partition_rows_by_nnz(Mt, 4)
    path = kind.split("_")[0]
    plan = ExecutionPlan(path=path, tm=32) if path in tpaths._REGISTRY \
        else None

    def build(M):
        if kind == "sharded_slots":
            return tsched.build_sharded_slots(M, part)
        if kind == "halo":
            return tsched.build_halo_layout(M, 4)
        if kind.endswith("_shards"):
            return tsched.build_path_shards(M, part, plan)
        return tsched.build_path_halo(M, 4, plan)

    lay = build(Mt)
    refreshed, d = _builds(lambda: tsched.refresh_shard_layout(lay, M2,
                                                               part=part))
    assert d == {"shard_value_refresh": 1}, d
    fresh = build(M2)
    assert type(refreshed) is type(fresh)
    for f in dataclasses.fields(fresh):
        a, b = getattr(refreshed, f.name), getattr(fresh, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
    if kind.endswith("_shards"):
        with pytest.raises(ValueError, match="row partition"):
            tsched.refresh_shard_layout(lay, M2)


def test_memo_and_cache_hits(tmp_path):
    _, Mt = _pair("band")
    plan = ExecutionPlan(path="flat", tm=32, strategy="mesh", mesh_p=4,
                         accumulation="allreduce")
    part = tpart.partition_rows_by_nnz(Mt, 4)
    tsched.clear_shard_layout_memos()
    first, d = _builds(lambda: tsched.build_path_shards(Mt, part, plan))
    assert d == {"flat_shards": 1}
    again, d = _builds(lambda: tsched.build_path_shards(Mt, part, plan))
    assert again is first and d == {}
    cache = ttuner.PlanCache(str(tmp_path / "plans.json"))
    _, d = _builds(lambda: tsched.build_path_shards(Mt, part, plan,
                                                    cache=cache))
    assert d == {} and len(cache.shard_layouts) == 1       # shipped
    tsched.clear_shard_layout_memos()
    cache2 = ttuner.PlanCache(str(tmp_path / "plans.json"))
    loaded, d = _builds(lambda: tsched.build_path_shards(Mt, part, plan,
                                                         cache=cache2))
    assert d == {} and cache2.shard_layout_hits == 1
    for f in ("vals_l", "col_local", "tile_of_step", "ad"):
        assert torch.equal(getattr(loaded, f), getattr(first, f))


@pytest.mark.parametrize("acc,path", [("reduce_scatter", "segment"),
                                      ("halo", "segment"),
                                      ("allreduce", "flat"),
                                      ("halo", "nnzsplit")])
def test_mesh_executor_ships_through_npz(tmp_path, acc, path):
    """A fresh process (a new PlanCache on the same file and cleared
    memos) constructs the mesh executor with zero structural work."""
    _, Mt = _pair("band")
    plan = ExecutionPlan(path=path, tm=32, strategy="mesh", mesh_p=4,
                         accumulation=acc)
    f = str(tmp_path / "plans.json")
    mesh = tdist.ShardMesh(4, CPU)
    ex = MeshExecutor(Mt, plan, mesh=mesh, cache=ttuner.PlanCache(f))
    x = torch.from_numpy(dyadic_x(Mt.n, 2))
    y = ex(x)
    tsched.clear_shard_layout_memos()
    ex2, d = _builds(lambda: MeshExecutor(Mt, plan, mesh=mesh,
                                          cache=ttuner.PlanCache(f)))
    assert d == {}, d
    assert torch.equal(ex2(x), y)


# ---------------------------------------------------------------------------
# Executors, placement and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("acc", ["allreduce", "reduce_scatter", "halo"])
def test_mesh_executor_bit_identical_to_local_p1(acc):
    M = to_torch_csrc(dyadic(jcsrc.fem_band(96, 4, seed=2)))
    local = LocalExecutor(M, ExecutionPlan(path="segment"), device=CPU)
    mesh = MeshExecutor(M, ExecutionPlan(path="segment", strategy="mesh",
                                         mesh_p=1, accumulation=acc),
                        device=CPU)
    assert mesh.device == torch.device(CPU) and mesh.kind == "mesh"
    for nrhs in (1, 3, 8):
        x = torch.from_numpy(dyadic_x(M.m, nrhs, seed=nrhs))
        assert torch.equal(local(x), mesh(x)), (acc, nrhs)


def test_mesh_engine_register_step_update_values():
    """The serving loop through MeshExecutor on four emulated shards:
    answers equal to the local engine's, metadata, no structural rebuild
    on re-register, the value-refresh probe on update_values."""
    Mj = dyadic(jcsrc.fem_band(200, 6, seed=3))
    M = to_torch_csrc(Mj)
    mesh_plan = ExecutionPlan(path="flat", tm=32, strategy="mesh", mesh_p=4,
                              accumulation="reduce_scatter",
                              variant="stream")
    eng = SpmvServingEngine(cache=ttuner.PlanCache(), mesh_p=4,
                            mesh=tdist.ShardMesh(4, CPU))
    oracle = SpmvServingEngine(cache=ttuner.PlanCache(), device=CPU)
    assert eng.device == torch.device(CPU)
    eng.register("m", M, plan=mesh_plan)
    oracle.register("m", M, plan=ExecutionPlan(path="segment"))
    assert eng.executor("m").kind == "mesh"
    xs = [dyadic_x(M.m, 1, seed=i) for i in range(3)]
    uids = [eng.submit("m", x) for x in xs]
    uids_o = [oracle.submit("m", x) for x in xs]
    out, out_o = eng.run_until_drained(), oracle.run_until_drained()
    for u, uo in zip(uids, uids_o):
        assert isinstance(out[u], SpmvResult)
        np.testing.assert_array_equal(np.asarray(out[u]),
                                      np.asarray(out_o[uo]))
        assert (out[u].executor, out[u].strategy, out[u].mesh_p,
                out[u].path, out[u].batched) == ("mesh", "mesh", 4, "flat",
                                                 3)
        assert out[u].plan_key == mesh_plan.key()
    _, d = _builds(lambda: eng.register("m2", M, plan=mesh_plan))
    assert d == {}, d
    M2 = _scaled(M, 2.0)
    _, d = _builds(lambda: eng.update_values("m", M2))
    assert d.get("shard_value_refresh") == 1, d
    assert not any(d.get(k) for k in STRUCTURAL_KEYS), d
    u = eng.submit("m", xs[0])
    A2 = 2.0 * np.asarray(jcsrc.to_dense(Mj), np.float64)
    np.testing.assert_array_equal(np.asarray(eng.step()[u]),
                                  (A2 @ xs[0]).astype(np.float32))


@pytest.mark.parametrize("acc", ["reduce_scatter", "halo"])
def test_mesh_update_values_rejects_structure_change(acc):
    M = to_torch_csrc(jcsrc.fem_band(96, 4, seed=2))
    other = to_torch_csrc(jcsrc.fem_band(96, 4, seed=9))
    ex = MeshExecutor(M, ExecutionPlan(path="segment", strategy="mesh",
                                       mesh_p=2, accumulation=acc),
                      mesh=tdist.ShardMesh(2, CPU))
    with pytest.raises(ValueError, match="structure differs"):
        ex.update_values(other)


def test_placement_falls_back_to_local_without_devices():
    """A mesh width the device count cannot satisfy, with no mesh given,
    degrades to the local plan (the CPU counts one device)."""
    assert placement.device_count(CPU) == 1
    assert placement.mesh_available(1, CPU)
    assert not placement.mesh_available(8, CPU)
    M = to_torch_csrc(jcsrc.fem_band(80, 4, seed=2))
    eng = SpmvServingEngine(cache=ttuner.PlanCache(), mesh_p=8, device=CPU)
    plan = eng.register("m", M)
    assert plan.strategy == "local"
    assert eng.executor("m").kind == "local"
    # ... and an emulated mesh opts in
    eng = SpmvServingEngine(cache=ttuner.PlanCache(), mesh_p=8,
                            mesh=tdist.ShardMesh(8, CPU))
    plan = eng.register("m", M)
    assert plan.strategy == "mesh" and plan.mesh_p == 8
    assert eng.executor("m").kind == "mesh"


def test_a_device_count_alone_never_builds_a_wide_mesh(monkeypatch):
    """Eight devices in the count do not make an eight-shard mesh: without
    ``mesh=`` the request degrades to local and the executor and the mesh
    tuner refuse, instead of piling eight shards on one device."""
    monkeypatch.setattr(placement, "device_count", lambda device=None: 8)
    assert placement.mesh_available(1, CPU)
    assert not placement.mesh_available(8, CPU)
    M = to_torch_csrc(jcsrc.fem_band(80, 4, seed=2))
    eng = SpmvServingEngine(cache=ttuner.PlanCache(), mesh_p=8, device=CPU)
    assert eng.register("m", M).strategy == "local"
    plan = ExecutionPlan(path="segment", strategy="mesh", mesh_p=8,
                         accumulation="halo")
    with pytest.raises(ValueError, match="one device per shard"):
        MeshExecutor(M, plan, device=CPU)
    with pytest.raises(ValueError, match="one device per shard"):
        ttuner.tune_mesh(M, 8, device=CPU, measure=lambda fn, x: 1.0)
    # one shard on the one device a process drives needs no mesh
    one = MeshExecutor(M, dataclasses.replace(plan, mesh_p=1), device=CPU)
    assert one.mesh.p == 1 and one.mesh.device == torch.device("cpu")


def test_mesh_executor_requires_devices_or_a_mesh():
    M = to_torch_csrc(jcsrc.fem_band(80, 4, seed=2))
    plan = ExecutionPlan(path="segment", strategy="mesh", mesh_p=8,
                         accumulation="halo")
    with pytest.raises(ValueError, match="devices"):
        MeshExecutor(M, plan, device=CPU)
    with pytest.raises(ValueError, match="shards"):
        MeshExecutor(M, plan, mesh=tdist.ShardMesh(4, CPU))
    with pytest.raises(ValueError, match="strategy='mesh'"):
        MeshExecutor(M, ExecutionPlan(path="segment"), device=CPU)


def test_placement_falls_back_to_local_for_rectangular():
    Mj = jcsrc.rectangular_fem(64, 16, 4, seed=5)
    M = to_torch_csrc(Mj)
    eng = SpmvServingEngine(cache=ttuner.PlanCache(), mesh_p=1,
                            mesh=tdist.ShardMesh(1, CPU))
    plan = eng.register("r", M)
    assert plan.strategy == "local" and eng.executor("r").kind == "local"
    x = np.random.default_rng(0).standard_normal(M.m).astype(np.float32)
    u = eng.submit("r", x)
    np.testing.assert_allclose(
        eng.step()[u], np.asarray(jcsrc.to_dense(Mj), np.float64) @ x,
        rtol=1e-5, atol=1e-5)


def test_mesh_plan_for_heuristic_is_cached():
    Mj = jcsrc.fem_band(256, 4, seed=1)
    M = to_torch_csrc(Mj)
    cache = ttuner.PlanCache()
    plan = ttuner.mesh_plan_for(M, 8, cache=cache)
    assert plan.to_json() == jtuner.mesh_plan_for(
        Mj, 8, cache=jtuner.PlanCache()).to_json()
    assert plan.strategy == "mesh" and plan.accumulation == "halo"
    hits = cache.hits
    assert ttuner.mesh_plan_for(M, 8, cache=cache) == plan
    assert cache.hits == hits + 1
    assert ttuner.plan_for(M, cache=cache).strategy == "local"


def _measure_first_wins():
    calls = []

    def measure(fn, x):
        calls.append(fn.strategy)
        return 1.0 + len(calls) * 1e-3
    return measure, calls


@pytest.mark.parametrize("p", [1, 4])
def test_tune_mesh_records_per_p_winner(p):
    Mj = jcsrc.fem_band(128, 4, seed=2)
    M = to_torch_csrc(Mj)
    cache = ttuner.PlanCache()
    measure, calls = _measure_first_wins()
    mesh = tdist.ShardMesh(p, CPU)
    res = ttuner.tune_mesh(M, p, cache=cache, mesh=mesh, measure=measure)
    cands = jtuner.enumerate_mesh_plans(jtuner.stats_of(Mj), p)
    assert list(res.timings_s) == [c.key() for c in cands]
    assert res.plan.to_json() == cands[0].to_json()
    assert set(calls) == {"halo", "reduce_scatter", "allreduce"}
    fp = ttuner.mesh_fingerprint(ttuner.fingerprint(M), p)
    assert res.fingerprint == fp and cache.entries[fp]["measured"]
    assert cache.shard_layouts           # the winner's layout shipped
    calls.clear()
    res2 = ttuner.tune_mesh(M, p, cache=cache, mesh=mesh, measure=measure)
    assert res2.cached and not calls and res2.plan == res.plan


def test_tune_mesh_ps_through_tune():
    M = to_torch_csrc(jcsrc.fem_band(128, 4, seed=2))
    cache = ttuner.PlanCache()
    res = ttuner.tune(M, cache=cache, device=CPU, predict=False,
                      measure=lambda op, x: 1.0, mesh_ps=(1,))
    assert res.plan.strategy == "local"
    assert res.mesh_plans[1].mesh_p == 1
    fp = ttuner.mesh_fingerprint(ttuner.fingerprint(M), 1)
    assert cache.get(fp, require_measured=True) is not None
    # a measured local entry spares the local tuning; p=2 needs a mesh
    res2 = ttuner.tune(M, cache=cache, device=CPU,
                       measure=lambda op, x: 1.0, mesh_ps=(2,),
                       mesh=tdist.ShardMesh(2, CPU))
    assert res2.cached and res2.mesh_plans[2].mesh_p == 2
    with pytest.raises(ValueError, match="devices"):
        ttuner.tune(M, cache=cache, device=CPU, mesh_ps=(4,),
                    measure=lambda op, x: 1.0)


def test_registered_mesh_winner_drives_serving():
    Mj = dyadic(jcsrc.fem_band(96, 4, seed=7))
    M = to_torch_csrc(Mj)
    cache = ttuner.PlanCache()
    mesh = tdist.ShardMesh(2, CPU)
    ttuner.tune_mesh(M, 2, cache=cache, mesh=mesh,
                     measure=lambda fn, x: 1.0)
    eng = SpmvServingEngine(cache=cache, mesh_p=2, mesh=mesh)
    plan = eng.register("m", M)
    assert plan.strategy == "mesh" and plan.mesh_p == 2
    x = dyadic_x(M.m, 1, seed=1)
    u = eng.submit("m", x)
    np.testing.assert_array_equal(
        np.asarray(eng.step()[u]),
        (np.asarray(jcsrc.to_dense(Mj), np.float64) @ x).astype(np.float32))
    # autotuning engines tune on the mesh they were given
    eng2 = SpmvServingEngine(cache=ttuner.PlanCache(), mesh_p=2, mesh=mesh,
                             autotune=True, serve_nrhs=1)
    assert eng2.register("m", M).strategy == "mesh"


@pytest.mark.parametrize("acc", ["allreduce", "halo"])
def test_cg_through_a_mesh_converges(acc):
    Mj = jcsrc.poisson2d(16)
    M = to_torch_csrc(Mj)
    A = np.asarray(jcsrc.to_dense(Mj), np.float64)
    plan = ExecutionPlan(path="segment", strategy="mesh", mesh_p=4,
                         accumulation=acc)
    x_true = np.random.default_rng(0).standard_normal((M.n, 3))
    b = torch.from_numpy((A @ x_true).astype(np.float32))
    ex = MeshExecutor(M, plan, mesh=tdist.ShardMesh(4, CPU))
    res = tsolvers.cg(ex, b, tol=1e-6, maxiter=1500, diag=M.ad)
    assert res.converged, res.residual
    res2, op = tsolvers.cg_solve(M, b, plan=plan, device=CPU,
                                 mesh=tdist.ShardMesh(4, CPU), tol=1e-6)
    assert res2.converged and op.kind == "mesh"
    assert torch.equal(res2.x, res.x)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-3)
