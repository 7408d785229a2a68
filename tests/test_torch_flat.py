"""The flat path of the port held against the JAX package on the CPU: the
pack and its value refresh array for array, the plain versions of K5-K8
against the Pallas bodies in interpret mode, plan keys, the skew gate and
its candidates, schedule npz files across the two packages, the cache,
serving and CG through a flat plan.

Dyadic values make float32 sums exact in any order, so those comparisons
are ``assert_array_equal``; on general values the bound is 1e-5 of the
row's absolute sum.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import csrc as jcsrc
from repro.core import paths as jpaths
from repro.core import plan as jplan
from repro.core import schedule as jsched
from repro.core import solvers as jsolvers
from repro.core import tuner as jtuner
from repro.kernels import csrc_spmv_flat as jflat
from repro.kernels import csrc_spmv_stream as jstream
from repro.kernels import ops as jops
from repro.serve import SpmvServingEngine as JEngine
from repro_torch import convert
from repro_torch.core import paths as tpaths
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import _build
from repro_torch.kernels import csrc_spmv as tmv
from repro_torch.kernels import csrc_spmv_flat as tflat
from repro_torch.kernels import csrc_spmv_stream as tstream
from repro_torch.kernels import ops as tops
from repro_torch.serve import SpmvServingEngine

from test_torch_parity_helpers import (MATRICES, dyadic, dyadic_x,
                                       empty_rows, np32, to_torch_csrc)

FLAT_ARRAYS = ("vals_l", "vals_u", "col_local", "row_in_win", "ad",
               "tile_of_step", "first_of_tile")


def _diag_only(n=17):
    i = np.arange(n)
    return jcsrc.from_coo(i, i, np.arange(1.0, n + 1.0), n=n)


# name -> JAX-package matrix factory; skewed rows give tiles of 1 to many
# k-steps at ks=1 (128 slots per step)
FLAT_MATRICES = {
    "skew256": lambda: jcsrc.skewed_band(256, 48, 3, seed=1),
    "skew1024": lambda: jcsrc.skewed_band(1024, 48, 3, seed=2),
    "skew_sym": lambda: jcsrc.skewed_band(256, 48, 3, seed=7,
                                          numeric_symmetric=True),
    "fem_band": MATRICES["fem_band"],
    "tail_tile": MATRICES["tail_tile"],                 # n % tm != 0
    "empty_rows": lambda: empty_rows(20),
    "n1": lambda: jcsrc.from_dense(np.array([[3.0]])),
    "diag_only": _diag_only,
}
# (matrix, tm, ks)
CASES = [("skew256", 32, 1), ("skew1024", 64, 1), ("skew_sym", 32, 1),
         ("skew1024", 128, 8), ("fem_band", 32, 2), ("tail_tile", 64, 1),
         ("empty_rows", 8, 1), ("n1", 128, 8), ("diag_only", 8, 1)]
DTYPES = {"f32_i32": (jnp.float32, jnp.int32, torch.float32, torch.int32),
          "bf16_i16": (jnp.bfloat16, jnp.int16, torch.bfloat16, torch.int16)}


def _packs(name, tm, ks, dtypes="f32_i32", quantize=True):
    jv, ji, tv, ti = DTYPES[dtypes]
    Mj = FLAT_MATRICES[name]()
    Mj = dyadic(Mj) if quantize else Mj
    pj = jflat.pack_flat(Mj, tm=tm, ks=ks, dtype=jv, index_dtype=ji)
    pt = tflat.pack_flat(to_torch_csrc(Mj), tm=tm, ks=ks, dtype=tv,
                         index_dtype=ti)
    return Mj, pj, pt


def assert_flat_pack_equal(pj, pt):
    for f in ("n", "tm", "nt", "w_pad", "total_steps", "ks",
              "num_symmetric", "pad_ratio"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in FLAT_ARRAYS:
        a, b = getattr(pj, f), getattr(pt, f)
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), f
        np.testing.assert_array_equal(np32(a).reshape(tuple(b.shape)),
                                      np32(b), err_msg=f)


def _foreign_flat(pj):
    """The port's FlatBlockEll for a JAX-package flat pack, via numpy."""
    return convert.flat_from_arrays(
        n=pj.n, tm=pj.tm, nt=pj.nt, w_pad=pj.w_pad,
        total_steps=pj.total_steps, ks=pj.ks,
        num_symmetric=pj.num_symmetric, pad_ratio=pj.pad_ratio,
        value_dtype=str(pj.vals_l.dtype),
        **{f: np32(getattr(pj, f)) for f in FLAT_ARRAYS})


# ---------------------------------------------------------------------------
# Pack, refresh, step ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("name,tm,ks", CASES)
def test_pack_flat_equal(name, tm, ks, dtypes):
    _, pj, pt = _packs(name, tm, ks, dtypes, quantize=False)
    assert_flat_pack_equal(pj, pt)
    assert pt.vals_l.shape == (pt.total_steps, ks * 128)
    assert pt.streamed_bytes() == pj.streamed_bytes()
    if pt.num_symmetric:
        assert pt.vals_u is pt.vals_l              # one stream in memory
    steps = np.diff(pt.step_start.numpy())
    assert steps.min() >= 1 and steps.sum() == pt.total_steps
    np.testing.assert_array_equal(
        np.repeat(np.arange(pt.nt), steps), pt.tile_of_step.numpy())


def test_skewed_tiles_carry_one_to_many_steps():
    _, _, pt = _packs("skew1024", 32, 1)
    steps = np.diff(pt.step_start.numpy())
    assert steps.min() == 1 and steps.max() >= 10
    assert pt.pad_ratio < 2.0


def test_convert_flat_roundtrip_and_device_move():
    _, pj, pt = _packs("skew256", 32, 1, "bf16_i16")
    pc = _foreign_flat(pj)
    assert_flat_pack_equal(pj, pc)
    assert torch.equal(pc.step_start, pt.step_start)
    assert pt.to("cpu") is pt
    x = torch.from_numpy(dyadic_x(pt.n, 1, seed=1))
    for variant in ("onehot", "stream"):
        assert torch.equal(tflat.flat_spmv(pc, x, variant=variant),
                           tflat.flat_spmv(pt, x, variant=variant))


def test_to_device_moves_step_start_and_keeps_the_alias():
    _, _, pt = _packs("skew_sym", 32, 1)
    moved = pt.to("meta")
    assert moved.vals_u is moved.vals_l
    assert all(getattr(moved, f).device.type == "meta"
               for f in FLAT_ARRAYS + ("step_start",))
    assert moved.step_start.shape == (pt.nt + 1,)


def test_flat_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    Mt = to_torch_csrc(FLAT_MATRICES["skew_sym"]())
    plan = tplan.ExecutionPlan(path="flat")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.SpmvOperator.from_plan(Mt, plan)
    with pytest.raises(RuntimeError, match="cuda"):
        tsolvers.cg_solve(Mt, torch.zeros(Mt.n), plan=plan)
    with pytest.raises(RuntimeError, match="cuda"):
        SpmvServingEngine().register("skew", Mt, plan=plan)


def test_malformed_step_maps_raise_before_any_launch():
    _, pj, _ = _packs("skew1024", 64, 1)
    good = {f: np32(getattr(pj, f)) for f in FLAT_ARRAYS}
    kw = dict(n=pj.n, tm=pj.tm, nt=pj.nt, w_pad=pj.w_pad,
              total_steps=pj.total_steps, ks=pj.ks, num_symmetric=False,
              pad_ratio=pj.pad_ratio)
    tile, first = good["tile_of_step"], good["first_of_tile"]
    swapped = tile.copy()
    swapped[[0, -1]] = swapped[[-1, 0]]            # a tile's steps split
    missing = np.where(tile == 3, 2, tile).astype(np.int32)
    shifted = np.roll(first, 1)
    for bad, msg in ((dict(tile_of_step=swapped), "contiguous"),
                     (dict(tile_of_step=missing), "at least one"),
                     (dict(first_of_tile=shifted), "first k-step"),
                     (dict(tile_of_step=tile + pj.nt), "tiles in")):
        with pytest.raises(ValueError, match=msg):
            convert.flat_from_arrays(**kw, **{**good, **bad})


@pytest.mark.parametrize("source", ["pack_flat", "load_npz",
                                    "flat_from_arrays", "one_step_shuffled"])
def test_rows_never_decrease_inside_a_step(source, tmp_path):
    """K7/K8 find a window row's slots as one run of the staged k-step: every
    pack built, loaded from a reference-written npz or converted keeps its
    rows non-decreasing inside each step, and a pack with one step's rows
    shuffled raises ValueError when it is constructed, before any launch."""
    if source == "pack_flat":
        packs = [tflat.pack_flat(to_torch_csrc(FLAT_MATRICES[name]()), tm=tm,
                                 ks=ks, dtype=DTYPES[d][2],
                                 index_dtype=DTYPES[d][3])
                 for name, tm, ks in CASES for d in DTYPES]
    elif source == "load_npz":
        Mj = dyadic(FLAT_MATRICES["skew1024"]())
        sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(
            path="flat", tm=64, k_step_sublanes=1))
        f = str(tmp_path / "flat.npz")
        sj.save_npz(f)
        packs = [tsched.SpmvSchedule.load_npz(f).flat_pack]
    elif source == "flat_from_arrays":
        packs = [_foreign_flat(_packs(name, tm, ks, d)[1])
                 for name, tm, ks in CASES[:4] for d in DTYPES]
    else:
        _, pj, pt = _packs("skew1024", 64, 1)
        rows = pt.row_in_win.clone()
        j = int(np.flatnonzero((rows[:, 0] != rows[:, -1]).numpy())[0])
        rows[j] = rows[j][np.random.default_rng(0).permutation(pt.step)]
        assert bool((rows[j, 1:] < rows[j, :-1]).any())
        good = {f: np32(getattr(pj, f)) for f in FLAT_ARRAYS}
        kw = dict(n=pj.n, tm=pj.tm, nt=pj.nt, w_pad=pj.w_pad,
                  total_steps=pj.total_steps, ks=pj.ks, num_symmetric=False,
                  pad_ratio=pj.pad_ratio)
        with pytest.raises(ValueError, match="non-decreasing"):
            convert.flat_from_arrays(**kw, **{**good,
                                              "row_in_win": rows.numpy()})
        with pytest.raises(ValueError, match="non-decreasing"):
            dataclasses.replace(pt, row_in_win=rows, step_start=None)
        return
    for pack in packs:
        rows = pack.row_in_win.to(torch.int64)
        assert bool((rows[:, 1:] >= rows[:, :-1]).all())


def test_pack_flat_gates_raise_like_reference():
    Mj = FLAT_MATRICES["skew256"]()
    Mt = to_torch_csrc(Mj)
    with pytest.raises(ValueError, match="cap"):
        jflat.pack_flat(Mj, w_cap=128)
    with pytest.raises(ValueError, match="cap"):
        tflat.pack_flat(Mt, w_cap=128)
    far = jcsrc.from_coo(np.array([0, 40000, 40000]),
                         np.array([0, 0, 40000]), np.ones(3), n=40001)
    with pytest.raises(ValueError, match="int16"):
        jflat.pack_flat(far, w_cap=1 << 20, index_dtype=jnp.int16)
    with pytest.raises(ValueError, match="int16"):
        tflat.pack_flat(to_torch_csrc(far), w_cap=1 << 20,
                        index_dtype=torch.int16)
    rect = jcsrc.rectangular_fem(40, 8, 6, seed=0)
    with pytest.raises(ValueError, match="square"):
        tflat.pack_flat(to_torch_csrc(rect))


@pytest.mark.parametrize("name", ["skew1024", "skew_sym", "empty_rows"])
def test_refresh_flat_values_equal(name):
    Mj = dyadic(FLAT_MATRICES[name]())
    pj = jflat.pack_flat(Mj, tm=32, ks=1)
    pt = tflat.pack_flat(to_torch_csrc(Mj), tm=32, ks=1)
    scaled = dataclasses.replace(Mj, ad=0.5 * Mj.ad, al=-0.25 * Mj.al,
                                 au=-0.25 * Mj.au)
    rj = jflat.refresh_flat_values(pj, scaled)
    rt = tflat.refresh_flat_values(pt, to_torch_csrc(scaled))
    assert_flat_pack_equal(rj, rt)
    assert rt.col_local is pt.col_local and rt.step_start is pt.step_start
    assert_flat_pack_equal(jflat.pack_flat(scaled, tm=32, ks=1), rt)


def test_refresh_rejects_symmetry_flip_and_other_size():
    _, _, pt = _packs("skew_sym", 32, 1)
    ns = to_torch_csrc(FLAT_MATRICES["skew256"]())
    with pytest.raises(ValueError, match="symmetry"):
        tflat.refresh_flat_values(pt, ns)
    with pytest.raises(ValueError, match="structure"):
        tflat.refresh_flat_values(pt, to_torch_csrc(_diag_only()))


# ---------------------------------------------------------------------------
# K5-K8 plain versions against the Pallas bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,tm,ks", CASES)
def test_flat_spmv_bit_identical(name, tm, ks, variant):
    """K5 / K7 plain versions through ``flat_spmv``: the Pallas body's
    product and the dense one, bit for bit."""
    Mj, pj, pt = _packs(name, tm, ks)
    x = dyadic_x(Mj.n, 1, seed=3)
    yj = jflat.flat_spmv(pj, jnp.asarray(x), interpret=True, variant=variant)
    yt = tflat.flat_spmv(pt, torch.from_numpy(x), variant=variant)
    assert yt.dtype == torch.float32 and yt.shape == (Mj.n,)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ x.astype(np.float64)).astype(np.float32))
    wins = tflat.flat_spmv_windows(pt, torch.from_numpy(x), variant=variant)
    assert wins.shape == (pt.nt, pt.w_pad)


@pytest.mark.parametrize("nrhs", [1, 3, 8])
@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,tm,ks", [("skew1024", 64, 1),
                                        ("skew_sym", 32, 1),
                                        ("tail_tile", 64, 1),
                                        ("empty_rows", 8, 1)])
def test_flat_spmm_bit_identical(name, tm, ks, variant, nrhs):
    """K6 / K8 plain versions through ``flat_spmm``."""
    Mj, pj, pt = _packs(name, tm, ks)
    X = dyadic_x(Mj.n, nrhs, seed=nrhs).reshape(Mj.n, nrhs)
    yj = jflat.flat_spmm(pj, jnp.asarray(X), interpret=True, variant=variant)
    yt = tflat.flat_spmm(pt, torch.from_numpy(X), variant=variant)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ X.astype(np.float64)).astype(np.float32))
    wins = tflat.flat_spmm_windows(pt, torch.from_numpy(X), variant=variant)
    assert wins.shape == (pt.nt, pt.w_pad, nrhs)


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_bf16_int16_streams_bit_identical(variant):
    Mj, pj, pt = _packs("skew_sym", 32, 1, "bf16_i16")
    X = dyadic_x(Mj.n, 3, seed=8)
    np.testing.assert_array_equal(
        np.asarray(jflat.flat_spmm(pj, jnp.asarray(X), interpret=True,
                                   variant=variant)),
        tflat.flat_spmm(pt, torch.from_numpy(X), variant=variant).numpy())
    x = dyadic_x(Mj.n, 1, seed=9)
    np.testing.assert_array_equal(
        np.asarray(jflat.flat_spmv(pj, jnp.asarray(x), interpret=True,
                                   variant=variant)),
        tflat.flat_spmv(pt, torch.from_numpy(x), variant=variant).numpy())


@pytest.mark.parametrize("nrhs", [1, 3])
def test_fused_stream_executors_equal(nrhs):
    """The fused forms (the plain versions of K5/K6) against the JAX
    package's fused flat executors."""
    Mj, pj, pt = _packs("skew1024", 64, 1)
    x = dyadic_x(Mj.n, nrhs, seed=11)
    if nrhs == 1:
        yj = jstream.flat_spmv_stream(pj, jnp.asarray(x))
        yt = tstream.flat_spmv_stream(pt, torch.from_numpy(x))
    else:
        yj = jstream.flat_spmm_stream(pj, jnp.asarray(x))
        yt = tstream.flat_spmm_stream(pt, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_general_values_within_rowsum_tolerance(variant):
    """General values: |port - reference| <= 1e-5 of the row's absolute
    sum (float32 sums taken in different orders)."""
    Mj, pj, pt = _packs("skew1024", 64, 1, quantize=False)
    x = np.random.default_rng(0).standard_normal((Mj.n, 3)).astype(np.float32)
    yj = np.asarray(jflat.flat_spmm(pj, jnp.asarray(x), interpret=True,
                                    variant=variant))
    yt = tflat.flat_spmm(pt, torch.from_numpy(x), variant=variant).numpy()
    bound = 1e-5 * (np.abs(jcsrc.to_dense(Mj)) @ np.abs(x))
    assert (np.abs(yj - yt) <= bound).all()


def test_onehot_plain_chunking_does_not_change_result(monkeypatch):
    Mj, pj, pt = _packs("skew1024", 64, 1)
    x = torch.from_numpy(dyadic_x(Mj.n, 3, seed=2))
    whole = tflat.flat_windows_onehot_plain(pt, x)
    monkeypatch.setattr(tmv, "_MASK_ELEMENTS", 1)     # one step per chunk
    assert torch.equal(whole, tflat.flat_windows_onehot_plain(pt, x))


def test_wrappers_validate_and_never_launch_on_cpu():
    Mj, pj, pt = _packs("skew256", 32, 1)
    x = torch.from_numpy(dyadic_x(Mj.n, 1))
    before = _build.launch_counts()
    tflat.flat_spmv_windows(pt, x, variant="stream")
    tflat.flat_spmm_windows(pt, x[:, None])
    assert _build.launch_counts() == before       # CPU tensors: plain only
    assert {"flat_spmv_stream", "flat_spmv_onehot", "flat_spmm_stream",
            "flat_spmm_onehot"} <= set(before)
    for launch in (lambda: tflat.flat_spmv_stream_cuda(pt, x),
                   lambda: tflat.flat_spmv_onehot_cuda(pt, x),
                   lambda: tflat.flat_spmm_stream_cuda(pt, x[:, None]),
                   lambda: tflat.flat_spmm_onehot_cuda(pt, x[:, None])):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    with pytest.raises(ValueError, match="variant"):
        tflat.flat_spmv_windows(pt, x, variant="mxu")
    with pytest.raises(ValueError, match="shape"):
        tflat.flat_spmv_windows(pt, x[:-1])
    with pytest.raises(ValueError, match="shape"):
        tflat.flat_spmm_windows(pt, x)


# ---------------------------------------------------------------------------
# Plans, registry, schedules
# ---------------------------------------------------------------------------

FLAT_PLAN_KW = [
    {"path": "flat"},
    {"path": "flat", "variant": "stream", "tm": 32, "k_step_sublanes": 1},
    {"path": "flat", "index_dtype": "int16", "value_dtype": "bfloat16",
     "nrhs": 8},
    {"path": "flat", "partition": "count", "accumulation": "halo"},
]


@pytest.mark.parametrize("kw", FLAT_PLAN_KW, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_flat_plan_keys_equal(kw):
    pj, pt = jplan.ExecutionPlan(**kw), tplan.ExecutionPlan(**kw)
    assert pj.key() == pt.key() and pj.to_json() == pt.to_json()
    assert tplan.ExecutionPlan.from_json(pj.to_json()) == pt
    assert (jsched.plan_artifact_fields(pj)
            == tsched.plan_artifact_fields(pt))
    assert (jsched.schedule_key("fp", "vd", pj, 8)
            == tsched.schedule_key("fp", "vd", pt, 8))


@pytest.mark.parametrize("name", ["skew256", "skew1024", "skew_sym",
                                  "fem_band", "poisson2d", "diag_only"])
def test_skew_gate_and_candidates_equal(name):
    """``flat_worth_measuring`` and the flat enumerator agree with the
    reference on skewed and uniform matrices."""
    factory = FLAT_MATRICES.get(name) or MATRICES[name]
    Mj = factory()
    sj, st = jtuner.stats_of(Mj), ttuner.stats_of(to_torch_csrc(Mj))
    assert jpaths.flat_worth_measuring(sj) == tpaths.flat_worth_measuring(st)
    assert tpaths.FLAT_SKEW_MIN == jpaths.FLAT_SKEW_MIN
    cj = jpaths.get_path("flat").candidates(sj, jpaths.CandidateSpace())
    ct = tpaths.get_path("flat").candidates(st, tpaths.CandidateSpace())
    assert [p.to_json() for p in cj] == [p.to_json() for p in ct]
    assert bool(ct) == name.startswith("skew")
    plan = tplan.ExecutionPlan(path="flat")
    assert (tplan.feasible(plan, n=st.n, m=st.m, bandwidth=st.bandwidth)
            == jpaths.get_path("flat").feasible(
                jplan.ExecutionPlan(path="flat"), n=sj.n, m=sj.m,
                bandwidth=sj.bandwidth))


def test_schedule_bundles_and_binds_the_flat_pack():
    Mt = to_torch_csrc(dyadic(FLAT_MATRICES["skew256"]()))
    plan = tplan.ExecutionPlan(path="flat", tm=32, k_step_sublanes=1)
    sched = tsched.build_schedule(Mt, plan)
    assert sched.flat_pack is not None and sched.pack is None
    assert sched.to("cpu") is sched
    op = tops.SpmvOperator.from_plan(Mt, plan, device="cpu", schedule=sched)
    assert op.pack is sched.flat_pack
    assert op.bytes_per_call == sched.flat_pack.streamed_bytes()


@pytest.mark.parametrize("dtypes", [("int32", "float32"),
                                    ("int16", "bfloat16")])
def test_schedule_npz_written_by_reference_loads_in_port(tmp_path, dtypes):
    Mj = dyadic(FLAT_MATRICES["skew_sym"]())
    kw = dict(path="flat", tm=32, k_step_sublanes=1, variant="stream",
              index_dtype=dtypes[0], value_dtype=dtypes[1])
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(**kw))
    f = str(tmp_path / "flat.npz")
    sj.save_npz(f)
    st = tsched.SpmvSchedule.load_npz(f)
    assert st.key() == sj.key() and st.plan.to_json() == sj.plan.to_json()
    assert_flat_pack_equal(sj.flat_pack, st.flat_pack)
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
    Mj = dyadic(FLAT_MATRICES["skew1024"]())
    Mt = to_torch_csrc(Mj)
    kw = dict(path="flat", tm=64, k_step_sublanes=1,
              index_dtype=dtypes[0], value_dtype=dtypes[1])
    st = tsched.build_schedule(Mt, tplan.ExecutionPlan(**kw))
    f = str(tmp_path / "flat.npz")
    st.save_npz(f)
    sj = jsched.SpmvSchedule.load_npz(f)
    assert sj.key() == st.key()
    assert_flat_pack_equal(sj.flat_pack, st.flat_pack)
    x = dyadic_x(Mj.n, 1, seed=2)
    yj = jops.SpmvOperator.from_plan(Mj, sj.plan, schedule=sj)(jnp.asarray(x))
    yt = tops.SpmvOperator.from_plan(Mt, st.plan, device="cpu",
                                     schedule=st)(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def _build_delta(fn):
    before = dict(tsched.BUILD_COUNTS.items())
    out = fn()
    after = dict(tsched.BUILD_COUNTS.items())
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def test_cache_hit_builds_zero_flat_packs(tmp_path):
    Mt = to_torch_csrc(dyadic(FLAT_MATRICES["skew256"]()))
    plan = tplan.ExecutionPlan(path="flat", tm=32, k_step_sublanes=1)
    cache = ttuner.PlanCache(path=str(tmp_path / "plans.json"))
    op1, d1 = _build_delta(lambda: tops.SpmvOperator.from_plan(
        Mt, plan, cache=cache, device="cpu"))
    assert d1.get("flat_pack") == 1 and d1.get("schedule") == 1
    op2, d2 = _build_delta(lambda: tops.SpmvOperator.from_plan(
        Mt, plan, cache=cache, device="cpu"))
    assert d2 == {}, f"cache hit rebuilt: {d2}"
    fresh = ttuner.PlanCache(path=str(tmp_path / "plans.json"))
    op3, d3 = _build_delta(lambda: tops.SpmvOperator.from_plan(
        Mt, plan, cache=fresh, device="cpu"))
    assert d3 == {}, f"disk hit rebuilt: {d3}"
    x = torch.from_numpy(dyadic_x(Mt.n, 1, seed=4))
    assert torch.equal(op1(x), op2(x)) and torch.equal(op1(x), op3(x))


def test_update_values_refreshes_flat_without_rebuild():
    Mj = dyadic(FLAT_MATRICES["skew1024"]())
    plan = tplan.ExecutionPlan(path="flat", tm=64, k_step_sublanes=1,
                               variant="stream")
    op = tops.SpmvOperator.from_plan(to_torch_csrc(Mj), plan, device="cpu")
    scaled = dataclasses.replace(Mj, ad=2.0 * Mj.ad, al=0.5 * Mj.al,
                                 au=-Mj.au)
    _, delta = _build_delta(lambda: op.update_values(to_torch_csrc(scaled)))
    assert delta == {"value_refresh": 1}
    x = dyadic_x(Mj.n, 3, seed=5)
    want = jflat.flat_spmm(jflat.pack_flat(scaled, tm=64, ks=1),
                           jnp.asarray(x), interpret=True, variant="stream")
    np.testing.assert_array_equal(np.asarray(want),
                                  op(torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# Serving and solving through a flat plan
# ---------------------------------------------------------------------------

def test_serving_engine_answers_through_a_flat_plan():
    Mj = dyadic(FLAT_MATRICES["skew1024"]())
    kw = dict(path="flat", tm=64, k_step_sublanes=1)
    ej, et = JEngine(), SpmvServingEngine(device="cpu")
    pj = ej.register("skew", Mj, plan=jplan.ExecutionPlan(**kw))
    pt = et.register("skew", to_torch_csrc(Mj),
                     plan=tplan.ExecutionPlan(**kw))
    assert pj.to_json() == pt.to_json()
    uids = []
    for i in range(4):
        x = dyadic_x(Mj.n, 1, seed=20 + i)
        uids.append(et.submit("skew", x))
        assert ej.submit("skew", x) == uids[-1]
    outj, outt = ej.run_until_drained(), et.run_until_drained()
    assert set(outt) == set(uids)
    for u in uids:
        np.testing.assert_array_equal(np.asarray(outj[u]),
                                      np.asarray(outt[u]))
        meta = outt[u].meta()
        assert meta["path"] == "flat" and meta["batched"] == 4
        assert meta["plan_key"] == pj.key()


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_cg_solve_flat_plan_same_iterations(variant):
    Mj = jcsrc.skewed_band(512, 48, 3, seed=3, numeric_symmetric=True)
    b = np.random.default_rng(3).standard_normal((Mj.n, 2)).astype(
        np.float32)
    kw = dict(path="flat", tm=64, k_step_sublanes=1, variant=variant)
    rj, opj = jsolvers.cg_solve(Mj, jnp.asarray(b),
                                plan=jplan.ExecutionPlan(**kw))
    rt, opt = tsolvers.cg_solve(to_torch_csrc(Mj), torch.from_numpy(b),
                                plan=tplan.ExecutionPlan(**kw), device="cpu")
    assert opt.plan.key() == opj.plan.key() and opt.path == "flat"
    assert rt.converged and rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                               atol=1e-6)
