"""The nnzsplit path of the port held against the JAX package on the CPU:
the pack and its value refresh array for array, the plain versions of
K9-K12 and the fused executors against the Pallas bodies in interpret mode,
plan keys, the unstructured gate and its candidates, schedule npz files
across the two packages, the cache, serving and CG through nnzsplit plans.

The JAX package's tuner classes (``TestNnzSplitTuning``) wait for the
port's tuner; its mesh classes wait for the port's mesh layer.

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
from repro.kernels import csrc_spmv_nnzsplit as jnz
from repro.kernels import csrc_spmv_stream as jstream
from repro.kernels import ops as jops
from repro.serve import SpmvServingEngine as JEngine
from repro_torch import convert
from repro_torch.core import csrc as tcsrc
from repro_torch.core import paths as tpaths
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import _build
from repro_torch.kernels import csrc_spmv_nnzsplit as tnz
from repro_torch.kernels import csrc_spmv_stream as tstream
from repro_torch.kernels import ops as tops
from repro_torch.serve import SpmvServingEngine

from _smoke import chip_smoke
from test_torch_parity_helpers import (MATRICES, dyadic, dyadic_x,
                                       empty_rows, np32, to_torch_csrc)

NZ_ARRAYS = ("vals", "lrow", "src", "chunk_row0", "fixup_idx", "ad")


def _diag_only(n=17):
    i = np.arange(n)
    return jcsrc.from_coo(i, i, np.arange(1.0, n + 1.0), n=n)


# name -> JAX-package matrix factory: power-law graphs with hub rows,
# unstructured random patterns, and the small edge cases
NZ_MATRICES = {
    "powerlaw": lambda: jcsrc.powerlaw_laplacian(300, seed=3),
    "random": lambda: jcsrc.random_symmetric_pattern(220, 5, seed=4),
    "paper_example": jcsrc.paper_example,
    "diag_only": _diag_only,
    "n1": lambda: jcsrc.from_dense(np.array([[3.0]])),
    "empty_rows": lambda: empty_rows(20),
    "fem_band": MATRICES["fem_band"],
}
DTYPES = {"f32_i32": (jnp.float32, jnp.int32, torch.float32, torch.int32),
          "bf16_i16": (jnp.bfloat16, jnp.int16, torch.bfloat16, torch.int16)}


def _packs(name, ks, dtypes="f32_i32", quantize=True):
    jv, ji, tv, ti = DTYPES[dtypes]
    Mj = NZ_MATRICES[name]()
    Mj = dyadic(Mj) if quantize else Mj
    pj = jnz.pack_nnzsplit(Mj, ks=ks, dtype=jv, index_dtype=ji)
    pt = tnz.pack_nnzsplit(to_torch_csrc(Mj), ks=ks, dtype=tv,
                           index_dtype=ti)
    return Mj, pj, pt


def assert_nz_pack_equal(pj, pt):
    for f in ("n", "num_chunks", "ks", "r_pad", "num_symmetric",
              "pad_ratio"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in NZ_ARRAYS:
        a, b = getattr(pj, f), getattr(pt, f)
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), f
        np.testing.assert_array_equal(np32(a).reshape(tuple(b.shape)),
                                      np32(b), err_msg=f)


def _foreign_pack(pj, **override):
    """The port's NnzSplitPack for a JAX-package pack, via numpy."""
    arrays = {f: np32(getattr(pj, f)) for f in NZ_ARRAYS}
    arrays.update(override)
    return convert.nnzsplit_from_arrays(
        n=pj.n, num_chunks=pj.num_chunks, ks=pj.ks, r_pad=pj.r_pad,
        num_symmetric=pj.num_symmetric, pad_ratio=pj.pad_ratio,
        value_dtype=str(pj.vals.dtype), **arrays)


def _partials_oracle(pj, x):
    """Per-chunk partials from the JAX pack's arrays with np.add.at."""
    nc, s, r_pad = pj.num_chunks, pj.ks * 128, pj.r_pad
    x2 = x.reshape(x.shape[0], -1).astype(np.float64)
    vals = np32(pj.vals).reshape(nc, s).astype(np.float64)
    lrow = np32(pj.lrow).reshape(nc, s).astype(np.int64)
    src = np32(pj.src).reshape(nc, s).astype(np.int64)
    out = np.zeros((nc, r_pad, x2.shape[1]))
    chunk = np.repeat(np.arange(nc), s)
    np.add.at(out, (chunk, lrow.reshape(-1)),
              vals.reshape(-1, 1) * x2[src.reshape(-1)])
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Pack, refresh, checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("ks", [1, 2, 8])
@pytest.mark.parametrize("name", list(NZ_MATRICES))
def test_pack_nnzsplit_equal(name, ks, dtypes):
    _, pj, pt = _packs(name, ks, dtypes, quantize=False)
    assert_nz_pack_equal(pj, pt)
    assert pt.vals.shape == pt.lrow.shape == pt.src.shape == (
        pt.num_chunks, ks * 128)
    assert pt.streamed_bytes() == pj.streamed_bytes()
    assert pt.streamed_bytes(3) > pt.streamed_bytes(1)
    assert (np.diff(pt.lrow.numpy().astype(np.int64), axis=1) >= 0).all()


def test_combined_stream_order_equals_stable_argsort():
    """The closed-form dest order is the JAX package's stable argsort."""
    for name in ("powerlaw", "random", "fem_band", "empty_rows"):
        Mj = NZ_MATRICES[name]()
        dj, sj, vj = jnz._combined_stream(Mj)
        dt, st, vt = tnz._combined_stream(to_torch_csrc(Mj))
        for a, b in ((dj, dt), (sj, st), (vj, vt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_hub_row_spans_several_chunks():
    """A star graph's centre fills several chunks; the fix-up merges it."""
    n = 700
    leaves = np.arange(1, n)
    Mj = jcsrc.from_coo(np.concatenate([leaves, np.zeros(n - 1, int),
                                        np.arange(n)]),
                        np.concatenate([np.zeros(n - 1, int), leaves,
                                        np.arange(n)]),
                        np.concatenate([-np.ones(2 * (n - 1)),
                                        np.full(n, 3.0)]), n=n)
    pj = jnz.pack_nnzsplit(Mj, ks=1)
    pt = tnz.pack_nnzsplit(to_torch_csrc(Mj), ks=1)
    assert_nz_pack_equal(pj, pt)
    assert (pt.chunk_row0.numpy() == 0).sum() >= 5
    x = dyadic_x(n, 1, seed=2)
    y = tnz.nnzsplit_spmv(pt, torch.from_numpy(x), variant="stream")
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(y.numpy(),
                                  (A @ x.astype(np.float64)).astype(
                                      np.float32))


def test_r_cap_gate_and_refusals_raise_like_reference():
    Mj = jcsrc.powerlaw_laplacian(600, seed=2)
    Mt = to_torch_csrc(Mj)
    with pytest.raises(ValueError, match="row window"):
        jnz.pack_nnzsplit(Mj, ks=8, r_cap=128)
    with pytest.raises(ValueError, match="row window"):
        tnz.pack_nnzsplit(Mt, ks=8, r_cap=128)
    far = to_torch_csrc(jcsrc.from_coo(np.array([0, 40000]),
                                       np.array([0, 40000]), np.ones(2),
                                       n=40001))
    with pytest.raises(ValueError, match="int16"):
        tnz.pack_nnzsplit(far, index_dtype=torch.int16, r_cap=1 << 20)
    rect = to_torch_csrc(jcsrc.rectangular_fem(40, 8, 6, seed=0))
    with pytest.raises(ValueError, match="square"):
        tnz.pack_nnzsplit(rect)


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("name", list(NZ_MATRICES))
def test_refresh_nnzsplit_values_equal(name, dtypes):
    _, pj, pt = _packs(name, 2, dtypes)
    Mj = dyadic(NZ_MATRICES[name]())
    scaled = dataclasses.replace(Mj, ad=0.5 * Mj.ad, al=-0.25 * Mj.al,
                                 au=-0.25 * Mj.au)
    rj = jnz.refresh_nnzsplit_values(pj, scaled)
    rt = tnz.refresh_nnzsplit_values(pt, to_torch_csrc(scaled))
    assert_nz_pack_equal(rj, rt)
    assert rt.lrow is pt.lrow and rt.src is pt.src
    jv, ji, tv, ti = DTYPES[dtypes]
    assert_nz_pack_equal(jnz.pack_nnzsplit(scaled, ks=2, dtype=jv,
                                           index_dtype=ji), rt)


def test_refresh_rejects_symmetry_flip_and_other_size():
    Mj = dyadic(NZ_MATRICES["powerlaw"]())        # numerically symmetric
    pt = tnz.pack_nnzsplit(to_torch_csrc(Mj), ks=2)
    flipped = dataclasses.replace(Mj, au=2.0 * Mj.au,
                                  numerically_symmetric=False)
    with pytest.raises(ValueError, match="symmetry"):
        tnz.refresh_nnzsplit_values(pt, to_torch_csrc(flipped))
    with pytest.raises(ValueError, match="structure"):
        tnz.refresh_nnzsplit_values(pt, to_torch_csrc(_diag_only()))


def test_convert_roundtrip_and_device_move():
    _, pj, pt = _packs("powerlaw", 2, "bf16_i16")
    pc = _foreign_pack(pj)
    assert_nz_pack_equal(pj, pc)
    assert pt.to("cpu") is pt
    moved = pt.to("meta")
    assert all(getattr(moved, f).device.type == "meta" for f in NZ_ARRAYS)
    x = torch.from_numpy(dyadic_x(pt.n, 1, seed=1))
    for variant in ("onehot", "stream"):
        assert torch.equal(tnz.nnzsplit_spmv(pc, x, variant=variant),
                           tnz.nnzsplit_spmv(pt, x, variant=variant))


def test_malformed_streams_raise_before_any_launch():
    _, pj, _ = _packs("powerlaw", 1)
    lrow = np32(pj.lrow).reshape(pj.num_chunks, -1).copy()
    swapped = lrow.copy()
    swapped[0, [0, -1]] = swapped[0, [-1, 0]]     # rows out of order
    src = np32(pj.src).copy()
    fix = np32(pj.fixup_idx).copy()
    row0 = np32(pj.chunk_row0).copy()
    for bad, msg in ((dict(lrow=swapped), "non-decreasing"),
                     (dict(lrow=lrow + pj.r_pad), r"\[0, "),
                     (dict(src=src + pj.n), "src"),
                     (dict(fixup_idx=fix + 1), "fixup_idx"),
                     (dict(chunk_row0=row0 - 1), "chunk_row0")):
        with pytest.raises(ValueError, match=msg):
            _foreign_pack(pj, **bad)


# ---------------------------------------------------------------------------
# K9-K12 plain versions against the Pallas bodies
# ---------------------------------------------------------------------------

EXEC_CASES = [("powerlaw", 1), ("powerlaw", 2), ("random", 2),
              ("random", 8), ("paper_example", 2), ("diag_only", 2),
              ("n1", 8), ("empty_rows", 2), ("fem_band", 1)]


@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,ks", EXEC_CASES)
def test_nnzsplit_spmv_bit_identical(name, ks, variant):
    """K9 / K11 plain versions through ``nnzsplit_spmv``: the Pallas body's
    product and the dense one, bit for bit; the partials equal an
    ``np.add.at`` oracle on the pack's arrays."""
    Mj, pj, pt = _packs(name, ks)
    x = dyadic_x(Mj.n, 1, seed=3)
    yj = jnz.nnzsplit_spmv(pj, jnp.asarray(x), interpret=True,
                           variant=variant)
    yt = tnz.nnzsplit_spmv(pt, torch.from_numpy(x), variant=variant)
    assert yt.dtype == torch.float32 and yt.shape == (Mj.n,)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ x.astype(np.float64)).astype(np.float32))
    part = tnz._partials(pt, torch.from_numpy(x), 1, variant)
    assert part.shape == (pt.num_chunks, pt.r_pad)
    np.testing.assert_array_equal(part.numpy(),
                                  _partials_oracle(pj, x)[..., 0])


@pytest.mark.parametrize("nrhs", [1, 3, 8])
@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,ks", [("powerlaw", 2), ("random", 1),
                                     ("empty_rows", 2), ("n1", 8)])
def test_nnzsplit_spmm_bit_identical(name, ks, variant, nrhs):
    """K10 / K12 plain versions through ``nnzsplit_spmm``."""
    Mj, pj, pt = _packs(name, ks)
    X = dyadic_x(Mj.n, nrhs, seed=nrhs).reshape(Mj.n, nrhs)
    yj = jnz.nnzsplit_spmm(pj, jnp.asarray(X), interpret=True,
                           variant=variant)
    yt = tnz.nnzsplit_spmm(pt, torch.from_numpy(X), variant=variant)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ X.astype(np.float64)).astype(np.float32))
    part = tnz._partials(pt, torch.from_numpy(X), 2, variant)
    assert part.shape == (pt.num_chunks, pt.r_pad, nrhs)
    np.testing.assert_array_equal(part.numpy(), _partials_oracle(pj, X))


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_bf16_int16_streams_bit_identical(variant):
    Mj, pj, pt = _packs("powerlaw", 2, "bf16_i16")
    assert pt.src.dtype == torch.int16
    X = dyadic_x(Mj.n, 3, seed=8)
    np.testing.assert_array_equal(
        np.asarray(jnz.nnzsplit_spmm(pj, jnp.asarray(X), interpret=True,
                                     variant=variant)),
        tnz.nnzsplit_spmm(pt, torch.from_numpy(X), variant=variant).numpy())
    x = dyadic_x(Mj.n, 1, seed=9)
    np.testing.assert_array_equal(
        np.asarray(jnz.nnzsplit_spmv(pj, jnp.asarray(x), interpret=True,
                                     variant=variant)),
        tnz.nnzsplit_spmv(pt, torch.from_numpy(x), variant=variant).numpy())


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", ["powerlaw", "random", "diag_only"])
def test_fused_stream_executors_equal(name, nrhs):
    """The fused forms (the plain versions of K9/K10) against the JAX
    package's fused nnz-split executors."""
    Mj, pj, pt = _packs(name, 2)
    x = dyadic_x(Mj.n, nrhs, seed=11)
    if nrhs == 1:
        yj = jstream.nnzsplit_spmv_stream(pj, jnp.asarray(x))
        yt = tstream.nnzsplit_spmv_stream(pt, torch.from_numpy(x))
    else:
        yj = jstream.nnzsplit_spmm_stream(pj, jnp.asarray(x))
        yt = tstream.nnzsplit_spmm_stream(pt, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    assert torch.equal(
        tstream.nnzsplit_partials_fused(pt, torch.from_numpy(x)),
        tnz.nnzsplit_partials_onehot_plain(pt, torch.from_numpy(x)))


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_general_values_within_rowsum_tolerance(variant):
    """General values: |port - reference| <= 1e-5 of the row's absolute
    sum (float32 sums taken in different orders)."""
    Mj, pj, pt = _packs("random", 1, quantize=False)
    x = np.random.default_rng(0).standard_normal((Mj.n, 3)).astype(np.float32)
    yj = np.asarray(jnz.nnzsplit_spmm(pj, jnp.asarray(x), interpret=True,
                                      variant=variant))
    yt = tnz.nnzsplit_spmm(pt, torch.from_numpy(x), variant=variant).numpy()
    bound = 1e-5 * (np.abs(jcsrc.to_dense(Mj)) @ np.abs(x))
    assert (np.abs(yj - yt) <= bound).all()


def test_padding_entries_carry_x0_into_the_last_row():
    """The JAX package's padding adds 0·x[0] to the stream's last row: a
    NaN at x[0] reaches that row there and in the port (ROADMAP C11)."""
    Mj, pj, pt = _packs("paper_example", 2)
    x = dyadic_x(Mj.n, 1, seed=5)
    x[0] = np.nan
    yj = np.asarray(jnz.nnzsplit_spmv(pj, jnp.asarray(x), variant="stream"))
    yt = tnz.nnzsplit_spmv(pt, torch.from_numpy(x), variant="stream").numpy()
    np.testing.assert_array_equal(np.isnan(yj), np.isnan(yt))
    assert np.isnan(yt[Mj.n - 1])


def test_onehot_plain_grouping_does_not_change_result(monkeypatch):
    Mj, pj, pt = _packs("powerlaw", 1)
    x = torch.from_numpy(dyadic_x(Mj.n, 3, seed=2))
    whole = tnz.nnzsplit_partials_onehot_plain(pt, x)
    monkeypatch.setattr(tnz, "_MASK_ELEMENTS", 1)     # one chunk per group
    assert torch.equal(whole, tnz.nnzsplit_partials_onehot_plain(pt, x))


NNZ_ADVERSARY_CASES = ["hub_fills_chunks", "run_crosses_pass", "r_pad_4096",
                       "bf16_i16"]


@pytest.mark.parametrize("case,kernel", [
    *(pytest.param(case, "K12", id=case) for case in NNZ_ADVERSARY_CASES),
    *(pytest.param(case, "K11", id=f"{case}-k11")
      for case in NNZ_ADVERSARY_CASES)])
def test_k12_adversary_packs_have_their_features(case, kernel):
    """``chip_smoke.py``'s adversary matrices for K11 / K12 (shared with the
    card tests) give packs with the feature each case aims at — a chunk of
    one row, a run cut by the end of a kernel pass, r_pad 4096, bfloat16 /
    int16 streams — and on them the one-hot plain version equals the
    stream one on dyadic X (n, 3) (K12), and on x (n,) equals the one-hot
    plain version's column 0 at B = 1 and the stream one (K11: K12's body
    at one column)."""
    sm = chip_smoke()
    vdt, idt, ks = sm.NNZ_ADVERSARIES[case]
    arrays = sm.nnzsplit_adversary_arrays(case, seed=0)
    M = tcsrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    pack = tnz.pack_nnzsplit(M, ks=ks, dtype=vdt, index_dtype=idt)
    geometry = sm.nnzsplit_chunk_geometry(pack)
    assert sm.nnzsplit_case_holds(case, geometry), geometry
    if kernel == "K12":
        X = torch.from_numpy(dyadic_x(M.n, 3, seed=1))
        assert torch.equal(tnz.nnzsplit_partials_onehot_plain(pack, X),
                           tnz.nnzsplit_partials_stream_plain(pack, X))
        return
    x = torch.from_numpy(dyadic_x(M.n, 1, seed=1))
    got = tnz.nnzsplit_partials_onehot_plain(pack, x)
    assert got.shape == (pack.num_chunks, pack.r_pad)
    assert torch.equal(
        got, tnz.nnzsplit_partials_onehot_plain(pack, x[:, None])[..., 0])
    assert torch.equal(got, tnz.nnzsplit_partials_stream_plain(pack, x))


@pytest.mark.parametrize("case", ["hub_fills_chunks", "run_crosses_pass"])
def test_k10_plain_bit_identical_on_adversary_packs(case):
    """K10's plain version through ``nnzsplit_spmm`` against the Pallas
    body (``variant="stream"``) at B = 11 on two of ``chip_smoke.py``'s
    adversary matrices (a star's hub row filling whole chunks; runs cut by
    a pass end): the product, the dense one and the partials' ``np.add.at``
    oracle, bit for bit on dyadic data."""
    sm = chip_smoke()
    arrays = sm.nnzsplit_adversary_arrays(case, seed=0)
    n = arrays[0].shape[0] - 1
    Mj = jcsrc.from_assembly(n, *arrays)
    pj = jnz.pack_nnzsplit(Mj, ks=8)
    pt = tnz.pack_nnzsplit(to_torch_csrc(Mj), ks=8)
    X = dyadic_x(n, 11, seed=12).reshape(n, 11)
    yj = jnz.nnzsplit_spmm(pj, jnp.asarray(X), interpret=True,
                           variant="stream")
    yt = tnz.nnzsplit_spmm(pt, torch.from_numpy(X), variant="stream")
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ X.astype(np.float64)).astype(np.float32))
    part = tnz._partials(pt, torch.from_numpy(X), 2, "stream")
    np.testing.assert_array_equal(part.numpy(), _partials_oracle(pj, X))


@pytest.mark.parametrize("r_pad,nrhs,tile", [
    (128, 11, 11), (128, 64, 25), (4096, 64, 2), (4096, 1, 1)])
def test_k12_column_tile_fits_the_shared_memory_budget(r_pad, nrhs, tile):
    """K12's column tile: the (r_pad, BT) partial, the (512, BT) staged
    products and the r_pad + 1 row pointers of a pass fit 64 KB."""
    bt = tnz._onehot_tile(r_pad, nrhs)
    assert bt == tile
    assert 4 * ((r_pad + tnz._STAGE) * bt + r_pad + 1) <= 64 * 1024


def test_wrappers_validate_and_never_launch_on_cpu():
    Mj, pj, pt = _packs("powerlaw", 2)
    x = torch.from_numpy(dyadic_x(Mj.n, 1))
    before = _build.launch_counts()
    tnz.nnzsplit_spmv(pt, x, variant="stream")
    tnz.nnzsplit_spmm(pt, x[:, None])
    assert _build.launch_counts() == before       # CPU tensors: plain only
    assert {"nnzsplit_spmv_stream", "nnzsplit_spmv_onehot",
            "nnzsplit_spmm_stream", "nnzsplit_spmm_onehot"} <= set(before)
    for launch in (lambda: tnz.nnzsplit_spmv_stream_cuda(pt, x),
                   lambda: tnz.nnzsplit_spmv_onehot_cuda(pt, x),
                   lambda: tnz.nnzsplit_spmm_stream_cuda(pt, x[:, None]),
                   lambda: tnz.nnzsplit_spmm_onehot_cuda(pt, x[:, None])):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    with pytest.raises(ValueError, match="variant"):
        tnz.nnzsplit_spmv(pt, x, variant="mxu")
    with pytest.raises(ValueError, match="shape"):
        tnz.nnzsplit_spmv(pt, x[:-1])
    with pytest.raises(ValueError, match="shape"):
        tnz.nnzsplit_spmm(pt, x)
    flags = tnz.chunk_stream_flags(pt, torch.device("cpu"), 64)
    assert flags == (False, False)
    with pytest.raises(TypeError, match="src"):
        tnz.chunk_stream_flags(dataclasses.replace(
            pt, src=pt.src.to(torch.int64)), torch.device("cpu"), 1)


# ---------------------------------------------------------------------------
# Plans, registry, schedules
# ---------------------------------------------------------------------------

NZ_PLAN_KW = [
    {"path": "nnzsplit"},
    {"path": "nnzsplit", "variant": "stream", "k_step_sublanes": 2},
    {"path": "nnzsplit", "index_dtype": "int16", "value_dtype": "bfloat16",
     "nrhs": 8},
    {"path": "nnzsplit", "tm": 32, "k_step_sublanes": 4},
    {"path": "nnzsplit", "partition": "count", "accumulation": "halo"},
]


@pytest.mark.parametrize("kw", NZ_PLAN_KW, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_nnzsplit_plan_keys_equal(kw):
    pj, pt = jplan.ExecutionPlan(**kw), tplan.ExecutionPlan(**kw)
    assert pj.key() == pt.key() and pj.to_json() == pt.to_json()
    assert pt.key().startswith("nnzsplit:ks")
    assert tplan.ExecutionPlan.from_json(pj.to_json()) == pt
    assert (jsched.plan_artifact_fields(pj)
            == tsched.plan_artifact_fields(pt))
    assert (jsched.schedule_key("fp", "vd", pj, 8)
            == tsched.schedule_key("fp", "vd", pt, 8))


def test_plan_key_is_tm_independent_and_gates():
    a = tplan.ExecutionPlan(path="nnzsplit", tm=32, k_step_sublanes=4)
    b = tplan.ExecutionPlan(path="nnzsplit", tm=128, k_step_sublanes=4)
    assert a.key() == b.key()
    assert tsched.plan_artifact_fields(a) == tsched.plan_artifact_fields(b)
    plan = tplan.ExecutionPlan(path="nnzsplit")
    assert tplan.feasible(plan, n=64, m=64, bandwidth=10)
    assert not tplan.feasible(plan, n=64, m=96, bandwidth=10)
    i16 = tplan.ExecutionPlan(path="nnzsplit", index_dtype="int16")
    assert tplan.feasible(i16, n=32767, m=32767, bandwidth=10)
    assert not tplan.feasible(i16, n=32768, m=32768, bandwidth=10)
    assert tpaths.NNZSPLIT_SKEW_MIN == jpaths.NNZSPLIT_SKEW_MIN
    assert tpaths.NNZSPLIT_SPREAD_MIN == jpaths.NNZSPLIT_SPREAD_MIN


GATE_MATRICES = {
    "powerlaw": NZ_MATRICES["powerlaw"],
    "random": NZ_MATRICES["random"],
    "poisson2d": lambda: jcsrc.poisson2d(16),
    "skewed_band": lambda: jcsrc.skewed_band(256, 48, 3, seed=1),
    "fem_band": MATRICES["fem_band"],
    "rectangular": lambda: jcsrc.rectangular_fem(48, 16, 4, seed=5),
}


@pytest.mark.parametrize("name", list(GATE_MATRICES))
def test_unstructured_gate_and_candidates_equal(name):
    """``nnzsplit_worth_measuring`` and the nnzsplit enumerator propose the
    reference's plans, in its order, for the same ``MatrixStats``; banded
    and rectangular matrices get none."""
    Mj = GATE_MATRICES[name]()
    sj, st = jtuner.stats_of(Mj), ttuner.stats_of(to_torch_csrc(Mj))
    assert sj.__dict__ == st.__dict__
    gate = tpaths.nnzsplit_worth_measuring(st)
    assert jpaths.nnzsplit_worth_measuring(sj) == gate
    assert gate == name.startswith(("powerlaw", "random"))
    cj = jpaths.get_path("nnzsplit").candidates(sj, jpaths.CandidateSpace())
    ct = tpaths.get_path("nnzsplit").candidates(st, tpaths.CandidateSpace())
    assert [p.to_json() for p in cj] == [p.to_json() for p in ct]
    assert bool(ct) == gate
    if gate:
        assert len({p.k_step_sublanes for p in ct}) > 1       # ks sweep
        assert all(tplan.feasible(p, n=st.n, m=st.m, bandwidth=st.bandwidth)
                   for p in ct)


def test_schedule_bundles_and_binds_the_nnzsplit_pack():
    Mt = to_torch_csrc(NZ_MATRICES["powerlaw"]())
    plan = tplan.ExecutionPlan(path="nnzsplit", k_step_sublanes=2)
    sched = tsched.build_schedule(Mt, plan)
    assert sched.nnzsplit_pack is not None
    assert sched.pack is None and sched.flat_pack is None
    assert sched.coloring is None and sched.partition.starts[-1] == Mt.n
    assert sched.to("cpu") is sched
    op = tops.SpmvOperator.from_plan(Mt, plan, device="cpu", schedule=sched)
    assert isinstance(op.pack, tnz.NnzSplitPack)
    assert op.pack is sched.nnzsplit_pack
    assert op.bytes_per_call == sched.nnzsplit_pack.streamed_bytes() > 0
    moved = sched.to("meta")
    assert moved.nnzsplit_pack.vals.device.type == "meta"


@pytest.mark.parametrize("dtypes", [("int32", "float32"),
                                    ("int16", "bfloat16")])
def test_schedule_npz_written_by_reference_loads_in_port(tmp_path, dtypes):
    Mj = dyadic(NZ_MATRICES["powerlaw"]())
    kw = dict(path="nnzsplit", k_step_sublanes=2, variant="stream",
              index_dtype=dtypes[0], value_dtype=dtypes[1])
    sj = jsched.build_schedule(Mj, jplan.ExecutionPlan(**kw))
    f = str(tmp_path / "nz.npz")
    sj.save_npz(f)
    st = tsched.SpmvSchedule.load_npz(f)
    assert st.key() == sj.key() and st.plan.to_json() == sj.plan.to_json()
    assert_nz_pack_equal(sj.nnzsplit_pack, st.nnzsplit_pack)
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
    Mj = dyadic(NZ_MATRICES["random"]())
    Mt = to_torch_csrc(Mj)
    kw = dict(path="nnzsplit", k_step_sublanes=1,
              index_dtype=dtypes[0], value_dtype=dtypes[1])
    st = tsched.build_schedule(Mt, tplan.ExecutionPlan(**kw))
    f = str(tmp_path / "nz.npz")
    st.save_npz(f)
    sj = jsched.SpmvSchedule.load_npz(f)
    assert sj.key() == st.key()
    assert_nz_pack_equal(sj.nnzsplit_pack, st.nnzsplit_pack)
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


def test_cache_hit_builds_zero_nnzsplit_packs(tmp_path):
    Mt = to_torch_csrc(NZ_MATRICES["powerlaw"]())
    plan = tplan.ExecutionPlan(path="nnzsplit", k_step_sublanes=2)
    cache = ttuner.PlanCache(path=str(tmp_path / "plans.json"))
    op1, d1 = _build_delta(lambda: tops.SpmvOperator.from_plan(
        Mt, plan, cache=cache, device="cpu"))
    assert d1.get("nnzsplit_pack") == 1 and d1.get("schedule") == 1
    op2, d2 = _build_delta(lambda: tops.SpmvOperator.from_plan(
        Mt, plan, cache=cache, device="cpu"))
    assert d2 == {}, f"cache hit rebuilt: {d2}"
    fresh = ttuner.PlanCache(path=str(tmp_path / "plans.json"))
    op3, d3 = _build_delta(lambda: tops.SpmvOperator.from_plan(
        Mt, plan, cache=fresh, device="cpu"))
    assert d3 == {}, f"disk hit rebuilt: {d3}"
    x = torch.from_numpy(dyadic_x(Mt.n, 1, seed=4))
    assert torch.equal(op1(x), op2(x)) and torch.equal(op1(x), op3(x))


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_update_values_refreshes_nnzsplit_without_rebuild(variant):
    Mj = dyadic(NZ_MATRICES["powerlaw"]())
    plan = tplan.ExecutionPlan(path="nnzsplit", k_step_sublanes=2,
                               variant=variant)
    op = tops.SpmvOperator.from_plan(to_torch_csrc(Mj), plan, device="cpu")
    scaled = dataclasses.replace(Mj, ad=2.0 * Mj.ad, al=2.0 * Mj.al,
                                 au=2.0 * Mj.au)
    _, delta = _build_delta(lambda: op.update_values(to_torch_csrc(scaled)))
    assert delta == {"value_refresh": 1}
    x = dyadic_x(Mj.n, 3, seed=5)
    A = jcsrc.to_dense(scaled).astype(np.float64)
    np.testing.assert_array_equal(
        op(torch.from_numpy(x)).numpy(),
        (A @ x.astype(np.float64)).astype(np.float32))


# ---------------------------------------------------------------------------
# Operator, serving and solving through nnzsplit plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(k_step_sublanes=2), dict(k_step_sublanes=8, variant="stream"),
    dict(k_step_sublanes=2, index_dtype="int16"),
    dict(k_step_sublanes=1, index_dtype="int16", value_dtype="bfloat16",
         variant="stream")])
def test_operator_matches_reference_operator(kw):
    Mj = dyadic(NZ_MATRICES["powerlaw"]())
    pj = jplan.ExecutionPlan(path="nnzsplit", **kw)
    pt = tplan.ExecutionPlan(path="nnzsplit", **kw)
    opj = jops.SpmvOperator.from_plan(Mj, pj)
    opt = tops.SpmvOperator.from_plan(to_torch_csrc(Mj), pt, device="cpu")
    assert opt.plan.key() == opj.plan.key() and opt.path == "nnzsplit"
    for nrhs in (1, 3):
        x = dyadic_x(Mj.n, nrhs, seed=nrhs)
        np.testing.assert_array_equal(np.asarray(opj(jnp.asarray(x))),
                                      opt(torch.from_numpy(x)).numpy())


def test_rectangular_matrix_is_refused():
    Mt = to_torch_csrc(jcsrc.rectangular_fem(48, 16, 4, seed=5))
    with pytest.raises(ValueError, match="square"):
        tops.SpmvOperator.from_plan(Mt, tplan.ExecutionPlan(path="nnzsplit"),
                                    device="cpu")


def test_nnzsplit_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    Mt = to_torch_csrc(NZ_MATRICES["powerlaw"]())
    plan = tplan.ExecutionPlan(path="nnzsplit")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.SpmvOperator.from_plan(Mt, plan)
    with pytest.raises(RuntimeError, match="cuda"):
        tsolvers.cg_solve(Mt, torch.zeros(Mt.n), plan=plan)
    with pytest.raises(RuntimeError, match="cuda"):
        SpmvServingEngine().register("pl", Mt, plan=plan)


def test_serving_engine_answers_through_an_nnzsplit_plan():
    Mj = NZ_MATRICES["powerlaw"]()
    kw = dict(path="nnzsplit", k_step_sublanes=2)
    ej, et = JEngine(), SpmvServingEngine(device="cpu")
    pj = ej.register("pl", Mj, plan=jplan.ExecutionPlan(**kw))
    pt = et.register("pl", to_torch_csrc(Mj), plan=tplan.ExecutionPlan(**kw))
    assert pj.to_json() == pt.to_json()
    uids = []
    for i in range(4):
        x = dyadic_x(Mj.n, 1, seed=20 + i)
        uids.append(et.submit("pl", x))
        assert ej.submit("pl", x) == uids[-1]
    outj, outt = ej.run_until_drained(), et.run_until_drained()
    assert set(outt) == set(uids)
    A = jcsrc.to_dense(Mj).astype(np.float64)
    for i, u in enumerate(uids):
        np.testing.assert_array_equal(np.asarray(outj[u]),
                                      np.asarray(outt[u]))
        x = dyadic_x(Mj.n, 1, seed=20 + i)
        np.testing.assert_array_equal(
            np.asarray(outt[u]), (A @ x.astype(np.float64)).astype(
                np.float32))
        meta = outt[u].meta()
        assert meta["path"] == "nnzsplit" and meta["batched"] == 4
        assert meta["plan_key"] == pj.key()


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_cg_solve_nnzsplit_plan_same_iterations(variant):
    Mj = jcsrc.powerlaw_laplacian(400, seed=6)
    Mj = dataclasses.replace(Mj, ad=Mj.ad + 1.0)         # SPD, not singular
    b = np.random.default_rng(3).standard_normal((Mj.n, 2)).astype(
        np.float32)
    kw = dict(path="nnzsplit", k_step_sublanes=2, variant=variant)
    rj, opj = jsolvers.cg_solve(Mj, jnp.asarray(b),
                                plan=jplan.ExecutionPlan(**kw))
    rt, opt = tsolvers.cg_solve(to_torch_csrc(Mj), torch.from_numpy(b),
                                plan=tplan.ExecutionPlan(**kw), device="cpu")
    assert opt.plan.key() == opj.plan.key() and opt.path == "nnzsplit"
    assert rt.converged and rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                               atol=1e-6)


def test_from_scipy_roundtrip_through_nnzsplit():
    """The JAX package's TestFromScipy: a scipy matrix ingested and run
    through an nnzsplit plan, bit for bit."""
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(0)
    A = sp.random(60, 60, density=0.08, random_state=0,
                  data_rvs=lambda k: rng.integers(-8, 8, k) / 4.0)
    A = (A + A.T).tocsr()                    # structurally symmetric
    A.setdiag(np.arange(1.0, 61.0))
    Mt = tcsrc.CSRC.from_scipy(A)
    Mj = jcsrc.CSRC.from_scipy(A)
    np.testing.assert_array_equal(tcsrc.to_dense(Mt),
                                  A.toarray().astype(np.float32))
    x = dyadic_x(60, 1, seed=7)
    plan = dict(path="nnzsplit", k_step_sublanes=2)
    y = tops.SpmvOperator.from_plan(Mt, tplan.ExecutionPlan(**plan),
                                    device="cpu")(torch.from_numpy(x))
    ref = (A.toarray().astype(np.float64)
           @ x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(y.numpy(), ref)
    yj = jops.SpmvOperator.from_plan(Mj, jplan.ExecutionPlan(**plan))(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(yj), y.numpy())
