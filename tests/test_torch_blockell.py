"""Block-ELL pack, value refresh and overlap-add of the port held against
the JAX package array for array, bf16 / int16 streams included."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import blockell as jbe
from repro.core import csrc as jcsrc
from repro_torch.core import blockell as tbe
from repro_torch.core import csrc as tcsrc
from repro_torch.kernels import csrc_spmv_flat as tfl

from _smoke import chip_smoke
from test_torch_parity_helpers import (MATRICES, assert_pack_equal, np32,
                                       to_torch_csrc, to_torch_pack)

DTYPES = {
    "f32_i32": (jnp.float32, jnp.int32, torch.float32, torch.int32),
    "bf16_i16": (jnp.bfloat16, jnp.int16, torch.bfloat16, torch.int16),
    "f32_i16": (jnp.float32, jnp.int16, torch.float32, torch.int16),
}


def _packs(Mj, tm, k_step, dt):
    jv, ji, tv, ti = DTYPES[dt]
    pj = jbe.pack(Mj, tm=tm, k_step=k_step, dtype=jv, index_dtype=ji)
    pt = tbe.pack(to_torch_csrc(Mj), tm=tm, k_step=k_step, dtype=tv,
                  index_dtype=ti)
    return pj, pt


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("tm,k_step", [(128, 1024), (32, 256), (8, 128)])
@pytest.mark.parametrize("name", list(MATRICES))
def test_pack_equal(name, tm, k_step, dt):
    """The vectorized fill gives the reference's per-slot loop, exactly."""
    pj, pt = _packs(MATRICES[name](), tm, k_step, dt)
    assert_pack_equal(pj, pt)
    assert pj.streamed_bytes() == pt.streamed_bytes()
    assert pj.n_pad == pt.n_pad


def test_pack_sentinels_and_alias():
    pj, pt = _packs(MATRICES["fem_band_sym"](), 32, 256, "f32_i32")
    assert pt.vals_u is pt.vals_l                 # one stream when symmetric
    pad = pt.col_local == pt.w_pad
    assert pad.any()
    assert (pt.row_in_win[pad] == pt.w_pad - 1).all()
    assert (pt.vals_l[pad] == 0).all()
    # the B-wide terms of streamed_bytes: x and the window partials
    extra = (pt.n_pad + pt.w_pad) * 4 + pt.nt * pt.w_pad * 4
    assert pt.streamed_bytes(nrhs=8) == pt.streamed_bytes() + 7 * extra



@pytest.mark.parametrize("grid", ["rect", "flat"])
@pytest.mark.parametrize("dt", ["f32_i32", "bf16_i16"])
@pytest.mark.parametrize("name", ["fem_band", "fem_band_sym", "empty_rows"])
def test_padding_bytes_count_the_layout_not_the_product(name, dt, grid):
    """``streamed_bytes`` less ``padding_bytes`` is what one product must
    move — each lower slot's values and indices once (one value stream
    when numerically symmetric), the diagonal, x and the window partials —
    and the padded slots' share is the layout's."""
    _, _, tv, ti = DTYPES[dt]
    Mt = to_torch_csrc(MATRICES[name]())
    if grid == "rect":
        pt = tbe.pack(Mt, tm=32, k_step=256, dtype=tv, index_dtype=ti)
    else:
        pt = tfl.pack_flat(Mt, tm=32, ks=2, dtype=tv, index_dtype=ti)
    per_slot = ((1 if pt.num_symmetric else 2) * pt.vals_l.element_size()
                + 2 * pt.col_local.element_size())
    k = int(Mt.ja.shape[0])
    padded = pt.col_local.numel() - k
    assert padded > 0
    assert tbe.padding_bytes(pt) == padded * per_slot
    for nrhs in (1, 3):
        rest = (pt.ad.numel() * pt.ad.element_size()
                + ((pt.n_pad + pt.w_pad) + pt.nt * pt.w_pad) * 4 * nrhs)
        assert (pt.streamed_bytes(nrhs) - tbe.padding_bytes(pt)
                == k * per_slot + rest)


@pytest.mark.parametrize("grid,case,ks", [
    ("rect", "row_spans_steps", 1), ("rect", "bucket_128", 8),
    ("rect", "padding_only_steps", 8), ("rect", "w4096", 8),
    ("rect", "warp_run_edges", 8),
    ("flat", "row_spans_steps", 1), ("flat", "bucket_128", 8),
    ("flat", "w4096", 8), ("flat", "warp_run_edges", 8)])
def test_onehot_adversary_packs_have_their_features(grid, case, ks):
    """``chip_smoke.py``'s adversary matrices for the one-hot kernels
    (K3/K4 rectangular, K7/K8 flat) and the stream SpMVs' warp runs (K1,
    K5; shared with the card tests) give packs with the feature each case
    aims at, in the slot order the kernels need (``check_slot_order``
    passed where they were built)."""
    sm = chip_smoke()
    arrays = sm.onehot_adversary_arrays(case, seed=0)
    M = tcsrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    if grid == "rect":
        pack, step = tbe.pack(M, k_step=ks * 128), ks * 128
    else:
        pack = tfl.pack_flat(M, ks=ks)
        step = pack.step
    geometry = sm.onehot_step_geometry(pack, step)
    assert sm.onehot_case_holds(case, geometry), geometry
    assert tbe.padding_bytes(pack) > 0

def test_pack_gates_raise_like_reference():
    Mj = jcsrc.fem_band(300, 200, seed=1, fill=0.1)
    Mt = to_torch_csrc(Mj)
    for fn, M in ((jbe.pack, Mj), (tbe.pack, Mt)):
        with pytest.raises(ValueError, match="cap"):
            fn(M, tm=128, w_cap=256)
    with pytest.raises(ValueError):
        tbe.pack(to_torch_csrc(jcsrc.rectangular_fem(40, 5, 3)), tm=32)


def test_convert_pack_roundtrip():
    pj, pt = _packs(MATRICES["fem_band"](), 32, 256, "bf16_i16")
    assert_pack_equal(pj, to_torch_pack(pj))
    assert pt.to("cpu") is pt


@pytest.mark.parametrize("dt", ["f32_i32", "bf16_i16"])
@pytest.mark.parametrize("name", ["fem_band", "fem_band_sym", "tail_tile"])
def test_refresh_values_equal(name, dt):
    Mj = MATRICES[name]()
    pj, pt = _packs(Mj, 32, 256, dt)
    scale = lambda a: np.asarray(a) * np.float32(0.75)
    Mj2 = dataclasses.replace(Mj, ad=scale(Mj.ad), al=scale(Mj.al),
                              au=scale(Mj.au))
    rj = jbe.refresh_values(pj, Mj2)
    rt = tbe.refresh_values(pt, to_torch_csrc(Mj2))
    assert_pack_equal(rj, rt)
    assert rt.col_local is pt.col_local           # index streams reused
    # and a refresh equals a fresh pack of the new matrix
    assert_pack_equal(rj, _packs(Mj2, 32, 256, dt)[1])


def test_refresh_rejects_symmetry_flip():
    Mj = MATRICES["fem_band_sym"]()
    _, pt = _packs(Mj, 32, 256, "f32_i32")
    flipped = dataclasses.replace(Mj, au=np.asarray(Mj.au) * 2,
                                  numerically_symmetric=False)
    with pytest.raises(ValueError, match="symmetry"):
        tbe.refresh_values(pt, to_torch_csrc(flipped))


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name,tm", [("fem_band", 32), ("tail_tile", 128),
                                     ("poisson2d", 8)])
def test_overlap_add_equal(name, tm, nrhs):
    """Same group decomposition, same order of additions: equal even on
    general values."""
    pj, pt = _packs(MATRICES[name](), tm, 128, "f32_i32")
    shape = (pj.nt, pj.w_pad) + ((nrhs,) if nrhs > 1 else ())
    wins = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    if nrhs == 1:
        yj = jbe.overlap_add(pj, jnp.asarray(wins))
        yt = tbe.overlap_add(pt, torch.from_numpy(wins))
    else:
        yj = jbe.overlap_add_mm(pj, jnp.asarray(wins))
        yt = tbe.overlap_add_mm(pt, torch.from_numpy(wins))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def test_pad_x_equal():
    pj, pt = _packs(MATRICES["tail_tile"](), 32, 256, "f32_i32")
    x = np.arange(pj.n, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(jbe.pad_x(pj, jnp.asarray(x))),
                                  np32(tbe.pad_x(pt, torch.from_numpy(x))))
    X = np.stack([x, -x], axis=1)
    assert tbe.pad_x(pt, torch.from_numpy(X)).shape == (pt.w_pad + pt.n_pad, 2)
