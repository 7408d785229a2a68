"""The plain PyTorch versions of the four window kernels (K1 stream SpMV,
K2 stream SpMM, K3 one-hot SpMV, K4 one-hot SpMM) held against the JAX
package's Pallas bodies run in interpret mode: the same (NT, W[, B])
windows and the same products.

Dyadic values make float32 sums exact in any order, so those comparisons
are ``assert_array_equal``.  On general values the packages sum in
different orders; the stated bound is 1e-5 of the row's absolute sum.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import blockell as jbe
from repro.core import csrc as jcsrc
from repro.kernels import csrc_spmm as jmm
from repro.kernels import csrc_spmv as jmv
from repro.kernels import csrc_spmv_stream as jstream
from repro_torch.core import blockell as tbe
from repro_torch.kernels import _build
from repro_torch.kernels import csrc_segment  # noqa: F401  (registers K15)
from repro_torch.kernels import csrc_spmm as tmm
from repro_torch.kernels import csrc_spmv as tmv
from repro_torch.kernels import csrc_spmv_stream as tstream

from _smoke import chip_smoke
from test_torch_parity_helpers import (MATRICES, dyadic, dyadic_x,
                                       to_torch_csrc)

KS = 2                       # k-step of 256 slots: two or more steps per tile
CASES = [("fem_band", 32), ("fem_band_sym", 32), ("tail_tile", 128),
         ("empty_rows", 32), ("poisson2d", 8)]


def _packs(name, tm, jv=jnp.float32, ji=jnp.int32, tv=torch.float32,
           ti=torch.int32, quantize=True):
    Mj = MATRICES[name]()
    Mj = dyadic(Mj) if quantize else Mj
    pj = jbe.pack(Mj, tm=tm, k_step=KS * 128, dtype=jv, index_dtype=ji)
    pt = tbe.pack(to_torch_csrc(Mj), tm=tm, k_step=KS * 128, dtype=tv,
                  index_dtype=ti)
    return Mj, pj, pt


@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,tm", CASES)
def test_spmv_windows_bit_identical(name, tm, variant):
    """K1 / K3 plain versions: the (NT, W) windows of the Pallas body."""
    Mj, pj, pt = _packs(name, tm)
    x = dyadic_x(Mj.n, 1, seed=3)
    wj = jmv.blockell_spmv_windows(pj, jnp.asarray(x), k_step_sublanes=KS,
                                   interpret=True, variant=variant)
    wt = tmv.blockell_spmv_windows(pt, torch.from_numpy(x),
                                   k_step_sublanes=KS, variant=variant)
    assert wt.dtype == torch.float32 and wt.shape == (pt.nt, pt.w_pad)
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())


@pytest.mark.parametrize("nrhs", [1, 3, 8])
@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,tm", CASES)
def test_spmm_bit_identical(name, tm, variant, nrhs):
    """K2 / K4 plain versions through ``blockell_spmm``, and the windows
    they sum."""
    Mj, pj, pt = _packs(name, tm)
    X = dyadic_x(Mj.n, nrhs, seed=nrhs).reshape(Mj.n, nrhs)
    yj = jmm.blockell_spmm(pj, jnp.asarray(X), k_step_sublanes=KS,
                           interpret=True, variant=variant)
    yt = tmm.blockell_spmm(pt, torch.from_numpy(X), k_step_sublanes=KS,
                           variant=variant)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ X.astype(np.float64)).astype(np.float32))
    wins = tmm.blockell_spmm_windows(pt, torch.from_numpy(X),
                                     k_step_sublanes=KS, variant=variant)
    assert wins.shape == (pt.nt, pt.w_pad, nrhs)
    np.testing.assert_array_equal(tbe.overlap_add_mm(pt, wins).numpy(),
                                  yt.numpy())


@pytest.mark.parametrize("variant", ["onehot", "stream"])
@pytest.mark.parametrize("name,tm", CASES)
def test_spmv_product_bit_identical(name, tm, variant):
    Mj, pj, pt = _packs(name, tm)
    x = dyadic_x(Mj.n, 1, seed=5)
    yj = jmv.blockell_spmv(pj, jnp.asarray(x), interpret=True,
                           k_step_sublanes=KS, variant=variant)
    yt = tmv.blockell_spmv(pt, torch.from_numpy(x), k_step_sublanes=KS,
                           variant=variant)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_bf16_int16_streams_bit_identical(variant):
    """Reduced streams: upcast in registers, products and sums in float32."""
    Mj, pj, pt = _packs("fem_band_sym", 32, jnp.bfloat16, jnp.int16,
                        torch.bfloat16, torch.int16)
    x = dyadic_x(Mj.n, 1, seed=7)
    wj = jmv.blockell_spmv_windows(pj, jnp.asarray(x), k_step_sublanes=KS,
                                   interpret=True, variant=variant)
    wt = tmv.blockell_spmv_windows(pt, torch.from_numpy(x),
                                   k_step_sublanes=KS, variant=variant)
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())
    X = dyadic_x(Mj.n, 3, seed=8)
    np.testing.assert_array_equal(
        np.asarray(jmm.blockell_spmm(pj, jnp.asarray(X), k_step_sublanes=KS,
                                     interpret=True, variant=variant)),
        tmm.blockell_spmm(pt, torch.from_numpy(X), k_step_sublanes=KS,
                          variant=variant).numpy())


@pytest.mark.parametrize("nrhs", [1, 3])
def test_fused_stream_executors_equal(nrhs):
    """The fused forms (the plain versions of K1/K2) against the JAX
    package's fused executors: same gathers, same segment ids."""
    Mj, pj, pt = _packs("fem_band", 32)
    x = dyadic_x(Mj.n, nrhs, seed=11)
    if nrhs == 1:
        yj = jstream.blockell_spmv_stream(pj, jnp.asarray(x),
                                          k_step_sublanes=KS)
        yt = tstream.blockell_spmv_stream(pt, torch.from_numpy(x),
                                          k_step_sublanes=KS)
    else:
        yj = jstream.blockell_spmm_stream(pj, jnp.asarray(x),
                                          k_step_sublanes=KS)
        yt = tstream.blockell_spmm_stream(pt, torch.from_numpy(x),
                                          k_step_sublanes=KS)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_general_values_within_rowsum_tolerance(variant):
    """General values: |port - reference| <= 1e-5 of the row's absolute
    sum (float32 rounding of sums taken in different orders)."""
    Mj, pj, pt = _packs("fem_band", 32, quantize=False)
    x = np.random.default_rng(0).standard_normal((Mj.n, 3)).astype(np.float32)
    yj = np.asarray(jmm.blockell_spmm(pj, jnp.asarray(x), k_step_sublanes=KS,
                                      interpret=True, variant=variant))
    yt = tmm.blockell_spmm(pt, torch.from_numpy(x), k_step_sublanes=KS,
                           variant=variant).numpy()
    bound = 1e-5 * (np.abs(jcsrc.to_dense(Mj)) @ np.abs(x))
    assert (np.abs(yj - yt) <= bound).all()


@pytest.mark.parametrize("variant", ["onehot", "stream"])
def test_windows_bit_identical_on_warp_run_edges(variant):
    """K1 / K3 plain versions against the Pallas bodies on the matrix of
    ``chip_smoke.py``'s ``warp_run_edges`` (row widths cycling over 1, 1,
    1..33, 64, 128 and 300: the card's K1 warps see runs end at every
    position): the (NT, W) windows and the product, bit for bit on dyadic
    data."""
    arrays = chip_smoke().onehot_adversary_arrays("warp_run_edges", seed=0)
    n = arrays[0].shape[0] - 1
    Mj = jcsrc.from_assembly(n, *arrays)
    pj = jbe.pack(Mj, k_step=8 * 128)
    pt = tbe.pack(to_torch_csrc(Mj), k_step=8 * 128)
    x = dyadic_x(n, 1, seed=4)
    wj = jmv.blockell_spmv_windows(pj, jnp.asarray(x), k_step_sublanes=8,
                                   interpret=True, variant=variant)
    wt = tmv.blockell_spmv_windows(pt, torch.from_numpy(x),
                                   k_step_sublanes=8, variant=variant)
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    yt = tmv.blockell_spmv(pt, torch.from_numpy(x), k_step_sublanes=8,
                           variant=variant)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ x.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("nrhs", [3, 11])
def test_spmm_stream_bit_identical_on_warp_run_edges(nrhs):
    """K2's plain version against the Pallas body (``variant="stream"``) on
    the matrix of ``chip_smoke.py``'s ``warp_run_edges`` (row widths
    cycling over 1, 1, 1..33, 64, 128 and 300: on the card K2's warps see
    runs end at every position, once per column): the product and the
    dense one, bit for bit on dyadic data, and the windows it sums."""
    arrays = chip_smoke().onehot_adversary_arrays("warp_run_edges", seed=0)
    n = arrays[0].shape[0] - 1
    Mj = jcsrc.from_assembly(n, *arrays)
    pj = jbe.pack(Mj, k_step=8 * 128)
    pt = tbe.pack(to_torch_csrc(Mj), k_step=8 * 128)
    X = dyadic_x(n, nrhs, seed=5).reshape(n, nrhs)
    yj = jmm.blockell_spmm(pj, jnp.asarray(X), k_step_sublanes=8,
                           interpret=True, variant="stream")
    yt = tmm.blockell_spmm(pt, torch.from_numpy(X), k_step_sublanes=8,
                           variant="stream")
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    A = jcsrc.to_dense(Mj).astype(np.float64)
    np.testing.assert_array_equal(
        yt.numpy(), (A @ X.astype(np.float64)).astype(np.float32))
    wins = tmm.blockell_spmm_windows(pt, torch.from_numpy(X),
                                     k_step_sublanes=8, variant="stream")
    np.testing.assert_array_equal(tbe.overlap_add_mm(pt, wins).numpy(),
                                  yt.numpy())


def test_onehot_plain_chunking_does_not_change_result(monkeypatch):
    Mj, pj, pt = _packs("fem_band", 32)
    x = torch.from_numpy(dyadic_x(Mj.n, 3, seed=2))
    whole = tmm.spmm_windows_onehot_plain(pt, x, KS * 128)
    monkeypatch.setattr(tmv, "_MASK_ELEMENTS", 1)     # one tile per chunk
    assert torch.equal(whole, tmm.spmm_windows_onehot_plain(pt, x, KS * 128))


def test_stream_spmv_lane_loads_need_whole_warps_and_aligned_streams():
    """K1/K5 load four consecutive slots per lane and 128 per warp:
    ``_build.check_lane_loads`` passes every packer's output and refuses a
    slot count that is not a multiple of 128 and a slot stream that does
    not start on a 16-byte boundary, before a launch could fault."""
    import dataclasses
    from repro_torch.kernels import csrc_spmv_flat as tfl
    _, _, pt = _packs("fem_band", 32)
    _build.check_lane_loads(pt, pt.s)
    pf = tfl.pack_flat(to_torch_csrc(MATRICES["fem_band"]()), tm=32, ks=1)
    _build.check_lane_loads(pf, pf.step)
    with pytest.raises(ValueError, match="multiple of 128"):
        _build.check_lane_loads(pt, 192)
    shifted = torch.empty(pt.col_local.numel() + 1, dtype=torch.int32)[1:]
    shifted.copy_(pt.col_local.reshape(-1))
    bad = dataclasses.replace(pt, col_local=shifted.view(pt.nt, pt.s))
    with pytest.raises(ValueError, match="16-byte boundary"):
        _build.check_lane_loads(bad, bad.s)


@pytest.mark.parametrize("grid", ["rect", "flat"])
def test_spmm_stream_wrappers_check_lane_loads_before_building(grid,
                                                               monkeypatch):
    """K2/K6 load four slots per lane like K1/K5: their wrappers run
    ``_build.check_lane_loads`` before anything is built or launched, so a
    slot stream off a 16-byte boundary raises ValueError there.  (The
    operands' CUDA-tensor check is stubbed so that a CPU pack reaches it.)"""
    import dataclasses
    from repro_torch.kernels import csrc_spmv_flat as tfl
    M = to_torch_csrc(MATRICES["fem_band"]())
    if grid == "rect":
        pack = tbe.pack(M, tm=32, k_step=KS * 128)
        monkeypatch.setattr(tmm, "_kernel_operands",
                            lambda p, x, ndim: (x, (), ()))
        wrapper, name = tmm.spmm_windows_stream_cuda, "blockell_spmm_stream"
    else:
        pack = tfl.pack_flat(M, tm=32, ks=1)
        monkeypatch.setattr(tfl, "_launch_operands",
                            lambda p, x, ndim: (x, (), ()))
        wrapper, name = tfl.flat_spmm_stream_cuda, "flat_spmm_stream"

    def no_build(*args, **kwargs):
        raise AssertionError("a kernel was built before the lane-load check")
    monkeypatch.setattr(_build, "build", no_build)
    shifted = torch.empty(pack.row_in_win.numel() + 1,
                          dtype=pack.row_in_win.dtype)[1:]
    shifted.copy_(pack.row_in_win.reshape(-1))
    bad = dataclasses.replace(pack, row_in_win=shifted.view(
        pack.row_in_win.shape))
    before = _build.launch_counts()[name]
    with pytest.raises(ValueError, match="16-byte boundary"):
        wrapper(bad, torch.ones((M.n, 3)))
    assert _build.launch_counts()[name] == before


def test_wrappers_validate_and_never_launch_on_cpu():
    Mj, pj, pt = _packs("fem_band", 32)
    x = torch.from_numpy(dyadic_x(Mj.n, 1))
    before = _build.launch_counts()
    tmv.blockell_spmv_windows(pt, x, k_step_sublanes=KS, variant="stream")
    tmm.blockell_spmm_windows(pt, x[:, None], k_step_sublanes=KS)
    assert _build.launch_counts() == before       # CPU tensors: plain only
    assert {"blockell_spmv_stream", "blockell_spmv_onehot",
            "blockell_spmm_stream", "blockell_spmm_onehot"} <= set(before)
    for launch in (lambda: tmv.spmv_windows_stream_cuda(pt, x),
                   lambda: tmv.spmv_windows_onehot_cuda(pt, x, KS * 128),
                   lambda: tmm.spmm_windows_stream_cuda(pt, x[:, None]),
                   lambda: tmm.spmm_windows_onehot_cuda(pt, x[:, None],
                                                        KS * 128)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    with pytest.raises(ValueError, match="variant"):
        tmv.blockell_spmv_windows(pt, x, k_step_sublanes=KS, variant="mxu")
    with pytest.raises(ValueError, match="k-steps"):
        tmv.blockell_spmv_windows(pt, x, k_step_sublanes=3)
    with pytest.raises(ValueError, match="shape"):
        tmv.blockell_spmv_windows(pt, x[:-1], k_step_sublanes=KS)
    with pytest.raises(ValueError, match="shape"):
        tmm.blockell_spmm_windows(pt, x, k_step_sublanes=KS)


def test_kernel_sources_and_notes_exist():
    """Every registered kernel has its CUDA source in the package and names
    the TPU body it replaces as ``file:line``, or, where its note says it
    replaces no TPU body (K15, added on the card alone), the JAX package's
    plain function it stands in for; every header beside the sources is in
    ``_build._HEADERS``, so an edit to it rebuilds every kernel."""
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    headers = sorted(f for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cuh"))
    assert headers == sorted(_build._HEADERS)
    assert "warp_scan.cuh" in headers
    for k in _build.KERNELS.values():
        assert os.path.isfile(k.source), k.source
        src = open(k.source).read()
        assert f'extern "C" int {k.name}(' in src
        assert "Bound on this card" in src
        path, line = k.replaces.rsplit(":", 1)
        body = open(os.path.join(root, path)).read().split("\n")[int(line) - 1]
        if "Replaces no TPU body" in src:
            # the JAX package's plain segment product (hopper-kernels §3)
            assert path == "src/repro/kernels/ref.py", (k.name, path)
            assert re.match(r"def csrc_spmm\(", body), (k.name, body)
        else:
            assert "Replaces the TPU body" in src
            # the def line of a Pallas body: _kernel*, _colored_kernel_*
            assert re.match(r"def _\w*kernel\w*\(", body), (k.name, body)
        assert k.repo_source == os.path.relpath(k.source, root)


def test_column_tile_fits_shared_memory_budget():
    for w_pad in (128, 256, 1024, 4096):
        for nrhs in (1, 3, 8, 64):
            for tiles in (1, 2):
                bt = tmm.column_tile(w_pad, nrhs, tiles)
                assert 1 <= bt <= nrhs
                assert bt == 1 or 4 * w_pad * bt * tiles <= 64 * 1024
