"""The CUDA kernels (K1-K12) against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere (the check
is made inside the fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at more shapes and at the
main path's size; this file is the pytest form of the core of them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import blockell, csrc
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import _build
from repro_torch.kernels import csrc_spmm as mm
from repro_torch.kernels import csrc_spmv as mv
from repro_torch.kernels import csrc_spmv_flat as fl
from repro_torch.kernels import csrc_spmv_nnzsplit as nz
from repro_torch.kernels.ops import SpmvOperator

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _dyadic_matrix(n=1000, half_band=24, symmetric=False, seed=0):
    rng = np.random.default_rng(seed)
    M = csrc.fem_band(n, half_band, seed=seed, numeric_symmetric=symmetric)

    def q(a):
        return torch.round(a * 4.0) / 4.0
    import dataclasses
    return dataclasses.replace(M, ad=q(M.ad), al=q(M.al), au=q(M.au)), rng


@pytest.mark.parametrize("vdt,idt", [(torch.float32, torch.int32),
                                     (torch.bfloat16, torch.int16)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_kernels_equal_plain_versions_on_dyadic_data(card, vdt, idt,
                                                     symmetric):
    M, rng = _dyadic_matrix(symmetric=symmetric)
    pack = blockell.pack(M, dtype=vdt, index_dtype=idt).to(card)
    x = torch.from_numpy((rng.integers(-8, 9, M.n) / 8).astype(np.float32)
                         ).to(card)
    X = torch.from_numpy((rng.integers(-8, 9, (M.n, 5)) / 8
                          ).astype(np.float32)).to(card)
    before = _build.launch_counts()
    assert torch.equal(mv.spmv_windows_stream_cuda(pack, x),
                       mv.spmv_windows_stream_plain(pack, x))
    assert torch.equal(mv.spmv_windows_onehot_cuda(pack, x, 1024),
                       mv.spmv_windows_onehot_plain(pack, x, 1024))
    assert torch.equal(mm.spmm_windows_stream_cuda(pack, X),
                       mm.spmm_windows_stream_plain(pack, X))
    assert torch.equal(mm.spmm_windows_onehot_cuda(pack, X, 1024),
                       mm.spmm_windows_onehot_plain(pack, X, 1024))
    after = _build.launch_counts()
    assert all(after[k] == before[k] + 1 for k in
               ("blockell_spmv_stream", "blockell_spmv_onehot",
                "blockell_spmm_stream", "blockell_spmm_onehot"))


def test_operator_on_the_card_launches_kernels_and_matches_segment(card):
    M, rng = _dyadic_matrix(n=3000)
    x = torch.from_numpy((rng.integers(-8, 9, (M.n, 3)) / 8
                          ).astype(np.float32))
    want = SpmvOperator(M, path="segment")(x.cuda())
    for variant, kernel in (("stream", "blockell_spmm_stream"),
                            ("onehot", "blockell_spmm_onehot")):
        op = SpmvOperator.from_plan(M, ExecutionPlan(path="kernel",
                                                     variant=variant))
        assert op.device.type == "cuda"
        before = _build.launch_counts()[kernel]
        assert torch.equal(op(x.cuda()), want)
        assert _build.launch_counts()[kernel] == before + 1
        with pytest.raises(ValueError, match="bound to"):
            op(x)                      # a CPU tensor is refused, not served


def _dyadic_skewed(n=3000, symmetric=False, seed=0):
    """A skewed matrix (wide band on the first 6 % of rows) whose tiles
    carry 1 to many k-steps of 256 slots."""
    M = csrc.skewed_band(n, 150, 3, seed=seed, numeric_symmetric=symmetric)

    def q(a):
        return torch.round(a * 4.0) / 4.0
    import dataclasses
    return dataclasses.replace(M, ad=q(M.ad), al=q(M.al), au=q(M.au))


@pytest.mark.parametrize("vdt,idt", [(torch.float32, torch.int32),
                                     (torch.bfloat16, torch.int16)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_flat_kernels_equal_plain_versions_on_dyadic_data(card, vdt, idt,
                                                          symmetric):
    """K5-K8, each launched once, against their plain versions."""
    M = _dyadic_skewed(symmetric=symmetric)
    pack = fl.pack_flat(M, ks=2, dtype=vdt, index_dtype=idt).to(card)
    steps = torch.diff(pack.step_start.cpu())
    assert steps.min() == 1 and steps.max() > 1
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.integers(-8, 9, M.n) / 8).astype(np.float32)
                         ).to(card)
    X = torch.from_numpy((rng.integers(-8, 9, (M.n, 5)) / 8
                          ).astype(np.float32)).to(card)
    names = ("flat_spmv_stream", "flat_spmv_onehot", "flat_spmm_stream",
             "flat_spmm_onehot")
    before = _build.launch_counts()
    assert torch.equal(fl.flat_spmv_stream_cuda(pack, x),
                       fl.flat_windows_stream_plain(pack, x))
    assert torch.equal(fl.flat_spmv_onehot_cuda(pack, x),
                       fl.flat_windows_onehot_plain(pack, x))
    assert torch.equal(fl.flat_spmm_stream_cuda(pack, X),
                       fl.flat_windows_stream_plain(pack, X))
    assert torch.equal(fl.flat_spmm_onehot_cuda(pack, X),
                       fl.flat_windows_onehot_plain(pack, X))
    after = _build.launch_counts()
    assert all(after[k] == before[k] + 1 for k in names)


def test_flat_plan_on_the_card_launches_kernels_and_matches_segment(card):
    M = _dyadic_skewed(n=5000)
    x = torch.from_numpy((np.random.default_rng(2).integers(-8, 9, (M.n, 3))
                          / 8).astype(np.float32))
    want = SpmvOperator(M, path="segment")(x.cuda())
    for variant, kernel in (("stream", "flat_spmm_stream"),
                            ("onehot", "flat_spmm_onehot")):
        op = SpmvOperator.from_plan(M, ExecutionPlan(path="flat",
                                                     variant=variant))
        assert isinstance(op.pack, fl.FlatBlockEll)
        assert op.pack.device.type == "cuda"
        before = _build.launch_counts()[kernel]
        assert torch.equal(op(x.cuda()), want)
        assert _build.launch_counts()[kernel] == before + 1


def _dyadic_powerlaw(n=3000, seed=0, symmetric=True):
    """A power-law graph Laplacian (hub rows, labels shuffled) with dyadic
    values; ``symmetric=False`` scales the upper half."""
    import dataclasses
    M = csrc.powerlaw_laplacian(n, attach=8, seed=seed)
    if symmetric:
        return M
    return dataclasses.replace(M, au=0.5 * M.au, numerically_symmetric=False)


@pytest.mark.parametrize("vdt,idt", [(torch.float32, torch.int32),
                                     (torch.bfloat16, torch.int16)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_nnzsplit_kernels_equal_plain_versions_on_dyadic_data(
        card, vdt, idt, symmetric):
    """K9-K12, each launched once, against their plain versions on the
    (C, r_pad[, B]) partials; the one-hot kernels repeat bit for bit."""
    M = _dyadic_powerlaw(symmetric=symmetric)
    pack = nz.pack_nnzsplit(M, ks=2, dtype=vdt, index_dtype=idt).to(card)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.integers(-8, 9, M.n) / 8).astype(np.float32)
                         ).to(card)
    X = torch.from_numpy((rng.integers(-8, 9, (M.n, 5)) / 8
                          ).astype(np.float32)).to(card)
    names = ("nnzsplit_spmv_stream", "nnzsplit_spmv_onehot",
             "nnzsplit_spmm_stream", "nnzsplit_spmm_onehot")
    before = _build.launch_counts()
    assert torch.equal(nz.nnzsplit_spmv_stream_cuda(pack, x),
                       nz.nnzsplit_partials_stream_plain(pack, x))
    once = nz.nnzsplit_spmv_onehot_cuda(pack, x)
    assert torch.equal(once, nz.nnzsplit_partials_onehot_plain(pack, x))
    assert torch.equal(nz.nnzsplit_spmm_stream_cuda(pack, X),
                       nz.nnzsplit_partials_stream_plain(pack, X))
    assert torch.equal(nz.nnzsplit_spmm_onehot_cuda(pack, X),
                       nz.nnzsplit_partials_onehot_plain(pack, X))
    after = _build.launch_counts()
    assert all(after[k] == before[k] + 1 for k in names)
    assert torch.equal(once, nz.nnzsplit_spmv_onehot_cuda(pack, x))


def test_nnzsplit_and_colorful_plans_on_the_card_match_segment(card):
    """Both variants of an nnzsplit plan launch their kernel through
    ``SpmvOperator``; a colorful plan answers on the card; all equal the
    segment path on dyadic data."""
    M = _dyadic_powerlaw(n=5000, symmetric=False)
    x = torch.from_numpy((np.random.default_rng(4).integers(-8, 9, (M.n, 3))
                          / 8).astype(np.float32))
    want = SpmvOperator(M, path="segment")(x.cuda())
    for variant, kernel in (("stream", "nnzsplit_spmm_stream"),
                            ("onehot", "nnzsplit_spmm_onehot")):
        op = SpmvOperator.from_plan(M, ExecutionPlan(path="nnzsplit",
                                                     variant=variant))
        assert isinstance(op.pack, nz.NnzSplitPack)
        assert op.pack.device.type == "cuda"
        before = _build.launch_counts()[kernel]
        assert torch.equal(op(x.cuda()), want)
        assert _build.launch_counts()[kernel] == before + 1
    op = SpmvOperator.from_plan(M, ExecutionPlan(path="colorful"))
    assert op.device.type == "cuda" and op.pack is None
    assert torch.equal(op(x.cuda()), want)
    assert torch.equal(op(x[:, 0].cuda()), want[:, 0])
