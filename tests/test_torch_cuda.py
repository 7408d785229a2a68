"""The CUDA kernels (K1-K14) against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere (the check
is made inside the fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at more shapes and at the
main path's size; this file is the pytest form of the core of them.
"""
import numpy as np
import pytest
import torch

from repro_torch.assembly import mesh as amesh
from repro_torch.assembly import scatter as ascatter
from repro_torch.core import blockell, csrc
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import _build
from repro_torch.kernels import assembly_scatter as ak
from repro_torch.kernels import csrc_spmm as mm
from repro_torch.kernels import csrc_spmv as mv
from repro_torch.kernels import csrc_spmv_flat as fl
from repro_torch.kernels import csrc_spmv_nnzsplit as nz
from repro_torch.kernels.ops import SpmvOperator

from _smoke import chip_smoke

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


def _adversary(case):
    """The adversary matrix of ``case`` (``w4096_bf16_i16``: the ``w4096``
    matrix, packed with bfloat16 values and int16 indices), its k-step's
    sublanes and the pack's dtype arguments."""
    gen = "w4096" if case == "w4096_bf16_i16" else case
    arrays = chip_smoke().onehot_adversary_arrays(gen, seed=0)
    M = csrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    ks = 1 if case == "row_spans_steps" else 8
    kw = (dict(dtype=torch.bfloat16, index_dtype=torch.int16)
          if case == "w4096_bf16_i16" else {})
    return M, ks, kw


def _assert_has_feature(case, pack, step):
    sm = chip_smoke()
    geometry = sm.onehot_step_geometry(pack, step)
    assert sm.onehot_case_holds(case, geometry), geometry


@pytest.mark.parametrize("case", ["row_spans_steps", "bucket_128",
                                  "w4096_bf16_i16"])
def test_onehot_flat_kernels_equal_plain_on_adversarial_packs(card, case):
    """K7/K8 against their plain version, exactly on dyadic data, at B = 1,
    3 and 64 (partial column tiles), and two runs bit for bit."""
    M, ks, kw = _adversary(case)
    pack = fl.pack_flat(M, ks=ks, **kw).to(card)
    _assert_has_feature(case, pack, pack.step)
    rng = np.random.default_rng(3)
    for nrhs, kernel in ((1, fl.flat_spmv_onehot_cuda),
                         (3, fl.flat_spmm_onehot_cuda),
                         (64, fl.flat_spmm_onehot_cuda)):
        shape = (M.n,) if nrhs == 1 else (M.n, nrhs)
        x = torch.from_numpy((rng.integers(-8, 9, shape) / 8
                              ).astype(np.float32)).to(card)
        got = kernel(pack, x)
        assert torch.equal(got, fl.flat_windows_onehot_plain(pack, x))
        assert torch.equal(got, kernel(pack, x))


@pytest.mark.parametrize("case", ["row_spans_steps", "bucket_128",
                                  "padding_only_steps", "w4096_bf16_i16"])
def test_onehot_rect_kernels_equal_plain_on_adversarial_packs(card, case):
    """K3/K4 on the rectangular grid against their plain version, exactly on
    dyadic data, K3 at B = 1 and K4 at B = 3 and 64 (a partial column
    tile), and two runs bit for bit."""
    M, ks, kw = _adversary(case)
    pack = blockell.pack(M, k_step=ks * 128, **kw).to(card)
    _assert_has_feature(case, pack, ks * 128)
    rng = np.random.default_rng(5)
    for nrhs, kernel in ((1, mv.spmv_windows_onehot_cuda),
                         (3, mm.spmm_windows_onehot_cuda),
                         (64, mm.spmm_windows_onehot_cuda)):
        shape = (M.n,) if nrhs == 1 else (M.n, nrhs)
        x = torch.from_numpy((rng.integers(-8, 9, shape) / 8
                              ).astype(np.float32)).to(card)
        got = kernel(pack, x, ks * 128)
        assert torch.equal(got, mv.windows_onehot_plain(pack, x, ks * 128))
        assert torch.equal(got, kernel(pack, x, ks * 128))


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


ASSEMBLY_CASES = {
    "tri_d1_i16": (lambda: amesh.grid_tri(8), 1, "greedy"),
    "quad_d2": (lambda: amesh.grid_quad(6), 2, "greedy"),
    "tet_d3": (lambda: amesh.grid_tet(3), 3, "greedy"),
    "tet_d3_race": (lambda: amesh.grid_tet(4), 3, "race"),
    "tri_i32_slots_i16_targets": (lambda: amesh.grid_tri(44), 1, "greedy"),
}


@pytest.mark.parametrize("case", list(ASSEMBLY_CASES))
def test_assembly_kernels_equal_plain_versions_and_oracle(card, case):
    """K13 and K14, each launched once, against their plain versions and
    the serial oracle on dyadic stiffness; K14 repeats bit for bit.  The
    RACE case repeats targets inside a color, so K13 adds with atomics."""
    make, d, provider = ASSEMBLY_CASES[case]
    mesh = make()
    sched = ascatter.build_assembly_schedule(mesh, d,
                                             coloring_provider=provider)
    assert sched.colored.repeats == (provider == "race")
    ke = amesh.synthetic_stiffness(mesh, d, seed=3)
    want = ascatter.scatter_serial(sched, ke)
    packs = sched.bind(card).colored
    k = torch.from_numpy(ke).to(card).reshape(-1)
    before = _build.launch_counts()
    stream = ak.colored_scatter_stream_cuda(packs, k)
    onehot = ak.colored_scatter_onehot_cuda(packs, k)
    after = _build.launch_counts()
    assert after["assembly_colored_stream"] == before[
        "assembly_colored_stream"] + 1
    assert after["assembly_colored_onehot"] == before[
        "assembly_colored_onehot"] + 1
    assert torch.equal(stream, ak.colored_scatter_stream_plain(packs, k))
    assert torch.equal(onehot, ak.colored_scatter_onehot_plain(packs, k))
    np.testing.assert_array_equal(stream.cpu().numpy(), want)
    np.testing.assert_array_equal(onehot.cpu().numpy(), want)
    assert torch.equal(onehot, ak.colored_scatter_onehot_cuda(packs, k))


def test_assembly_int16_overflow_empty_color_and_single_element(card):
    import dataclasses
    from repro_torch.assembly import conflict
    ke1 = np.asarray([[[2.0, -0.5, -0.25], [-0.5, 1.0, -0.125],
                       [-0.25, -0.125, 3.0]]], np.float32)
    for conn in (np.asarray([[0, 1, 32767]]), np.asarray([[0, 1, 2]])):
        sched = ascatter.build_assembly_schedule(conn)
        want = ascatter.scatter_serial(sched, ke1)
        for variant in ("stream", "onehot"):
            got = ascatter.scatter_colored(sched, ke1, variant, device=card)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
    mesh = amesh.grid_tri(4)
    col = conflict.color_elements(mesh.conn)
    padded = dataclasses.replace(
        col, num_colors=col.num_colors + 1,
        color_ptr=np.append(col.color_ptr, col.color_ptr[-1]))
    sched = ascatter.build_assembly_schedule(mesh, coloring=padded)
    ke = amesh.synthetic_stiffness(mesh, seed=9)
    want = ascatter.scatter_serial(sched, ke)
    for variant in ("stream", "onehot"):
        got = ascatter.scatter_colored(sched, ke, variant, device=card)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_assemble_on_the_card_binds_once_and_keeps_values_there(card):
    from repro_torch import obs
    mesh = amesh.grid_tet(3)
    sched = ascatter.build_assembly_schedule(mesh, 3)
    ke = amesh.synthetic_stiffness(mesh, 3, seed=1)
    want = ascatter.scatter_serial(sched, ke)
    before = obs.snapshot()
    for strategy, variant in ascatter.ASSEMBLY_CANDIDATES:
        M = ascatter.assemble(sched, ke, strategy, variant)
        assert M.device.type == "cuda" and M.ia.device.type == "cuda"
        got = torch.cat([M.ad, M.al, M.au]).cpu().numpy()
        np.testing.assert_array_equal(got, want, err_msg=strategy + variant)
    d = obs.snapshot().diff(before)
    for part in ("structure", "colored", "sorted", "private"):
        assert d.total("assembly_pack_uploads_total", part=part) == 1, part
    assert d.merged_hist("assembly_device_seconds", strategy="colored",
                         variant="stream").get("count") == 1
