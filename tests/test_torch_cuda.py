"""The CUDA kernels (K1-K15) against their plain versions, on the card.

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
from repro_torch.kernels import csrc_segment as seg
from repro_torch.kernels import csrc_spmm as mm
from repro_torch.kernels import csrc_spmv as mv
from repro_torch.kernels import csrc_spmv_flat as fl
from repro_torch.kernels import csrc_spmv_nnzsplit as nz
from repro_torch.kernels.ops import SpmvOperator

from _smoke import chip_smoke
from _split_cases import SPLIT_CASES, split_case

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
    """The adversary matrix of ``case`` (a ``_bf16_i16`` suffix: the same
    matrix packed with bfloat16 values and int16 indices), its generator
    case, its k-step's sublanes and the pack's dtype arguments."""
    gen = case.removesuffix("_bf16_i16")
    arrays = chip_smoke().onehot_adversary_arrays(gen, seed=0)
    M = csrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    ks = 1 if gen == "row_spans_steps" else 8
    kw = (dict(dtype=torch.bfloat16, index_dtype=torch.int16)
          if case != gen else {})
    return M, gen, ks, kw


def _assert_has_feature(gen, pack, step):
    sm = chip_smoke()
    geometry = sm.onehot_step_geometry(pack, step)
    assert sm.onehot_case_holds(gen, geometry), geometry


def _dyadic_x(rng, n, nrhs, card):
    shape = (n,) if nrhs == 1 else (n, nrhs)
    return torch.from_numpy((rng.integers(-8, 9, shape) / 8
                             ).astype(np.float32)).to(card)


@pytest.mark.parametrize("case", ["row_spans_steps", "bucket_128",
                                  "w4096_bf16_i16", "warp_run_edges"])
def test_onehot_flat_kernels_equal_plain_on_adversarial_packs(card, case):
    """K7/K8 against their plain version, exactly on dyadic data, at B = 1,
    3 and 64 (partial column tiles), and two runs bit for bit."""
    M, gen, ks, kw = _adversary(case)
    pack = fl.pack_flat(M, ks=ks, **kw).to(card)
    _assert_has_feature(gen, pack, pack.step)
    rng = np.random.default_rng(3)
    for nrhs, kernel in ((1, fl.flat_spmv_onehot_cuda),
                         (3, fl.flat_spmm_onehot_cuda),
                         (64, fl.flat_spmm_onehot_cuda)):
        x = _dyadic_x(rng, M.n, nrhs, card)
        got = kernel(pack, x)
        assert torch.equal(got, fl.flat_windows_onehot_plain(pack, x))
        assert torch.equal(got, kernel(pack, x))


@pytest.mark.parametrize("case", ["row_spans_steps", "bucket_128",
                                  "padding_only_steps", "w4096_bf16_i16",
                                  "warp_run_edges"])
def test_onehot_rect_kernels_equal_plain_on_adversarial_packs(card, case):
    """K3/K4 on the rectangular grid against their plain version, exactly on
    dyadic data, K3 at B = 1 and K4 at B = 3 and 64 (a partial column
    tile), and two runs bit for bit."""
    M, gen, ks, kw = _adversary(case)
    pack = blockell.pack(M, k_step=ks * 128, **kw).to(card)
    _assert_has_feature(gen, pack, ks * 128)
    rng = np.random.default_rng(5)
    for nrhs, kernel in ((1, mv.spmv_windows_onehot_cuda),
                         (3, mm.spmm_windows_onehot_cuda),
                         (64, mm.spmm_windows_onehot_cuda)):
        x = _dyadic_x(rng, M.n, nrhs, card)
        got = kernel(pack, x, ks * 128)
        assert torch.equal(got, mv.windows_onehot_plain(pack, x, ks * 128))
        assert torch.equal(got, kernel(pack, x, ks * 128))


# the window stream kernels' adversary packs (K1/K5, K2/K6): grid, case
STREAM_ADVERSARIES = [
    ("rect", "row_spans_steps"), ("rect", "bucket_128"),
    ("rect", "padding_only_steps"), ("rect", "w4096_bf16_i16"),
    ("rect", "warp_run_edges"), ("rect", "warp_run_edges_bf16_i16"),
    ("flat", "row_spans_steps"), ("flat", "bucket_128"),
    ("flat", "w4096_bf16_i16"), ("flat", "warp_run_edges"),
    ("flat", "warp_run_edges_bf16_i16")]


@pytest.mark.parametrize("grid,case", STREAM_ADVERSARIES)
def test_stream_spmv_kernels_equal_plain_on_adversarial_packs(card, grid,
                                                              case):
    """K1 (rectangular) and K5 (flat), whose lanes and warps sum runs of
    equal rows, against their plain versions on the adversary packs,
    exactly on dyadic data: runs ending at every position of a warp, four
    rows in a lane, runs filling one warp or several and crossing 256-slot
    strides and step ends (``warp_run_edges``), runs over whole steps,
    padding-only steps, W = 4096.  Stream kernels add in atomic order, so
    two runs are not compared bit for bit."""
    M, gen, ks, kw = _adversary(case)
    if grid == "rect":
        pack = blockell.pack(M, k_step=ks * 128, **kw).to(card)
        step, kernel, plain = (ks * 128, mv.spmv_windows_stream_cuda,
                               mv.spmv_windows_stream_plain)
    else:
        pack = fl.pack_flat(M, ks=ks, **kw).to(card)
        step, kernel, plain = (pack.step, fl.flat_spmv_stream_cuda,
                               fl.flat_windows_stream_plain)
    _assert_has_feature(gen, pack, step)
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = _dyadic_x(rng, M.n, 1, card)
        assert torch.equal(kernel(pack, x), plain(pack, x))


@pytest.mark.parametrize("grid,case", STREAM_ADVERSARIES)
def test_stream_spmm_kernels_equal_plain_on_adversarial_packs(card, grid,
                                                              case):
    """K2 (rectangular) and K6 (flat), K1/K5's lanes and warp runs once per
    column, against their plain versions on the same adversary packs at B
    = 1, 3, 11 and 64, exactly on dyadic data; at W = 4096 B = 3 leaves a
    partial column tile (BT = 2, then 1)."""
    M, gen, ks, kw = _adversary(case)
    if grid == "rect":
        pack = blockell.pack(M, k_step=ks * 128, **kw).to(card)
        step, kernel, plain = (ks * 128, mm.spmm_windows_stream_cuda,
                               mm.spmm_windows_stream_plain)
    else:
        pack = fl.pack_flat(M, ks=ks, **kw).to(card)
        step, kernel, plain = (pack.step, fl.flat_spmm_stream_cuda,
                               fl.flat_windows_stream_plain)
    _assert_has_feature(gen, pack, step)
    if pack.w_pad == 4096:
        assert mm.column_tile(pack.w_pad, 3, 2) == 2
    rng = np.random.default_rng(8)
    for nrhs in (1, 3, 11, 64):
        X = _dyadic_x(rng, M.n, nrhs, card).reshape(M.n, nrhs)
        assert torch.equal(kernel(pack, X), plain(pack, X)), nrhs


@pytest.mark.parametrize("grid", ["rect", "flat"])
def test_stream_spmv_wrappers_refuse_misaligned_streams(card, grid):
    """K1/K5 read four slots per lane in one vector load: a slot stream that
    does not start on a 16-byte boundary raises ValueError in the wrapper,
    and nothing is launched."""
    import dataclasses
    M = _dyadic_skewed()
    if grid == "rect":
        pack = blockell.pack(M).to(card)
        kernel, name = mv.spmv_windows_stream_cuda, "blockell_spmv_stream"
    else:
        pack = fl.pack_flat(M).to(card)
        kernel, name = fl.flat_spmv_stream_cuda, "flat_spmv_stream"
    rows = torch.empty(pack.row_in_win.numel() + 1, dtype=torch.int32,
                       device=card)[1:]
    rows.copy_(pack.row_in_win.reshape(-1))
    bad = dataclasses.replace(pack, row_in_win=rows.view(
        pack.row_in_win.shape))
    x = torch.ones(M.n, device=card)
    before = _build.launch_counts()[name]
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernel(bad, x)
    assert _build.launch_counts()[name] == before


@pytest.mark.parametrize("grid", ["rect", "flat"])
def test_stream_spmm_wrappers_refuse_misaligned_streams(card, grid):
    """K2/K6 read the slot streams as K1/K5 do: a value stream that does
    not start on a 16-byte boundary raises ValueError in the wrapper, and
    nothing is launched."""
    import dataclasses
    M = _dyadic_skewed()
    if grid == "rect":
        pack = blockell.pack(M).to(card)
        kernel, name = mm.spmm_windows_stream_cuda, "blockell_spmm_stream"
    else:
        pack = fl.pack_flat(M).to(card)
        kernel, name = fl.flat_spmm_stream_cuda, "flat_spmm_stream"
    vals = torch.empty(pack.vals_l.numel() + 1, dtype=pack.vals_l.dtype,
                       device=card)[1:]
    vals.copy_(pack.vals_l.reshape(-1))
    bad = dataclasses.replace(pack, vals_l=vals.view(pack.vals_l.shape))
    X = torch.ones((M.n, 3), device=card)
    before = _build.launch_counts()[name]
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernel(bad, X)
    assert _build.launch_counts()[name] == before


@pytest.mark.parametrize("grid", ["rect", "flat"])
def test_stream_spmv_kernels_within_rowsum_tolerance_on_general_values(
        card, grid):
    """K1 / K5 on standard-normal values and x at a mid shape (a band of 24
    at fill 0.6; a skewed matrix with a 512-wide band on 6 % of its rows):
    within 1e-5 of the row's absolute sum of their plain versions."""
    import dataclasses
    n = 40000
    if grid == "rect":
        M = csrc.fem_band(n, 24, seed=11, numeric_symmetric=False)
        pack = blockell.pack(M).to(card)
        kernel, plain = (mv.spmv_windows_stream_cuda,
                         mv.spmv_windows_stream_plain)
    else:
        M = csrc.skewed_band(n, 512, 3, seed=11, numeric_symmetric=False)
        pack = fl.pack_flat(M).to(card)
        kernel, plain = (fl.flat_spmv_stream_cuda,
                         fl.flat_windows_stream_plain)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        n).astype(np.float32)).to(card)
    apack = dataclasses.replace(pack, vals_l=pack.vals_l.abs(),
                                vals_u=pack.vals_u.abs(), ad=pack.ad.abs())
    bound = 1e-5 * plain(apack, x.abs())
    assert bool(((kernel(pack, x) - plain(pack, x)).abs() <= bound).all())


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
    RACE case repeats targets inside a color, whose adds then land in
    atomic order.  On a greedy coloring K13 also equals its plain version
    bit for bit on standard-normal contributions: a target takes at most
    one add per color, in color order, in both."""
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
    if provider == "greedy":
        kn = torch.from_numpy(np.random.default_rng(5).standard_normal(
            ke.size).astype(np.float32)).to(card)
        assert torch.equal(ak.colored_scatter_stream_cuda(packs, kn),
                           ak.colored_scatter_stream_plain(packs, kn))


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


@pytest.mark.parametrize("case", ["race_fan", "tile_over_one_pass",
                                  "empty_tile", "empty_color",
                                  "i16_targets_32767"])
def test_k14_equals_plain_and_oracle_on_adversarial_packs(card, case):
    """K14 on ``chip_smoke.py``'s adversary assemblies (runs over pass
    ends, a tile over one pass, an empty tile and color, int16 targets at
    the sentinel 32,767): equal to its plain version and to the serial
    oracle bit for bit on dyadic stiffness, and two runs bit for bit.  K13
    on the same packs equals both too (the RACE fan's repeated targets
    land in atomic order, exact on dyadic data)."""
    sm = chip_smoke()
    sched, ke = sm.assembly_adversary(case, seed=0)
    packs = sched.bind(card).colored
    assert sm.assembly_case_holds(case, sm.assembly_pack_geometry(packs))
    k = torch.from_numpy(ke).to(card).reshape(-1)
    want = ascatter.scatter_serial(sched, ke)
    got = ak.colored_scatter_onehot_cuda(packs, k)
    assert torch.equal(got, ak.colored_scatter_onehot_plain(packs, k))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, ak.colored_scatter_onehot_cuda(packs, k))
    stream = ak.colored_scatter_stream_cuda(packs, k)
    assert torch.equal(stream, ak.colored_scatter_stream_plain(packs, k))
    np.testing.assert_array_equal(stream.cpu().numpy(), want)


NNZ_CASES = ["hub_fills_chunks", "run_crosses_pass", "r_pad_4096",
             "bf16_i16"]


@pytest.mark.parametrize("case,kernel", [
    *(pytest.param(case, "K12", id=case) for case in NNZ_CASES),
    *(pytest.param(case, "K11", id=f"{case}-k11")
      for case in NNZ_CASES + ["mid"])])
def test_k12_equals_plain_on_adversarial_packs(card, case, kernel):
    """K12 on ``chip_smoke.py``'s adversary packs (a hub row filling whole
    chunks, runs cut by a pass end, r_pad 4096, bfloat16 / int16) at B = 1,
    3, 11 and 64: equal to its plain version bit for bit on dyadic data,
    and two runs bit for bit.  K11 (K12's body at one column) on the same
    packs and on a mid-size random pattern (dyadic values): equal to its
    plain version on dyadic x, and to K12's column 0 bit for bit on
    standard-normal x."""
    sm = chip_smoke()
    if case == "mid":
        vdt, idt, ks = torch.float32, torch.int32, 8
        arrays = sm.random_arrays(20000, 0, dyadic=True)
    else:
        vdt, idt, ks = sm.NNZ_ADVERSARIES[case]
        arrays = sm.nnzsplit_adversary_arrays(case, seed=0)
    M = csrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    pack = nz.pack_nnzsplit(M, ks=ks, dtype=vdt, index_dtype=idt).to(card)
    if case != "mid":
        assert sm.nnzsplit_case_holds(case,
                                      sm.nnzsplit_chunk_geometry(pack))
    rng = np.random.default_rng(6)
    if kernel == "K11":
        x = torch.from_numpy((rng.integers(-8, 9, M.n) / 8
                              ).astype(np.float32)).to(card)
        got = nz.nnzsplit_spmv_onehot_cuda(pack, x)
        assert torch.equal(got, nz.nnzsplit_partials_onehot_plain(pack, x))
        assert torch.equal(got, nz.nnzsplit_spmv_onehot_cuda(pack, x))
        xn = torch.from_numpy(rng.standard_normal(M.n, dtype=np.float32)
                              ).to(card)
        assert torch.equal(nz.nnzsplit_spmv_onehot_cuda(pack, xn),
                           nz.nnzsplit_spmm_onehot_cuda(pack,
                                                        xn[:, None])[..., 0])
        return
    for nrhs in (1, 3, 11, 64):
        X = torch.from_numpy((rng.integers(-8, 9, (M.n, nrhs)) / 8
                              ).astype(np.float32)).to(card)
        got = nz.nnzsplit_spmm_onehot_cuda(pack, X)
        assert torch.equal(got, nz.nnzsplit_partials_onehot_plain(pack, X))
        assert torch.equal(got, nz.nnzsplit_spmm_onehot_cuda(pack, X))


@pytest.mark.parametrize("case", NNZ_CASES)
def test_k10_equals_plain_on_adversarial_packs(card, case):
    """K10 (X rows staged per warp with the column fastest) on the K12
    adversary packs at B = 3, 8, 11 and 64, and K9 (the direct gather) at B
    = 1: equal to their plain versions bit for bit on dyadic data."""
    sm = chip_smoke()
    vdt, idt, ks = sm.NNZ_ADVERSARIES[case]
    arrays = sm.nnzsplit_adversary_arrays(case, seed=0)
    M = csrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    pack = nz.pack_nnzsplit(M, ks=ks, dtype=vdt, index_dtype=idt).to(card)
    assert sm.nnzsplit_case_holds(case, sm.nnzsplit_chunk_geometry(pack))
    rng = np.random.default_rng(10)
    x = _dyadic_x(rng, M.n, 1, card)
    assert torch.equal(nz.nnzsplit_spmv_stream_cuda(pack, x),
                       nz.nnzsplit_partials_stream_plain(pack, x))
    for nrhs in (3, 8, 11, 64):
        X = _dyadic_x(rng, M.n, nrhs, card)
        assert torch.equal(nz.nnzsplit_spmm_stream_cuda(pack, X),
                           nz.nnzsplit_partials_stream_plain(pack, X)), nrhs


@pytest.mark.parametrize("case", NNZ_CASES + ["lane_run_edges",
                                              "lane_run_edges_bf16_i16"])
def test_k9_equals_plain_on_adversarial_packs(card, case):
    """K9 (the warp's runs of equal lrow summed by shuffles before one
    shared add per run) on the nnz-split adversary packs — the K12 ones (a
    hub row filling whole chunks, runs cut by a pass end, r_pad 4096,
    bfloat16 / int16) and ``lane_run_edges`` in float32 / int32 and
    bfloat16 / int16 (runs ending at every position of a warp of 128
    entries, four rows in four consecutive entries, runs crossing warp,
    pass and chunk ends): equal to its plain version bit for bit on dyadic
    x, each launch counted once.  K9 adds in atomic order, so two runs are
    not compared with each other."""
    sm = chip_smoke()
    vdt, idt, ks = sm.NNZ_ADVERSARIES[case]
    arrays = sm.nnzsplit_adversary_arrays(case, seed=0)
    M = csrc.from_assembly(arrays[0].shape[0] - 1, *arrays)
    pack = nz.pack_nnzsplit(M, ks=ks, dtype=vdt, index_dtype=idt).to(card)
    assert sm.nnzsplit_case_holds(case, sm.nnzsplit_chunk_geometry(pack))
    rng = np.random.default_rng(14)
    for _ in range(2):
        x = _dyadic_x(rng, M.n, 1, card)
        before = _build.launch_counts()["nnzsplit_spmv_stream"]
        got = nz.nnzsplit_spmv_stream_cuda(pack, x)
        assert _build.launch_counts()["nnzsplit_spmv_stream"] == before + 1
        assert torch.equal(got, nz.nnzsplit_partials_stream_plain(pack, x))


@pytest.mark.parametrize("pattern", ["powerlaw", "random"])
def test_k9_within_rowsum_tolerance_on_general_values(card, pattern):
    """K9 on standard-normal values and x at a mid-size pattern (n =
    40,000: a power-law graph with hub rows, a random pattern of 20
    entries a row): its partials within 2e-5 of the row's absolute sum of
    the plain version's (both add in atomic order on the card)."""
    import dataclasses
    sm = chip_smoke()
    n = 40000
    arrays = (sm.powerlaw_arrays(n, 15, general=True) if pattern == "powerlaw"
              else sm.random_arrays(n, 15))
    M = csrc.from_assembly(n, *arrays)
    pack = nz.pack_nnzsplit(M).to(card)
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(
        n).astype(np.float32)).to(card)
    apack = dataclasses.replace(pack, vals=pack.vals.abs())
    bound = 2e-5 * nz.nnzsplit_partials_stream_plain(apack, x.abs())
    got = nz.nnzsplit_spmv_stream_cuda(pack, x)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - nz.nnzsplit_partials_stream_plain(pack, x)).abs()
                 <= bound).all())


def test_calibrate_measures_the_card(card):
    from repro_torch.roofline import cost_model
    den = cost_model.calibrate(card)
    assert den.source.startswith("measured on ")
    assert den.hbm_bw > 0 and 0 < den.launch_s < 50e-6
    assert cost_model.calibrate("cuda") is den          # once a process


def test_tune_on_the_card_with_the_default_timer(card):
    """The measured tuner at a mid size (n = 40,000, the main path's band
    shape): every measured candidate timed by CUDA events, a stream and a
    one-hot plan among them, and the winner, served from the cache with no
    pack, equal to the segment path bit for bit on dyadic data."""
    from repro_torch.core import schedule, tuner
    M, rng = _dyadic_matrix(n=40000)
    cache = tuner.PlanCache()
    res = tuner.tune(M, cache=cache, device=card, nrhs_options=(1, 8))
    assert not res.cached and all(t > 0 for t in res.timings_s.values())
    keys = list(res.timings_s)
    assert any(":st:" in k for k in keys)
    assert any(k.startswith("kernel") and ":st:" not in k for k in keys)
    before = dict(schedule.BUILD_COUNTS.items())
    op = SpmvOperator.from_plan(M, res.plan, cache=cache, device=card)
    assert dict(schedule.BUILD_COUNTS.items()) == before
    X = torch.from_numpy((rng.integers(-8, 9, (M.n, 8)) / 8
                          ).astype(np.float32)).to(card)
    want = SpmvOperator(M, path="segment", device=card)
    assert torch.equal(op(X), want(X))
    assert torch.equal(op(X[:, 0].contiguous()), want(X[:, 0].contiguous()))


# ---------------------------------------------------------------------------
# The mesh layer: K5-K12 on flat and nnz-split shard and halo packs
# ---------------------------------------------------------------------------

MESH_N = 40000


def _mesh_matrix(pattern, dyadic):
    sm = chip_smoke()
    if pattern == "band":
        arrays = sm.band_arrays(MESH_N, sm.HALF_BAND, sm.FILL, 21, False,
                                dyadic=dyadic)
    else:
        arrays = sm.powerlaw_arrays(MESH_N, 22, dyadic=dyadic,
                                    general=not dyadic)
    return csrc.from_assembly(MESH_N, *arrays)


def _mesh_layout(M, kind, p=4, starts=None):
    from repro_torch.core import partition, schedule
    path = kind.split("_")[0]
    plan = ExecutionPlan(path=path)
    if kind.endswith("_halo"):
        return schedule.build_path_halo(M, p, plan)
    if starts is None:
        starts = partition.partition_rows_by_nnz(M, p).starts
    sup = {"flat": fl, "nnzsplit": nz}[path]
    pack = (sup.pack_flat_shards if path == "flat"
            else sup.pack_nnzsplit_shards)
    return pack(M, starts)


def _shard_runners(pack):
    """name -> (kernel, plain version) on one shard's pack."""
    if isinstance(pack, nz.NnzSplitPack):
        return {"nnzsplit_spmv_stream": (nz.nnzsplit_spmv_stream_cuda,
                                         nz.nnzsplit_partials_stream_plain),
                "nnzsplit_spmv_onehot": (nz.nnzsplit_spmv_onehot_cuda,
                                         nz.nnzsplit_partials_onehot_plain),
                "nnzsplit_spmm_stream": (nz.nnzsplit_spmm_stream_cuda,
                                         nz.nnzsplit_partials_stream_plain),
                "nnzsplit_spmm_onehot": (nz.nnzsplit_spmm_onehot_cuda,
                                         nz.nnzsplit_partials_onehot_plain)}
    return {"flat_spmv_stream": (fl.flat_spmv_stream_cuda,
                                 fl.flat_windows_stream_plain),
            "flat_spmv_onehot": (fl.flat_spmv_onehot_cuda,
                                 fl.flat_windows_onehot_plain),
            "flat_spmm_stream": (fl.flat_spmm_stream_cuda,
                                 fl.flat_windows_stream_plain),
            "flat_spmm_onehot": (fl.flat_spmm_onehot_cuda,
                                 fl.flat_windows_onehot_plain)}


def _shard_kernels_equal_plain(lay, card, rng):
    """Every shard's pack, each of its four kernels at B = 1, 3, 11, equal
    bit for bit to the plain version on dyadic x, each launch counted."""
    lay = lay.to(card)
    for t in range(lay.p):
        pack = lay.shard_pack(t)
        for name, (kernel, plain) in _shard_runners(pack).items():
            for nrhs in ((1,) if "spmv" in name else (3, 11)):
                x = _dyadic_x(rng, pack.n, nrhs, card)
                before = _build.launch_counts()[name]
                got = kernel(pack, x)
                assert _build.launch_counts()[name] == before + 1
                assert torch.equal(got, plain(pack, x)), (name, t, nrhs)
    return lay


@pytest.mark.parametrize("kind,pattern", [
    ("flat_shards", "band"), ("flat_halo", "band"),
    ("nnzsplit_shards", "powerlaw"), ("nnzsplit_halo", "band")])
def test_mesh_shard_kernels_equal_plain_on_dyadic_data(card, kind, pattern):
    """K5-K12 on the stacked shard packs of the mesh strategies (n =
    40,000, p = 4): each shard's pack is a view of the stacked streams, its
    step range ends at its real step count, and every kernel equals its
    plain version bit for bit."""
    M = _mesh_matrix(pattern, dyadic=True)
    _shard_kernels_equal_plain(_mesh_layout(M, kind), card,
                               np.random.default_rng(31))


@pytest.mark.parametrize("kind,pattern", [
    ("flat_shards", "band"), ("flat_halo", "band"),
    ("nnzsplit_shards", "powerlaw"), ("nnzsplit_halo", "band")])
def test_mesh_shard_kernels_within_rowsum_tolerance(card, kind, pattern):
    """The same kernels on standard-normal values and x: within 2e-5 of
    the row's absolute sum of the plain version's answer."""
    import dataclasses
    M = _mesh_matrix(pattern, dyadic=False)
    lay = _mesh_layout(M, kind).to(card)
    rng = np.random.default_rng(32)
    for t in range(lay.p):
        pack = lay.shard_pack(t)
        if isinstance(pack, nz.NnzSplitPack):
            apack = dataclasses.replace(pack, vals=pack.vals.abs())
        else:
            apack = dataclasses.replace(
                pack, vals_l=pack.vals_l.abs(), vals_u=pack.vals_u.abs(),
                ad=pack.ad.abs())
        for name, (kernel, plain) in _shard_runners(pack).items():
            for nrhs in ((1,) if "spmv" in name else (3, 11)):
                shape = (pack.n,) if nrhs == 1 else (pack.n, nrhs)
                x = torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).to(card)
                got, want = kernel(pack, x), plain(pack, x)
                bound = 2e-5 * plain(apack, x.abs())
                assert bool(torch.isfinite(got).all())
                assert bool(((got - want).abs() <= bound + 1e-30).all()), \
                    (name, t, nrhs)


def test_mesh_unbalanced_partition_long_inert_tail(card):
    """Three light shards of a few rows each beside one holding the rest:
    the light shards' packs are nearly all inert trailing steps of the last
    tile, which their step range ends before; K5-K8 equal the plain
    versions (which walk every step) bit for bit, and so does the whole
    product."""
    M = _mesh_matrix("band", dyadic=True)
    starts = np.array([0, 3, 6, 9, M.n])
    lay = _shard_kernels_equal_plain(_mesh_layout(M, "flat_shards",
                                                  starts=starts),
                                     card, np.random.default_rng(33))
    for t in range(3):
        used = int(lay.shard_pack(t).step_start[-1])
        assert used == lay.nt and lay.steps - used > lay.nt // 2
    rng = np.random.default_rng(34)
    x = _dyadic_x(rng, M.n, 3, card)
    for variant in ("stream", "onehot"):
        fn = fl.flat_local_fn(lay, M.n, variant)
        y = sum(fn(t, x) for t in range(4))
        assert torch.equal(y, SpmvOperator(M, path="segment")(x)), variant


@pytest.mark.parametrize("path,acc", [
    ("flat", "allreduce"), ("flat", "reduce_scatter"), ("flat", "halo"),
    ("nnzsplit", "halo"), ("segment", "halo")])
def test_mesh_executor_on_the_card_matches_segment(card, path, acc):
    """The MeshExecutor on four shards emulated on the card, both variants,
    equal to the local segment path on dyadic data; the shard-local kernel
    launched once per shard and product."""
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.serve import MeshExecutor
    M = _mesh_matrix("band", dyadic=True)
    rng = np.random.default_rng(35)
    X = _dyadic_x(rng, M.n, 3, card)
    want = SpmvOperator(M, path="segment")(X)
    for variant in ("stream", "onehot"):
        ex = MeshExecutor(M, ExecutionPlan(path=path, variant=variant,
                                           strategy="mesh", mesh_p=4,
                                           accumulation=acc),
                          mesh=ShardMesh(4, card))
        assert ex.device.type == "cuda"
        name = f"{path}_spmm_{variant}"
        before = _build.launch_counts().get(name, 0)
        assert torch.equal(ex(X), want), variant
        if path != "segment":
            assert _build.launch_counts()[name] == before + 4


# ---------------------------------------------------------------------------
# K15: the segment path's product in one pass
# ---------------------------------------------------------------------------

SEGMENT_CASES = ("stencil", "wide_stencil", "random_empty_rows",
                 "rectangular")
SEGMENT_WIDTHS = (1, 2, 3, 8, 11, 64, 136)


def _segment_matrix(case, dyadic, symmetric, seed=0):
    """A host CSRC for K15: HPCG's stencil on 9 x 9 x 6 (window 91) and on
    64 x 64 x 3 (band 4,161: no window takes it), a random structurally
    symmetric pattern with 40 empty rows (among them the first and the
    last), and a band matrix with a rectangular tail."""
    if case in ("stencil", "wide_stencil"):
        grid = (9, 9, 6) if case == "stencil" else (64, 64, 3)
        arr = chip_smoke().stencil27_arrays(*grid, seed=seed,
                                          symmetric=symmetric, dyadic=dyadic)
        return csrc.from_assembly(int(np.prod(grid)), *arr)
    if case == "random_empty_rows":
        n = 3000
        empty = np.concatenate(([0, n - 1], np.random.default_rng(seed)
                                .choice(np.arange(1, n - 1), 38,
                                        replace=False)))
        ia, ja, ad, al, au = chip_smoke().random_arrays(
            n, seed, per_row=12, dyadic=dyadic, empty_rows=empty)
        M = csrc.from_assembly(n, ia, ja, ad, al, al if symmetric else au)
        assert (np.diff(ia)[empty] == 0).all()
        return M
    import dataclasses
    M = csrc.rectangular_fem(700, 53, 11, seed=seed)    # al = au
    if not symmetric:
        M = dataclasses.replace(M, au=torch.roll(M.al, 1),
                                numerically_symmetric=False)
    if dyadic:
        M = dataclasses.replace(M, **{f: torch.round(getattr(M, f) * 4) / 4
                                      for f in ("ad", "al", "au", "ar")})
    return M


def _abs_matrix(M):
    import dataclasses
    return dataclasses.replace(M, **{f: getattr(M, f).abs()
                                     for f in ("ad", "al", "au", "ar")})


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("symmetric", [False, True])
def test_k15_equals_plain_chain_on_dyadic_data(card, case, symmetric):
    """K15 against the gather + index_add_ chain on the card, equal on
    dyadic values at every width (vec 4 / 2 / 1, one to 32 lanes, a lane
    looping over column groups at B = 136); one launch a product, two
    where rows pass HEAVY_SLOTS (the random pattern's longest rows)."""
    M = _segment_matrix(case, dyadic=True, symmetric=symmetric).to(card)
    assert M.numerically_symmetric == symmetric
    k = seg.SegmentKernel(M)
    launches = 1 + (k.split.chunks.shape[0] > 0)
    assert launches == 1 + (case == "random_empty_rows")
    rng = np.random.default_rng(51)
    for width in SEGMENT_WIDTHS:
        x = _dyadic_x(rng, M.m, width, card)
        before = _build.launch_counts()["csrc_segment_spmm"]
        got = k(x)
        assert _build.launch_counts()["csrc_segment_spmm"] == (
            before + launches)
        want = seg.segment_product_plain(M, x)
        assert got.shape == want.shape == (M.n,) + tuple(x.shape[1:])
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=f"{case} B={width}")


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_k15_within_rowsum_tolerance_on_general_values(card, case):
    """Standard-normal values: K15 adds in another order than the chain
    (its reductions land in atomic order, so does index_add_), so each row
    is held within 1e-5 of its absolute sum (|A|·|x|), as K1-K8 are."""
    M = _segment_matrix(case, dyadic=False, symmetric=False).to(card)
    Ma = _abs_matrix(M)
    rng = np.random.default_rng(52)
    for width in (1, 3, 8, 11):
        x = torch.from_numpy(rng.standard_normal(
            (M.m, width), dtype=np.float32)).to(card)
        if width == 1:
            x = x[:, 0].contiguous()
        got = seg.SegmentKernel(M)(x)
        want = seg.segment_product_plain(M, x)
        bound = 1e-5 * seg.segment_product_plain(Ma, x.abs()) + 1e-30
        assert bool(((got - want).abs() <= bound).all()), (case, width)


def test_k15_misaligned_operand_takes_scalar_lanes(card):
    """X starting 4 bytes past a 16-byte boundary: the lane mapping falls to
    one column a lane (8 lanes at B = 8), and the answer is unchanged; one
    bound kernel keeps a mapping per width and alignment, so the aligned
    call after the misaligned one (and the reverse) launches its own."""
    M = _segment_matrix("wide_stencil", dyadic=True, symmetric=False)
    M = M.to(card)
    rng = np.random.default_rng(53)
    x = _dyadic_x(rng, M.m, 8, card)
    buf = torch.empty(x.numel() + 1, device=card)[1:]
    shifted = buf.view(M.m, 8)
    shifted.copy_(x)
    assert seg.lane_mapping(8, shifted.data_ptr()) == (1, 8)
    assert seg.lane_mapping(8, x.data_ptr()) == (4, 2)
    k = seg.SegmentKernel(M)
    want = seg.segment_product_plain(M, x)
    for operand in (shifted, x, shifted, x):
        assert torch.equal(k(operand), want)
    assert sorted(k._mappings.values()) == [(1, 8), (4, 2)]


def test_segment_operator_on_the_card_routes_to_k15(card):
    """A matrix whose window exceeds w_cap: ``path="auto"`` falls to
    ``segment``, whose executors on the card are K15 (one
    ``segment_route_total{route="kernel"}`` a bound operator, one launch a
    product, SpMV and SpMM), equal to the plain chain; a float64 matrix on
    the card is refused when the operator binds (K15 launches or raises:
    nothing falls back to the chain there), counted on no route, and
    launches nothing."""
    import dataclasses
    from repro_torch import obs
    M = _segment_matrix("wide_stencil", dyadic=True, symmetric=True)
    routed = obs.counter("segment_route_total", route="kernel")
    plain = obs.counter("segment_route_total", route="plain")
    r0, p0 = routed.value, plain.value
    op = SpmvOperator(M)
    assert op.plan.path == "segment" and op.device.type == "cuda"
    assert routed.value == r0 + 1 and plain.value == p0
    assert isinstance(op._fn, seg.SegmentKernel)
    assert isinstance(op._fn_mm, seg.SegmentKernel)
    rng = np.random.default_rng(54)
    X = _dyadic_x(rng, M.n, 8, card)
    before = _build.launch_counts()["csrc_segment_spmm"]
    Y, y = op(X), op(X[:, 0])
    assert _build.launch_counts()["csrc_segment_spmm"] == before + 2
    Md = M.to(card)
    assert torch.equal(Y, seg.segment_product_plain(Md, X))
    assert torch.equal(y, seg.segment_product_plain(Md, X[:, 0]))
    M64 = dataclasses.replace(M, **{f: getattr(M, f).double()
                                    for f in ("ad", "al", "au", "ar")})
    before = _build.launch_counts()["csrc_segment_spmm"]
    with pytest.raises(TypeError, match="float32 values"):
        SpmvOperator(M64, path="segment")
    assert routed.value == r0 + 1 and plain.value == p0
    assert _build.launch_counts()["csrc_segment_spmm"] == before


SPLIT_WIDTHS = (1, 2, 8, 32)


def _k15_launches():
    return _build.launch_counts()["csrc_segment_spmm"]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("symmetric", [False, True])
def test_k15_split_equals_plain_chain_on_dyadic_data(card, case,
                                                      symmetric):
    """Rows with more than HEAVY_SLOTS lower slots are cut into chunks:
    each product is two launches (the row-owned kernel, which leaves a
    heavy row its diagonal and tail, and the chunk kernel), equal to the
    gather + index_add_ chain on dyadic values at B = 1, 2, 8 and 32 (one
    row holding every slot, rows just under and just over the threshold, a
    Kronecker graph, al != au, a rectangular tail)."""
    M = split_case(case, symmetric=symmetric).to(card)
    k = seg.SegmentKernel(M)
    assert k.split.chunks.shape[0] > 0 and k.split.rows > 0
    rng = np.random.default_rng(61)
    for width in SPLIT_WIDTHS:
        x = _dyadic_x(rng, M.m, width, card)
        before = _k15_launches()
        got = k(x)
        assert _k15_launches() == before + 2
        want = seg.segment_product_plain(M, x)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=f"{case} B={width}")


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_k15_split_within_rowsum_tolerance_on_general_values(card, case):
    """Standard-normal values, al != au: a heavy row's sum is its chunks'
    partial sums joined in atomic order, so each row is held within 1e-5
    of its absolute sum, as K15's rows without the split are."""
    M = split_case(case, dyadic=False, symmetric=False).to(card)
    Ma = _abs_matrix(M)
    k = seg.SegmentKernel(M)
    rng = np.random.default_rng(62)
    for width in SPLIT_WIDTHS:
        x = torch.from_numpy(rng.standard_normal(
            (M.m, width), dtype=np.float32)).to(card)
        if width == 1:
            x = x[:, 0].contiguous()
        got = k(x)
        want = seg.segment_product_plain(M, x)
        bound = 1e-5 * seg.segment_product_plain(Ma, x.abs()) + 1e-30
        assert bool(((got - want).abs() <= bound).all()), (case, width)


@pytest.mark.parametrize("heavy,chunk", [(0, 1), (5, 3), (13, 1000)])
def test_k15_split_at_any_threshold_and_chunk(card, heavy, chunk):
    """Every row split into one-slot chunks, short chunks, one chunk a
    row: the same product, at every lane mapping (B = 3 and 11: one column
    a lane; 136: a lane looping over column groups)."""
    M = split_case("kronecker", symmetric=False).to(card)
    k = seg.SegmentKernel(M, seg.split_rows(M.ia, heavy, chunk))
    assert k.split.chunks.shape[0] > 0 and k.split.heavy == heavy
    rng = np.random.default_rng(63)
    for width in (1, 3, 8, 11, 136):
        x = _dyadic_x(rng, M.m, width, card)
        assert torch.equal(k(x), seg.segment_product_plain(M, x)), width


def test_k15_without_heavy_rows_keeps_one_launch(card):
    """HPCG's stencil has no row over the threshold: an empty chunk table
    and one launch a product, as before the split."""
    M = _segment_matrix("wide_stencil", dyadic=True, symmetric=True)
    k = seg.SegmentKernel(M.to(card))
    assert tuple(k.split.chunks.shape) == (0, 3) and k.split.rows == 0
    x = _dyadic_x(np.random.default_rng(64), M.m, 8, card)
    before = _k15_launches()
    k(x)
    assert _k15_launches() == before + 1


def test_segment_operator_splits_once_and_counts(card, tmp_path):
    """A bound ``segment`` operator splits its matrix once, in its
    schedule: its SpMV and SpMM executors take the one split, one
    ``schedule.segment_split`` span carries the heavy rows, their slots
    and the chunks, and ``segment_split_rows_total`` /
    ``segment_split_chunks_total`` rise by them once.  A second operator
    on the same PlanCache takes the stored split: no span, the same table,
    the counters rise again (one bound operator more)."""
    from repro_torch import obs
    from repro_torch.core.tuner import PlanCache
    M = split_case("kronecker")
    rows = obs.counter("segment_split_rows_total")
    chunks = obs.counter("segment_split_chunks_total")
    r0, c0 = rows.value, chunks.value
    path = str(tmp_path / "plans.json")
    obs.clear_trace()
    op = SpmvOperator(M, path="segment", cache=PlanCache(path))
    split = op._fn.split
    assert op._fn_mm.split is split and split.chunks.is_cuda
    spans = obs.trace("schedule.segment_split")
    assert len(spans) == 1
    assert spans[0]["labels"] == {"rows": str(split.rows),
                                  "slots": str(split.slots),
                                  "chunks": str(split.chunks.shape[0])}
    assert rows.value == r0 + split.rows > r0
    assert chunks.value == c0 + split.chunks.shape[0]
    X = _dyadic_x(np.random.default_rng(65), M.n, 8, card)
    assert torch.equal(op(X), seg.segment_product_plain(M.to(card), X))
    obs.clear_trace()
    again = SpmvOperator(M, path="segment", cache=PlanCache(path))
    assert obs.trace("schedule.segment_split") == []
    assert torch.equal(again._fn.split.chunks, split.chunks)
    assert rows.value == r0 + 2 * split.rows
    assert torch.equal(again(X), op(X))


def test_k15_refuses_a_chunk_table_it_cannot_read(card):
    """A split whose table is not contiguous int32 (chunks, 3) is refused
    when the kernel binds, before any launch."""
    import dataclasses
    M = split_case("kronecker").to(card)
    split = seg.split_rows(M.ia)
    before = _k15_launches()
    for chunks in (split.chunks.long(), split.chunks.t()):
        with pytest.raises(ValueError, match="int32"):
            seg.SegmentKernel(M, dataclasses.replace(split, chunks=chunks))
    assert _k15_launches() == before
