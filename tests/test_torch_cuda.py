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
