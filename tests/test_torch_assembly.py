"""FEM assembly of the port held against the JAX package on the CPU.

Meshes and stiffness arrays, element adjacency and colorings (greedy and
RACE), every ``AssemblySchedule`` field and its npz file across the two
packages, every executor against the JAX package's serial oracle, the plain
versions of K13/K14 against the Pallas bodies in interpret mode, the int16
gate, the empty color and the single element, the build probes of value
refresh and time stepping, the cost model's bytes and flops, the assembly
tuner and its cache records in both packages, and the conversion of a
foreign schedule.

The stiffness is dyadic (multiples of 1/64), so float32 sums are exact in
any order and every comparison of values is ``assert_array_equal``.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.assembly import conflict as jconflict
from repro.assembly import mesh as jmesh
from repro.assembly import scatter as jscatter
from repro.core import csrc as jcsrc
from repro.core import plan as jplan
from repro.core import tuner as jtuner
from repro.kernels import assembly_scatter as jkern
from repro.roofline import cost_model as jcost
from repro_torch import convert, obs
from repro_torch.assembly import conflict as tconflict
from repro_torch.assembly import mesh as tmesh
from repro_torch.assembly import scatter as tscatter
from repro_torch.core import csrc as tcsrc
from repro_torch.core import plan as tplan
from repro_torch.core import solvers as tsolvers
from repro_torch.core import tuner as ttuner
from repro_torch.core.coloring import Coloring
from repro_torch.core.paths import BUILD_COUNTS
from repro_torch.kernels import _build
from repro_torch.kernels import assembly_scatter as tkern
from repro_torch.kernels import ops as tops
from repro_torch.roofline import cost_model as tcost
from repro_torch.serve import SpmvServingEngine

from test_torch_parity_helpers import to_torch_csrc

CPU = "cpu"
MESHES = {
    "tri": lambda: jmesh.grid_tri(5),
    "quad": lambda: jmesh.grid_quad(4),
    "tet": lambda: jmesh.grid_tet(3),
}
SCHED_ARRAYS = ("ia", "ja", "targets", "buffer_elements", "color_slots",
                "color_targets", "sorted_perm", "sorted_targets")
SCHED_SCALARS = ("structure_digest", "n", "k", "ne", "edof",
                 "ndof_per_node", "num_buffers", "size")
COLORING_ARRAYS = ("color_of_row", "rows_by_color", "color_ptr",
                   "level_of_row", "group_of_row")
EXECUTORS = [("colored", "stream"), ("colored", "onehot"),
             ("colored", "percolor"), ("sorted", "stream"),
             ("private", "vmap"), ("serial", "numpy")]
EXECUTOR_IDS = [f"{s}-{v}" for s, v in EXECUTORS]


def _pair(name, d=1, provider="greedy", seed=13):
    """(mesh, ke, reference schedule, port schedule) for one mesh."""
    mesh = MESHES[name]()
    ke = jmesh.synthetic_stiffness(mesh, d, seed=seed)
    js = jscatter.build_assembly_schedule(mesh.conn, d,
                                          coloring_provider=provider)
    ts = tscatter.build_assembly_schedule(mesh.conn, d,
                                          coloring_provider=provider)
    return mesh, ke, js, ts


def _vals(M) -> np.ndarray:
    """The unified [ad | al | au] vector of an assembled port matrix."""
    return torch.cat([M.ad, M.al, M.au]).numpy()


def _build_delta(fn):
    before = dict(BUILD_COUNTS.items())
    out = fn()
    after = dict(BUILD_COUNTS.items())
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return out, {k: v for k, v in delta.items() if v}


def assert_coloring_equal(cj, ct):
    assert int(cj.num_colors) == int(ct.num_colors)
    assert cj.provider == ct.provider
    for f in COLORING_ARRAYS:
        a, b = getattr(cj, f), getattr(ct, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


def assert_schedule_equal(js, ts):
    for f in SCHED_SCALARS:
        assert getattr(js, f) == getattr(ts, f), f
    for f in SCHED_ARRAYS:
        a, b = np.asarray(getattr(js, f)), np.asarray(getattr(ts, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert js.key() == ts.key() and js.index_dtypes == ts.index_dtypes
    assert_coloring_equal(js.coloring, ts.coloring)


# ---------------------------------------------------------------------------
# Meshes, stiffness, adjacency, colorings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_and_stiffness_equal(name, d):
    jm = MESHES[name]()
    tm = {"tri": tmesh.grid_tri(5), "quad": tmesh.grid_quad(4),
          "tet": tmesh.grid_tet(3)}[name]
    assert (jm.name, jm.dim) == (tm.name, tm.dim)
    np.testing.assert_array_equal(jm.coords, tm.coords)
    np.testing.assert_array_equal(jm.conn, tm.conn)
    assert jm.conn.dtype == tm.conn.dtype
    np.testing.assert_array_equal(jmesh.element_volumes(jm),
                                  tmesh.element_volumes(tm))
    for seed in (0, 7):
        a = jmesh.synthetic_stiffness(jm, d, seed=seed)
        b = tmesh.synthetic_stiffness(tm, d, seed=seed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jmesh.poisson_stiffness(jm, mass=0.5 * d),
                                  tmesh.poisson_stiffness(tm, mass=0.5 * d))
    np.testing.assert_array_equal(jconflict.element_dofs(jm.conn, d),
                                  tconflict.element_dofs(tm.conn, d))


def test_mesh_generator_table_and_full_width_tet_shape():
    assert ([n for n, _ in jmesh.MESH_GENERATORS]
            == [n for n, _ in tmesh.MESH_GENERATORS])
    for (_, gj), (_, gt) in zip(jmesh.MESH_GENERATORS,
                                tmesh.MESH_GENERATORS):
        np.testing.assert_array_equal(gj(7).conn, gt(7).conn)
    assert tmesh.QUANTUM == jmesh.QUANTUM
    np.testing.assert_array_equal(jmesh.quantize(np.pi * np.arange(9)),
                                  tmesh.quantize(np.pi * np.arange(9)))
    m = tmesh.grid_tet(4, 2, 3)                 # anisotropic block
    np.testing.assert_array_equal(m.conn, jmesh.grid_tet(4, 2, 3).conn)
    assert m.ne == 6 * 4 * 2 * 3 and m.num_nodes == 5 * 3 * 4


ADJ_CASES = {
    "tri": lambda: jmesh.grid_tri(8).conn,
    "quad": lambda: jmesh.grid_quad(5).conn,
    "tet": lambda: jmesh.grid_tet(3).conn,
    "tet_block": lambda: jmesh.grid_tet(3, 2, 1).conn,
    "single": lambda: np.asarray([[0, 1, 2]]),
    "repeated_node": lambda: np.asarray([[0, 1, 1], [1, 2, 3], [4, 5, 6]]),
}


@pytest.mark.parametrize("case", list(ADJ_CASES))
def test_element_adjacency_equal(case):
    conn = ADJ_CASES[case]()
    a = jconflict.element_adjacency(conn)
    b = tconflict.element_adjacency(conn)
    assert len(a) == len(b) == conn.shape[0]
    for e, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, e
        np.testing.assert_array_equal(x, y, err_msg=f"element {e}")


@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("case", ["tri", "quad", "tet", "tet_block"])
def test_element_colorings_equal(case, provider):
    conn = ADJ_CASES[case]()
    cj = jconflict.color_elements(conn, provider=provider)
    ct = tconflict.color_elements(conn, provider=provider)
    assert_coloring_equal(cj, ct)
    assert tconflict.verify_element_coloring(conn, ct)
    assert (jconflict.verify_element_coloring(conn, cj)
            == tconflict.verify_element_coloring(conn, ct))


def test_verify_element_coloring_catches_a_conflict():
    conn = jmesh.grid_tri(4).conn
    col = tconflict.color_elements(conn)
    bad = np.zeros_like(col.color_of_row)          # everything one color
    one = Coloring(color_of_row=bad, num_colors=1,
                   rows_by_color=np.arange(bad.size),
                   color_ptr=np.asarray([0, bad.size]))
    assert not tconflict.verify_element_coloring(conn, one)
    assert not jconflict.verify_element_coloring(conn, one)


# ---------------------------------------------------------------------------
# The schedule artifact, its digest and its npz file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", list(MESHES))
def test_schedule_fields_equal(name, d, provider):
    _, _, js, ts = _pair(name, d, provider)
    assert_schedule_equal(js, ts)
    assert tscatter.structure_digest(ts.targets.reshape(-1, 1)) == \
        jscatter.structure_digest(js.targets.reshape(-1, 1))


def test_structure_digest_equal_and_discriminating():
    conn = jmesh.grid_tri(4).conn
    for d, nn in ((1, None), (3, None), (1, 40)):
        assert (tscatter.structure_digest(conn, d, nn)
                == jscatter.structure_digest(conn, d, nn))
    assert (tscatter.structure_digest(conn, 1)
            != tscatter.structure_digest(conn, 2))
    assert tscatter.assembly_key("ab", 8) == jscatter.assembly_key("ab", 8)
    assert (tscatter.assembly_key("ab", 8, "race")
            == jscatter.assembly_key("ab", 8, "race"))


@pytest.mark.parametrize("provider", ["greedy", "race"])
def test_npz_written_by_reference_loads_in_port(tmp_path, provider):
    _, _, js, _ = _pair("tet", 3, provider)
    path = os.path.join(tmp_path, "asm.npz")
    js.save_npz(path)
    assert_schedule_equal(js, tscatter.AssemblySchedule.load_npz(path))


@pytest.mark.parametrize("provider", ["greedy", "race"])
def test_npz_written_by_port_loads_in_reference(tmp_path, provider):
    _, _, js, ts = _pair("quad", 2, provider)
    path = os.path.join(tmp_path, "asm.npz")
    ts.save_npz(path)
    assert_schedule_equal(jscatter.AssemblySchedule.load_npz(path), ts)
    back = tscatter.AssemblySchedule.load_npz(path)
    assert_schedule_equal(js, back)


def test_npz_version_mismatch_raises(tmp_path, monkeypatch):
    _, _, _, ts = _pair("tri")
    path = os.path.join(tmp_path, "asm.npz")
    monkeypatch.setattr(tscatter, "ASSEMBLY_VERSION", 2)
    ts.save_npz(path)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="version"):
        tscatter.AssemblySchedule.load_npz(path)
    with pytest.raises(ValueError, match="version"):
        jscatter.AssemblySchedule.load_npz(path)


# ---------------------------------------------------------------------------
# Executors against the serial oracle, plain kernels against Pallas bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,variant", EXECUTORS, ids=EXECUTOR_IDS)
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("name", list(MESHES))
def test_every_executor_equals_reference_serial(name, d, strategy, variant):
    _, ke, js, ts = _pair(name, d)
    want = jscatter.scatter_serial(js, ke)
    M = tscatter.assemble(ts, ke, strategy, variant, device=CPU)
    assert M.device.type == "cpu"
    np.testing.assert_array_equal(_vals(M), want)
    if strategy == "colored":
        got = tscatter.scatter_colored(ts, ke, variant=variant, device=CPU)
    elif strategy == "sorted":
        got = tscatter.scatter_sorted(ts, ke, device=CPU)
    elif strategy == "private":
        got = tscatter.scatter_private(ts, ke, device=CPU)
    else:
        got = tscatter.scatter_serial(ts, ke)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("variant", ["stream", "onehot"])
@pytest.mark.parametrize("name,d", [("tri", 1), ("quad", 2), ("tet", 1)])
def test_plain_kernels_equal_pallas_bodies(name, d, variant):
    """The plain versions of K13 / K14 against the TPU bodies run through
    the emulated Pallas grid, on the same packs."""
    mesh = {"tri": jmesh.grid_tri(5), "quad": jmesh.grid_quad(3),
            "tet": jmesh.grid_tet(2)}[name]
    ke = jmesh.synthetic_stiffness(mesh, d, seed=5)
    js = jscatter.build_assembly_schedule(mesh.conn, d)
    want = np.asarray(jkern.colored_scatter_grid(
        js.color_slots, js.color_targets, jnp.asarray(ke), js.size,
        variant=variant, interpret=True))
    packs = tkern.pack_colored_streams(js.color_slots, js.color_targets,
                                       ke.size, js.size)
    plain = (tkern.colored_scatter_stream_plain if variant == "stream"
             else tkern.colored_scatter_onehot_plain)
    np.testing.assert_array_equal(plain(packs, torch.from_numpy(ke)).numpy(),
                                  want)
    got = tkern.colored_scatter(js.color_slots, js.color_targets, ke,
                                js.size, variant=variant, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tkern.colored_scatter_grid is tkern.colored_scatter


def test_race_packs_through_both_kernel_plain_versions():
    """RACE colors repeat targets inside a color: the packs say so (K13
    then adds with atomics) and both plain versions stay exact."""
    _, ke, js, ts = _pair("tet", 3, "race", seed=17)
    assert ts.colored.repeats
    assert not _pair("tet", 3)[3].colored.repeats
    want = jscatter.scatter_serial(js, ke)
    for variant in ("stream", "onehot"):
        np.testing.assert_array_equal(
            tscatter.scatter_colored(ts, ke, variant, device=CPU).numpy(),
            want)
        np.testing.assert_array_equal(np.asarray(jscatter.scatter_colored(
            js, ke, variant=variant)), want)


def test_fused_and_sorted_torch_ops_equal_reference():
    _, ke, js, _ = _pair("tet", 3, seed=2)
    kf = ke.reshape(-1)
    want = jscatter.scatter_serial(js, ke)
    fused = tkern.colored_scatter_fused(js.color_slots, js.color_targets,
                                        torch.from_numpy(kf), js.size)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(
        jkern.colored_scatter_fused(js.color_slots, js.color_targets,
                                    jnp.asarray(kf), js.size)))
    srt = tkern.sorted_scatter(js.sorted_perm, js.sorted_targets,
                               torch.from_numpy(kf), js.size)
    np.testing.assert_array_equal(srt.numpy(), np.asarray(
        jkern.sorted_scatter(js.sorted_perm, js.sorted_targets,
                             jnp.asarray(kf), js.size)))
    np.testing.assert_array_equal(fused.numpy(), want)


def test_tile_buckets_are_a_stable_sort_by_output_tile():
    _, _, _, ts = _pair("tet", 3)
    p = ts.colored
    tile = tkern.ONEHOT_TILE
    slots, tgts = ts.color_slots, ts.color_targets
    for c in range(p.num_colors):
        real = tgts[c] != ts.size
        key = np.where(real, tgts[c].astype(np.int64) // tile, p.num_tiles)
        np.testing.assert_array_equal(p.order[c].numpy(),
                                      np.argsort(key, kind="stable"))
        counts = np.bincount(key, minlength=p.num_tiles + 1)[:p.num_tiles]
        np.testing.assert_array_equal(p.ptr[c].numpy(),
                                      np.r_[0, np.cumsum(counts)])
        assert int(p.ptr[c, -1]) == int(real.sum())
        assert (slots[c][~real] == ts.num_contribs).all()
    assert p.num_tiles == -(-(ts.size + 1) // tile)


def test_malformed_packs_raise_before_any_launch():
    _, _, js, _ = _pair("tri")
    G, size = js.targets.size, js.size
    slots, tgts = js.color_slots.copy(), js.color_targets.copy()
    tkern.pack_colored_streams(slots, tgts, G, size)          # valid
    bad = slots.copy()
    bad[0, 0] = G + 1
    with pytest.raises(ValueError, match="lie in"):
        tkern.pack_colored_streams(bad, tgts, G, size)
    bad = tgts.copy()
    bad[0, 0] = size                      # target sentinel, real slot
    with pytest.raises(ValueError, match="both sentinels"):
        tkern.pack_colored_streams(slots, bad, G, size)
    with pytest.raises(TypeError, match="int16 or int32"):
        tkern.pack_colored_streams(slots.astype(np.int64), tgts, G, size)
    with pytest.raises(ValueError, match="one"):
        tkern.pack_colored_streams(slots[:, :64], tgts, G, size)


def test_wrappers_validate_and_never_launch_on_cpu():
    _, ke, _, ts = _pair("tri")
    packs = ts.bind(CPU).colored
    k = torch.from_numpy(ke).reshape(-1)
    before = _build.launch_counts()
    for launch in (tkern.colored_scatter_stream_cuda,
                   tkern.colored_scatter_onehot_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(packs, k)
    with pytest.raises(ValueError, match="variant"):
        tkern.run_colored(packs, k, "percolor")
    with pytest.raises(ValueError, match="contributions"):
        tkern.run_colored(packs, k[:-1], "stream")
    tkern.run_colored(packs, k, "stream")
    tkern.run_colored(packs, k, "onehot")
    assert _build.launch_counts() == before
    assert {"assembly_colored_stream", "assembly_colored_onehot"} <= set(
        _build.KERNELS)
    assert tkern.K13.replaces.endswith("assembly_scatter.py:102")
    assert tkern.K14.replaces.endswith("assembly_scatter.py:121")


@pytest.mark.parametrize("name,d", [("tri", 1), ("tet", 3)])
def test_streamed_bytes_count_the_function_not_the_layout(name, d):
    """K13 and K14 compute one function and share its byte count: each
    real entry's slot, target and contribution once, the vector once.
    Padding and K14's buckets are the layout's, counted apart."""
    _, _, _, ts = _pair(name, d)
    packs = ts.colored
    idx = packs.slots.element_size() + packs.tgts.element_size()
    assert packs.num_entries == ts.num_contribs
    assert packs.streamed_bytes() == (ts.num_contribs * (idx + 4)
                                      + 4 * ts.size)
    pad = (packs.slots.numel() - ts.num_contribs) * idx
    assert pad > 0
    assert packs.layout_bytes("stream") == pad
    assert packs.layout_bytes("onehot") == pad + 4 * (packs.order.numel()
                                                      + packs.ptr.numel())


# ---------------------------------------------------------------------------
# int16 gate, empty color, single element
# ---------------------------------------------------------------------------

def test_int16_gate_small_mesh_narrows_all_streams():
    _, _, js, ts = _pair("tri")
    for f in ("color_slots", "color_targets", "sorted_perm",
              "sorted_targets"):
        assert getattr(ts, f).dtype == getattr(js, f).dtype == np.int16, f
    assert ts.colored.slots.dtype == torch.int16


def test_int16_gate_overflow_widens_targets_only():
    conn = np.asarray([[0, 1, np.iinfo(np.int16).max]])
    js = jscatter.build_assembly_schedule(conn)
    ts = tscatter.build_assembly_schedule(conn)
    assert_schedule_equal(js, ts)
    assert ts.color_targets.dtype == np.int32
    assert ts.color_slots.dtype == np.int16
    ke = np.asarray([[[2.0, -0.5, -0.25], [-0.5, 1.0, -0.125],
                      [-0.25, -0.125, 3.0]]], np.float32)
    want = jscatter.scatter_serial(js, ke)
    for strategy, variant in EXECUTORS:
        np.testing.assert_array_equal(
            _vals(tscatter.assemble(ts, ke, strategy, variant, device=CPU)),
            want, err_msg=f"{strategy}/{variant}")


def test_int32_slots_with_int16_targets():
    """More contributions than int16 holds on a vector that fits: the
    gates are per stream."""
    mesh = jmesh.grid_tri(44)
    ts = tscatter.build_assembly_schedule(mesh.conn)
    assert ts.color_slots.dtype == np.int32
    assert ts.color_targets.dtype == np.int16
    ke = jmesh.synthetic_stiffness(mesh, seed=4)
    want = tscatter.scatter_serial(ts, ke)
    for variant in ("stream", "onehot"):
        np.testing.assert_array_equal(
            tscatter.scatter_colored(ts, ke, variant, device=CPU).numpy(),
            want)


def test_empty_color_class_is_inert():
    mesh = jmesh.grid_tri(4)
    ke = jmesh.synthetic_stiffness(mesh, seed=9)
    col = tconflict.color_elements(mesh.conn)
    padded = Coloring(color_of_row=col.color_of_row,
                      num_colors=col.num_colors + 1,
                      rows_by_color=col.rows_by_color,
                      color_ptr=np.append(col.color_ptr, col.color_ptr[-1]),
                      provider=col.provider)
    ts = tscatter.build_assembly_schedule(mesh, coloring=padded)
    assert ts.color_slots.shape[0] == col.num_colors + 1
    assert (ts.color_slots[-1] == ts.targets.size).all()
    assert int(ts.colored.ptr[-1, -1]) == 0
    js = jscatter.build_assembly_schedule(mesh, coloring=padded)
    assert_schedule_equal(js, ts)
    want = jscatter.scatter_serial(js, ke)
    for variant in ("stream", "onehot", "percolor"):
        np.testing.assert_array_equal(
            tscatter.scatter_colored(ts, ke, variant, device=CPU).numpy(),
            want, err_msg=variant)


def test_single_element_mesh():
    conn = np.asarray([[0, 1, 2]])
    ke = np.asarray([[[2.0, -1.0, -1.0], [-1.0, 2.0, -1.0],
                      [-1.0, -1.0, 2.0]]], np.float32) / 4
    js = jscatter.build_assembly_schedule(conn)
    ts = tscatter.build_assembly_schedule(conn)
    assert ts.ne == 1 and ts.coloring.num_colors == 1
    assert_schedule_equal(js, ts)
    want = jscatter.scatter_serial(js, ke)
    for strategy, variant in EXECUTORS:
        np.testing.assert_array_equal(
            _vals(tscatter.assemble(ts, ke, strategy, variant, device=CPU)),
            want, err_msg=f"{strategy}/{variant}")


# ---------------------------------------------------------------------------
# Assembled matrices, value-refresh probes, time stepping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,d", [("tri", 1), ("quad", 2), ("tet", 3)])
def test_values_to_csrc_equals_reference(name, d):
    _, ke, js, ts = _pair(name, d)
    Mj = jscatter.assemble(js, ke, "serial")
    Mt = tscatter.assemble(ts, ke, device=CPU)
    assert bool(Mt.numerically_symmetric) == bool(Mj.numerically_symmetric)
    np.testing.assert_array_equal(tcsrc.to_dense(Mt), jcsrc.to_dense(Mj))
    for f in ("ia", "ja"):
        np.testing.assert_array_equal(getattr(Mt, f).numpy(),
                                      np.asarray(getattr(Mj, f)))
    ns = tscatter.values_to_csrc(ts, np.arange(ts.size, dtype=np.float32))
    assert not ns.numerically_symmetric or ts.k == 0
    with pytest.raises(ValueError, match="shape"):
        tscatter.values_to_csrc(ts, np.zeros(ts.size + 1, np.float32))


def test_assemble_counts_one_value_refresh_and_zero_rebuilds():
    mesh = jmesh.grid_tri(5)
    ke = jmesh.poisson_stiffness(mesh, mass=1.0)
    ts, d0 = _build_delta(lambda: tscatter.build_assembly_schedule(mesh))
    assert d0 == {"assembly_schedule": 1, "element_coloring": 1,
                  "assembly_color_pack": 1, "assembly_sorted_pack": 1}
    for strategy in tscatter.STRATEGIES:
        _, d = _build_delta(lambda: tscatter.assemble(ts, ke, strategy,
                                                      device=CPU))
        assert d == {"assembly_value_refresh": 1}, (strategy, d)


def test_assemble_observes_span_histogram_and_one_bind():
    mesh = jmesh.grid_tri(4)
    ke = jmesh.poisson_stiffness(mesh, mass=1.0)
    ts = tscatter.build_assembly_schedule(mesh)
    snap0 = obs.snapshot()
    obs.clear_trace()
    tscatter.assemble(ts, ke, strategy="sorted", device=CPU)
    for _ in range(3):
        tscatter.assemble(ts, ke, strategy="colored", variant="onehot",
                          device=CPU)
    d = obs.snapshot().diff(snap0)
    assert d.merged_hist("assembly_scatter_seconds", strategy="sorted",
                         variant="stream").get("count") == 1
    assert d.merged_hist("assembly_scatter_seconds", strategy="colored",
                         variant="onehot").get("count") == 3
    assert d.total("build_total", kind="assembly_value_refresh") == 4
    # each used strategy's streams moved to the device once, not once per
    # assembly; the private strategy never ran, so its streams never moved
    for part in ("structure", "sorted", "colored"):
        assert d.total("assembly_pack_uploads_total", part=part) == 1, part
    assert d.total("assembly_pack_uploads_total", part="private") == 0
    names = [r["name"] for r in obs.trace()]
    assert names.count("assembly.value_refresh") == 4
    assert names.count("assembly.bind") == 3


def test_time_stepping_reuses_everything():
    """The JAX package's time-stepping probe on the port: re-assembly with
    unchanged connectivity reuses the assembly schedule and the SpMV
    schedule — one value refresh each, zero structural rebuilds."""
    mesh = tmesh.grid_tri(6)
    cache = ttuner.PlanCache()
    plan = tplan.ExecutionPlan(path="kernel", tm=8)
    sched = tscatter.assembly_schedule_for(mesh, cache=cache)

    def step(t):
        ke = tmesh.poisson_stiffness(mesh, mass=0.5 + 0.25 * t)
        return tscatter.assemble(sched, ke, strategy="colored", device=CPU)

    _, da = _build_delta(lambda: step(0))
    assert da == {"assembly_value_refresh": 1}, f"refresh rebuilt: {da}"
    M0 = step(0)
    op, d0 = _build_delta(
        lambda: tops.SpmvOperator.from_plan(M0, plan, cache=cache,
                                            device=CPU))
    assert d0.get("pack") == 1
    M1 = step(1)
    op1, d1 = _build_delta(
        lambda: tops.SpmvOperator.from_plan(M1, plan, cache=cache,
                                            device=CPU))
    assert d1 == {"value_refresh": 1}, f"structural rebuild: {d1}"
    x = np.random.default_rng(0).standard_normal(M1.m).astype(np.float32)
    ref = tcsrc.to_dense(M1).astype(np.float64) @ x.astype(np.float64)
    scale = max(1.0, np.abs(ref).max())
    got = op1(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=2e-4,
                               atol=2e-4)
    _, d2 = _build_delta(lambda: op.update_values(M1))
    assert d2 == {"value_refresh": 1}
    assert torch.equal(op(torch.from_numpy(x)), op1(torch.from_numpy(x)))


def test_serving_time_stepping_value_refresh():
    mesh = tmesh.grid_tri(6)
    sched = tscatter.build_assembly_schedule(mesh)

    def asm(mass):
        return tscatter.assemble(
            sched, tmesh.poisson_stiffness(mesh, mass=mass), device=CPU)

    M0, M1 = asm(0.5), asm(1.5)
    eng = SpmvServingEngine(cache=ttuner.PlanCache(), device=CPU)
    eng.register("fem", M0)
    _, d = _build_delta(lambda: eng.register("fem", M1))
    assert d == {"value_refresh": 1}, f"structural rebuild: {d}"
    _, d2 = _build_delta(lambda: eng.update_values("fem", asm(2.5)))
    assert d2 == {"value_refresh": 1, "assembly_value_refresh": 1}
    x = np.random.default_rng(1).standard_normal(M1.m).astype(np.float32)
    uid = eng.submit("fem", x)
    out = eng.run_until_drained()
    np.testing.assert_allclose(out[uid], tcsrc.to_dense(asm(2.5)) @ x,
                               rtol=2e-4, atol=2e-4)


def test_end_to_end_assemble_solve_matches_reference():
    """assemble_mesh → cg_solve on the port and on the JAX package: same
    matrix, same iterations, the dense solution."""
    jm = jmesh.grid_tri(6)
    ke = jmesh.poisson_stiffness(jm, mass=1.0)
    Mj, _ = jscatter.assemble_mesh(jm, ke, cache=jtuner.PlanCache())
    Mt, ts = tscatter.assemble_mesh(tmesh.grid_tri(6), ke,
                                    cache=ttuner.PlanCache(), device=CPU)
    np.testing.assert_array_equal(tcsrc.to_dense(Mt), jcsrc.to_dense(Mj))
    A = tcsrc.to_dense(Mt).astype(np.float64)
    x_true = np.random.default_rng(3).standard_normal(Mt.n)
    b = torch.from_numpy((A @ x_true).astype(np.float32))
    sol, op = tsolvers.cg_solve(Mt, b, plan=tplan.ExecutionPlan(path="kernel"),
                                tol=1e-7, maxiter=2000, device=CPU)
    assert sol.converged and op.path == "kernel"
    np.testing.assert_allclose(sol.x.numpy().astype(np.float64), x_true,
                               rtol=5e-3, atol=5e-3)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    _, ke, _, ts = _pair("tri")
    for call in (lambda: tscatter.assemble(ts, ke),
                 lambda: tscatter.scatter_colored(ts, ke),
                 lambda: tscatter.scatter_sorted(ts, ke),
                 lambda: tscatter.scatter_private(ts, ke),
                 lambda: ts.bind(None),
                 lambda: tscatter.tune_assembly(ts, ke,
                                                measure=lambda f, k: 1.0)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


# ---------------------------------------------------------------------------
# Plan cache, cost model, tuner, conversion
# ---------------------------------------------------------------------------

def test_schedule_cache_hits_zero_builds_across_processes(tmp_path):
    path = os.path.join(tmp_path, "plans.json")
    mesh = tmesh.grid_tet(2)
    cache = ttuner.PlanCache(path=path)
    s0, d0 = _build_delta(lambda: tscatter.assembly_schedule_for(
        mesh, 3, cache=cache))
    assert d0.get("assembly_schedule") == 1
    _, d1 = _build_delta(lambda: tscatter.assembly_schedule_for(
        mesh, 3, cache=cache))
    assert d1 == {} and cache.assembly_hits == 1
    _, dr = _build_delta(lambda: tscatter.assembly_schedule_for(
        mesh, 3, cache=cache, coloring_provider="race"))
    assert dr.get("element_coloring") == 1
    fresh = ttuner.PlanCache(path=path)                # "new process"
    s2, d2 = _build_delta(lambda: tscatter.assembly_schedule_for(
        mesh, 3, cache=fresh))
    assert d2 == {}, f"disk hit rebuilt: {d2}"
    assert_schedule_equal(s0, s2)
    s3 = tscatter.assembly_schedule_for(mesh, 3, cache=fresh,
                                        coloring_provider="race")
    assert s3.coloring.provider == "race" and s3.coloring.group_of_row \
        is not None
    # the reference's cache reads the port's npz files, and vice versa
    jfresh = jtuner.PlanCache(path=path)
    js = jscatter.assembly_schedule_for(mesh.conn, 3, cache=jfresh)
    assert jfresh.assembly_hits == 1
    assert_schedule_equal(js, s0)


def test_cache_hit_when_fewer_elements_than_buffers(tmp_path):
    conn = np.asarray([[0, 1, 2], [1, 2, 3]])
    cache = ttuner.PlanCache(path=os.path.join(tmp_path, "p.json"))
    s = tscatter.assembly_schedule_for(conn, cache=cache)
    assert s.num_buffers == 2
    _, d = _build_delta(lambda: tscatter.assembly_schedule_for(
        conn, cache=cache))
    assert d == {}


@pytest.mark.parametrize("name,d", [("tri", 1), ("tet", 3)])
def test_assembly_cost_bytes_and_flops_equal(name, d):
    _, _, js, ts = _pair(name, d)
    for s, v in tscatter.ASSEMBLY_CANDIDATES + (("serial", "numpy"),):
        a, b = jcost.assembly_cost(js, s, v), tcost.assembly_cost(ts, s, v)
        assert (a.bytes, a.flops) == (b.bytes, b.flops), (s, v)
        assert b.predicted_s >= max(b.bytes / tcost.HBM_BW,
                                    b.flops / tcost.PEAK_FLOPS)
    ranked = tcost.rank_assembly_candidates(ts,
                                            tscatter.ASSEMBLY_CANDIDATES)
    times = [est.predicted_s for _, est in ranked]
    assert times == sorted(times) and len(ranked) == 5
    # the TPU one-hot form is priced as compute-bound, as in the reference
    assert dict(ranked)[("colored", "onehot")].bound == "compute"


PLAN_CASES = [
    dict(path="kernel"), dict(path="kernel", variant="stream", nrhs=8),
    dict(path="kernel", index_dtype="int16", value_dtype="bfloat16"),
    dict(path="flat", variant="onehot"), dict(path="nnzsplit"),
    dict(path="nnzsplit", variant="stream", nrhs=3),
    dict(path="colorful"), dict(path="colorful", coloring="race"),
    dict(path="segment"),
]


@pytest.mark.parametrize("kw", PLAN_CASES,
                         ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("matrix", ["fem_band", "poisson2d"])
def test_plan_cost_bytes_and_flops_equal(matrix, kw):
    Mj = {"fem_band": lambda: jcsrc.fem_band(300, 9, seed=2),
          "poisson2d": lambda: jcsrc.poisson2d(14)}[matrix]()
    sj = jtuner.stats_of(Mj)
    st = ttuner.stats_of(to_torch_csrc(Mj))
    a = jcost.plan_cost(sj, jplan.ExecutionPlan(**kw))
    b = tcost.plan_cost(st, tplan.ExecutionPlan(**kw))
    assert (a.bytes, a.flops) == (b.bytes, b.flops)
    # the denominators are the card's, so the bound may differ
    assert (b.bound == "compute") == (b.compute_s > b.memory_s)
    assert b.memory_s == b.bytes / tcost.HBM_BW
    assert b.to_dict()["bytes"] == b.bytes
    plans = [tplan.ExecutionPlan(**k) for k in PLAN_CASES]
    ranked = tcost.rank_plans(st, plans)
    keys = [p.predicted_s / max(q.nrhs, 1) for q, p in ranked]
    assert keys == sorted(keys) and len(ranked) == len(plans)
    assert tcost.roofline_fraction(b, 0.0) == 0.0
    assert tcost.roofline_fraction(b, b.predicted_s * 2) == pytest.approx(0.5)


def test_tune_assembly_injected_measure_cache_and_both_packages(tmp_path):
    path = os.path.join(tmp_path, "plans.json")
    mesh = jmesh.grid_tri(5)
    ke = jmesh.poisson_stiffness(mesh, mass=1.0)
    ts = tscatter.build_assembly_schedule(mesh)
    cache = ttuner.PlanCache(path=path)
    seen = []

    def measure(fn, k):
        out = fn(k)                        # the executor actually runs
        assert out.shape == (ts.size,) and k.device.type == "cpu"
        seen.append(out)
        return 1.0

    res = tscatter.tune_assembly(ts, ke, cache=cache, measure=measure,
                                 device=CPU)
    assert not res.cached
    assert (res.strategy, res.variant) in tscatter.ASSEMBLY_CANDIDATES
    assert res.predictions_s.keys() >= res.timings_s.keys()
    assert set(res.roofline_fraction) == set(res.timings_s)
    assert {k.split("/")[0] for k in res.timings_s} == {
        "colored", "sorted", "private"}
    want = tscatter.scatter_serial(ts, ke)
    for out in seen:
        np.testing.assert_array_equal(out.numpy(), want)

    def never(fn, k):
        pytest.fail("measured on a cache hit")

    res2 = tscatter.tune_assembly(ts, ke, cache=cache, measure=never,
                                  device=CPU)
    assert res2.cached and res2.key() == res.key()
    res3 = tscatter.tune_assembly(ts, ke, cache=ttuner.PlanCache(path=path),
                                  measure=never, device=CPU)
    assert res3.cached and res3.roofline_fraction == res.roofline_fraction
    # the JAX package reads the port's asmplan- record as its own hit
    js = jscatter.build_assembly_schedule(mesh)
    jres = jscatter.tune_assembly(js, ke, cache=jtuner.PlanCache(path=path),
                                  measure=never)
    assert jres.cached and jres.key() == res.key()
    with open(path) as f:
        entry = json.load(f)["entries"]["asmplan-" + ts.key()]
    assert entry["measured"] and entry["assembly"]["strategy"] == res.strategy


def test_port_reads_a_tuned_record_written_by_the_reference(tmp_path):
    path = os.path.join(tmp_path, "plans.json")
    mesh = jmesh.grid_tri(4)
    ke = jmesh.poisson_stiffness(mesh, mass=1.0)
    js = jscatter.build_assembly_schedule(mesh)
    jres = jscatter.tune_assembly(js, ke, cache=jtuner.PlanCache(path=path),
                                  measure=lambda fn, k: 2.0)
    ts = tscatter.build_assembly_schedule(mesh)
    res = tscatter.tune_assembly(ts, ke, cache=ttuner.PlanCache(path=path),
                                 measure=lambda fn, k: pytest.fail("timed"),
                                 device=CPU)
    assert res.cached and res.key() == jres.key()
    assert res.timings_s == jres.timings_s


def test_time_scatter_median_on_the_host():
    calls = []
    t = tscatter._time_scatter(lambda k: calls.append(k), torch.zeros(3),
                               warmup=1, repeats=3)
    assert len(calls) == 4 and t >= 0.0


@pytest.mark.parametrize("provider", ["greedy", "race"])
@pytest.mark.parametrize("name,d", [("tri", 1), ("tet", 3)])
def test_convert_assembly_schedule_from_arrays(name, d, provider):
    _, ke, js, _ = _pair(name, d, provider)
    col = js.coloring
    ts = convert.assembly_schedule_from_arrays(
        structure_digest=js.structure_digest, n=js.n, k=js.k, ne=js.ne,
        edof=js.edof, ndof_per_node=js.ndof_per_node,
        num_buffers=js.num_buffers,
        coloring={f: getattr(col, f) for f in COLORING_ARRAYS
                  + ("num_colors", "provider")},
        **{f: np.asarray(getattr(js, f)) for f in SCHED_ARRAYS})
    assert_schedule_equal(js, ts)
    np.testing.assert_array_equal(
        tscatter.scatter_colored(ts, ke, "onehot", device=CPU).numpy(),
        jscatter.scatter_serial(js, ke))
    bad = np.asarray(js.color_slots).copy()
    bad[0, 0] = -1
    with pytest.raises(ValueError, match="lie in"):
        convert.assembly_schedule_from_arrays(
            structure_digest=js.structure_digest, n=js.n, k=js.k, ne=js.ne,
            edof=js.edof, ndof_per_node=js.ndof_per_node,
            num_buffers=js.num_buffers, coloring=ts.coloring,
            **{f: (bad if f == "color_slots" else np.asarray(getattr(js, f)))
               for f in SCHED_ARRAYS})
