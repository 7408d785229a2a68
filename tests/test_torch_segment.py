"""The ``segment`` path's module on the CPU (``kernels/csrc_segment.py``):
K15's plain version against the JAX package's segment product, the
wrapper's checks and lane mapping, and the path's executor factories,
which take the plain chain here and count the route.  K15 itself runs only
on the card: its cases are in ``test_torch_cuda.py``."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csrc as jcsrc
from repro.core import plan as jplan
from repro.core import schedule as jschedule
from repro.kernels import ref as jref
from repro_torch import obs
from repro_torch.core import schedule
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels import _build, ref
from repro_torch.kernels import csrc_segment as seg
from repro_torch.kernels.ops import SpmvOperator

from _smoke import chip_smoke
from _split_cases import SPLIT_CASES, split_case
from test_torch_parity_helpers import (MATRICES, dyadic, dyadic_x,
                                       to_torch_csrc)

SEGMENT_MATRICES = dict(
    MATRICES, rectangular=lambda: jcsrc.rectangular_fem(120, 17, 6, seed=2))


def _pair(name):
    Mj = dyadic(SEGMENT_MATRICES[name]())
    return Mj, to_torch_csrc(Mj)


def _routes():
    return (obs.counter("segment_route_total", route="kernel").value,
            obs.counter("segment_route_total", route="plain").value)


@pytest.mark.parametrize("nrhs", [1, 3, 8])
@pytest.mark.parametrize("name", list(SEGMENT_MATRICES))
def test_plain_version_equals_the_jax_segment_product(name, nrhs):
    """On dyadic values, bit for bit, at one column and at several; the
    rectangular tail included."""
    Mj, Mt = _pair(name)
    x = dyadic_x(Mj.m, nrhs, seed=nrhs)
    want = (jref.csrc_spmv(Mj, jnp.asarray(x)) if nrhs == 1
            else jref.csrc_spmm(Mj, jnp.asarray(x)))
    got = seg.segment_product_plain(Mt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (Mj.n,) + x.shape[1:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nrhs,pointers,want", [
    (1, (0, 0), (1, 1)),
    (2, (0, 0), (2, 1)),
    (3, (0, 0), (1, 3)),
    (8, (256, 512), (4, 2)),         # the cube's cg8: two lanes of 16 bytes
    (8, (8, 0), (2, 4)),             # X 8-byte aligned
    (8, (0, 4), (1, 8)),             # Y 4-byte aligned
    (11, (0, 0), (1, 11)),
    (64, (0, 0), (4, 16)),
    (136, (0, 0), (4, 32)),          # 34 groups: lanes loop past 32
])
def test_lane_mapping_follows_width_and_alignment(nrhs, pointers, want):
    vec, lanes = seg.lane_mapping(nrhs, *pointers)
    assert (vec, lanes) == want
    assert nrhs % vec == 0 and 1 <= lanes <= seg.MAX_LANES


def test_lane_mapping_refuses_an_empty_width():
    with pytest.raises(ValueError, match="at least 1"):
        seg.lane_mapping(0, 0)


def test_kernel_takes_float32_values_and_int32_indices_only():
    _, M = _pair("fem_band")
    assert seg.kernel_takes(M)
    seg.check_matrix(M)
    M64 = dataclasses.replace(M, al=M.al.double())
    assert not seg.kernel_takes(M64)
    with pytest.raises(TypeError, match="float32 values"):
        seg.check_matrix(M64)
    assert not seg.kernel_takes(dataclasses.replace(M, ja=M.ja.long()))
    strided = torch.empty(2 * M.k)[::2]
    strided.copy_(M.al)
    with pytest.raises(ValueError, match="contiguous"):
        seg.check_matrix(dataclasses.replace(M, al=strided))


def test_wrapper_refuses_cpu_tensors_and_wrong_shapes_without_launching():
    _, M = _pair("rectangular")
    x = torch.from_numpy(dyadic_x(M.m, 3))
    before = _build.launch_counts()
    assert seg.K15.name in before
    with pytest.raises(ValueError, match="on the card"):
        seg.SegmentKernel(M)
    with pytest.raises(ValueError, match="shape"):
        seg.segment_product_plain(M, x[:M.n])
    with pytest.raises(ValueError, match="shape"):
        seg.segment_product_plain(M, x[None])
    seg.segment_product_plain(M, x.double())        # widened to float32
    assert _build.launch_counts() == before


def test_segment_factories_take_the_plain_chain_on_the_cpu():
    """On the CPU both executors are the reference chain, as before K15;
    ``segment_route_total{route="plain"}`` counts one a bound operator (a
    value refresh binds again), and no kernel launches."""
    _, M = _pair("fem_band")
    kernel0, plain0 = _routes()
    launches0 = _build.launch_counts()
    op = SpmvOperator(M, path="segment", device="cpu")
    assert _routes() == (kernel0, plain0 + 1)
    assert isinstance(op._fn, functools.partial)
    assert op._fn.func is ref.csrc_spmv and op._fn_mm.func is ref.csrc_spmm
    x = torch.from_numpy(dyadic_x(M.m, 4))
    assert torch.equal(op(x), seg.segment_product_plain(M, x))
    assert torch.equal(op(x[:, 1]), seg.segment_product_plain(M, x[:, 1]))
    op.update_values(M)
    assert _routes() == (kernel0, plain0 + 2)
    with obs.disabled():
        SpmvOperator(M, path="segment", device="cpu")
    assert _routes() == (kernel0, plain0 + 3)
    assert _build.launch_counts() == launches0



# ---------------------------------------------------------------------------
# The split of heavy rows (``split_rows``): the ``segment`` schedule's
# artifact, which K15 reads when it binds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heavy,chunk", [(seg.HEAVY_SLOTS, seg.CHUNK_SLOTS),
                                         (0, 1), (5, 3), (100, 7)])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_covers_each_heavy_slot_once(case, heavy, chunk):
    """Every lower slot of a row with more than ``heavy`` lies in exactly
    one chunk, no other slot in any; a chunk stays inside its row, holds
    1 to ``chunk`` slots, and a row's chunks follow each other in slot
    order.  ``rows`` and ``slots`` count the split rows and their slots."""
    M = split_case(case)
    split = seg.split_rows(M.ia, heavy, chunk)
    table = split.chunks
    assert table.dtype == torch.int32 and table.shape[1] == 3
    assert split.heavy == heavy
    ia = M.ia.long()
    lengths = ia[1:] - ia[:-1]
    row, first, end = table.long().unbind(1)
    heavy_rows = torch.nonzero(lengths > heavy).flatten()
    assert torch.equal(torch.unique_consecutive(row), heavy_rows)
    assert split.rows == heavy_rows.numel() > 0
    assert split.slots == int(lengths[heavy_rows].sum())
    assert bool((row[1:] >= row[:-1]).all())
    assert bool(((end - first >= 1) & (end - first <= chunk)).all())
    assert bool(((first >= ia[row]) & (end <= ia[row + 1])).all())
    covered = torch.zeros(M.k, dtype=torch.long)
    for a, b in zip(first.tolist(), end.tolist()):
        covered[a:b] += 1
    row_of = torch.repeat_interleave(torch.arange(M.n), lengths)
    assert torch.equal(covered, (lengths[row_of] > heavy).long())


def test_split_is_empty_where_every_row_is_short():
    """HPCG's stencil (at most 13 lower slots a row): no row is heavy, so
    K15 keeps its one row-owned launch."""
    from repro_torch.core import csrc
    M = csrc.from_assembly(16 ** 3, *chip_smoke().stencil27_arrays(16, 16,
                                                                   16))
    assert int((M.ia[1:] - M.ia[:-1]).max()) == 13 < seg.HEAVY_SLOTS
    split = seg.split_rows(M.ia)
    assert split.chunks.shape == (0, 3) and split.rows == split.slots == 0


@pytest.mark.parametrize("heavy,chunk", [(-1, 8), (8, 0)])
def test_split_refuses_bad_arguments(heavy, chunk):
    M = split_case("one_row")
    with pytest.raises(ValueError, match="heavy"):
        seg.split_rows(M.ia, heavy, chunk)


def _assert_split_equal(a, b):
    assert (a.heavy, a.rows, a.slots) == (b.heavy, b.rows, b.slots)
    assert torch.equal(a.chunks.cpu(), b.chunks.cpu())


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_segment_schedule_carries_the_split(tmp_path, case):
    """The ``segment`` schedule's artifact is the split of the matrix, made
    in one ``schedule.segment_split`` span; it survives ``save_npz`` /
    ``load_npz``, stays one object under ``to`` on its own device and under
    a same-structure value refresh, and the bound CPU operator answers as
    the plain chain."""
    M = split_case(case)
    obs.clear_trace()
    sched = schedule.build_schedule(M, ExecutionPlan(path="segment"))
    spans = obs.trace("schedule.segment_split")
    assert len(spans) == 1
    split = sched.segment_split
    _assert_split_equal(split, seg.split_rows(M.ia))
    assert spans[0]["labels"] == {"rows": str(split.rows),
                                  "slots": str(split.slots),
                                  "chunks": str(split.chunks.shape[0])}
    f = str(tmp_path / "segment.npz")
    sched.save_npz(f)
    _assert_split_equal(schedule.SpmvSchedule.load_npz(f).segment_split,
                        split)
    assert sched.to("cpu") is sched
    M2 = dataclasses.replace(M, al=M.al * 2, au=M.au * 2)
    assert schedule.refresh_schedule(sched, M2).segment_split is split
    op = SpmvOperator.from_plan(M, sched.plan, device="cpu", schedule=sched)
    x = torch.from_numpy(dyadic_x(M.m, 3))
    assert torch.equal(op(x), seg.segment_product_plain(M, x))


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_plan_cache_keeps_the_split(tmp_path, case):
    """A second engine on the same PlanCache file takes the stored split:
    its ``register`` makes no ``schedule.segment_split`` span."""
    from repro_torch.core.tuner import PlanCache
    from repro_torch.serve.engine import SpmvServingEngine
    M = split_case(case)
    path = str(tmp_path / "plans.json")
    plan = ExecutionPlan(path="segment")
    obs.clear_trace()
    SpmvServingEngine(cache=PlanCache(path), device="cpu").register(
        "m", M, plan=plan)
    assert len(obs.trace("schedule.segment_split")) == 1
    obs.clear_trace()
    eng = SpmvServingEngine(cache=PlanCache(path), device="cpu")
    eng.register("m", M, plan=plan)
    assert obs.trace("schedule.segment_split") == []
    assert [r for r in obs.trace() if r["name"] == "schedule.load"]


def test_segment_schedule_written_by_reference_loads_without_a_split(
        tmp_path):
    """The JAX package's ``segment`` schedule has no artifact: the port
    loads it with no split (K15 then splits the matrix when it binds), and
    the bound CPU operator answers as the reference's."""
    Mj, Mt = _pair("rectangular")
    sj = jschedule.build_schedule(Mj, jplan.ExecutionPlan(path="segment"))
    f = str(tmp_path / "segment.npz")
    sj.save_npz(f)
    st = schedule.SpmvSchedule.load_npz(f)
    assert st.key() == sj.key() and st.segment_split is None
    op = SpmvOperator.from_plan(Mt, st.plan, device="cpu", schedule=st)
    x = dyadic_x(Mj.m, 3, seed=4)
    np.testing.assert_array_equal(
        op(torch.from_numpy(x)).numpy(),
        np.asarray(jref.csrc_spmm(Mj, jnp.asarray(x))))
