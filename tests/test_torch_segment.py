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
from repro.kernels import ref as jref
from repro_torch import obs
from repro_torch.kernels import _build, ref
from repro_torch.kernels import csrc_segment as seg
from repro_torch.kernels.ops import SpmvOperator

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

