"""The Kronecker configuration: its generator against a plain dense
construction of label spreading's operator, the file's ``expected`` block,
and whole tiny runs on the CPU (a sound one, the control, and faults),
each on a small graph from this file's own fixture."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from perfbench.harness import runner, spec
from test_perfbench_faults import _fails, _patch_product, _patch_solver

CELL = "kron21-lgc.cg8"
SEED = 2**31 + 7
TINY_SCALE = 13         # 8,192 vertices: the band passes the window, so
                        # the default plan is 'segment', as at SCALE 21


def _cfg(**kw):
    return dict(spec._json("configs", "kron21-lgc.json"), **kw)


def _gen():
    return spec.generator("kron")


@pytest.fixture
def tiny_kron(tmp_path, monkeypatch):
    """The cell on a SCALE-13 graph, its plan cache in tmp_path."""
    monkeypatch.setattr(runner, "CACHE", str(tmp_path))
    cell = spec.load_cell(CELL)
    return dataclasses.replace(cell, config=_cfg(scale=TINY_SCALE,
                                                 name="tiny-kron21-lgc"))


def _dense_operator(cfg):
    """I - alpha D^-1/2 W D^-1/2 in float64, W the 0/1 adjacency of the raw
    edge list (both directions, no self-loops), as a dense torch matrix."""
    n = 1 << cfg["scale"]
    u, v = (torch.from_numpy(a).long() for a in _gen().kronecker_edges(
        cfg["scale"], cfg["edgefactor"], cfg["initiator"],
        cfg["graph_seed"]))
    W = torch.zeros(n, n, dtype=torch.float64)
    W[u, v] = 1.0
    W[v, u] = 1.0
    W.fill_diagonal_(0.0)
    d = W.sum(dim=1)
    s = torch.where(d > 0, d.rsqrt(), torch.zeros_like(d))
    return torch.eye(n, dtype=torch.float64) - cfg["alpha"] * (
        s[:, None] * W * s[None, :])


def _dense_csrc(a):
    n = a["n"]
    A = torch.zeros(n, n, dtype=torch.float64)
    rows = torch.repeat_interleave(torch.arange(n),
                                   torch.from_numpy(np.diff(a["ia"])))
    cols = torch.from_numpy(a["ja"]).long()
    A[rows, cols] = torch.from_numpy(a["al"]).double()
    A[cols, rows] = torch.from_numpy(a["au"]).double()
    A[torch.arange(n), torch.arange(n)] = torch.from_numpy(a["ad"]).double()
    return A


@pytest.mark.parametrize("scale", [8, 9, 10])
def test_generator_equals_a_dense_construction(scale):
    """The CSRC arrays are the dense float64 operator rounded to float32:
    the same pattern, each value within float32's rounding."""
    cfg = _cfg(scale=scale)
    a = _gen().build(cfg)
    want = _dense_operator(cfg)
    got = _dense_csrc(a)
    assert torch.equal(got != 0, want != 0)
    torch.testing.assert_close(got, want.float().double(), rtol=2e-7,
                               atol=0.0)
    assert torch.equal(got, got.T)
    assert a["ad"].dtype == a["al"].dtype == np.float32


@pytest.mark.parametrize("scale", [8, 10, 12])
def test_lower_triangle_is_clean(scale):
    """No self-loop, no repeated slot, columns ascending within a row, one
    value array for both halves, and the graph from the file's seed alone."""
    a = _gen().build(_cfg(scale=scale))
    n, ia, ja = a["n"], a["ia"], a["ja"]
    assert ia.dtype == ja.dtype == np.int32
    assert ia[0] == 0 and ia[-1] == ja.shape[0] and (np.diff(ia) >= 0).all()
    rows = np.repeat(np.arange(n), np.diff(ia))
    assert (ja < rows).all() and (ja >= 0).all()
    same = rows[1:] == rows[:-1]
    assert (ja[1:][same] > ja[:-1][same]).all()
    assert a["au"] is a["al"] and a["numerically_symmetric"] is True
    assert (a["ad"] == 1.0).all() and (a["al"] < 0).all()
    again = _gen().build(_cfg(scale=scale))
    for f in ("ia", "ja", "al"):
        np.testing.assert_array_equal(again[f], a[f])
    other = _gen().build(_cfg(scale=scale, graph_seed=2))
    assert not np.array_equal(other["ja"], a["ja"])


def test_power_law_rows():
    """The skew the cell exists for, at SCALE 14: many isolated vertices,
    a longest row far above the mean, and rows past K15's split."""
    from repro_torch.kernels import csrc_segment as seg
    s = _gen().summary(_gen().build(_cfg(scale=14)))
    assert s["isolated"] > 0.2 * s["n"]
    assert s["longest_lower_row"] > 50 * s["k"] / s["n"]
    assert s["longest_lower_row"] > seg.HEAVY_SLOTS


@pytest.mark.parametrize("level", [0, 6, 11])
def test_quadrant_draw_follows_the_initiator(level):
    """The draw alone, against Graph500's initiator [[A, B], [C, D]]: with
    the labels' permutation undone (drawn, as the module says, from the
    last stream spawned from the seed), an edge's (row bit, column bit) at
    one level is (0, 0), (0, 1), (1, 0) or (1, 1) at the shares A, B, C and
    D, each within 5 standard errors over the 65,536 edges of SCALE 12."""
    scale, seed = 12, 3
    a, b, c = _cfg()["initiator"]
    u, v = _gen().kronecker_edges(scale, 16, (a, b, c), seed)
    streams = np.random.SeedSequence(seed).spawn(_gen().BLOCKS + 1)
    perm = np.random.default_rng(streams[-1]).permutation(1 << scale)
    label = np.argsort(perm)
    row = (label[u] >> level) & 1
    col = (label[v] >> level) & 1
    m = u.shape[0]
    for (r, q), share in {(0, 0): a, (0, 1): b, (1, 0): c,
                          (1, 1): 1 - a - b - c}.items():
        got = float(np.mean((row == r) & (col == q)))
        assert abs(got - share) <= 5 * np.sqrt(share * (1 - share) / m), (
            (r, q), got, share)


def test_config_states_the_deployment():
    cfg = spec._json("configs", "kron21-lgc.json")
    assert (cfg["generator"], cfg["scale"], cfg["edgefactor"]) == (
        "kron", 21, 16)
    assert cfg["initiator"] == [0.57, 0.19, 0.19] and cfg["alpha"] == 0.99
    assert (cfg["precision"], cfg["preconditioner"]) == ("float32", "jacobi")
    assert cfg["numerically_symmetric"] is True
    assert set(cfg["reduced"]) == {"scale", "precision"}
    bench = {c["name"]: c for c in spec.load_benchmark()["configs"]}
    assert bench["kron21-lgc"]["source"] == cfg["source"]
    assert cfg["expected"]["n"] == 1 << cfg["scale"]
    assert cfg["expected"]["nnz"] == cfg["expected"]["n"] + 2 * cfg[
        "expected"]["k"]


def test_expected_block_matches_the_generator():
    """The whole SCALE 21 graph, as a run draws it (about 2 GB of host
    memory at its peak): n, k, nnz, the longest lower row and the isolated
    vertices the configuration states."""
    cfg = spec._json("configs", "kron21-lgc.json")
    assert _gen().summary(_gen().build(cfg)) == cfg["expected"]


def _run(cell, **kw):
    code, res = runner.run(cell, SEED, 0.2, False, time.perf_counter(),
                           device="cpu", **kw)
    assert code == 0
    return res


def test_sound_run_is_correct_on_the_segment_path(tiny_kron, capsys):
    res = _run(tiny_kron)
    assert res["correct"] is True and res["failed"] == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"perfbench"')]
    register = next(line for line in lines if line["perfbench"] == "register")
    assert register["path"] == "segment"


def test_control_is_not_correct(tiny_kron):
    _fails(_run(tiny_kron, control="bf16"), "product_err")


def test_state_returned_unchanged(tiny_kron, monkeypatch):
    _patch_solver(monkeypatch, torch.zeros_like)
    _fails(_run(tiny_kron), "x_err")


def test_product_entry_altered(tiny_kron, monkeypatch):
    """One entry of every product off by a thousandth of the largest."""
    def alter(y, x):
        y = y.clone()
        y[y.shape[0] // 3, 0] += 1e-3 * y.abs().max()
        return y
    _patch_product(monkeypatch, alter)
    _fails(_run(tiny_kron), "product_err")


def test_split_ms_reads_the_chunk_kernel_alone():
    from perfbench.harness import devtrace
    read = spec.metric_reader("split_ms")

    def run(ops):
        s = devtrace.DeviceSlice(1.0, 0.5, 4, 0.4, 0.1, ops, [])
        return runner.Run(n=1, k=0, nnz=1, nrhs=8,
                          numerically_symmetric=True, peaks=None,
                          setup_s=1.0, register_s=1.0, slice=s)
    chunk = "(anonymous namespace)::segment_chunk_kernel<4, true>(int co..."
    light = "(anonymous namespace)::segment_light_kernel<4, true, false>(..."
    assert read(run([(light, 0.3), (chunk, 0.002)])) == pytest.approx(0.5)
    assert read(run([("(anonymous namespace)::segment_kernel<4, true, "
                      "false>(...", 0.3)])) is None
    assert read(runner.Run(n=1, k=0, nnz=1, nrhs=8,
                           numerically_symmetric=True, peaks=None,
                           setup_s=1.0, register_s=1.0)) is None
