"""The comparison fails what it must: the control (the reference one
precision down, in the program's place) and the timed path broken
underneath, each at a tiny size on the CPU, through the whole of a run
but its look for a card.  A sound run of the same size passes."""
import time

import pytest
import torch

from perfbench.harness import runner

SEED = 2**31 + 5
CELLS = ["hpcg-pencil56.cg8", "hpcg-cube112.cg8", "hpcg-pencil56.cg1",
         "hpcg-cube112.cg1", "hpcg-pencil56.cg32"]
BLOCK_CELLS = ["hpcg-pencil56.cg8", "hpcg-cube112.cg8", "hpcg-pencil56.cg32"]


def _run(cell, **kw):
    code, res = runner.run(cell, SEED, 0.2, False, time.perf_counter(),
                           device="cpu", **kw)
    assert code == 0
    return res


def _fails(res, *numbers):
    assert res["correct"] is False
    for name in numbers:
        c = res["checks"][name]
        assert c["value"] is None or c["value"] > c["limit"], name


def _patch_product(monkeypatch, fault):
    from repro_torch.serve import executor
    real = executor.LocalExecutor.__call__

    def broken(self, x):
        return fault(real(self, x), x)
    monkeypatch.setattr(executor.LocalExecutor, "__call__", broken)


def _patch_solver(monkeypatch, fault):
    from repro_torch.core import solvers
    real = solvers.cg

    def broken(*args, **kw):
        res = real(*args, **kw)
        return res._replace(x=fault(res.x))
    monkeypatch.setattr(solvers, "cg", broken)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, name):
    _fails(_run(tiny_cell(name), control="bf16"), "product_err")


@pytest.mark.parametrize("name", CELLS)
def test_state_returned_unchanged(tiny_cell, monkeypatch, name):
    """The solve hands back its starting x: no step moved it."""
    _patch_solver(monkeypatch, torch.zeros_like)
    _fails(_run(tiny_cell(name)), "x_err")


@pytest.mark.parametrize("name", BLOCK_CELLS)
def test_half_the_batch_left_out(tiny_cell, monkeypatch, name):
    """The product computes half of the block's columns and gives the
    rest their mean."""
    def half(y, x):
        h = y.shape[1] // 2
        y = y.clone()
        y[:, h:] = y[:, :h].mean(dim=1, keepdim=True)
        return y
    _patch_product(monkeypatch, half)
    _fails(_run(tiny_cell(name)), "product_err", "x_err")


@pytest.mark.parametrize("name", CELLS)
def test_product_altered_where_produced(tiny_cell, monkeypatch, name):
    """One row of every product is off by a thousandth of the largest."""
    def alter(y, x):
        y = y.clone()
        y[y.shape[0] // 3] += 1e-3 * y.abs().max()
        return y
    _patch_product(monkeypatch, alter)
    _fails(_run(tiny_cell(name)), "product_err")


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced(tiny_cell, monkeypatch, name):
    """One entry of every solve's x is off by a thousandth of x's norm."""
    def alter(x):
        x = x.clone()
        x[x.shape[0] // 2] += 1e-3 * torch.linalg.vector_norm(x)
        return x
    _patch_solver(monkeypatch, alter)
    _fails(_run(tiny_cell(name)), "x_err")
