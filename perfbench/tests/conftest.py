import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import dataclasses  # noqa: E402

import pytest  # noqa: E402

# small grids that take each path of the engine's default plan on the CPU:
# the pencil's band fits the window ('kernel'), the slab's does not
# ('segment', as the 112^3 cube)
TINY_GRIDS = {"hpcg-pencil56": (8, 8, 24), "hpcg-cube112": (64, 64, 2)}


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """A cell of BENCHMARK.json on a tiny grid, its plan cache in tmp_path."""
    from perfbench.harness import runner, spec
    monkeypatch.setattr(runner, "CACHE", str(tmp_path))

    def make(name: str) -> "spec.Cell":
        cell = spec.load_cell(name)
        grid = TINY_GRIDS[cell.config["name"]]
        return dataclasses.replace(
            cell, config=dict(cell.config, grid=list(grid),
                              name="tiny-" + cell.config["name"]))
    return make
