"""The comparison's two numbers: every cell's limits file holds both, a
file that lacks one is refused, and a reading over its limit fails."""
import math

import pytest
import torch

from perfbench.harness import checks, spec
from perfbench.reference import csrc_ref

LIMITS = {"product_err": {"limit": 1e-4}, "x_err": {"limit": 5e-5}}


@pytest.fixture(scope="module")
def ref():
    cfg = spec._json("configs", "hpcg-pencil56.json")
    a = spec.generator("hpcg27").build(dict(cfg, grid=[5, 4, 6]))
    return csrc_ref.Csrc64(a, "cpu")


def _set(ref, offsets, iters=9):
    """A solved set whose columns are off the reference's x by the given
    relative amounts."""
    b = torch.randn(ref.n, len(offsets), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(9))
    x = csrc_ref.pcg(ref, b, iters)
    x = x * (1 + torch.tensor(offsets, dtype=torch.float64))
    return b, x, iters


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_every_cell_holds_both_numbers(name):
    """Each workload of BENCHMARK.json is judged on product_err and
    x_err, each with a finite limit."""
    limits = spec.load_cell(name).limits
    assert set(checks.NAMES) <= set(limits)
    assert all(math.isfinite(float(limits[k]["limit"]))
               for k in checks.NAMES)


@pytest.mark.parametrize("missing", checks.NAMES)
def test_a_limits_file_lacking_a_number_is_refused(ref, missing):
    limits = {k: v for k, v in LIMITS.items() if k != missing}
    with pytest.raises(KeyError):
        checks.compare(ref, [], [_set(ref, [0.0])], limits)


def test_widest_column_and_failed_sets(ref):
    sets = [_set(ref, [1e-3, 0.0]), _set(ref, [0.0, 1e-7])]
    got, failed = checks.compare(ref, [], sets, LIMITS)
    assert got["x_err"]["value"] == pytest.approx(1e-3, rel=1e-6)
    assert got["x_err"]["each"][1] == pytest.approx(1e-7, rel=1e-4)
    assert failed == 1


def test_non_finite_answer_fails(ref):
    b, x, iters = _set(ref, [0.0, 0.0])
    x[3, 1] = math.nan
    got, failed = checks.compare(ref, [], [(b, x, iters)], LIMITS)
    assert got["x_err"]["value"] == math.inf
    assert failed == 1
