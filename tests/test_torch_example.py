"""``examples/torch_assemble_tune_solve.py`` on the CPU at a small size:
the port's assemble → tune_assembly → tune → CG pipeline end to end,
with the same checks the reference example prints."""
import importlib.util
import os

import pytest

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "torch_assemble_tune_solve.py")


def _example():
    spec = importlib.util.spec_from_file_location("torch_example", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_assembles_tunes_and_solves_on_the_cpu(capsys):
    out = _example().main(["--n", "8", "--steps", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[tune_assembly] winner=" in printed and "[step 2]" in printed
    assert out["exact"] and not out["assembly"].cached
    assert "colored/onehot" in out["assembly"].timings_s
    res = out["tune"]
    assert not res.cached and res.timings_s
    assert set(res.timings_s) <= set(res.predictions_s)
    assert out["solve"].converged
    for delta, sol in out["steps"]:
        # a value refresh per step, no structural rebuild
        assert set(delta) <= {"value_refresh", "assembly_value_refresh"}
        assert sol.converged


def test_example_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _example().main(["--n", "4", "--steps", "0"])


MESH_EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "torch_serve_mesh.py")


def _mesh_example():
    spec = importlib.util.spec_from_file_location("torch_mesh_example",
                                                  MESH_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_example_tunes_and_serves_on_an_emulated_mesh(capsys):
    out = _mesh_example().main(["--device", "cpu", "--n", "512",
                                "--mesh-p", "4", "--requests", "7"])
    printed = capsys.readouterr().out
    assert "tuned fem_band @p4:" in printed and "value refresh" in printed
    assert all(p.strategy == "mesh" and p.mesh_p == 4
               for p in out["plans"].values())
    assert all(r.executor == "mesh" for r in out["results"].values())
    assert len(out["results"]) == 7
    assert out["max_err"] < 1e-3 and out["refresh_err"] < 1e-3
    assert out["refresh_executor"] == "mesh"


def test_mesh_example_degrades_to_local_without_a_mesh(capsys):
    out = _mesh_example().main(["--device", "cpu", "--n", "256",
                                "--no-mesh", "--requests", "3"])
    assert all(p.strategy == "local" for p in out["plans"].values())
    assert out["max_err"] < 1e-3


def test_mesh_example_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _mesh_example().main(["--n", "64", "--requests", "1"])


TRAIN_EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                             "torch_train_lm.py")


def _train_example():
    spec = importlib.util.spec_from_file_location("torch_train_example",
                                                  TRAIN_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_example_lowers_the_loss_on_the_cpu(capsys):
    """The ~10M-weight CPU size, 8 steps of 4 x 64 tokens, microbatches 2
    and full remat as in the reference example."""
    out = _train_example().main(["--device", "cpu", "--steps", "8"])
    printed = capsys.readouterr().out
    assert "params: 13.8M on cpu" in printed and "(improved)" in printed
    steps = [s for s, _ in out["losses"]]
    assert steps == [0, 7]
    first, last = out["losses"][0][1], out["losses"][-1][1]
    assert last < first
    assert int(out["trainer"].state.step) == 8


def test_train_example_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _train_example().main(["--steps", "1"])
