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


def _load(name):
    path = os.path.join(os.path.dirname(__file__), "..", "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_its_seven_steps_on_the_cpu(capsys):
    """The checks ``examples/quickstart.py`` prints: the kernel path on
    the Laplacian, Ax == A^T x, a coloring, CG converging, an SpMM's
    shape, a tuned plan and a cached cg_solve."""
    out = _load("torch_quickstart.py").main(["--device", "cpu",
                                             "--side", "16"])
    printed = capsys.readouterr().out
    assert "path=kernel" in printed and "tuned plan:" in printed
    assert out["path"] == "kernel" and out["symmetric"]
    assert out["colors"] >= 2 and out["cg"].converged
    assert out["spmm_shape"] == (256, 8)
    res = out["tune"]
    assert not res.cached and res.timings_s
    assert out["cg_cached"].converged and out["cache_hits"] >= 1


def test_quickstart_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _load("torch_quickstart.py").main(["--side", "8"])


def test_fem_cg_solve_runs_the_products_and_both_solvers_on_the_cpu(capsys):
    """The checks ``examples/fem_cg_solve.py`` prints, at a small size: the
    products on both paths, PCG converging to x_true, BiCGSTAB on the
    non-symmetric band, the paper's loads per flop."""
    out = _load("torch_fem_cg_solve.py").main(["--device", "cpu", "--n",
                                               "16", "--products", "3"])
    printed = capsys.readouterr().out
    assert "[spmv:segment ]" in printed and "[spmv:kernel  ]" in printed
    assert set(out["per_product_s"]) == {"segment", "kernel"}
    assert out["cg"].converged and out["cg_err"] < 1e-4
    assert out["bicgstab"].converged
    loads = out["loads_per_flop"]
    assert loads["csrc_sym"] < loads["csrc"] < loads["csr"]


def test_fem_cg_solve_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _load("torch_fem_cg_solve.py").main(["--n", "8", "--products", "1"])


def test_serve_batched_greedy_tokens_equal_the_reference_example():
    """``examples/serve_batched.py``'s traffic (6 requests, 3 slots, 12 new
    tokens, the reduced granite, weights from PRNGKey(0)) through the
    twin's ``serve`` on the same weights: every greedy request gets the
    reference's tokens; the sampled ones draw a torch stream (C31) and
    only have their lengths and vocabulary checked.  Both run in float32:
    in bf16 the two packages' CPU ops round differently (the LM parity
    suites hold bf16 logits to 2e-2), and a greedy argmax over a near-tie
    then picks another token a few steps in."""
    import numpy as np
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServingEngine as JEngine
    from test_torch_parity_helpers import lm_pair
    ex = _load("torch_serve_batched.py")
    jm, params, tm = lm_pair("granite-3-2b", dtype="float32")
    engine = JEngine(jm, params, max_slots=3, max_len=128, eos_id=1)
    rng = np.random.default_rng(0)
    for i in range(6):
        engine.submit(JRequest(
            uid=i, prompt=rng.integers(2, jm.cfg.vocab, 4 + i % 5),
            max_new_tokens=12, temperature=0.0 if i % 2 == 0 else 0.8))
    want = {r.uid: r.out_tokens for r in engine.run_until_drained()}
    got, _ = ex.serve(tm, tm.cfg, 6, 12)
    assert sorted(got) == list(range(6))
    for uid in range(0, 6, 2):
        assert got[uid].out_tokens == want[uid], uid
    for uid in range(1, 6, 2):
        toks = got[uid].out_tokens
        assert 1 <= len(toks) <= 12
        assert all(0 <= t < tm.cfg.vocab for t in toks)


def test_serve_batched_runs_on_the_cpu(capsys):
    out = _load("torch_serve_batched.py").main(["--device", "cpu",
                                                "--requests", "4",
                                                "--max-new", "5"])
    assert "served 4 requests" in capsys.readouterr().out
    assert sorted(out["done"]) == [0, 1, 2, 3]
    assert out["tokens"] == sum(len(r.out_tokens)
                                for r in out["done"].values())


def test_serve_batched_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        _load("torch_serve_batched.py").main(["--requests", "1"])
