"""The port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package, and importing the
port needs neither a CUDA compiler, nor ``triton``, nor a card."""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    for must in ("chip_smoke.py", "src/repro_torch/device.py",
                 "src/repro_torch/convert.py",
                 "src/repro_torch/kernels/_build.py",
                 "src/repro_torch/kernels/csrc_spmv.py",
                 "src/repro_torch/kernels/csrc_spmm.py",
                 "src/repro_torch/kernels/csrc_spmv_stream.py",
                 "src/repro_torch/kernels/csrc_spmv_flat.py",
                 "src/repro_torch/kernels/csrc_spmv_nnzsplit.py",
                 "src/repro_torch/kernels/assembly_scatter.py",
                 "src/repro_torch/assembly/__init__.py",
                 "src/repro_torch/assembly/mesh.py",
                 "src/repro_torch/assembly/conflict.py",
                 "src/repro_torch/assembly/scatter.py",
                 "src/repro_torch/roofline/cost_model.py",
                 "src/repro_torch/core/coloring.py",
                 "src/repro_torch/core/solvers.py",
                 "src/repro_torch/serve/engine.py",
                 "src/repro_torch/obs/provenance.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/qwen3_8b.py",
                 "src/repro_torch/configs/deepseek_v2_lite_16b.py",
                 "src/repro_torch/configs/zamba2_7b.py",
                 "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/mla.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/rwkv6.py",
                 "src/repro_torch/models/mamba2.py",
                 "src/repro_torch/configs/rwkv6_1_6b.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/tree.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/optim/compress.py",
                 "src/repro_torch/train/step.py",
                 "src/repro_torch/train/trainer.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/checkpoint/ckpt.py",
                 "src/repro_torch/launch/train.py"):
        assert must in names, must


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", sorted(
    os.path.join(ROOT, "examples", f)
    for f in os.listdir(os.path.join(ROOT, "examples"))
    if f.startswith("torch_") and f.endswith(".py")),
    ids=os.path.basename)
def test_no_example_of_the_port_imports_jax_or_the_jax_package(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_import_in_a_fresh_process_pulls_in_nothing_foreign():
    """Import every module of the port in a subprocess whose PATH holds no
    compiler: no jax / repro / triton in ``sys.modules``, no kernel built."""
    mods = []
    for p in _sources()[1:]:
        rel = os.path.relpath(p, os.path.join(ROOT, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "roots = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'roots': roots,\n"
        "                  'kernels': sorted(_build.KERNELS),\n"
        "                  'bound': [k._fn is not None\n"
        "                            for k in _build.KERNELS.values()]}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["PATH"] = ""
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert not (set(info["roots"]) & (FORBIDDEN | {"triton"})), info["roots"]
    assert "torch" in info["roots"]
    assert len(info["kernels"]) == 14 and not any(info["bound"])


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_needs_nvcc_only_when_asked(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert _build.build_dir().endswith(os.path.join("repro_torch", "_build"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", "/some/where")
    assert _build.build_dir() == "/some/where"


def test_provenance_records_torch_under_shared_keys():
    from repro_torch import obs
    env = obs.environment_provenance()
    assert {"python", "git_sha", "torch", "cuda", "backend", "device_kind",
            "device_count", "sm_count"} <= set(env)
    assert "jax" not in env
    assert obs.env_mismatches(dict(env)) == {}
    assert set(obs.env_mismatches({"backend": "tpu", "jax": "0"})) == {
        "backend"}


def test_build_counts_shim_reads_the_obs_registry():
    from repro_torch import obs
    from repro_torch.core.paths import BUILD_COUNTS
    before = BUILD_COUNTS["unit_probe"]
    with obs.disabled():
        BUILD_COUNTS.inc("unit_probe")       # counts even when disabled
    assert BUILD_COUNTS["unit_probe"] == before + 1
    assert "unit_probe" in BUILD_COUNTS and "unit_probe" in dict(
        BUILD_COUNTS.items())
    assert obs.REGISTRY.family("build_total", "counter", ("kind",)).labels(
        kind="unit_probe").value == before + 1
