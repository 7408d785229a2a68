"""Nothing under perfbench/ imports JAX or the JAX package, and the
yardstick (the reference, the generators) imports nothing of the program.
Names are compared by their whole top-level part, so ``repro_torch`` is
not taken for ``repro``."""
import ast
import os

import pytest

from perfbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: judged answers never come from the program's own code
PROGRAM_FREE = ("reference", "generators", "harness/checks.py",
                "harness/roofline.py", "harness/devtrace.py",
                "harness/traffic.py")


def _sources():
    for d, _, files in os.walk(spec.PERFBENCH):
        if os.sep + "cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_guard_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import obs\n"
                 "import jaxtyping_like\n")
    assert not top_level_imports(str(p)) & FORBIDDEN
    p.write_text("from repro.core import csrc\n")
    assert top_level_imports(str(p)) & FORBIDDEN == {"repro"}
    p.write_text("import jax.numpy as jnp\n")
    assert top_level_imports(str(p)) & FORBIDDEN == {"jax"}


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.PERFBENCH))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in _sources()
    if os.path.relpath(p, spec.PERFBENCH).startswith(PROGRAM_FREE)),
    ids=lambda p: os.path.relpath(p, spec.PERFBENCH))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.PERFBENCH))
def test_reads_no_file_of_the_jax_side(path):
    with open(path) as f:
        text = f.read()
    if os.path.basename(path) == "test_perfbench_imports.py":
        return
    for needle in ("benchmarks/", "src/repro/", "chip_smoke"):
        assert needle not in text, needle
