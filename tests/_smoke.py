"""The repo root's ``chip_smoke.py`` as a module, for the tests that share
its one-hot adversary matrices (``onehot_adversary_arrays``) and their pack
checks (``onehot_step_geometry``, ``onehot_case_holds``).  Loading it runs
no phase: the script's work starts in ``main()``."""
import functools
import importlib.util
import pathlib


@functools.lru_cache(maxsize=None)
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
