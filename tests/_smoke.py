"""The repo root's ``chip_smoke.py`` as a module, for the tests that share
its one-hot adversary cases and their pack checks (K3/K4/K7/K8:
``onehot_adversary_arrays``; K12: ``nnzsplit_adversary_arrays``; K14:
``assembly_adversary``).  Loading it runs no phase: the script's work
starts in ``main()``."""
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
