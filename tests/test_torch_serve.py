"""The served path as a whole: the same requests through the JAX package's
``SpmvServingEngine`` and the port's (``device="cpu"``) — equal answers,
equal metadata."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.serve import SpmvServingEngine as JEngine
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as tsched
from repro_torch.core.distributed import ShardMesh
from repro_torch.core import tuner as ttuner
from repro_torch.serve import (LocalExecutor, SpmvResult, SpmvServingEngine,
                               placement)

from test_torch_parity_helpers import (MATRICES, dyadic, dyadic_x,
                                       to_torch_csrc)

STREAM = dict(path="kernel", tm=32, k_step_sublanes=2, variant="stream")


def _engines():
    ej, et = JEngine(), SpmvServingEngine(device="cpu")
    mats = {"band": dyadic(MATRICES["fem_band"]()),
            "sym": dyadic(MATRICES["fem_band_sym"]())}
    plans_j = {"band": ej.register("band", mats["band"]),
               "sym": ej.register("sym", mats["sym"],
                                  plan=jplan.ExecutionPlan(**STREAM))}
    plans_t = {"band": et.register("band", to_torch_csrc(mats["band"])),
               "sym": et.register("sym", to_torch_csrc(mats["sym"]),
                                  plan=tplan.ExecutionPlan(**STREAM))}
    return ej, et, mats, plans_j, plans_t


def test_same_requests_same_answers_and_metadata():
    ej, et, mats, plans_j, plans_t = _engines()
    for mid in mats:
        assert plans_j[mid].to_json() == plans_t[mid].to_json()
    assert plans_t["band"].variant == "onehot"       # default: heuristic
    # a wave coalesced into one SpMM per matrix, then single requests
    sent = []
    for wave in (5, 1):
        uids = []
        for mid, M in mats.items():
            for i in range(wave):
                x = dyadic_x(M.n, 1, seed=len(sent) + i)
                uj, ut = ej.submit(mid, x), et.submit(mid, x)
                assert uj == ut
                uids.append((uj, mid))
        outj, outt = ej.run_until_drained(), et.run_until_drained()
        assert set(outj) == set(outt) == {u for u, _ in uids}
        for uid, mid in uids:
            rj, rt = outj[uid], outt[uid]
            assert isinstance(rt, SpmvResult) and rt.dtype == np.float32
            np.testing.assert_array_equal(np.asarray(rj), np.asarray(rt))
            mj, mt = rj.meta(), rt.meta()
            assert mt["batched"] == wave
            for k in ("matrix_id", "plan_key", "path", "strategy", "mesh_p",
                      "executor", "batched"):
                assert mj[k] == mt[k], k
            assert set(mt["timings"]) == {"queue_wait_s", "execute_s"}
            assert mt["timings"]["execute_s"] > 0
        sent.extend(uids)
    assert not et.queue and len(sent) == 12


def test_max_batch_splits_ticks():
    et = SpmvServingEngine(device="cpu", max_batch=4)
    M = dyadic(MATRICES["fem_band"]())
    et.register("band", to_torch_csrc(M))
    for i in range(6):
        et.submit("band", dyadic_x(M.n, 1, seed=i))
    first = et.step()
    assert sorted(r.batched for r in first.values()) == [4] * 4
    assert len(et.queue) == 2
    assert sorted(r.batched for r in et.step().values()) == [2, 2]


def test_update_values_refreshes_without_rebuild():
    ej, et, mats, _, _ = _engines()
    M2 = dataclasses.replace(mats["sym"], al=np.asarray(mats["sym"].al) * 2,
                             au=np.asarray(mats["sym"].au) * 2)
    before = dict(tsched.BUILD_COUNTS.items())
    ej.update_values("sym", M2)
    et.update_values("sym", to_torch_csrc(M2))
    delta = {k: v - before.get(k, 0)
             for k, v in tsched.BUILD_COUNTS.items() if v != before.get(k, 0)}
    assert delta == {"value_refresh": 1}
    x = dyadic_x(M2.n, 1, seed=3)
    uj, ut = ej.submit("sym", x), et.submit("sym", x)
    np.testing.assert_array_equal(np.asarray(ej.step()[uj]),
                                  np.asarray(et.step()[ut]))
    with pytest.raises(KeyError):
        et.update_values("nope", to_torch_csrc(M2))


def test_reregistering_known_matrix_builds_nothing():
    cache = ttuner.PlanCache()
    M = to_torch_csrc(MATRICES["fem_band"]())
    SpmvServingEngine(cache=cache, device="cpu").register("a", M)
    before = dict(tsched.BUILD_COUNTS.items())
    eng = SpmvServingEngine(cache=cache, device="cpu")
    eng.register("a", M)
    assert dict(tsched.BUILD_COUNTS.items()) == before
    assert isinstance(eng.executor("a"), LocalExecutor)
    assert eng.executor("a").device == torch.device("cpu")
    assert eng.plan("a") == eng.executor("a").plan
    assert eng.executor("a").path == "kernel"


def test_submit_validation_and_unported_modes():
    eng = SpmvServingEngine(device="cpu")
    M = to_torch_csrc(MATRICES["fem_band"]())
    eng.register("a", M)
    with pytest.raises(KeyError):
        eng.submit("b", np.zeros(M.n))
    with pytest.raises(ValueError, match="shape"):
        eng.submit("a", np.zeros(M.n + 1))
    assert eng.step() == {}
    # autotuning is ported: it measures at the engine's batched width
    tuned = SpmvServingEngine(device="cpu", autotune=True).register("a", M)
    assert tuned.nrhs in (1, 8)
    # a mesh plan needs a mesh of its width: the CPU counts one device, so
    # two shards are refused unless an emulated mesh is supplied
    mesh = tplan.ExecutionPlan(path="segment", strategy="mesh", mesh_p=2)
    with pytest.raises(ValueError, match="devices"):
        placement.build_executor(M, mesh, device="cpu")
    ex = placement.build_executor(M, mesh, mesh=ShardMesh(2, "cpu"))
    assert ex.kind == "mesh" and ex.device == torch.device("cpu")
    # a mesh request degrades to the local entries, as in the reference
    # when the process cannot see enough devices
    assert placement.resolve_plan(M, mesh_p=4).strategy == "local"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SpmvServingEngine()
