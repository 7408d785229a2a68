"""Token serving: the port's ``ServingEngine`` (``device="cpu"``) against
the JAX package's on the same requests and weights, the engine's token
accounting (the counterparts of ``tests/test_serve.py``'s engine tests, on
a toy model that steers EOS), temperature sampling, and the CPU launcher."""
import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch
from repro_torch.models.transformer import build_model
from repro_torch.serve import Request, ServingEngine

from test_torch_parity_helpers import lm_pair


def _requests(cls, vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, vocab, 5 + i % 3),
                max_new_tokens=3 + i % 4) for i in range(n)]


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b", "zamba2-7b"])
def test_greedy_outputs_equal_the_reference_engine(arch):
    """float32, 7 requests through 3 slots (prompts of 5-7 tokens, budgets
    of 3-6, eos 0): the same requests retire with the same tokens in the
    same order."""
    jm, params, tm = lm_pair(arch)
    vocab = jm.cfg.vocab
    je = JEngine(jm, params, max_slots=3, max_len=32, eos_id=0)
    te = ServingEngine(tm, max_slots=3, max_len=32, eos_id=0)
    for rj, rt in zip(_requests(JRequest, vocab), _requests(Request, vocab)):
        je.submit(rj)
        te.submit(rt)
    want = [(r.uid, r.out_tokens) for r in je.run_until_drained()]
    got = [(r.uid, r.out_tokens) for r in te.run_until_drained()]
    assert got == want
    assert len(got) == 7 and all(len(t) >= 1 for _, t in got)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("granite-3-2b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    return cfg, build_model(cfg, device="cpu", generator=gen)


def test_engine_drains_and_batches(small_model):
    cfg, model = small_model
    eng = ServingEngine(model, max_slots=3, max_len=64, eos_id=0)
    rng = np.random.default_rng(0)
    for i in range(7):
        eng.submit(Request(uid=i, prompt=rng.integers(2, 64, 5 + i % 3),
                           max_new_tokens=5))
    done = eng.run_until_drained()
    assert sorted(r.uid for r in done) == list(range(7))
    assert all(1 <= len(r.out_tokens) <= 5 for r in done)
    assert not eng.active and not eng.queue


def test_greedy_determinism(small_model):
    cfg, model = small_model
    outs = []
    for _ in range(2):
        eng = ServingEngine(model, max_slots=1, max_len=64, eos_id=0)
        eng.submit(Request(uid=0, prompt=np.arange(2, 10),
                           max_new_tokens=8))
        outs.append(eng.run_until_drained()[0].out_tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_temperature_sampling_repeats_per_seed(small_model):
    """Draws come from the engine's own torch.Generator: the same seed
    gives the same stream, another seed another one (the stream is not
    jax.random's: ROADMAP C31)."""
    cfg, model = small_model

    def run(seed):
        eng = ServingEngine(model, max_slots=2, max_len=64, eos_id=-1,
                            seed=seed)
        for i in range(2):
            eng.submit(Request(uid=i, prompt=np.arange(2, 8) + i,
                               max_new_tokens=12, temperature=1.0))
        return {r.uid: r.out_tokens for r in eng.run_until_drained()}

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert all(len(t) == 12 and all(0 <= x < cfg.vocab for x in t)
               for t in a.values())


# ---------------------------------------------------------------------------
# Token accounting on a toy model that steers EOS
# ---------------------------------------------------------------------------

class _CountingModel:
    """Deterministic toy LM: the next token is always (prev + 1) mod
    vocab, so tests can steer exactly when EOS appears."""
    vocab = 16
    device = torch.device("cpu")

    def _logits(self, tok):
        nxt = (tok[:, -1:].long() + 1) % self.vocab
        return torch.nn.functional.one_hot(nxt, self.vocab).float()

    def prefill(self, prompt, max_len):
        return None, self._logits(prompt)

    def decode_step(self, state, tok):
        return state, self._logits(tok)


def _counting_engine(eos_id, max_slots=2):
    return ServingEngine(_CountingModel(), max_slots=max_slots, max_len=32,
                         eos_id=eos_id)


def test_max_new_tokens_one_emits_exactly_one_token():
    eng = _counting_engine(eos_id=15)
    eng.submit(Request(uid=0, prompt=np.array([2, 3]), max_new_tokens=1))
    done = eng.step()
    assert [r.uid for r in done] == [0]
    assert done[0].out_tokens == [4]          # exactly one, no decode
    assert not eng.active and not eng.queue


def test_prefill_eos_retires_without_decode_tick():
    eng = _counting_engine(eos_id=9)
    eng.submit(Request(uid=0, prompt=np.array([3, 8]), max_new_tokens=10))
    done = eng.step()
    assert [r.uid for r in done] == [0]
    assert done[0].out_tokens == [9]
    assert not eng.active and not eng.queue


def test_exact_token_budget_without_eos():
    eng = _counting_engine(eos_id=15)
    for k in (1, 2, 5):
        eng.submit(Request(uid=k, prompt=np.array([0]), max_new_tokens=k))
    done = eng.run_until_drained()
    assert {r.uid: len(r.out_tokens) for r in done} == {1: 1, 2: 2, 5: 5}
    assert all(r.out_tokens == list(range(1, r.uid + 1)) for r in done)


def test_prefill_eos_frees_slot_for_queue():
    eng = _counting_engine(eos_id=9, max_slots=1)
    eng.submit(Request(uid=0, prompt=np.array([8]), max_new_tokens=10))
    eng.submit(Request(uid=1, prompt=np.array([0]), max_new_tokens=3))
    done = eng.run_until_drained()
    assert sorted(r.uid for r in done) == [0, 1]
    by_uid = {r.uid: r.out_tokens for r in done}
    assert by_uid[0] == [9]
    assert by_uid[1] == [1, 2, 3]


def test_decode_eos_frees_slot_mid_run():
    """EOS from a decode retires the request that tick; the queued one is
    admitted on the next."""
    eng = _counting_engine(eos_id=5, max_slots=1)
    eng.submit(Request(uid=0, prompt=np.array([2]), max_new_tokens=10))
    eng.submit(Request(uid=1, prompt=np.array([10]), max_new_tokens=2))
    first = eng.step()                        # prefill 3, decode 4
    assert first == [] and 0 in {r.uid for r in eng.active.values()}
    done = eng.step()                         # decode 5 = EOS
    assert [r.uid for r in done] == [0] and done[0].out_tokens == [3, 4, 5]
    done = eng.run_until_drained()
    assert [(r.uid, r.out_tokens) for r in done] == [(1, [11, 12])]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_cpu_launcher_serves_the_reduced_config(capsys):
    done = launch.main(["--arch", "granite-3-2b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--max-new", "4"])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(1 <= len(r.out_tokens) <= 4 for r in done)
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_cpu_launcher_serves_the_recurrent_families(arch, capsys):
    """The ssm and hybrid families through the launcher: every request
    retires; the hybrid's ring (64 positions) is shorter than max_len."""
    done = launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--requests", "3", "--max-new", "5",
                        "--max-len", "128"])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(1 <= len(r.out_tokens) <= 5 for r in done)
    assert "[serve] 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch,why", [("musicgen-large", "embeds")])
def test_cpu_launcher_refuses(arch, why):
    with pytest.raises(SystemExit, match=why):
        launch.main(["--arch", arch, "--reduced", "--device", "cpu"])
