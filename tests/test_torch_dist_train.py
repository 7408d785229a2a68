"""Distributed training: the GPipe pipeline (``train/pipeline.py``) and the
compressed all-reduce (``optim/compress.py::compressed_psum``) over a
``ShardMesh``, against the JAX package's run in a subprocess on 4
placeholder devices (as ``tests/test_pipeline.py`` runs it; the installed
jax needs the pipeline jitted under ``jax.set_mesh``), against the port's
own sequential loop, and on gloo process groups of 2 and 4 ranks.

Tolerances: the pipeline 1e-5 against the reference (its own test's bar)
and 1e-6 against the sequential loop (bit for bit in fact); compressed
sums exact on dyadic values in float32 and int8 (on standard-normal
values int8 within two float32 ulps: XLA multiplies by reciprocals), exact
in bf16 where the bf16 sums are exact, else within one bf16 ulp of the
sum; gloo sums bf16 in bf16, so its bar is half an ulp of the absolute sum
per rank."""
import functools
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import ShardMesh
from repro_torch.obs import collectives
from repro_torch.optim.compress import compressed_psum, wire_bytes
from repro_torch.roofline.op_cost import collective_stats
from repro_torch.train.pipeline import bubble_fraction, pipeline_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, M, B, S = 8, 16, 6, 3, 4          # tests/test_pipeline.py's case
P = 4                                    # shards of the all-reduce
MODES = ("float32", "bfloat16", "int8")


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return w, xs


def _psum_inputs(kind):
    """Per-shard leaves stacked on a leading shard axis."""
    rng = np.random.default_rng(1 if kind == "dyadic" else 2)
    shapes = {"a": (P, 64), "b": (P, 3, 5)}
    if kind == "dyadic":             # k / 8, |k| <= 64: bf16 sums exact
        return {k: (rng.integers(-64, 65, s) / 8.0).astype(np.float32)
                for k, s in shapes.items()}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


REFERENCE = textwrap.dedent("""
    import functools, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.optim.compress import compressed_psum
    from repro.train.pipeline import pipeline_apply
    src, dst = sys.argv[1], sys.argv[2]
    inp = dict(np.load(src))
    out = {}
    mesh = jax.make_mesh((4,), ('stage',))
    def layer_fn(p, x):
        return jnp.tanh(x @ p['w'])
    with jax.set_mesh(mesh):
        out['pipeline'] = np.asarray(jax.jit(
            lambda w, x: pipeline_apply(layer_fn, {'w': w}, x, mesh,
                                        'stage'))(inp['w'], inp['xs']))
    dmesh = jax.make_mesh((4,), ('d',))
    for kind in ('dyadic', 'normal'):
        tree_ = {k: inp[f'{kind}_{k}'] for k in ('a', 'b')}
        for mode in ('float32', 'bfloat16', 'int8'):
            fn = jax.shard_map(
                functools.partial(compressed_psum, axis_name='d', mode=mode),
                mesh=dmesh, in_specs=P('d'), out_specs=P('d'))
            got = jax.jit(fn)(tree_)
            for k, v in got.items():
                out[f'psum_{kind}_{mode}_{k}'] = np.asarray(v)
    np.savez(dst, **out)
    print('OK')
""")


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX package's pipeline and compressed sums, one subprocess."""
    w, xs = _pipeline_inputs()
    arrays = {"w": w, "xs": xs}
    for kind in ("dyadic", "normal"):
        for k, v in _psum_inputs(kind).items():
            arrays[f"{kind}_{k}"] = v
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run([sys.executable, "-c", REFERENCE, src, dst],
                             capture_output=True, text=True, env=env,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return dict(np.load(dst))


def _layer_fn(p, x):
    return torch.tanh(x @ p["w"])


def _sequential(w, xs):
    ref = xs
    for i in range(w.shape[0]):
        ref = torch.tanh(ref @ w[i])
    return ref


@pytest.mark.parametrize("stages,micro", [(1, 8), (4, 8), (4, 32), (2, 1),
                                          (8, 3)])
def test_bubble_fraction_equals_the_reference(stages, micro):
    from repro.train.pipeline import bubble_fraction as ref
    assert bubble_fraction(stages, micro) == ref(stages, micro)
    assert bubble_fraction(4, 32) < bubble_fraction(4, 8)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9


def test_pipeline_equals_the_reference_and_the_sequential_loop():
    w, xs = _pipeline_inputs()
    tw, txs = torch.from_numpy(w), torch.from_numpy(xs)
    with collectives.recording() as log:
        got = pipeline_apply(_layer_fn, {"w": tw}, txs, ShardMesh(S, "cpu"))
    want = _reference()["pipeline"]
    assert got.shape == (M, B, D)
    assert np.abs(got.numpy() - want).max() < 1e-5
    seq = _sequential(tw, txs)
    assert (got - seq).abs().max() < 1e-6
    assert torch.equal(got, seq)
    # (S-1) hand-offs for each of the M microbatches, one collection
    stats = collective_stats(log)
    assert stats["send-recv"]["count"] == (S - 1) * M
    assert stats["send-recv"]["bytes"] == (S - 1) * M * B * D * 4
    assert stats["all-reduce"] == {"count": 1.0, "bytes": M * B * D * 4.0}


@pytest.mark.parametrize("stages", [1, 2, 8])
def test_pipeline_stage_counts_equal_the_sequential_loop(stages):
    w, xs = _pipeline_inputs()
    tw, txs = torch.from_numpy(w), torch.from_numpy(xs)
    got = pipeline_apply(_layer_fn, {"w": tw}, txs,
                         ShardMesh(stages, "cpu"))
    assert torch.equal(got, _sequential(tw, txs))


def test_pipeline_refuses_a_stage_count_that_does_not_divide_the_layers():
    w, xs = _pipeline_inputs()
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(_layer_fn, {"w": torch.from_numpy(w)},
                       torch.from_numpy(xs), ShardMesh(3, "cpu"))


def _port_psum(arrays, mode):
    trees = [{k: torch.from_numpy(v[i]) for k, v in arrays.items()}
             for i in range(P)]
    with collectives.recording() as log:
        out = compressed_psum(trees, ShardMesh(P, "cpu"), mode)
    assert len(out) == P and all(o is out[0] for o in out)
    assert collective_stats(log)["all-reduce"]["bytes"] == wire_bytes(
        trees[0], mode)
    return out[0]


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("mode", MODES)
def test_compressed_psum_equals_the_reference(mode, kind):
    arrays = _psum_inputs(kind)
    got = _port_psum(arrays, mode)
    ref = _reference()
    for k in arrays:
        want = ref[f"psum_{kind}_{mode}_{k}"]
        # every shard of the reference holds the sum
        assert want.shape == arrays[k].shape
        assert all(np.array_equal(want[0], want[i]) for i in range(P))
        g = got[k].numpy()
        if mode == "int8" and kind == "normal":
            # XLA multiplies by the reciprocal of 127 and of the scale
            np.testing.assert_array_max_ulp(g, want[0], maxulp=2)
        elif mode != "bfloat16" or kind == "dyadic":
            if mode == "float32" and kind == "normal":
                # float32 sums in another order: within an ulp of 4 terms
                np.testing.assert_allclose(g, want[0], rtol=0,
                                           atol=4e-6 * np.abs(arrays[k]
                                                              ).sum(0).max())
            else:
                np.testing.assert_array_equal(g, want[0])
        else:
            assert (np.abs(g - want[0]) <= _bf16_ulp(want[0])).all()


def test_compressed_psum_int8_uses_the_largest_shard_amax():
    arrays = {"a": np.zeros((P, 8), np.float32)}
    arrays["a"][2, 3] = 127.0
    arrays["a"][1, 0] = 1.0
    got = _port_psum(arrays, "int8")["a"]
    want = arrays["a"].sum(0)
    assert torch.equal(got, torch.from_numpy(want))
    zero = _port_psum({"a": np.zeros((P, 4), np.float32)}, "int8")["a"]
    assert torch.equal(zero, torch.zeros(4))


def test_compressed_psum_refuses_an_unknown_mode_and_a_wrong_tree_count():
    mesh = ShardMesh(2, "cpu")
    with pytest.raises(ValueError, match="mode"):
        compressed_psum([{}, {}], mesh, "fp8")
    with pytest.raises(ValueError, match="trees"):
        compressed_psum([{"a": torch.ones(2)}], mesh, "float32")


RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.obs import collectives
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.train.pipeline import pipeline_apply
    L, D, M, B = 8, 16, 6, 3
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((L, D, D)) * D ** -0.5
                          ).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((M, B, D)).astype(np.float32))
    def layer_fn(p, x):
        return torch.tanh(x @ p["w"])
    group = ShardMesh(world, "cpu", backend="process_group")
    with collectives.recording() as log:
        got = pipeline_apply(layer_fn, {"w": w}, xs, group)
    want = pipeline_apply(layer_fn, {"w": w}, xs, ShardMesh(world, "cpu"))
    assert torch.equal(got, want), float((got - want).abs().max())
    sends = [e for e in log if e["kind"] == "send-recv"]
    assert len(sends) == (M if rank < world - 1 else 0), len(sends)
    for kind in ("dyadic", "normal"):
        g = np.random.default_rng(5)
        vals = (g.integers(-64, 65, (world, 40)) / 8.0 if kind == "dyadic"
                else g.standard_normal((world, 40))).astype(np.float32)
        trees = [{"a": torch.from_numpy(vals[i])} for i in range(world)]
        for mode in ("float32", "bfloat16", "int8"):
            mine = compressed_psum(trees[rank], group, mode)["a"]
            emu = compressed_psum(trees, ShardMesh(world, "cpu"),
                                  mode)[0]["a"]
            if mode == "bfloat16" and kind == "normal":
                # gloo adds the bf16 values in bf16, rounding each partial
                # sum: half an ulp of the absolute sum per add
                absum = torch.from_numpy(vals).bfloat16().float().abs().sum(0)
                ulp = 2.0 ** (torch.floor(torch.log2(absum)) - 7)
                assert bool(((mine - emu).abs()
                             <= world / 2 * ulp).all()), mode
            elif mode == "float32" and kind == "normal":
                assert float((mine - emu).abs().max()) <= 1e-5, mode
            else:
                assert torch.equal(mine, emu), (kind, mode)
    dist.destroy_process_group()
    print("OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_and_psum_on_gloo_equal_the_emulated_mesh(world):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"OK {r}" in out, err[-3000:]
