"""The LM building blocks, function by function: ``models/layers.py``,
``attention.py``, ``mla.py`` and ``moe.py`` of the JAX package and of the
port (``device="cpu"``) on the same float32 inputs and weights, made from a
numpy seed.  Bar: max |port - reference| <= 1e-5 · max |reference| (float32
sums in another order), unless a case says otherwise."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mla as JM
from repro.models import moe as JO
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mla as TM
from repro_torch.models import moe as TO

REL = 1e-5


def close(got, want, rel=REL):
    got = got.detach().float().numpy() if hasattr(got, "detach") \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def jitted(fn, **static):
    """The reference's function compiled once, its keyword arguments
    static (eager JAX compiles op by op)."""
    return jax.jit(functools.partial(fn, **static))


def weights(rng, **shapes):
    """Standard-normal float32 weights scaled by 1/sqrt(fan-in)."""
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def both(w):
    """The same weights as the reference's params dict and the port's
    ``Params`` (nested dicts become sub-groups)."""
    def to_j(d):
        return {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in d.items()}

    def to_t(d):
        return TL.Params(**{k: to_t(v) if isinstance(v, dict)
                            else torch.from_numpy(v.copy())
                            for k, v in d.items()})
    return to_j(w), to_t(w)


def arr(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    xj, xt = arr(rng, 3, 5, 32, scale=3.0)
    sj, st = arr(rng, 32)
    close(TL.rms_norm(xt, st, offset=offset),
          JL.rms_norm(xj, sj, offset=offset))


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm(with_bias):
    rng = np.random.default_rng(1)
    xj, xt = arr(rng, 4, 48, scale=2.0)
    sj, st = arr(rng, 48)
    bj, bt = arr(rng, 48) if with_bias else (None, None)
    close(TL.layer_norm(xt, st, bt), JL.layer_norm(xj, sj, bj))


def test_rope_freqs_and_split_halves_rotation():
    close(TL.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6))
    rng = np.random.default_rng(2)
    xj, xt = arr(rng, 2, 7, 3, 16)
    pos = np.array([0, 1, 2, 5, 9, 100, 4095])
    close(TL.apply_rope(xt, torch.from_numpy(pos), 1e4),
          JL.apply_rope(xj, jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gated_mlp(activation):
    rng = np.random.default_rng(3)
    pj, pt = both(weights(rng, wi_gate=(32, 64), wi_up=(32, 64),
                          wo=(64, 32)))
    xj, xt = arr(rng, 2, 5, 32)
    close(TL.mlp(pt, xt, activation), JL.mlp(pj, xj, activation))


def test_cross_entropy_loss_masks_negative_labels():
    rng = np.random.default_rng(4)
    lj, lt = arr(rng, 2, 6, 40, scale=4.0)
    labels = rng.integers(0, 40, (2, 6))
    labels[0, :2] = -100
    close(TL.cross_entropy_loss(lt, torch.from_numpy(labels)),
          JL.cross_entropy_loss(lj, jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# attention.py
# ---------------------------------------------------------------------------

D, H, KH, HD = 32, 4, 2, 8


def attn_weights(rng, bias=False, qk_norm=False):
    w = weights(rng, wq=(D, H * HD), wk=(D, KH * HD), wv=(D, KH * HD),
                wo=(H * HD, D))
    if bias:
        w.update({k: (rng.standard_normal(n) * 0.1).astype(np.float32)
                  for k, n in (("bq", H * HD), ("bk", KH * HD),
                               ("bv", KH * HD))})
    if qk_norm:
        w.update({k: (1 + 0.1 * rng.standard_normal(HD)).astype(np.float32)
                  for k in ("q_norm", "k_norm")})
    return both(w)


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False),
                                          (False, True)])
def test_qkv(bias, qk_norm):
    rng = np.random.default_rng(5)
    pj, pt = attn_weights(rng, bias, qk_norm)
    xj, xt = arr(rng, 2, 6, D)
    pos = np.arange(3, 9)
    got = TA.qkv(pt, xt, H, KH, HD, torch.from_numpy(pos), 1e4, qk_norm)
    want = jitted(JA.qkv, n_heads=H, n_kv=KH, head_dim=HD, rope_theta=1e4,
                  qk_norm=qk_norm)(pj, xj, positions=jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("window,kv_chunk", [(None, None), (5, None),
                                             (None, 8), (5, 8), (None, 32)])
def test_attention_full_window_and_chunked(window, kv_chunk):
    """sk = 32: kv_chunk 8 takes the online-softmax branch (4 chunks);
    kv_chunk 32 (sk <= kv_chunk) the one-pass branch."""
    rng = np.random.default_rng(6)
    qj, qt = arr(rng, 2, 32, H, HD)
    kj, kt = arr(rng, 2, 32, KH, HD)
    vj, vt = arr(rng, 2, 32, KH, HD)
    pos = np.arange(32)
    got = TA.attention(qt, kt, vt, torch.from_numpy(pos),
                       torch.from_numpy(pos), window=window,
                       kv_chunk=kv_chunk)
    want = jitted(JA.attention, window=window, kv_chunk=kv_chunk)(
        qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos))
    close(got, want)


def test_chunked_attention_refuses_a_chunk_that_does_not_divide():
    rng = np.random.default_rng(7)
    _, qt = arr(rng, 1, 12, H, HD)
    _, kt = arr(rng, 1, 12, KH, HD)
    pos = torch.arange(12)
    with pytest.raises(AssertionError, match="divide"):
        TA.attention(qt, kt, kt, pos, pos, kv_chunk=5)


def test_attention_bf16_scores_in_fp32():
    """bf16 q/k/v: the scores are fp32 contractions of the bf16 values,
    the weights are rounded to bf16 before the product with v."""
    rng = np.random.default_rng(8)
    qj, qt = arr(rng, 1, 16, H, HD)
    kj, kt = arr(rng, 1, 16, KH, HD)
    vj, vt = arr(rng, 1, 16, KH, HD)
    pos = np.arange(16)
    got = TA.attention(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                       torch.from_numpy(pos), torch.from_numpy(pos))
    want = JA.attention(qj.astype(jnp.bfloat16), kj.astype(jnp.bfloat16),
                        vj.astype(jnp.bfloat16), jnp.asarray(pos),
                        jnp.asarray(pos))
    assert got.dtype == torch.bfloat16
    close(got, want, rel=2e-2)


def test_attn_forward():
    rng = np.random.default_rng(9)
    pj, pt = attn_weights(rng, qk_norm=True)
    xj, xt = arr(rng, 2, 10, D)
    pos = np.arange(10)
    kw = dict(n_heads=H, n_kv=KH, head_dim=HD, rope_theta=1e6, qk_norm=True,
              window=4)
    yt, (kt, vt) = TA.attn_forward(pt, xt, torch.from_numpy(pos), **kw)
    yj, (kj, vj) = jitted(JA.attn_forward, **kw)(pj, xj, jnp.asarray(pos))
    for g, w in ((yt, yj), (kt, kj), (vt, vj)):
        close(g, w)


def _linear_cache(rng, b=2, t=12, fill=7):
    """A cache of t positions holding ``fill`` tokens of random K/V."""
    k = np.zeros((b, t, KH, HD), np.float32)
    v = np.zeros((b, t, KH, HD), np.float32)
    k[:, :fill] = rng.standard_normal((b, fill, KH, HD))
    v[:, :fill] = rng.standard_normal((b, fill, KH, HD))
    return k, v


@pytest.mark.parametrize("window", [None, 4])
def test_attn_decode(window):
    rng = np.random.default_rng(10)
    pj, pt = attn_weights(rng, bias=True)
    k, v = _linear_cache(rng)
    xj, xt = arr(rng, 2, 1, D)
    kw = dict(n_heads=H, n_kv=KH, head_dim=HD, window=window)
    yj, cj = jitted(JA.attn_decode, **kw)(
        pj, xj, JA.KVCache(jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(7, jnp.int32)))
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    yt, ct = TA.attn_decode(pt, xt, TA.KVCache(kt, vt, 7), **kw)
    close(yt, yj)
    close(ct.k, cj.k)
    close(ct.v, cj.v)
    assert ct.k is kt and int(ct.length) == int(cj.length) == 8


def test_ring_positions():
    for length, t in ((11, 8), (2, 8), (0, 4), (37, 6)):
        got = TA.ring_positions(length, t).numpy()
        want = np.asarray(JA.ring_positions(jnp.asarray(length, jnp.int32),
                                            t))
        np.testing.assert_array_equal(got, want)


def test_ring_decode_matches_reference_and_window_attention():
    """Token-by-token ring decode with a buffer of exactly the window:
    equal to the reference's ring decode at every step, and to full
    sliding-window attention over the sequence (the reference's own
    2e-4 bar for the latter)."""
    rng = np.random.default_rng(11)
    pj, pt = attn_weights(rng)
    xj, xt = arr(rng, 1, 20, D)
    window = 6
    kw = dict(n_heads=H, n_kv=KH, head_dim=HD, window=window)
    pos = torch.arange(20)
    y_full, _ = TA.attn_forward(pt, xt, pos, **kw)
    kj = vj = jnp.zeros((1, window, KH, HD), jnp.float32)
    kt = torch.zeros((1, window, KH, HD))
    vt = torch.zeros((1, window, KH, HD))
    ring = jitted(JA.attn_decode_ring, **kw)
    for t in range(20):
        yj, kj, vj = ring(pj, xj[:, t:t + 1], kj, vj, jnp.asarray(t))
        yt, kt, vt = TA.attn_decode_ring(pt, xt[:, t:t + 1], kt, vt, t, **kw)
        close(yt, yj)
        close(kt, kj)
        close(vt, vj)
        np.testing.assert_allclose(yt[0, 0].numpy(), y_full[0, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_quantize_dequantize_kv():
    rng = np.random.default_rng(12)
    kj, kt = arr(rng, 2, 5, KH, 16, scale=3.0)
    kt[0, 0, 0] = 0.0                 # an all-zero row takes scale 1
    kj = kj.at[0, 0, 0].set(0.0)
    qt, st = TA.quantize_kv(kt)
    qj, sj = JA.quantize_kv(kj)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj, np.float32))
    close(TA.dequantize_kv(qt, st, torch.float32),
          JA.dequantize_kv(qj, sj, jnp.float32))
    back = TA.dequantize_kv(qt, st, torch.float32)
    assert float((back - kt).abs().max()) <= float(kt.abs().max()) / 100


def test_attn_decode_quant():
    rng = np.random.default_rng(13)
    pj, pt = attn_weights(rng, qk_norm=True)
    k, v = _linear_cache(rng)
    kq, ks = JA.quantize_kv(jnp.asarray(k))
    vq, vs = JA.quantize_kv(jnp.asarray(v))
    xj, xt = arr(rng, 2, 1, D)
    kw = dict(n_heads=H, n_kv=KH, head_dim=HD, qk_norm=True)
    yj, cj = jitted(JA.attn_decode_quant, **kw)(
        pj, xj, kq, vq, ks, vs, jnp.asarray(7, jnp.int32))

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(a.copy())
    yt, ct = TA.attn_decode_quant(pt, xt, t(kq), t(vq), t(ks), t(vs), 7,
                                  **kw)
    close(yt, yj)
    for g, w in zip(ct, cj):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_decode_at_a_full_cache_reference_clamps_port_raises():
    """The JAX package's dynamic_update_slice clamps a start past the end:
    a decode at length == max_len overwrites the last slot and returns.
    The port refuses it (ROADMAP C30)."""
    rng = np.random.default_rng(14)
    pj, pt = attn_weights(rng)
    t = 6
    k, v = _linear_cache(rng, t=t, fill=t)
    xj, xt = arr(rng, 2, 1, D)
    kw = dict(n_heads=H, n_kv=KH, head_dim=HD)
    _, cj = jitted(JA.attn_decode, **kw)(
        pj, xj, JA.KVCache(jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(t, jnp.int32)))
    assert not np.array_equal(np.asarray(cj.k[:, t - 1]), k[:, t - 1])
    np.testing.assert_array_equal(np.asarray(cj.k[:, :t - 1]), k[:, :t - 1])
    with pytest.raises(ValueError, match="does not fit"):
        TA.attn_decode(pt, xt, TA.KVCache(torch.from_numpy(k.copy()),
                                          torch.from_numpy(v.copy()), t),
                       **kw)
    (kq, ks), (vq, vs) = (TA.quantize_kv(torch.from_numpy(a))
                          for a in (k, v))
    with pytest.raises(ValueError, match="does not fit"):
        TA.attn_decode_quant(pt, xt, kq, vq, ks, vs, t, **kw)


# ---------------------------------------------------------------------------
# mla.py
# ---------------------------------------------------------------------------

MH, R, NOPE, ROPE, VD = 4, 16, 8, 4, 8


def mla_weights(rng):
    w = {"w_dkv": (rng.standard_normal((D, R + ROPE)) / np.sqrt(D)),
         "ckv_norm": 1 + 0.1 * rng.standard_normal(R),
         "w_uk": rng.standard_normal((R, MH, NOPE)) / np.sqrt(R),
         "w_uv": rng.standard_normal((R, MH, VD)) / np.sqrt(R),
         "w_q": rng.standard_normal((D, MH, NOPE + ROPE)) / np.sqrt(D),
         "w_o": rng.standard_normal((MH, VD, D)) / np.sqrt(MH * VD)}
    return both({k: v.astype(np.float32) for k, v in w.items()})


MLA_KW = dict(n_heads=MH, kv_lora=R, nope_dim=NOPE, rope_dim=ROPE, v_dim=VD,
              rope_theta=1e4)


def test_mla_latents():
    rng = np.random.default_rng(15)
    pj, pt = mla_weights(rng)
    xj, xt = arr(rng, 2, 5, D)
    pos = np.arange(5)
    for g, w in zip(TM._latents(pt, xt, torch.from_numpy(pos), R, 1e4),
                    jitted(JM._latents, kv_lora=R, rope_theta=1e4)(
                        pj, xj, jnp.asarray(pos))):
        close(g, w)


@pytest.mark.parametrize("kv_chunk", [None, 4])
def test_mla_forward(kv_chunk):
    rng = np.random.default_rng(16)
    pj, pt = mla_weights(rng)
    xj, xt = arr(rng, 2, 12, D)
    pos = np.arange(12)
    yt, (ct, rt) = TM.mla_forward(pt, xt, torch.from_numpy(pos),
                                  kv_chunk=kv_chunk, **MLA_KW)
    yj, (cj, rj) = jitted(JM.mla_forward, kv_chunk=kv_chunk, **MLA_KW)(
        pj, xj, jnp.asarray(pos))
    for g, w in ((yt, yj), (ct, cj), (rt, rj)):
        close(g, w)


def test_mla_decode_absorbed():
    """Absorbed decode against the reference, and against the materialized
    forward on the extended sequence (same math, other contraction)."""
    rng = np.random.default_rng(17)
    pj, pt = mla_weights(rng)
    xj, xt = arr(rng, 2, 9, D)
    t = 12
    pos = torch.arange(8)
    _, (c8, r8) = TM.mla_forward(pt, xt[:, :8], pos, **MLA_KW)
    ckv = torch.zeros((2, t, R))
    kr = torch.zeros((2, t, ROPE))
    ckv[:, :8], kr[:, :8] = c8, r8
    cache_j = JM.MLACache(jnp.asarray(ckv.numpy()), jnp.asarray(kr.numpy()),
                          jnp.asarray(8, jnp.int32))
    yj, cj = jitted(JM.mla_decode, **MLA_KW)(pj, xj[:, 8:9], cache_j)
    yt, ct = TM.mla_decode(pt, xt[:, 8:9], TM.MLACache(ckv, kr, 8), **MLA_KW)
    close(yt, yj)
    close(ct.c_kv, cj.c_kv)
    close(ct.k_rope, cj.k_rope)
    assert int(ct.length) == 9
    y_full, _ = TM.mla_forward(pt, xt, torch.arange(9), **MLA_KW)
    close(yt[:, 0], y_full[:, 8], rel=1e-4)


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------

E, K, FF = 8, 2, 24


def moe_weights(rng, shared=True):
    w = {"router": (rng.standard_normal((D, E)) / np.sqrt(D)),
         "w_gate": rng.standard_normal((E, D, FF)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, FF)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, FF, D)) / np.sqrt(FF)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    if shared:
        w["shared"] = weights(rng, wi_gate=(D, 48), wi_up=(D, 48),
                              wo=(48, D))
    return both(w)


def _moe_case(fn_t, fn_j, capacity_factor, b, s, shared, seed):
    rng = np.random.default_rng(seed)
    pj, pt = moe_weights(rng, shared)
    xj, xt = arr(rng, b, s, D)
    kw = dict(num_experts=E, top_k=K, capacity_factor=capacity_factor)
    yt, at = fn_t(pt, xt, **kw)
    yj, aj = jitted(fn_j, **kw)(pj, xj)
    close(yt, yj)
    for name in ("load_balance_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(at[name]), float(aj[name]),
                                   rtol=1e-6, atol=1e-7)
    return float(aj["dropped_fraction"])


@pytest.mark.parametrize("capacity_factor,shared,drops", [
    (E / K, True, False), (1.0, True, True), (0.5, False, True)])
def test_moe_forward_with_and_without_drops(capacity_factor, shared, drops):
    dropped = _moe_case(TO.moe_forward, JO.moe_forward, capacity_factor,
                        b=2, s=12, shared=shared, seed=18)
    assert (dropped > 0) == drops


@pytest.mark.parametrize("capacity_factor,b,drops", [
    (E / K, 6, False), (1.0, 6, True), (0.75, 32, True)])
def test_moe_forward_hierarchical(capacity_factor, b, drops):
    """Groups: b = 6 -> 6 groups of one sequence; b = 32 -> 16 groups of
    two (DISPATCH_GROUPS); capacity per group."""
    dropped = _moe_case(TO.moe_forward_hierarchical,
                        JO.moe_forward_hierarchical, capacity_factor,
                        b=b, s=4, shared=True, seed=19)
    assert (dropped > 0) == drops


def test_moe_bf16_within_2e2():
    rng = np.random.default_rng(20)
    pj, pt = moe_weights(rng)
    bf16 = jnp.bfloat16
    pj = {**{k: pj[k].astype(bf16) for k in ("w_gate", "w_up", "w_down")},
          "router": pj["router"],
          "shared": {k: a.astype(bf16) for k, a in pj["shared"].items()}}
    for group in (pt, pt["shared"]):
        for name, w in group.named_parameters(recurse=False):
            if name != "router":
                w.data = w.data.bfloat16()
    xj, xt = arr(rng, 2, 8, D)
    kw = dict(num_experts=E, top_k=K, capacity_factor=E / K)
    yt, _ = TO.moe_forward(pt, xt.bfloat16(), **kw)
    yj, _ = jitted(JO.moe_forward, **kw)(pj, xj.astype(jnp.bfloat16))
    assert yt.dtype == torch.bfloat16
    close(yt, yj, rel=2e-2)
