"""The port's quantizers, W4 and W8 bridges, W4A8 and W8A8 matmul twins,
int8-KV attention twins and the packed int4 extend write vs the JAX
package, on the CPU.

Inputs come from numpy generators; the JAX side runs as its own tests run
it (Pallas kernels in interpret mode, jitted XLA where the engine jits).
Tolerances: quantized bytes, int8 values and scales, activation
quantization, `_kv_quantize`, the decode kernels' row and scale writes,
the packed extend write and the W8A8 matmul (exact int32 products, then
the same two fp32 multiplies) are compared bitwise; the W4A8 matmul (fp32
group sums in another order) to rtol 1e-5; the int8 attention outputs to
atol 1e-5 (online vs one-shot softmax in fp32).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.ops.pallas import quant_matmul as jqm
from aurora_tpu.ops.pallas import ragged_attention as jra
from aurora_tpu.serve import engine as jeng
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models.llama import W4Linear, W8Linear
from aurora_tpu_torch.ops.pallas import quant_matmul as tqm
from aurora_tpu_torch.ops.pallas import ragged_attention as tra
from aurora_tpu_torch.serve import engine as teng

MM_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("q", "k", "v", "o", "gate", "up", "down")
CFG = JLlamaConfig(vocab_size=96, hidden_size=256, intermediate_size=384,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def dense():
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(7), CFG,
                                            dtype=jnp.float32))
    model = bridge.llama_from_params(tree, bridge.llama_config_from(CFG),
                                     dtype=torch.float32, device="cpu")
    return tree, model


def _assert_w4_equal(proj, pk, s_w):
    """A port W4Linear holds exactly the bytes/scales of one reference
    flat layer ([G, g/2, N], [G, 1, N])."""
    packed, scale = tqm.w4_from_flat(np.asarray(pk), np.asarray(s_w))
    np.testing.assert_array_equal(_np(proj.packed), _np(packed))
    np.testing.assert_array_equal(_np(proj.scale), _np(scale))


def test_quantize_int4_and_fuse_match_jax(dense):
    tree, model = dense
    jq = jax.device_get(jeng.quantize_weights_int4(dict(tree)))
    tq = teng.quantize_weights_int4(model)
    for l in range(CFG.num_hidden_layers):
        for name in NAMES:
            _assert_w4_equal(getattr(tq.layers[l], name),
                             jq["layers"][name][l],
                             jq["layers"][name + "_scale4"][l])
    # the int8 LM head (_w8): values and per-output-channel scales
    np.testing.assert_array_equal(_np(tq.lm_head.weight), jq["lm_head"].T)
    np.testing.assert_array_equal(_np(tq.lm_head.scale),
                                  jq["lm_head_scale"].reshape(-1))
    # embeddings and norms are shared with the dense model, not copied
    assert tq.embed_tokens is model.embed_tokens
    jf = jax.device_get(jeng.fuse_serving_weights(jq))
    tf = teng.fuse_serving_weights(tq)
    for l in range(CFG.num_hidden_layers):
        for name in ("qkv", "o", "gateup", "down"):
            _assert_w4_equal(getattr(tf.layers[l], name),
                             jf["layers"][name][l],
                             jf["layers"][name + "_scale4"][l])
        assert not hasattr(tf.layers[l], "q")


def test_fuse_dense_matches_jax_and_bridge(dense):
    """fuse_serving_weights on a dense model: the same qkv/gateup streams
    as the reference's, and the bridge carries its fused dense tree."""
    tree, model = dense
    jf = jax.device_get(jeng.fuse_serving_weights(dict(tree)))
    got = bridge.llama_from_params(jf, bridge.llama_config_from(CFG),
                                   dtype=torch.float32, device="cpu")
    want = teng.fuse_serving_weights(copy.deepcopy(model))
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    assert "layers.0.qkv.weight" in got_sd
    for key, val in want_sd.items():
        assert torch.equal(got_sd[key], val), key


@pytest.mark.parametrize("shape", [(64, 48), (512, 40)])
def test_w4_and_w8_small_groups_match_jax(shape):
    """group = min(128, D) (one group of 64 rows) and G = 4, with an
    all-zero output channel (the 1e-12 scale floor)."""
    rng = np.random.default_rng(shape[0])
    w = rng.standard_normal((1,) + shape).astype(np.float32)
    w[0, :, 3] = 0.0
    pk, s4 = jeng._w4(jnp.asarray(w))
    tpk, ts4 = teng._w4(torch.from_numpy(w[0].T.copy()))
    _assert_w4_equal(W4Linear(tpk, ts4), pk[0], s4[0])
    w8, s8 = jeng._w8(jnp.asarray(w[0]))
    tw8, ts8 = teng._w8(torch.from_numpy(w[0].T.copy()))
    np.testing.assert_array_equal(_np(tw8), np.asarray(w8).T)
    np.testing.assert_array_equal(_np(ts8), np.asarray(s8).reshape(-1))


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_bridge_carries_jax_w4_trees_bytewise(dense, layout):
    """The reference's quantized trees (per-name flat; fused and in the
    tile-contiguous decode layout) bridge into byte-identical port
    weights: the same as the port quantizing the dense model itself."""
    tree, model = dense
    jq = jeng.quantize_weights_int4(dict(tree))
    want = teng.quantize_weights_int4(model)
    if layout == "tiled":
        jq = jeng.w4_decode_layout_params(jeng.fuse_serving_weights(jq), CFG)
        assert jq["layers"]["qkv"].ndim == 5         # [L, Nb, Kb, bk, bn]
        want = teng.fuse_serving_weights(want)
    got = bridge.llama_from_params(jax.device_get(jq),
                                   bridge.llama_config_from(CFG),
                                   dtype=torch.float32, device="cpu")
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for key, val in want_sd.items():
        assert got_sd[key].dtype == val.dtype, key
        assert torch.equal(got_sd[key], val), key


def _w4_case(rng, B, K, N):
    """Reference flat W4 weights and activations for one matmul."""
    w = rng.standard_normal((1, K, N)).astype(np.float32) * 0.05
    pk, s_w = jeng._w4(jnp.asarray(w))
    h = rng.standard_normal((B, K)).astype(np.float32)
    h[0, :7] *= 40.0                      # one outlier-heavy token
    packed, scale = tqm.w4_from_flat(np.asarray(pk[0]), np.asarray(s_w[0]))
    return h, pk[0], s_w[0], packed, scale


@pytest.mark.parametrize("K,N", [(256, 512), (512, 1024)])
@pytest.mark.parametrize("B", [1, 4, 9])
def test_w4a8_plain_matches_jax_kernel_and_w4dot(B, K, N):
    rng = np.random.default_rng(B * 1000 + K)
    h, pk, s_w, packed, scale = _w4_case(rng, B, K, N)
    calls = tqm.w4a8_matmul_tiled_plain.calls
    launches = tqm.w4a8_matmul_tiled.launches
    got = tqm.w4a8_matmul_tiled(torch.from_numpy(h), packed, scale)
    assert tqm.w4a8_matmul_tiled_plain.calls == calls + 1
    assert tqm.w4a8_matmul_tiled.launches == launches   # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (B, N)
    pkt, swt = jqm.w4_tile_layout(pk, s_w, block_n=256)
    want = jqm.w4a8_matmul_tiled(jnp.asarray(h), pkt, swt,
                                 out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MM_TOL)
    # the engine's _w4dot at ≤ 64 tokens, both sides (JAX: XLA branch)
    want_dot = jeng._w4dot(jnp.asarray(h), pk, s_w)
    got_dot = teng._w4dot(torch.from_numpy(h), W4Linear(packed, scale))
    np.testing.assert_allclose(_np(got_dot), np.asarray(want_dot), **MM_TOL)


def test_w4dot_above_64_tokens_dequantizes_like_jax():
    """More than _W4_GROUPED_MAX_TOKENS tokens (counted over every leading
    axis): dequantized weights and a dense matmul, no activation
    quantization and no kernel, in both packages."""
    rng = np.random.default_rng(3)
    h, pk, s_w, packed, scale = _w4_case(rng, 80, 256, 512)
    h3 = h.reshape(5, 16, 256)
    calls = tqm.w4a8_matmul_tiled_plain.calls
    got = teng._w4dot(torch.from_numpy(h3), W4Linear(packed, scale))
    assert tqm.w4a8_matmul_tiled_plain.calls == calls
    want = jeng._w4dot(jnp.asarray(h3), pk, s_w)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MM_TOL)
    # the dequantized weights are the reference's (_w4dot's unpack) exactly
    four = jnp.int8(4)
    lo = jax.lax.shift_right_arithmetic(jax.lax.shift_left(pk, four), four)
    hi = jax.lax.shift_right_arithmetic(pk, four)
    G, gh, N = pk.shape
    dense = (jnp.stack([lo, hi], axis=2).reshape(G, 2 * gh, N)
             .astype(jnp.float32) * s_w).reshape(2 * G * gh, N)
    np.testing.assert_array_equal(
        _np(tqm.w4_dequantize(packed, scale, torch.float32)),
        np.asarray(dense).T)


def test_activation_quantization_and_int8_head_match_jax():
    """quantize_activations as the engine runs it (jitted) and the W8A8
    LM head: int8 values, scales and logits bitwise."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    x[2] = 0.0                                   # the 1e-12 floor
    h8, s_a = jax.jit(jqm.quantize_activations)(jnp.asarray(x))
    th8, ts_a = tqm.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(th8), np.asarray(h8))
    np.testing.assert_array_equal(_np(ts_a), np.asarray(s_a))
    w = rng.standard_normal((256, 96)).astype(np.float32)
    w8, s8 = jeng._w8(jnp.asarray(w))
    params = {"lm_head": w8, "lm_head_scale": s8}
    want = jax.jit(lambda p, v: jeng._lm_head(p, CFG, v))(params,
                                                         jnp.asarray(x))

    class Head:
        lm_head = teng.W8Linear(*teng._w8(torch.from_numpy(w.T.copy())))

    got = teng._lm_head(Head, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_kv_quantize_matches_jax_bitwise():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 4, 64)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                             # the 1e-8 floor
    x[1, 2, 3, 5] = 250.0
    for maxq in (127.0, 7.0):
        want_q, want_s = jax.jit(jeng._kv_quantize, static_argnums=1)(
            jnp.asarray(x), maxq)
        got_q, got_s = tra.kv_quantize(torch.from_numpy(x), maxq)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(_np(got_q), np.asarray(want_q))
        np.testing.assert_array_equal(_np(got_s), np.asarray(want_s))


L, B, S, HD = 2, 4, 256, 64


def _int8_rows(rng, hkv):
    """int8 rows on the _kv_quantize grid with their scales."""
    k, ks = jeng._kv_quantize(jnp.asarray(
        rng.standard_normal((L, B, hkv, S, HD)).astype(np.float32)))
    v, vs = jeng._kv_quantize(jnp.asarray(
        rng.standard_normal((L, B, hkv, S, HD)).astype(np.float32)))
    return [np.array(a) for a in (k, v, ks, vs)]


@pytest.mark.parametrize("G", [1, 4])
def test_int8_extend_plain_matches_jax(G):
    rng = np.random.default_rng(30 + G)
    hkv, T = 2, 24
    k, v, ks, vs = _int8_rows(rng, hkv)
    q = rng.standard_normal((4, T, hkv * G, HD)).astype(np.float32)
    offs = np.array([0, 100, 7, 0], np.int32)
    lens = np.array([T, 100 + T, 7 + T - 5, 0], np.int32)   # lane 3 padded
    rows = np.array([2, 0, 3, 1], np.int32)
    want = jra.ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jnp.asarray(offs), jnp.asarray(rows), layer=1, chunk=128,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    launches = tra.ragged_attention.launches_int8
    got = tra.ragged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lens, offs, rows, layer=1, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    assert tra.ragged_attention.launches_int8 == launches
    np.testing.assert_allclose(_np(got)[:3], np.asarray(want)[:3],
                               **ATTN_TOL)
    np.testing.assert_array_equal(_np(got)[3], 0.0)


@pytest.mark.parametrize("G", [1, 4])
def test_int8_decode_plain_matches_jax(G):
    rng = np.random.default_rng(40 + G)
    hkv = 2
    k, v, ks, vs = _int8_rows(rng, hkv)
    q = rng.standard_normal((B, 1, hkv * G, HD)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    v_new[3, 1] = 0.0                            # all-zero token: 1e-8 floor
    lens = np.array([5, 130, 0, 256], np.int32)  # lane 2 inactive
    rows = np.array([1, 3, 0, 2], np.int32)
    w_out, w_k, w_v, w_ks, w_vs = jra.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), jnp.asarray(rows),
        layer=1, chunk=128, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k, v, ks, vs))
    res = tra.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, lens, rows, layer=1, k_scales=tks, v_scales=tvs)
    assert len(res) == 5 and all(a is b for a, b in zip(res[1:],
                                                         (tk, tv, tks, tvs)))
    for got, want in ((tk, w_k), (tv, w_v), (tks, w_ks), (tvs, w_vs)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_allclose(_np(res[0])[[0, 1, 3]],
                               np.asarray(w_out)[[0, 1, 3]], **ATTN_TOL)
    np.testing.assert_array_equal(_np(res[0])[2], 0.0)


def test_int8_kv_bytes_per_token_layer_matches_jax():
    jc = JLlamaConfig.vicuna_7b_v15_16k()
    tc = bridge.llama_config_from(jc)
    for quant, jdt, tdt in (("int8", jnp.bfloat16, torch.bfloat16),
                            ("none", jnp.bfloat16, torch.bfloat16),
                            ("none", jnp.float32, torch.float32)):
        assert teng.kv_bytes_per_token_layer(tc, quant, tdt) == \
            jeng.kv_bytes_per_token_layer(jc, quant, jdt)


# --- W8 weights ------------------------------------------------------------

def test_quantize_int8_and_fuse_match_jax(dense):
    tree, model = dense
    jq = jax.device_get(jeng.quantize_weights_int8(dict(tree)))
    tq = teng.quantize_weights_int8(model)
    assert teng.weight_quant_of(tq) == "int8"
    for l in range(CFG.num_hidden_layers):
        for name in NAMES:
            proj = getattr(tq.layers[l], name)
            assert isinstance(proj, W8Linear)
            np.testing.assert_array_equal(_np(proj.weight),
                                          jq["layers"][name][l].T)
            np.testing.assert_array_equal(
                _np(proj.scale), jq["layers"][name + "_scale"][l].reshape(-1))
    np.testing.assert_array_equal(_np(tq.lm_head.weight), jq["lm_head"].T)
    np.testing.assert_array_equal(_np(tq.lm_head.scale),
                                  jq["lm_head_scale"].reshape(-1))
    assert tq.embed_tokens is model.embed_tokens
    jf = jax.device_get(jeng.fuse_serving_weights(jq))
    tf = teng.fuse_serving_weights(tq)
    for l in range(CFG.num_hidden_layers):
        for name in ("qkv", "o", "gateup", "down"):
            proj = getattr(tf.layers[l], name)
            np.testing.assert_array_equal(_np(proj.weight),
                                          jf["layers"][name][l].T)
            np.testing.assert_array_equal(
                _np(proj.scale), jf["layers"][name + "_scale"][l].reshape(-1))


@pytest.mark.parametrize("fused", [False, True])
def test_bridge_carries_jax_w8_trees_bytewise(dense, fused):
    """The reference's W8 trees (per-name and fused) bridge into the
    bytes and scales of the port quantizing the dense model itself."""
    tree, model = dense
    jq = jeng.quantize_weights_int8(dict(tree))
    want = teng.quantize_weights_int8(model)
    if fused:
        jq = jeng.fuse_serving_weights(jq)
        want = teng.fuse_serving_weights(want)
    assert bridge.llama_layout(jq) == ("int8", fused)
    got = bridge.llama_from_params(jax.device_get(jq),
                                   bridge.llama_config_from(CFG),
                                   dtype=torch.float32, device="cpu")
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for key, val in want_sd.items():
        assert got_sd[key].dtype == val.dtype, key
        assert torch.equal(got_sd[key], val), key


def _w8_case(rng, B, K, N):
    """A reference W8 weight ([K, N] int8, [1, N] scales) and activations,
    with an outlier-heavy token and an all-zero output channel."""
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    w[:, 5] = 0.0
    w8, s_w = jeng._w8(jnp.asarray(w))
    h = rng.standard_normal((B, K)).astype(np.float32)
    h[0, :7] *= 40.0
    lin = W8Linear(torch.from_numpy(np.array(w8).T.copy()),
                   torch.from_numpy(np.array(s_w).reshape(-1)))
    return h, w8, s_w, lin


@pytest.mark.parametrize("B,K,N", [(1, 256, 512), (4, 512, 768),
                                   (9, 384, 256)])
def test_w8a8_plain_matches_jax_kernel_bitwise(B, K, N):
    rng = np.random.default_rng(B * 100 + K)
    h, w8, s_w, lin = _w8_case(rng, B, K, N)
    h8, s_a = jax.jit(jqm.quantize_activations)(jnp.asarray(h))
    th8, ts_a = (torch.from_numpy(np.array(a)) for a in (h8, s_a))
    calls = tqm.w8a8_matmul_plain.calls
    launches = tqm.w8a8_matmul.launches
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jqm.w8a8_matmul(h8, s_a, w8, s_w, out_dtype=jdt,
                               interpret=True)
        got = tqm.w8a8_matmul(th8, ts_a, lin.weight, lin.scale,
                              out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (B, N)
        np.testing.assert_array_equal(_np(got.float()),
                                      np.asarray(want.astype(jnp.float32)))
    assert tqm.w8a8_matmul_plain.calls == calls + 2
    assert tqm.w8a8_matmul.launches == launches          # CPU: no launch


@pytest.mark.parametrize("shape", [(3, 5), (5, 16)])
def test_w8dot_both_branches_match_jax_wdot_bitwise(shape):
    """The engine's `_w8dot` at ≤ 64 tokens (the W8A8 kernel's twin) and
    above (torch._int_mm) vs the reference's jitted int8 `_wdot`."""
    rng = np.random.default_rng(shape[1])
    h, w8, s_w, lin = _w8_case(rng, shape[0] * shape[1], 256, 512)
    h3 = h.reshape(*shape, 256)
    calls = tqm.w8a8_matmul_plain.calls
    want = jax.jit(lambda x, lp: jeng._wdot(x, lp, "o"))(
        jnp.asarray(h3), {"o": w8, "o_scale": s_w})
    got = teng._w8dot(torch.from_numpy(h3), lin)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    kernel_branch = shape[0] * shape[1] <= teng._W4_GROUPED_MAX_TOKENS
    assert tqm.w8a8_matmul_plain.calls == calls + int(kernel_branch)


# --- packed int4 KV: the extend write --------------------------------------

def test_packed_extend_write_matches_jax_bytewise():
    """Two waves through `_write_kv_window` with packed rows vs the
    reference's _write_kv_window_packed from the same random rows. Wave
    1: lane 0 writes tokens 0-199 (both nibbles of bytes 0-71 in one
    wave), lane 1 tokens 100-149 (the high nibbles of bytes 0-21 beside
    untouched low ones), lane 2 tokens 300-511 (bucket padding past the
    row), lane 3 is padding. Wave 2: lane 0 writes tokens 200-259, beside
    the low nibbles wave 1 wrote, and into the second segment."""
    rng = np.random.default_rng(80)
    Lw, Bw, hkv, S, hd, l = 2, 4, 2, 512, 16, 1
    r = {"k": rng.integers(-128, 128, (Lw, Bw, hkv, S // 2, hd)),
         "v": rng.integers(-128, 128, (Lw, Bw, hkv, S // 2, hd))}
    r = {n: a.astype(np.int8) for n, a in r.items()}
    for n in ("ks", "vs"):
        r[n] = rng.random((Lw, Bw, hkv, S)).astype(np.float32)
    trows = {n: torch.from_numpy(a.copy()) for n, a in r.items()}
    jrows = {n: jnp.asarray(a) for n, a in r.items()}
    waves = [(256, [2, 0, 3, 1], [0, 100, 300, 0], [200, 150, 556, 0]),
             (64, [2], [200], [260])]
    for T, rows, offs, lens in waves:
        Bk = len(rows)
        kf = rng.standard_normal((Bk, T, hkv, hd)).astype(np.float32)
        vf = rng.standard_normal((Bk, T, hkv, hd)).astype(np.float32)
        quant = jax.jit(jeng._kv_quantize, static_argnums=1)
        (k4, ks), (v4, vs) = quant(jnp.asarray(kf), 7.0), quant(
            jnp.asarray(vf), 7.0)
        ids = [jnp.asarray(np.array(x, np.int32)) for x in (rows, offs,
                                                           lens)]
        jrows = jeng._write_kv_window_packed(jrows, l, k4, v4, (ks, vs),
                                             *ids)
        widx = teng._kv_write_index(rows, offs, lens, T, S, "cpu",
                                    pack=True)
        teng._write_kv_window(trows, l, *(torch.from_numpy(np.array(a))
                                          for a in (k4, v4)), widx,
                              tuple(torch.from_numpy(np.array(a))
                                    for a in (ks, vs)))
        # each touched byte is planned once
        key = widx.byte_row * (S // 2) + widx.byte_pos
        assert len(torch.unique(key)) == len(key)
    for n in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(_np(trows[n]), np.asarray(jrows[n]))
    assert not np.array_equal(_np(trows["k"]), r["k"])
