"""The port's two further W4 decode layouts vs the JAX package, on the CPU:
the reference's flat layout (`EngineConfig(w4_tiled=False)`, its
AURORA_W4_TILED=0) with `w4a8_matmul` and `w4a16_matmul`, and the
fused MLP (`EngineConfig(w4_fused_mlp=True)`, its AURORA_W4_FUSED_MLP=1)
with `fused_mlp_w4`.

Inputs come from numpy generators; the JAX kernels run in interpret mode,
as tests/test_quant_matmul.py and tests/test_fused_mlp_w4.py run them.
Tolerances: layouts and bridged bytes bitwise; the W4A8 twin (exact int32
group partials, fp32 group sums in another order), the W4A16 twin (exact
products, fp32 sums in another order) and the fused MLP twin in fp32 (the
reference's interpret-mode numerics) to rtol 1e-5, the last two with an
atol of 1e-6 of the output's max |value| (the fp32 sums' rounding scales
with the summed magnitudes, not with each output: a W4A16 output near 0
read 7.6e-6 off, 3e-8 of the max); the engines under the near-tie
contract of tests/test_torch_engine_quant.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.ops.pallas import quant_matmul as jqm
from aurora_tpu.serve import engine as jeng
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models.llama import W4FusedMLP, W4Linear
from aurora_tpu_torch.ops.pallas import quant_matmul as tqm
from aurora_tpu_torch.serve import engine as teng
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import (BUCKETS, CONFIGS, W4KV8,
                                     assert_near_tie_parity)
from utils import drain_engine

MM_TOL = dict(rtol=1e-5, atol=1e-6)
D, GROUP = 256, 128


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _flat(rng, K, N, scale=0.05):
    """A random [K → N] weight quantized by the reference's _w4, one
    layer of its flat layout ([G, g/2, N], [G, 1, N]) as numpy."""
    w = jnp.asarray(rng.standard_normal((1, K, N)) * scale, jnp.float32)
    pk, s = jeng._w4(w, group=min(GROUP, K))
    return np.array(pk[0]), np.array(s[0])


def _h(rng, B, K):
    h = rng.standard_normal((B, K)).astype(np.float32)
    h[0, :7] *= 40.0                      # one outlier-heavy token
    return h


@pytest.mark.parametrize("K,N", [(256, 512), (384, 768)])
def test_flat_and_stripe_layouts_convert_bytewise(K, N):
    rng = np.random.default_rng(K)
    pk, s = map(np.array, _flat(rng, K, N))
    packed, scale = tqm.w4_from_flat(pk, s)
    assert packed.shape == (N, K // 2) and scale.shape == (N, K // GROUP)
    back_pk, back_s = tqm.w4_to_flat(packed, scale)
    assert np.array_equal(_np(back_pk), pk) and np.array_equal(_np(back_s), s)
    # both layouts dequantize to the same dense weights
    np.testing.assert_array_equal(
        _np(tqm.w4_flat_dequantize(back_pk, back_s, torch.float32)),
        _np(tqm.w4_dequantize(packed, scale, torch.float32)).T)


@pytest.mark.parametrize("B", [1, 3, 8, 33])
def test_w4a8_flat_plain_matches_jax_kernel(B):
    rng = np.random.default_rng(B)
    pk, s = _flat(rng, D, 512)
    h = _h(rng, B, D)
    calls, launches = tqm.w4a8_matmul_plain.calls, tqm.w4a8_matmul.launches
    got = tqm.w4a8_matmul(torch.from_numpy(h), torch.from_numpy(pk),
                          torch.from_numpy(s))
    assert tqm.w4a8_matmul_plain.calls == calls + 1
    assert tqm.w4a8_matmul.launches == launches          # CPU: no launch
    want = jqm.w4a8_matmul(jnp.asarray(h), pk, s, block_n=256,
                           out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MM_TOL)
    # the engine's _w4dot on a flat module, both sides (JAX: XLA branch)
    got_dot = teng._w4dot(torch.from_numpy(h),
                          W4Linear(torch.from_numpy(pk), torch.from_numpy(s)))
    np.testing.assert_allclose(_np(got_dot),
                               np.asarray(jeng._w4dot(jnp.asarray(h), pk, s)),
                               **MM_TOL)


# ---- the flat W4A8 kernel's fragment map (csrc/weight_stream.cuh
# `A8Warp` with FLAT, csrc/w4a8_matmul.cu), emulated in numpy: the
# byte addresses of the 128-byte swizzle, the 4 x 4 byte transposes,
# the int8 mma m16n8k32 fragments and the channel / token maps that
# `flush` and `each` use


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm (selectors 0-7) on uint32 arrays."""
    b = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x,
                                                                 np.uint64)
    sel = np.broadcast_to(np.asarray(sel, np.uint64), b.shape)
    out = np.zeros(b.shape, np.uint64)
    for i in range(4):
        idx = (sel >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((b >> (np.uint64(8) * idx)) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def _swz128(r, chunk):
    return r * 128 + ((chunk ^ (r & 7)) * 16)


def _word(mem, off, nbytes=4):
    """Little-endian words of nbytes at byte offsets off [lanes] of a
    shared-memory image → [lanes, nbytes // 4] uint32."""
    idx = np.asarray(off)[:, None] + np.arange(nbytes)
    b = mem[idx].astype(np.uint32).reshape(len(off), nbytes // 4, 4)
    return (b << (np.arange(4, dtype=np.uint32) * 8)).sum(-1,
                                                          dtype=np.uint32)


def _bytes(w):
    """uint32 words [...] → their 4 bytes as signed int8 [..., 4]."""
    return ((np.asarray(w, np.uint32)[..., None]
             >> (np.arange(4, dtype=np.uint32) * 8)) & 0xFF
            ).astype(np.uint8).view(np.int8)


def _flat_kernel_partials(pk, he, ho, B):
    """16 x the int32 group partials [B, G, N] as the flat W4A8 kernel
    forms them: per column tile of 128 and stage of 256 k, the weight box
    and the plane boxes in their swizzled shared-memory places, then
    every consumer warp's units of its groups, mma by mma."""
    G, gh, N = pk.shape
    K2 = G * gh
    group = 2 * gh
    TT = 1 if B <= 8 else 2 if B <= 16 else 4 if B <= 32 else 8
    MT = 4 if TT == 1 else 2
    TW = 2 if TT == 8 else 1
    TPW, CW = TT // TW, 128 // (16 * MT)
    KW = 8 // (CW * TW)
    NW = 4 if group % 128 == 0 else 1
    flat = pk.reshape(K2, N).view(np.uint8)
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    rows = np.zeros((8 * TT, K2), np.uint8)
    out = np.zeros((B, G, N), np.int64)
    for n0 in range(0, N, 128):
        for kc in range(0, 2 * K2, 256):
            p0, np_ = kc // 2, min(128, K2 - kc // 2)
            wbox = np.zeros(128 * 128, np.uint8)
            ebox = np.zeros(8 * TT * 128, np.uint8)
            obox = np.zeros(8 * TT * 128, np.uint8)
            for p in range(np_):
                for c in range(min(128, N - n0)):
                    wbox[_swz128(p, c >> 4) + (c & 15)] = flat[p0 + p,
                                                               n0 + c]
                for t in range(B):
                    a = _swz128(t, p >> 4) + (p & 15)
                    ebox[a] = he[t, p0 + p]
                    obox[a] = ho[t, p0 + p]
            for warp in range(8):
                cw, tw, kw = warp % CW, (warp // CW) % TW, warp // (CW * TW)
                c0, t0 = cw * MT * 16, tw * TPW
                col = c0 + 2 * MT * g
                off = [_swz128(4 * q + t, col >> 4) + (col & 15)
                       for t in range(4)]
                for u in range(256 // (32 * NW)):
                    k = kc + u * 32 * NW
                    grp = k // group
                    if k >= 2 * K2 or grp % KW != kw:
                        continue
                    for i in range(NW):
                        chunk = NW * u + i
                        v = np.stack([_word(wbox, 2048 * chunk + off[t],
                                            2 * MT) for t in range(4)])
                        x = []
                        for half in range(MT // 2):
                            t01l = _byte_perm(v[0, :, half], v[1, :, half],
                                              0x5140)
                            t01h = _byte_perm(v[0, :, half], v[1, :, half],
                                              0x7362)
                            t23l = _byte_perm(v[2, :, half], v[3, :, half],
                                              0x5140)
                            t23h = _byte_perm(v[2, :, half], v[3, :, half],
                                              0x7362)
                            x += [_byte_perm(t01l, t23l, 0x5410),
                                  _byte_perm(t01l, t23l, 0x7632),
                                  _byte_perm(t01h, t23h, 0x5410),
                                  _byte_perm(t01h, t23h, 0x7632)]
                        lo = [(xw << np.uint32(4)) & np.uint32(0xF0F0F0F0)
                              for xw in x]
                        hi = [xw & np.uint32(0xF0F0F0F0) for xw in x]
                        for t in range(TPW):
                            at = _swz128(8 * (t0 + t) + g, chunk) + 4 * q
                            e = _bytes(_word(ebox, at)[:, 0])
                            o = _bytes(_word(obox, at)[:, 0])
                            bm = np.zeros((32, 8), np.int64)
                            bm[4 * q[:, None] + np.arange(4), g[:, None]] = e
                            bm[16 + 4 * q[:, None] + np.arange(4),
                               g[:, None]] = o
                            for mt in range(MT):
                                am = np.zeros((16, 32), np.int64)
                                kk = 4 * q[:, None] + np.arange(4)
                                am[g[:, None], kk] = _bytes(lo[2 * mt])
                                am[g[:, None] + 8, kk] = _bytes(lo[2 * mt + 1])
                                am[g[:, None], 16 + kk] = _bytes(hi[2 * mt])
                                am[g[:, None] + 8, 16 + kk] = _bytes(
                                    hi[2 * mt + 1])
                                d = am @ bm           # [16 rows, 8 tokens]
                                # each: row r -> channel chan(c0, mt, r // 8,
                                # r % 8), column c -> token 8 (t0 + t) + c
                                r = np.arange(16)
                                ch = n0 + c0 + 2 * MT * (r % 8) + 2 * mt \
                                    + r // 8
                                for c in range(8):
                                    tok = 8 * (t0 + t) + c
                                    keep = (ch < N) & (tok < B)
                                    if tok < B:
                                        out[tok, grp, ch[keep]] += d[keep, c]
    return out


@pytest.mark.parametrize("B,K,N,group", [(3, 512, 192, 128),
                                         (12, 512, 256, 32),
                                         (5, 768, 128, 64)])
def test_w4a8_flat_kernel_fragment_map_gives_exact_partials(B, K, N, group):
    """The flat W4A8 kernel's index map, emulated, against the twin's
    exact int32 group partials (`_w4a8_terms` with unit scales): 8 and 4
    channels a thread (B 3: one token tile, B 12: two), units of four mma
    (groups of 128) and of one (32, 64), a column tile past N."""
    rng = np.random.default_rng(K + group)
    q4 = rng.integers(-8, 8, size=(K, N))
    pk = _np(tqm.w4_pack(torch.from_numpy(q4.T.copy())).t().contiguous()
             .reshape(K // group, group // 2, N))
    h = torch.from_numpy(_h(rng, B, K))
    h8, _ = tqm.quantize_activations(h)
    h8 = _np(h8)
    got = _flat_kernel_partials(pk, h8[:, 0::2], h8[:, 1::2], B)
    ones = torch.ones((K // group, 1, N), dtype=torch.float32)
    terms, _ = tqm._w4a8_terms(h, torch.from_numpy(pk), ones)
    want = _np(terms).astype(np.int64)
    assert np.array_equal(got, 16 * want)


def test_w4dot_flat_above_64_tokens_dequantizes_like_jax():
    rng = np.random.default_rng(9)
    pk, s = _flat(rng, D, 512)
    h = _h(rng, 80, D).reshape(5, 16, D)
    calls = tqm.w4a8_matmul_plain.calls
    got = teng._w4dot(torch.from_numpy(h),
                      W4Linear(torch.from_numpy(pk), torch.from_numpy(s)))
    assert tqm.w4a8_matmul_plain.calls == calls
    np.testing.assert_allclose(_np(got),
                               np.asarray(jeng._w4dot(jnp.asarray(h), pk, s)),
                               **MM_TOL)


@pytest.mark.parametrize("B", [1, 3, 8, 33])
def test_w4a16_plain_matches_jax_kernel(B):
    rng = np.random.default_rng(100 + B)
    pk, s = _flat(rng, D, 512, scale=1.0)
    h = _h(rng, B, D)
    calls = tqm.w4a16_matmul_plain.calls
    got = tqm.w4a16_matmul(torch.from_numpy(h), torch.from_numpy(pk),
                           torch.from_numpy(s), out_dtype=torch.float32)
    assert tqm.w4a16_matmul_plain.calls == calls + 1
    want = jqm.w4a16_matmul(jnp.asarray(h), pk, s, block_n=256,
                            out_dtype=jnp.float32, interpret=True)
    _close(got, want)


def _mlp_case(rng, I):
    gu = _flat(rng, D, 2 * I)
    dn = _flat(rng, I, D)
    return gu + dn


@pytest.mark.parametrize("I,B", [(384, 1), (384, 33), (512, 3), (512, 8)])
def test_fused_mlp_plain_matches_jax_kernel(I, B):
    """fp32 compute (the reference's interpret-mode numerics) against
    JAX's fused_mlp_w4 with several I-tiles on both sides (ti 128 or 256,
    the reference's choice on both), batches that are not multiples of
    8."""
    rng = np.random.default_rng(I + B)
    flat = _mlp_case(rng, I)
    h = _h(rng, B, D)
    tiles = tqm.w4_mlp_tile_layout(*map(torch.from_numpy, flat))
    ti = 256 if I % 256 == 0 else 128
    assert tiles[0].shape == (I // ti, 2 * ti, D // 2)
    assert tiles[1].shape == (I // ti, D // GROUP, 2 * ti)
    # the port's layout round-trips to the flat bytes
    assert all(np.array_equal(_np(a), b)
               for a, b in zip(tqm.w4_mlp_untile_layout(*tiles), flat))
    calls, launches = tqm.fused_mlp_w4_plain.calls, tqm.fused_mlp_w4.launches
    got = tqm.fused_mlp_w4(torch.from_numpy(h), *tiles)
    assert tqm.fused_mlp_w4_plain.calls == calls + 1
    assert tqm.fused_mlp_w4.launches == launches
    jtiles = jqm.w4_mlp_tile_layout(*flat, ti=256 if I % 256 == 0 else 128)
    want = jqm.fused_mlp_w4(jnp.asarray(h), *jtiles, out_dtype=jnp.float32,
                            interpret=True)
    _close(got, want)


@pytest.mark.parametrize("Dm,I,ti", [(256, 512, 256), (256, 512, 128),
                                     (384, 384, 128), (128, 256, 64),
                                     (1024, 2816, 256)])
def test_fused_mlp_layout_round_trips(Dm, I, ti):
    """tile → untile gives back the flat bytes, and each 16-channel group
    of a tile is 8 gate columns then the same 8 up columns, their
    scales in the same order."""
    rng = np.random.default_rng(Dm + I + ti)
    flat = tuple(map(torch.from_numpy, _flat(rng, Dm, 2 * I)
                     + _flat(rng, I, Dm)))
    tiles = tqm.w4_mlp_tile_layout(*flat, ti=ti)
    assert tiles[0].shape == (I // ti, 2 * ti, Dm // 2)
    assert all(torch.equal(a, b)
               for a, b in zip(tqm.w4_mlp_untile_layout(*tiles), flat))
    gu_pk, gu_s = flat[:2]
    j, m, c = I // ti - 1, ti // 8 - 1, 3
    col = j * ti + 8 * m + c
    for half, n in ((0, col), (1, I + col)):
        ch = 16 * m + 8 * half + c
        assert torch.equal(tiles[0][j, ch], gu_pk.reshape(Dm // 2, -1)[:, n])
        assert torch.equal(tiles[1][j, :, ch], gu_s[:, 0, n])


def test_fused_mlp_bound_holds_a_near_tie_flip():
    """An activation planted one fp32 ulp above a bf16 rounding midpoint:
    a kernel whose fp32 sum lands one ulp below it rounds to the other
    bf16 neighbour. That flip moves the down product, and stays within
    fused_mlp_down_bound; the same MLP in fp32 falls outside the bound."""
    rng = np.random.default_rng(21)
    Dm, I, B = 256, 256, 2
    flat = tuple(map(torch.from_numpy, _flat(rng, Dm, 2 * I)
                     + _flat(rng, I, Dm)))
    tiles = tqm.w4_mlp_tile_layout(*flat)
    h = torch.from_numpy(_h(rng, B, Dm))
    act, e_act = tqm.fused_mlp_act(h, tiles[0], tiles[1])
    i0 = int(act[0].abs().argmax())
    v = act[0, i0]
    down = v.to(torch.bfloat16).float()
    if down > v:                           # the bf16 value just below v
        down = torch.nextafter(down.to(torch.bfloat16),
                               torch.tensor(-1e30, dtype=torch.bfloat16)
                               ).float()
    up = torch.nextafter(down.to(torch.bfloat16),
                         torch.tensor(1e30, dtype=torch.bfloat16)).float()
    mid = (down + up) / 2                  # exact in fp32
    inf = torch.tensor(float("inf"))
    twin_a, kern_a = torch.nextafter(mid, inf), torch.nextafter(mid, -inf)
    assert twin_a.to(torch.bfloat16) != kern_a.to(torch.bfloat16)
    planted = act.clone()
    planted[0, i0] = twin_a
    flipped = planted.clone()
    flipped[0, i0] = kern_a
    mdw, mds = tiles[2], tiles[3]
    wd = tqm._w4a16_weight(mdw, mds, torch.bfloat16).float()
    want = planted.to(torch.bfloat16).float() @ wd
    got = flipped.to(torch.bfloat16).float() @ wd
    bound = tqm.fused_mlp_down_bound(planted, e_act, mdw, mds,
                                     tiles[0].shape[1] // 2)
    assert (got - want).abs().max() > 0                 # the flip shows
    assert bool(((got - want).abs() <= bound).all())
    # the planted row's bound holds the flip's own term: one bf16 step
    step = (up - down).double()
    assert bool((bound[0].double() >= step * wd[i0].double().abs()
                 * (1 - 1e-6)).all())
    w32 = (tqm.w4_flat_dequantize(mdw, mds, torch.float32))
    f32 = planted @ w32
    assert ((f32 - want).abs() > bound).float().mean().item() >= 0.5


def _fused_mlp_tree(cfg, monkeypatch):
    """The reference's W4 tree as its engine lays it out under
    AURORA_W4_FUSED_MLP=1 (fused streams first, as its callers do)."""
    tree = init_llama_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    q = jeng.fuse_serving_weights(jeng.quantize_weights_int4(tree))
    monkeypatch.setenv("AURORA_W4_FUSED_MLP", "1")
    jax.clear_caches()
    return tree, q, jax.device_get(jeng.w4_decode_layout_params(q, cfg))


def test_bridge_reads_a_fused_mlp_tree(monkeypatch):
    cfg = CONFIGS["tiled256"]
    _, q, fused = _fused_mlp_tree(cfg, monkeypatch)
    assert "mlp_gu" in fused["layers"] and "gateup" not in fused["layers"]
    tcfg = bridge.llama_config_from(cfg)
    model = bridge.llama_from_params(fused, tcfg, dtype=torch.float32,
                                     device="cpu")
    for l, layer in enumerate(model.layers):
        for name in ("gateup", "down"):
            want = tqm.w4_from_flat(np.asarray(q["layers"][name][l]),
                                    np.asarray(q["layers"][name
                                                           + "_scale4"][l]))
            got = getattr(layer, name)
            assert torch.equal(got.packed, want[0])
            assert torch.equal(got.scale, want[1])
    # the engine fuses them again, in its own layout
    laid = teng.w4_decode_layout(model, tcfg, teng.EngineConfig(
        weight_quant="int4", w4_fused_mlp=True))
    assert isinstance(laid.layers[0].mlp, W4FusedMLP)
    assert not hasattr(laid.layers[0], "gateup")
    assert laid.layers[0].qkv is model.layers[0].qkv
    assert teng.w4_decode_layout(laid, tcfg, teng.EngineConfig(
        weight_quant="int4", w4_fused_mlp=True)) is laid


def test_fuse_rejects_mismatched_scales():
    cfg = bridge.llama_config_from(CONFIGS["tiled256"])
    model = teng.LlamaModel(cfg, device="cpu", weight_quant="int4",
                            fused=True)
    ecfg = teng.EngineConfig(weight_quant="int4", w4_fused_mlp=True)
    assert isinstance(teng.w4_decode_layout(model, cfg, ecfg).layers[0].mlp,
                      W4FusedMLP)
    layer = model.layers[1]
    layer.down.scale = layer.down.scale[:, :1].contiguous()
    with pytest.raises(ValueError, match="down"):
        teng.w4_decode_layout(model, cfg, ecfg)
    layer.down.scale = torch.zeros(cfg.hidden_size + 1, 4)
    with pytest.raises(ValueError, match="down"):
        teng.w4_decode_layout(model, cfg, ecfg)
    for bad in (dict(w4_fused_mlp=True), dict(w4_tiled=False)):
        with pytest.raises(ValueError, match="int4"):
            teng.EngineConfig(weight_quant="int8", **bad)


def _parity(cfg, jtree, model, **layout):
    """The port's engine (quantizing the dense model itself, in the given
    layout) and the JAX engine (serving `jtree`) through the same
    requests, W4 + int8 KV, decode_steps 4: request 0 alone first (a
    32-token extend: the decode kernels), then three more in one wave of
    4 lanes × 64 tokens (the prefill branch); decode runs 4 rows."""
    rng = np.random.default_rng(4)
    # five tokens each: the first from the extend, four from one decode
    # block, so each engine compiles one decode block
    lens, news = [9, 40, 17, 33], [5] * 4
    prompts = [[int(x) for x in rng.integers(3, 128, size=n)] for n in lens]
    common = dict(max_seq_len=96, prefill_buckets=BUCKETS, kv_chunk=32,
                  disable_radix_cache=True, max_batch=4, decode_steps=4,
                  **W4KV8)
    jeng_ = JServeEngine(jtree, cfg, JEngineConfig(kv_dtype=jnp.float32,
                                                   **common))
    teng_ = teng.ServeEngine(model, model.cfg, teng.EngineConfig(
        kv_dtype=torch.float32, **common, **layout))

    def reqs(cls):
        return [cls(rid=str(i), input_ids=list(p), max_new_tokens=m,
                    eos_ids=(), logprobs=True)
                for i, (p, m) in enumerate(zip(prompts, news))]

    jreqs, treqs = reqs(JRequest), reqs(Request)
    want = drain_engine(jeng_, jreqs[:1])
    got = drain_engine(teng_, treqs[:1])
    want.update(drain_engine(jeng_, jreqs[1:]))
    got.update(drain_engine(teng_, treqs[1:]))
    assert_near_tie_parity(got, want)
    return jeng_, teng_.runner.model


def test_engine_fused_mlp_matches_jax_engine(monkeypatch):
    cfg = CONFIGS["tiled256"]
    tree, _, _ = _fused_mlp_tree(cfg, monkeypatch)
    model = bridge.llama_from_params(jax.device_get(tree),
                                     bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    calls = tqm.fused_mlp_w4_plain.calls
    jeng_, served = _parity(cfg, jeng.fuse_serving_weights(
        jeng.quantize_weights_int4(tree)), model, w4_fused_mlp=True)
    assert "mlp_gu" in jeng_.params["layers"]
    assert all(isinstance(l.mlp, W4FusedMLP) for l in served.layers)
    # the 32-token extend and every decode step run it once a layer
    assert tqm.fused_mlp_w4_plain.calls - calls >= 2 * cfg.num_hidden_layers
    jax.clear_caches()


def test_engine_keeps_two_call_mlp_where_the_reference_does(monkeypatch):
    """At intermediate width 64 no reference I-tile (256 or 128) fits, so
    the JAX engine keeps the two-call MLP under AURORA_W4_FUSED_MLP=1.
    The port follows the reference: no W4FusedMLP, and the same greedy
    tokens."""
    import dataclasses
    cfg = dataclasses.replace(CONFIGS["tiny"], intermediate_size=64)
    tree, q, laid = _fused_mlp_tree(cfg, monkeypatch)
    assert "mlp_gu" not in laid["layers"] and "gateup" in laid["layers"]
    tcfg = bridge.llama_config_from(cfg)
    model = bridge.llama_from_params(jax.device_get(tree), tcfg,
                                     dtype=torch.float32, device="cpu")
    ecfg = teng.EngineConfig(weight_quant="int4", w4_fused_mlp=True)
    w4 = teng.fuse_serving_weights(teng.quantize_weights_int4(model))
    assert teng.w4_decode_layout(w4, tcfg, ecfg) is w4
    calls = tqm.fused_mlp_w4_plain.calls
    jeng_, served = _parity(cfg, q, model, w4_fused_mlp=True)
    assert "mlp_gu" not in jeng_.params["layers"]
    assert not any(hasattr(l, "mlp") for l in served.layers)
    assert all(isinstance(l.gateup, W4Linear) for l in served.layers)
    assert tqm.fused_mlp_w4_plain.calls == calls
    jax.clear_caches()


def test_engine_flat_layout_matches_jax_engine(monkeypatch):
    cfg = CONFIGS["tiled256"]
    tree = init_llama_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    model = bridge.llama_from_params(jax.device_get(tree),
                                     bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    monkeypatch.setenv("AURORA_W4_TILED", "0")
    jax.clear_caches()
    calls = tqm.w4a8_matmul_plain.calls
    tiled = tqm.w4a8_matmul_tiled_plain.calls
    jeng_, served = _parity(cfg, tree, model, w4_tiled=False)
    assert jeng_.params["layers"]["q"].ndim == 4          # stayed flat
    assert all(m.flat for l in served.layers for m in l.children())
    assert tqm.w4a8_matmul_plain.calls > calls
    assert tqm.w4a8_matmul_tiled_plain.calls == tiled
    jax.clear_caches()


def test_profile_serve_fused_mlp_runs_on_cpu(tmp_path, capsys):
    """The profile's W4 layout flags and its family split, on the tiny
    config (no device events on the CPU, so every family reads 0)."""
    import json

    from aurora_tpu_torch.tools import profile_serve
    assert profile_serve.main(["--tiny", "--device", "cpu", "--reps", "1",
                               "--steps", "4", "--batch", "2",
                               "--w4kv8-fused", "--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "w4kv8-fused" and res["weights"] == "int4"
    assert set(res["decode_ms_per_step_by_family"]) == {
        "attention", "w4a8", "fused_mlp", "quantizer", "other"}
    events = [("mlp_tile_kernel", 0.0, 30.0), ("quantize_rows<bf16>", 0, 2.0),
              ("w4a8_kernel<1, 16, true, __nv_bfloat16>", 0, 8.0),
              ("elementwise", 0, 4.0)]
    assert profile_serve.family_ms(events, 2) == {
        "attention": 0.0, "w4a8": 0.004, "fused_mlp": 0.015,
        "quantizer": 0.001, "other": 0.002}
