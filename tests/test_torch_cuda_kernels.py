"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

bf16 inputs; the twin computes in fp32 from the same bf16 values.
Tolerances, max abs error (chip_smoke.py's bounds): 2e-2 for extend
(bf16 output rounding plus bf16 probabilities in the PV product), 3e-3
for decode (fp32 probabilities). With int8 KV the same bounds sit on top
of the output's own bf16 rounding (2^-8 |want|), since dequantized values
are not bf16 numbers, and each active lane's max error over its max
|output| stays within 1e-2 (extend) and 8e-3 (decode). Decode row writes
(int8: values and scales) are exact. Packed int4 KV: the int8 bounds,
and the decode kernel's packed bytes (mate nibbles included) and scales
exact. The sliding window and the logit softcap, in every KV mode and
with GQA, under the same bounds; each result must also sit more than 10×
its error away from the twin without the option. The decode kernel's
split-KV grid at its edges (kv_len at 1, 255, 256, 257 and on split
boundaries, windows whose edge falls on or inside a split, G 1, 4, 8)
under the decode bounds, and two decode calls on the same inputs agree
bitwise; the extend kernel at its tile edges (T off the tile, q_offset
with a window, an int4 tile's high half partly past kv_len) under the
extend bounds; the extend kernel at head_dim 256 (extend_d256_kernel,
G 1 and 2, T 700 over rows of 1024, offsets and lengths off its 64-key
tiles, a window cutting tiles inside blocks, the cap) under the extend
bounds and bitwise repeatable; both kernels at head_dims 16, 48, 64, 80,
96, 112, 160 and 208 (padded to their kernel's width) with and without
the window and the cap, and head_dims 72 and 264 refused; the extend
kernel at widths 64 and 96 over rows of 1024 with prefix hits, G 1 and 7,
bitwise repeatable, and every route's profiler name extend_kernel<W> or
extend_d256_kernel (no mma.sync kernel). W4A8 matmul: max |Δ| /
max |want| ≤ 1e-5 with fp32 output (only
the fp32 order of the group sum differs), and bf16 output within one bf16
rounding of the twin's; repeated launches agree bitwise. W8A8 matmul:
bitwise the twin's, fp32 and bf16 output (exact int32 sums, then the same
two fp32 multiplies). The weight streamers (W8A8, W4A16) at B 1, 4, 8,
9, 17, 64 with K 11008, N off the column tile (W4A16's packed rows then
off 16-byte boundaries) and a split-K grid whose last split is short:
W8A8 bitwise the twin's, W4A16 within 1e-5 and bitwise repeatable; the
W4A8 streamers (stripe and flat layouts) at B 1, 4, 9, 64 with groups of
32, 128 and 1024 the same way, within 1e-5, their bf16 output their fp32
output rounded; the four captured in one CUDA graph, whose replays equal
the eager results. The fused W4 MLP: every output within the
bound `fused_mlp_w4_bound` derives (its fp32 control outside it), bitwise
repeatable. The
W8A8 path's one-launch quantizer: bitwise quantize_activations. Flash attention (bf16 in, the fp32 twin on the same bf16
values, causal, GQA, q_offset, segment ids with rows that see no key):
out within 2e-2 max abs and, per query row, 1.5e-2 of that row's max
|out|; lse within 1e-4 (fp32 on both sides from the same bf16 scores);
each of dQ, dK, dV within 1.5e-2 of its max |want| (bf16 P and dS in the
tensor-core products) — chip_smoke.py's bounds; repeated backward passes
agree bitwise; at D 256 and 512 the forward repeats bit for bit and a query row
that sees no key gives out 0 and lse -2.3819763e38. The remat policies of a bf16 train step on the card give
the same loss and grad norm (1e-5) and keep or recompute the flash
forward as their names say. The dense greedy decode of the caption path
repeats bit for bit. The HTTP server (serve/api.py) at 8 layers of 7B
widths, W4 + int8 KV, streams the text it answers plain, through the
kernels and never their twins. The grouped-expert kernel of the MoE
layers at Mixtral's, Qwen3-MoE's and DeepSeek-V2-Lite's shapes, bf16 and
int8 experts, with an expert that gets no rows and one that gets every
row, in both plans of `moe_plan` (decode and extend, M at their edge, K
and N off the tiles): fp32 output within 1e-5 of max |want|, bf16 output
within one bf16 rounding of the twin's fp32 result, repeats bitwise;
rows outside [offsets[0], offsets[E]) stay as they were; it refuses what it
does not take (no fallback); a MoE layer's forward makes no host sync
(`torch.cuda.set_sync_debug_mode("error")`); Mixtral's (W8, 2 layers)
and DeepSeek-V2-Lite's (3 layers) engines repeat bit for bit.
"""


def _lane_rel(got, want, lanes):
    return max(((got[i].float() - want[i]).abs().max()
                / want[i].abs().max()).item() for i in lanes)

import pytest
import torch

from aurora_tpu_torch.ops.pallas import flash_attention as tfa
from aurora_tpu_torch.ops.pallas import quant_matmul as tqm
from aurora_tpu_torch.ops.pallas import ragged_attention as tra


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; run on the card with `-m cuda`)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
def test_extend_kernel_matches_plain_on_card(cuda_device, G):
    gen = torch.Generator(device=cuda_device).manual_seed(G)
    hkv, T, Sr, hd = 4, 200, 512, 128
    kw = dict(device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn((2, 4, hkv, Sr, hd), generator=gen, **kw)
    v = torch.randn((2, 4, hkv, Sr, hd), generator=gen, **kw)
    q = torch.randn((4, T, hkv * G, hd), generator=gen, **kw)
    offs = torch.tensor([0, 150, 3, 0], dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([T, 150 + T, 3 + T - 9, 0], dtype=torch.int32,
                        device=cuda_device)
    rows = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=cuda_device)
    layer = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    got = tra.ragged_attention(q, k, v, lens, offs, rows, layer=layer)
    want = tra.ragged_attention_plain(q.float(), k.float(), v.float(), lens,
                                      offs, rows, layer=1)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 8])
def test_decode_kernel_matches_plain_on_card(cuda_device, G):
    gen = torch.Generator(device=cuda_device).manual_seed(10 + G)
    hkv, Sr, hd = 4, 512, 128
    kw = dict(device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn((2, 4, hkv, Sr, hd), generator=gen, **kw)
    v = torch.randn((2, 4, hkv, Sr, hd), generator=gen, **kw)
    q = torch.randn((4, 1, hkv * G, hd), generator=gen, **kw)
    kn = torch.randn((4, hkv, hd), generator=gen, **kw)
    vn = torch.randn((4, hkv, hd), generator=gen, **kw)
    lens = torch.tensor([300, 0, 1, 512], dtype=torch.int32,
                        device=cuda_device)
    rows = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=cuda_device)
    layer = torch.tensor([0], dtype=torch.int32, device=cuda_device)
    kp, vp = k.clone(), v.clone()
    out, k2, v2 = tra.ragged_decode_attention(q, kn, vn, k, v, lens, rows,
                                              layer=layer)
    want, _, _ = tra.ragged_decode_attention_plain(
        q.float(), kn.float(), vn.float(), kp, vp, lens, rows, layer=0)
    torch.cuda.synchronize()
    assert torch.equal(k2, kp) and torch.equal(v2, vp)
    assert (out.float() - want).abs().max().item() <= 3e-3


def _int8_rows(gen, dev, hkv, Sr=512, hd=128):
    kw = dict(device=dev, dtype=torch.bfloat16)
    k8, ks = tra.kv_quantize(torch.randn((2, 4, hkv, Sr, hd), generator=gen,
                                         **kw))
    v8, vs = tra.kv_quantize(torch.randn((2, 4, hkv, Sr, hd), generator=gen,
                                         **kw))
    return k8, v8, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
def test_int8_extend_kernel_matches_plain_on_card(cuda_device, G):
    gen = torch.Generator(device=cuda_device).manual_seed(20 + G)
    hkv, T = 4, 200
    k8, v8, ks, vs = _int8_rows(gen, cuda_device, hkv)
    q = torch.randn((4, T, hkv * G, 128), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    offs = torch.tensor([0, 150, 3, 0], **i32)
    lens = torch.tensor([T, 150 + T, 3 + T - 9, 0], **i32)
    rows = torch.tensor([3, 1, 0, 2], **i32)
    launches = tra.ragged_attention.launches_int8
    got = tra.ragged_attention(q, k8, v8, lens, offs, rows,
                               layer=torch.tensor([1], **i32), k_scales=ks,
                               v_scales=vs)
    want = tra.ragged_attention_plain(q.float(), k8, v8, lens, offs, rows,
                                      layer=1, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert tra.ragged_attention.launches_int8 == launches + 1
    assert bool(((got.float() - want).abs()
                 <= 2e-2 + 2.0 ** -8 * want.abs()).all())
    assert _lane_rel(got, want, (0, 1, 2)) <= 1e-2
    assert bool((got[3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 8])
def test_int8_decode_kernel_matches_plain_on_card(cuda_device, G):
    gen = torch.Generator(device=cuda_device).manual_seed(30 + G)
    hkv = 4
    k8, v8, ks, vs = _int8_rows(gen, cuda_device, hkv)
    kw = dict(device=cuda_device, dtype=torch.bfloat16)
    q = torch.randn((4, 1, hkv * G, 128), generator=gen, **kw)
    kn = torch.randn((4, hkv, 128), generator=gen, **kw)
    vn = torch.randn((4, hkv, 128), generator=gen, **kw)
    vn[3, 1] = 0                         # an all-zero token: the 1e-8 floor
    i32 = dict(dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([300, 0, 1, 512], **i32)
    rows = torch.tensor([2, 0, 3, 1], **i32)
    plain = [t.clone() for t in (k8, v8, ks, vs)]
    out = tra.ragged_decode_attention(q, kn, vn, k8, v8, lens, rows,
                                      layer=torch.tensor([0], **i32),
                                      k_scales=ks, v_scales=vs)[0]
    want = tra.ragged_decode_attention_plain(
        q.float(), kn, vn, *plain[:2], lens, rows, layer=0,
        k_scales=plain[2], v_scales=plain[3])[0]
    torch.cuda.synchronize()
    for got_t, want_t in zip((k8, v8, ks, vs), plain):
        assert torch.equal(got_t, want_t)
    # int8 rows dequantize to values bf16 cannot hold (a one-key lane's
    # output is v8 * vs itself), so the bound sits on top of the output's
    # own bf16 rounding, 2^-8 relative
    assert bool(((out.float() - want).abs()
                 <= 3e-3 + 2.0 ** -8 * want.abs()).all())
    assert _lane_rel(out, want, (0, 2, 3)) <= 8e-3
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(1, 512, 1024), (4, 4096, 4096),
                                   (9, 11008, 512), (64, 256, 768)])
def test_w4a8_kernel_matches_plain_on_card(cuda_device, B, K, N):
    from aurora_tpu_torch.serve.engine import _w4
    gen = torch.Generator(device=cuda_device).manual_seed(B + K)
    w = torch.randn((N, K), generator=gen, device=cuda_device) * 0.02
    packed, scale = _w4(w)
    h = torch.randn((B, K), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    launches = tqm.w4a8_matmul_tiled.launches
    got = tqm.w4a8_matmul_tiled(h, packed, scale, out_dtype=torch.float32)
    again = tqm.w4a8_matmul_tiled(h, packed, scale, out_dtype=torch.float32)
    got16 = tqm.w4a8_matmul_tiled(h, packed, scale)
    want = tqm.w4a8_matmul_tiled_plain(h, packed, scale,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tqm.w4a8_matmul_tiled.launches == launches + 3
    assert torch.equal(got, again)                   # deterministic
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-5
    assert got16.dtype == torch.bfloat16
    # one bf16 rounding of the twin (2^-8 relative), plus the fp32 slack
    bound = want.abs() * 2.0 ** -8 + 1e-5 * want.abs().max()
    assert bool(((got16.float() - want).abs() <= bound).all())


def _stripe_w4(gen, dev, K, N, group):
    """Random W4 stripes [N, K/2] and scales [N, K/group] with groups of
    `group` rows (the engine's _w4 recipe at any group)."""
    w = torch.randn((N, K // group, group), generator=gen, device=dev) * 0.02
    s = (w.abs().amax(dim=2) / 7.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(w / s[:, :, None]), -8, 7)
    return tqm.w4_pack(q.reshape(N, K)), s


# the W4A8 weight streamer at every token-tile count and at groups of 32
# (units of one mma), 128 (the 7B's) and 1024 (a group over four ring
# stages); N off the column tile; with N 4096 and groups of 128, a split
# grid whose last K split is short
@pytest.mark.cuda
@pytest.mark.parametrize("N", [1028, 4096])
@pytest.mark.parametrize("K,group", [(11008, 128), (4096, 32), (8192, 1024)])
@pytest.mark.parametrize("B", [1, 4, 9, 64])
def test_w4a8_kernel_rows_groups_and_splits_on_card(cuda_device, B, K,
                                                     group, N):
    gen = torch.Generator(device=cuda_device).manual_seed(B + K + N + group)
    packed, scale = _stripe_w4(gen, cuda_device, K, N, group)
    if N == 4096 and group == 128:
        assert _short_last_split(cuda_device, N, K, group)
    h = torch.randn((B, K), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    got = tqm.w4a8_matmul_tiled(h, packed, scale, out_dtype=torch.float32)
    again = tqm.w4a8_matmul_tiled(h, packed, scale, out_dtype=torch.float32)
    got16 = tqm.w4a8_matmul_tiled(h, packed, scale)
    want = tqm.w4a8_matmul_tiled_plain(h, packed, scale,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(1, 512, 1024), (4, 4096, 4096),
                                   (9, 11008, 512), (64, 256, 768)])
def test_w8a8_kernel_matches_plain_on_card(cuda_device, B, K, N):
    from aurora_tpu_torch.serve.engine import _w8
    gen = torch.Generator(device=cuda_device).manual_seed(B + N)
    w8, s_w = _w8(torch.randn((N, K), generator=gen, device=cuda_device))
    h8, s_a = tqm.quantize_activations(torch.randn(
        (B, K), generator=gen, device=cuda_device, dtype=torch.bfloat16))
    launches = tqm.w8a8_matmul.launches
    got = tqm.w8a8_matmul(h8, s_a, w8, s_w, out_dtype=torch.float32)
    got16 = tqm.w8a8_matmul(h8, s_a, w8, s_w)
    want = tqm.w8a8_matmul_plain(h8, s_a, w8, s_w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tqm.w8a8_matmul.launches == launches + 2
    assert torch.equal(got, want)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, want.to(torch.bfloat16))


def _flat_w4(gen, dev, K, N):
    """Random W4 weights [K → N] in the reference's flat layout."""
    from aurora_tpu_torch.serve.engine import _w4
    return tqm.w4_to_flat(*_w4(torch.randn((N, K), generator=gen,
                                           device=dev) * 0.02))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(1, 512, 1028), (4, 4096, 4096),
                                   (9, 11008, 516), (64, 256, 772)])
def test_w4a8_flat_kernel_matches_plain_on_card(cuda_device, B, K, N):
    gen = torch.Generator(device=cuda_device).manual_seed(B + K + N)
    pk, s = _flat_w4(gen, cuda_device, K, N)
    h = torch.randn((B, K), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    launches = tqm.w4a8_matmul.launches
    got = tqm.w4a8_matmul(h, pk, s, out_dtype=torch.float32)
    again = tqm.w4a8_matmul(h, pk, s, out_dtype=torch.float32)
    got16 = tqm.w4a8_matmul(h, pk, s)
    want = tqm.w4a8_matmul_plain(h, pk, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tqm.w4a8_matmul.launches == launches + 3
    assert torch.equal(got, again)                   # deterministic
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))


# the flat W4A8 streamer as the stripe one above: every token-tile count,
# groups of 32, 128 and 1024, N off the column tile (N % 16 == 4: the
# packed rows then start off 16-byte boundaries and the weights come by
# cp.async) and a split grid whose last K split is short
@pytest.mark.cuda
@pytest.mark.parametrize("N", [1028, 4096])
@pytest.mark.parametrize("K,group", [(11008, 128), (4096, 32), (8192, 1024)])
@pytest.mark.parametrize("B", [1, 4, 9, 64])
def test_w4a8_flat_kernel_rows_groups_and_splits_on_card(cuda_device, B, K,
                                                         group, N):
    gen = torch.Generator(device=cuda_device).manual_seed(B + K + N + group)
    pk, s = tqm.w4_to_flat(*_stripe_w4(gen, cuda_device, K, N, group))
    if N == 4096 and group == 128:
        assert _short_last_split(cuda_device, N, K, group)
    h = torch.randn((B, K), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    got = tqm.w4a8_matmul(h, pk, s, out_dtype=torch.float32)
    again = tqm.w4a8_matmul(h, pk, s, out_dtype=torch.float32)
    got16 = tqm.w4a8_matmul(h, pk, s)
    want = tqm.w4a8_matmul_plain(h, pk, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N,h_dtype", [
    (1, 512, 1028, torch.bfloat16), (4, 4096, 4096, torch.bfloat16),
    (9, 11008, 516, torch.float32), (64, 256, 772, torch.bfloat16)])
def test_w4a16_kernel_matches_plain_on_card(cuda_device, B, K, N, h_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(B + K)
    pk, s = _flat_w4(gen, cuda_device, K, N)
    h = torch.randn((B, K), generator=gen, device=cuda_device, dtype=h_dtype)
    launches = tqm.w4a16_matmul.launches
    got = tqm.w4a16_matmul(h, pk, s, out_dtype=torch.float32)
    again = tqm.w4a16_matmul(h, pk, s, out_dtype=torch.float32)
    want = tqm.w4a16_matmul_plain(h, pk, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tqm.w4a16_matmul.launches == launches + 2
    assert torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


# the weight streamers (w8a8_matmul, w4a16_matmul) at every token-tile
# count, K = 11008 (86 groups of 128), N off the 128-column tile (W4A16:
# N % 16 == 4, so packed rows start off 16-byte boundaries) and, with N
# 4096, a grid whose last K split is shorter than the others
STREAM_ROWS = [1, 4, 8, 9, 17, 64]
STREAM_N = [1028, 4096]


def _short_last_split(dev, N, K, group):
    _, per, nsplit = tqm.weight_plan(N, K, group, tra._sm_count(dev))
    return nsplit > 1 and -(-K // group) - (nsplit - 1) * per < per


@pytest.mark.cuda
@pytest.mark.parametrize("N", STREAM_N)
@pytest.mark.parametrize("B", STREAM_ROWS)
def test_w8a8_kernel_rows_and_splits_on_card(cuda_device, B, N):
    from aurora_tpu_torch.serve.engine import _w8
    K = 11008
    gen = torch.Generator(device=cuda_device).manual_seed(7 * B + N)
    w8, s_w = _w8(torch.randn((N, K), generator=gen, device=cuda_device))
    h8, s_a = tqm.quantize_activations(torch.randn(
        (B, K), generator=gen, device=cuda_device, dtype=torch.bfloat16))
    if N == 4096:
        assert _short_last_split(cuda_device, N, K, tqm.W8_GROUP)
    got = tqm.w8a8_matmul(h8, s_a, w8, s_w, out_dtype=torch.float32)
    again = tqm.w8a8_matmul(h8, s_a, w8, s_w, out_dtype=torch.float32)
    got16 = tqm.w8a8_matmul(h8, s_a, w8, s_w)
    want = tqm.w8a8_matmul_plain(h8, s_a, w8, s_w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    assert torch.equal(got16, want.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("N", STREAM_N)
@pytest.mark.parametrize("B", STREAM_ROWS)
def test_w4a16_kernel_rows_and_splits_on_card(cuda_device, B, N):
    K = 11008
    gen = torch.Generator(device=cuda_device).manual_seed(7 * B + N)
    pk, s = _flat_w4(gen, cuda_device, K, N)
    if N == 4096:
        assert _short_last_split(cuda_device, N, K, K // s.shape[0])
    h = torch.randn((B, K), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    got = tqm.w4a16_matmul(h, pk, s, out_dtype=torch.float32)
    again = tqm.w4a16_matmul(h, pk, s, out_dtype=torch.float32)
    got16 = tqm.w4a16_matmul(h, pk, s)
    want = tqm.w4a16_matmul_plain(h, pk, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.cuda
def test_weight_streamers_replay_in_a_cuda_graph_on_card(cuda_device):
    """One capture of the four streamers (split grids, so the
    per-device scratch and tickets are in the graph): each replay equals
    the eager result bitwise."""
    from aurora_tpu_torch.serve.engine import _w8
    K, N, B = 11008, 4096, 9
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    w8, s_w = _w8(torch.randn((N, K), generator=gen, device=cuda_device))
    pk, s = _flat_w4(gen, cuda_device, K, N)
    packed, scale = _stripe_w4(gen, cuda_device, K, N, 128)
    h = torch.randn((B, K), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    h8, s_a = tqm.quantize_activations(h)

    def step():
        return (tqm.w8a8_matmul(h8, s_a, w8, s_w),
                tqm.w4a16_matmul(h, pk, s, out_dtype=torch.float32),
                tqm.w4a8_matmul_tiled(h, packed, scale,
                                      out_dtype=torch.float32),
                tqm.w4a8_matmul(h, pk, s, out_dtype=torch.float32))

    eager = step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,K", [(1, 4096), (4, 11008), (64, 4096),
                                 (2, 14336)])
def test_quantize_rows_kernel_matches_plain_on_card(cuda_device, B, K,
                                                    dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(B + K)
    h = torch.randn((B, K), generator=gen, device=cuda_device) * 3
    h[0, :7] = 0.0                       # zeros in a row
    h = h.to(dtype)
    launches = tqm.quantize_rows.launches
    h8, s_a = tqm.quantize_rows(h)
    w8, ws_a = tqm.quantize_activations(h)
    torch.cuda.synchronize()
    assert tqm.quantize_rows.launches == launches + 1
    assert h8.dtype == torch.int8 and s_a.shape == (B, 1)
    assert torch.equal(h8, w8)
    assert torch.equal(s_a, ws_a)


def _mlp_tiles(gen, dev, D, I):
    gu_pk, gu_s = _flat_w4(gen, dev, D, 2 * I)
    dn_pk, dn_s = _flat_w4(gen, dev, I, D)
    return tqm.w4_mlp_tile_layout(gu_pk, gu_s, dn_pk, dn_s)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,I", [(4, 4096, 11008), (9, 384, 384),
                                   (64, 256, 512), (1, 256, 128)])
def test_fused_mlp_kernel_matches_plain_on_card(cuda_device, B, D, I):
    """The fused W4 MLP vs its bf16 twin: the two differ only in the fp32
    order of the gate/up and down sums, which can flip a near-tie bf16
    activation; every output lies within the bound fused_mlp_w4_bound
    derives from that (chip_smoke.py's check), and the same MLP computed
    in fp32 (no bf16 activation or down weights) falls outside it on most
    outputs."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + D + I)
    tiles = _mlp_tiles(gen, cuda_device, D, I)
    h = torch.randn((B, D), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    launches = tqm.fused_mlp_w4.launches
    got = tqm.fused_mlp_w4(h, *tiles, out_dtype=torch.float32)
    got16 = tqm.fused_mlp_w4(h, *tiles)
    want = tqm.fused_mlp_w4_plain(h, *tiles, out_dtype=torch.float32)
    f32 = tqm.fused_mlp_w4_plain(h, *tiles, out_dtype=torch.float32,
                                 compute_dtype=torch.float32)
    bound = tqm.fused_mlp_w4_bound(h, *tiles)
    torch.cuda.synchronize()
    assert tqm.fused_mlp_w4.launches == launches + 2
    assert got.shape == (B, D) and got16.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound).all())
    assert ((f32 - want).abs() > bound).float().mean().item() >= 0.5
    assert bool(((got16.float() - want).abs()
                 <= want.abs() * 2.0 ** -8 + 2 * bound).all())


@pytest.mark.cuda
def test_fused_mlp_kernel_is_bitwise_repeatable_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    tiles = _mlp_tiles(gen, cuda_device, 4096, 11008)
    h = torch.randn((4, 4096), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    runs = [tqm.fused_mlp_w4(h, *tiles, out_dtype=torch.float32)
            for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def _int4_rows(gen, dev, hkv, Sr=512, hd=128):
    """Packed int4 rows (maxq-7 grid) and their token-space scales."""
    out = []
    for _ in "kv":
        x4, s = tra.kv_quantize(torch.randn((2, 4, hkv, Sr, hd), generator=gen,
                                            device=dev,
                                            dtype=torch.bfloat16), 7.0)
        out.append((tra.pack_int4_rows(x4), s))
    (k4, ks), (v4, vs) = out
    return k4, v4, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
def test_int4_extend_kernel_matches_plain_on_card(cuda_device, G):
    gen = torch.Generator(device=cuda_device).manual_seed(50 + G)
    hkv, T = 4, 200
    k4, v4, ks, vs = _int4_rows(gen, cuda_device, hkv)
    q = torch.randn((4, T, hkv * G, 128), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    offs = torch.tensor([0, 150, 3, 0], **i32)
    lens = torch.tensor([T, 150 + T, 3 + T - 9, 0], **i32)
    rows = torch.tensor([3, 1, 0, 2], **i32)
    kw = dict(k_scales=ks, v_scales=vs, kv_pack=True)
    launches = tra.ragged_attention.launches_int4
    got = tra.ragged_attention(q, k4, v4, lens, offs, rows,
                               layer=torch.tensor([1], **i32), **kw)
    want = tra.ragged_attention_plain(q.float(), k4, v4, lens, offs, rows,
                                      layer=1, **kw)
    torch.cuda.synchronize()
    assert tra.ragged_attention.launches_int4 == launches + 1
    assert bool(((got.float() - want).abs()
                 <= 2e-2 + 2.0 ** -8 * want.abs()).all())
    assert _lane_rel(got, want, (0, 1, 2)) <= 1e-2
    assert bool((got[3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 8])
def test_int4_decode_kernel_matches_plain_on_card(cuda_device, G):
    """Writes into the low plane (position 299 - 256 = 43 of segment 1),
    none (inactive lane), the high plane (position 200) and the row's last
    position (511, high plane): packed bytes and scales exact."""
    gen = torch.Generator(device=cuda_device).manual_seed(60 + G)
    hkv = 4
    k4, v4, ks, vs = _int4_rows(gen, cuda_device, hkv)
    kw = dict(device=cuda_device, dtype=torch.bfloat16)
    q = torch.randn((4, 1, hkv * G, 128), generator=gen, **kw)
    kn = torch.randn((4, hkv, 128), generator=gen, **kw)
    vn = torch.randn((4, hkv, 128), generator=gen, **kw)
    vn[3, 1] = 0                         # an all-zero token: the 1e-8 floor
    i32 = dict(dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([300, 0, 201, 512], **i32)
    rows = torch.tensor([2, 0, 3, 1], **i32)
    plain = [t.clone() for t in (k4, v4, ks, vs)]
    launches = tra.ragged_decode_attention.launches_int4
    out = tra.ragged_decode_attention(q, kn, vn, k4, v4, lens, rows,
                                      layer=torch.tensor([0], **i32),
                                      k_scales=ks, v_scales=vs, kv_maxq=7.0,
                                      kv_pack=True)[0]
    want = tra.ragged_decode_attention_plain(
        q.float(), kn, vn, *plain[:2], lens, rows, layer=0,
        k_scales=plain[2], v_scales=plain[3], kv_maxq=7.0, kv_pack=True)[0]
    torch.cuda.synchronize()
    assert tra.ragged_decode_attention.launches_int4 == launches + 1
    for got_t, want_t in zip((k4, v4, ks, vs), plain):
        assert torch.equal(got_t, want_t)
    assert bool(((out.float() - want).abs()
                 <= 3e-3 + 2.0 ** -8 * want.abs()).all())
    assert _lane_rel(out, want, (0, 2, 3)) <= 8e-3
    assert bool((out[1] == 0).all())


def _mode_rows(gen, dev, mode, hkv, Sr=512, hd=128):
    """bf16, int8 or packed int4 rows of Sr tokens → (k, v, the KV
    keyword arguments of both functions' extend call)."""
    if mode == "bf16":
        kw = dict(device=dev, dtype=torch.bfloat16)
        k = torch.randn((2, 4, hkv, Sr, hd), generator=gen, **kw)
        v = torch.randn((2, 4, hkv, Sr, hd), generator=gen, **kw)
        return k, v, {}
    if mode == "int8":
        k, v, ks, vs = _int8_rows(gen, dev, hkv, Sr, hd)
        return k, v, dict(k_scales=ks, v_scales=vs)
    k, v, ks, vs = _int4_rows(gen, dev, hkv, Sr, hd)
    return k, v, dict(k_scales=ks, v_scales=vs, kv_pack=True)


# window 100 starts inside packing segments (lanes at 150-349 and 3-185);
# a cap of 50 (Gemma2's) on q scaled by 8, so that scores reach it. The
# scaled q peaks the softmax, so outputs approach single V rows and the
# bounds take the output's own bf16 rounding (2^-8 |want|) in every mode
RND = 2.0 ** -8
WINDOW_CAP = [dict(window=100), dict(logit_cap=50.0),
              dict(window=100, logit_cap=50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("opts", WINDOW_CAP, ids=["window", "cap", "both"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_window_cap_extend_kernel_matches_plain_on_card(cuda_device, mode, G,
                                                        opts):
    gen = torch.Generator(device=cuda_device).manual_seed(70 + G)
    hkv, T = 4, 200
    k, v, kv = _mode_rows(gen, cuda_device, mode, hkv)
    q = 8 * torch.randn((4, T, hkv * G, 128), generator=gen,
                        device=cuda_device, dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    offs = torch.tensor([0, 150, 3, 0], **i32)
    lens = torch.tensor([T, 150 + T, 3 + T - 9, 0], **i32)
    rows = torch.tensor([3, 1, 0, 2], **i32)
    launches = tra.ragged_attention.launches_window
    got = tra.ragged_attention(q, k, v, lens, offs, rows,
                               layer=torch.tensor([1], **i32), **kv, **opts)
    want = tra.ragged_attention_plain(q.float(), k, v, lens, offs, rows,
                                      layer=1, **kv, **opts)
    off = tra.ragged_attention_plain(q.float(), k, v, lens, offs, rows,
                                     layer=1, **kv)
    torch.cuda.synchronize()
    assert tra.ragged_attention.launches_window == launches + 1
    diff = (got.float() - want).abs()
    assert bool((diff <= 2e-2 + RND * want.abs()).all())
    assert _lane_rel(got, want, (0, 1, 2)) <= 1e-2
    assert bool((got[3] == 0).all())
    # the options reached the kernel: without them the twin is far off
    assert (got.float() - off).abs().max().item() > 10 * diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("opts", WINDOW_CAP, ids=["window", "cap", "both"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_window_cap_decode_kernel_matches_plain_on_card(cuda_device, mode, G,
                                                        opts):
    """Queries at 299 (a window of 100 starts at 200, in segment 0's high
    plane), nowhere, 200 (starts at 101, low plane) and 511: row writes
    (packed bytes, scales) exact."""
    gen = torch.Generator(device=cuda_device).manual_seed(80 + G)
    hkv = 4
    k, v, kv = _mode_rows(gen, cuda_device, mode, hkv)
    if mode != "bf16":
        kv = dict(kv, kv_maxq=7.0 if mode == "int4" else 127.0)
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    q = 8 * torch.randn((4, 1, hkv * G, 128), generator=gen, **bf)
    kn = torch.randn((4, hkv, 128), generator=gen, **bf)
    vn = torch.randn((4, hkv, 128), generator=gen, **bf)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([300, 0, 201, 512], **i32)
    rows = torch.tensor([2, 0, 3, 1], **i32)
    state = [k, v] + [kv[n] for n in ("k_scales", "v_scales") if n in kv]
    plain = [t.clone() for t in state]
    pkv = dict(kv, **dict(zip(("k_scales", "v_scales"), plain[2:])))
    launches = tra.ragged_decode_attention.launches_window
    out = tra.ragged_decode_attention(q, kn, vn, k, v, lens, rows,
                                      layer=torch.tensor([0], **i32), **kv,
                                      **opts)[0]
    want = tra.ragged_decode_attention_plain(
        q.float(), kn, vn, *plain[:2], lens, rows, layer=0, **pkv,
        **opts)[0]
    off = tra.ragged_decode_attention_plain(
        q.float(), kn, vn, *plain[:2], lens, rows, layer=0, **pkv)[0]
    torch.cuda.synchronize()
    assert tra.ragged_decode_attention.launches_window == launches + 1
    for got_t, want_t in zip(state, plain):
        assert torch.equal(got_t, want_t)
    diff = (out.float() - want).abs()
    assert bool((diff <= 3e-3 + RND * want.abs()).all())
    assert _lane_rel(out, want, (0, 2, 3)) <= 8e-3
    assert bool((out[1] == 0).all())
    assert (out.float() - off).abs().max().item() > 10 * diff.max().item()


# the decode kernel's split-KV grid (splits of 256 keys over rows of 1024):
# lengths at 1, inside the first split, on a split boundary and one past
# it; lengths on later boundaries; a window whose lower edge falls on a
# split boundary (kv_len - w = 512, 768, 256, 0) and one whose edge falls
# inside a split
SPLIT_EDGES = {"edges": (dict(), (1, 255, 256, 257)),
               "boundaries": (dict(), (512, 513, 768, 1024)),
               "window-on-boundary": (dict(window=256), (768, 1024, 512, 256)),
               "window-inside": (dict(window=300), (900, 301, 1000, 1))}


def _decode_case(dev, seed, mode, hkv, G, lens, Sr, opts, q_gain=1.0,
                 hd=128):
    """One decode call through the kernel and through the twin on copies
    of the same rows → (out, want, state, plain): the state tensors (rows
    and scales) as the kernel left them and as the twin did."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, v, kv = _mode_rows(gen, dev, mode, hkv, Sr, hd)
    if mode != "bf16":
        kv = dict(kv, kv_maxq=7.0 if mode == "int4" else 127.0)
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = q_gain * torch.randn((4, 1, hkv * G, hd), generator=gen, **bf)
    kn = torch.randn((4, hkv, hd), generator=gen, **bf)
    vn = torch.randn((4, hkv, hd), generator=gen, **bf)
    i32 = dict(dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, **i32)
    rows = torch.tensor([2, 0, 3, 1], **i32)
    state = [k, v] + [kv[n] for n in ("k_scales", "v_scales") if n in kv]
    plain = [t.clone() for t in state]
    pkv = dict(kv, **dict(zip(("k_scales", "v_scales"), plain[2:])))
    out = tra.ragged_decode_attention(q, kn, vn, k, v, lens_t, rows,
                                      layer=torch.tensor([1], **i32), **kv,
                                      **opts)[0]
    want = tra.ragged_decode_attention_plain(
        q.float(), kn, vn, *plain[:2], lens_t, rows, layer=1, **pkv,
        **opts)[0]
    torch.cuda.synchronize()
    return out, want, state, plain, (q, kn, vn, lens_t, rows, kv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_EDGES))
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_decode_kernel_split_edges_on_card(cuda_device, mode, G, case):
    """Rows of 1024 tokens (4 splits of 256): the new token at either end
    of a split, windows whose edge falls on and inside a split; row and
    scale writes exact, the output within the decode bounds (bf16
    rounding of the output on top in the quantized modes)."""
    opts, lens = SPLIT_EDGES[case]
    out, want, state, plain, _ = _decode_case(
        cuda_device, 90 + G, mode, 4, G, lens, 1024, opts)
    for got_t, want_t in zip(state, plain):
        assert torch.equal(got_t, want_t)
    rnd = 0.0 if mode == "bf16" else RND
    diff = (out.float() - want).abs()
    assert bool((diff <= 3e-3 + rnd * want.abs()).all()), diff.max().item()
    assert _lane_rel(out, want, range(4)) <= 8e-3


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("Sr", [513, 1030])
def test_bf16_decode_kernel_takes_any_row_width_on_card(cuda_device, Sr, G,
                                                        window):
    """bf16 rows need no width of a multiple of 4 tokens (only quantized
    rows copy scale planes): rows of 513 and 1030 tokens, the last split
    partly past S, lengths at the row's end and inside a split."""
    lens = (Sr, 257, 0, Sr - 1)
    out, want, state, plain, _ = _decode_case(
        cuda_device, 70 + G, "bf16", 4, G, lens, Sr, dict(window=window))
    for got_t, want_t in zip(state, plain):
        assert torch.equal(got_t, want_t)
    assert (out.float() - want).abs().max().item() <= 3e-3
    assert _lane_rel(out, want, (0, 1, 3)) <= 8e-3
    assert bool((out[2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 512])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_decode_kernel_is_bitwise_repeatable_on_card(cuda_device, mode,
                                                     window):
    """Two decode calls on the same inputs agree bitwise: the splits'
    partials merge in split order whichever block merges (rows of 1792,
    GQA 4, the serving lengths). The second call rewrites the same token
    into the same place."""
    lens = (1648, 700, 0, 1)
    out, _, state, _, (q, kn, vn, lens_t, rows, kv) = _decode_case(
        cuda_device, 7, mode, 8, 4, lens, 1792, dict(window=window))
    layer = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    for _ in range(2):
        again = tra.ragged_decode_attention(q, kn, vn, *state[:2], lens_t,
                                            rows, layer=layer, window=window,
                                            **kv)[0]
        torch.cuda.synchronize()
        assert torch.equal(again, out)


# the extend kernel's tiles (128 folded query rows, 128 keys; int4: 64
# packed rows, keys base + [0, 64) and base + 128 + [0, 64)): T = 77 and
# 333 (neither rows nor keys on a tile edge), q_offset > 0 with a window
# (the first key tile starts past 0, its lower part below every window),
# and lengths whose last int4 tile's high-nibble half lies partly past
# kv_len (kv_len % 256 = 160 and 230) — lanes: (q_offset, T_lane)
EXTEND_EDGES = {"ragged-T": (dict(), 77, ((0, 77), (40, 77), (3, 60),
                                         (0, 0))),
                "offset-window": (dict(window=100), 333,
                                  ((300, 333), (0, 333), (500, 200), (0, 0))),
                "int4-high-half": (dict(), 200, ((216, 200), (30, 200),
                                                 (0, 160), (0, 0)))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXTEND_EDGES))
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_extend_kernel_tile_edges_on_card(cuda_device, mode, G, case):
    """Rows of 1024 tokens; each lane's kv_len = q_offset + its own token
    count (the last lane padded): the extend bounds, a padded lane of
    zeros."""
    opts, T, lanes = EXTEND_EDGES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(100 + G)
    hkv = 4
    k, v, kv = _mode_rows(gen, cuda_device, mode, hkv, 1024)
    q = torch.randn((4, T, hkv * G, 128), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    offs = torch.tensor([o for o, _ in lanes], **i32)
    lens = torch.tensor([o + n if n else 0 for o, n in lanes], **i32)
    rows = torch.tensor([3, 1, 0, 2], **i32)
    got = tra.ragged_attention(q, k, v, lens, offs, rows,
                               layer=torch.tensor([1], **i32), **kv, **opts)
    want = tra.ragged_attention_plain(q.float(), k, v, lens, offs, rows,
                                      layer=1, **kv, **opts)
    torch.cuda.synchronize()
    rnd = 0.0 if mode == "bf16" and not opts else RND
    diff = (got.float() - want).abs()
    assert bool((diff <= 2e-2 + rnd * want.abs()).all()), diff.max().item()
    # rows past a lane's own token count see keys up to kv_len only
    live = [i for i, (_, n) in enumerate(lanes) if n]
    assert _lane_rel(got, want, live) <= 1e-2
    assert bool((got[3] == 0).all())


def _flash_inputs(dev, seed, B, T, S, H, Hkv, D):
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(device=dev, dtype=torch.bfloat16)
    q, g = (torch.randn((B, T, H, D), generator=gen, **kw) for _ in "qg")
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, **kw) for _ in "kv")
    return q, k, v, g


def _grads(fn, q, k, v, *cot):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, leaves, cot)
    return [o.detach() for o in outs], list(grads)


def _grad_rel(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _flash_check(dev, seed, B, T, S, H, Hkv, D, causal, q_offset, segments):
    """The kernels vs the fp32 twin: out, the per-row error, q/k/v grads
    and the launch counts (those at width 512 too); with segments (S = T + q_offset) three
    documents whose boundaries fall inside tiles, and rows 200.. of the
    last batch row carry an id no key has."""
    q, k, v, g = _flash_inputs(dev, seed, B, T, S, H, Hkv, D)
    kw = dict(causal=causal, q_offset=q_offset)
    if segments:
        seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
        seg[:, 100:230] = 1
        seg[:, 230:] = 2
        qseg = seg[:, q_offset:].clone()
        qseg[-1, 200:] = 9                   # rows that see no key
        kw.update(q_segment_ids=qseg, kv_segment_ids=seg)
    counters = [f"launches_{k_}{w}" for w in ("", "_d512")
                for k_ in ("fwd", "dkv", "dq")]
    launches = [getattr(tfa.flash_attention, c) for c in counters]
    (got,), got_g = _grads(
        lambda *a: tfa.flash_attention(*a, **kw), q, k, v, g)
    (want,), want_g = _grads(
        lambda *a: tfa.flash_attention_plain(*a, **kw)[0],
        q.float(), k.float(), v.float(), g.float())
    torch.cuda.synchronize()
    # the width-512 counters rise only where the head pads to 512
    assert [getattr(tfa.flash_attention, c) for c in counters] == [
        n + 1 for n in launches[:3]] + [n + int(D > 256)
                                        for n in launches[3:]]
    diff = (got.float() - want).abs()
    assert diff.max().item() <= 2e-2
    row_max = want.abs().amax(-1).clamp_min(1e-6)
    assert (diff.amax(-1) / row_max).max().item() <= 1.5e-2
    if segments:
        assert bool((got[-1, 200:] == 0).all())
        assert bool((got_g[0][-1, 200:] == 0).all())
    for name, a, b in zip("qkv", got_g, want_g):
        assert _grad_rel(a, b) <= 1.5e-2, name


# T and S off the tiles of 64 and 128, the causal diagonal across two key
# tiles (q_offset 64, 200), heads of 64 and 96 (zero-filled by the TMA
# boxes of 64 columns), non-causal with S != T, segment boundaries inside
# tiles
@pytest.mark.cuda
@pytest.mark.parametrize("T,S,Hkv,D,causal,q_offset,segments", [
    (300, 300, 8, 128, True, 0, False), (300, 300, 2, 128, True, 0, False),
    (300, 364, 8, 128, True, 64, True), (300, 300, 8, 64, True, 0, False),
    (300, 500, 8, 128, True, 200, False), (300, 300, 8, 96, True, 0, False),
    (300, 200, 8, 128, False, 0, False), (200, 330, 4, 128, False, 0, False),
    (300, 300, 8, 128, False, 0, True), (300, 300, 8, 128, True, 0, True)])
def test_flash_kernels_match_plain_on_card(cuda_device, T, S, Hkv, D, causal,
                                           q_offset, segments):
    _flash_check(cuda_device, D + Hkv + q_offset, 2, T, S, 8, Hkv, D, causal,
                 q_offset, segments)


@pytest.mark.cuda
def test_flash_kernels_match_plain_at_training_width_on_card(cuda_device):
    """B x H = 4 x 32 at T 2048, causal: forward and backward."""
    _flash_check(cuda_device, 3, 4, 2048, 2048, 32, 32, 128, True, 0, False)


@pytest.mark.cuda
def test_flash_lse_kernel_matches_plain_on_card(cuda_device):
    B, T, H, Hkv, D = 2, 256, 8, 4, 128
    q, k, v, g = _flash_inputs(cuda_device, 77, B, T, T, H, Hkv, D)
    g_lse = torch.randn((B, H, T), device=cuda_device)
    (out, lse), got_g = _grads(
        lambda *a: tfa.flash_attention_lse(*a, causal=True), q, k, v, g,
        g_lse)
    (w_out, w_lse), want_g = _grads(
        lambda *a: tfa.flash_attention_plain(*a, causal=True),
        q.float(), k.float(), v.float(), g.float(), g_lse)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32
    assert (out.float() - w_out).abs().max().item() <= 2e-2
    assert (lse - w_lse).abs().max().item() <= 1e-4
    for name, a, b in zip("qkv", got_g, want_g):
        assert _grad_rel(a, b) <= 1.5e-2, name


@pytest.mark.cuda
def test_flash_backward_is_deterministic_on_card(cuda_device):
    q, k, v, g = _flash_inputs(cuda_device, 5, 2, 512, 512, 8, 8, 128)
    runs = [_grads(lambda *a: tfa.flash_attention(*a, causal=True),
                   q, k, v, g)[1] for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


@pytest.mark.cuda
def test_flash_rejects_what_the_kernels_do_not_take(cuda_device):
    """fp32 inputs and heads past 512 columns raise; a head of 72 columns
    (not a multiple of 16) is padded to 80 and matches the twin."""
    q, k, v, _ = _flash_inputs(cuda_device, 6, 1, 128, 128, 2, 2, 128)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), k.float(), v.float())
    q72, k72, v72, _ = _flash_inputs(cuda_device, 7, 1, 128, 128, 2, 2, 72)
    got = tfa.flash_attention(q72, k72, v72)
    want = tfa.flash_attention_plain(q72.float(), k72.float(), v72.float())[0]
    torch.cuda.synchronize()
    assert got.shape == q72.shape
    assert (got.float() - want).abs().max().item() <= 2e-2
    q640, k640, v640, _ = _flash_inputs(cuda_device, 8, 1, 128, 128, 2, 2,
                                        640)
    with pytest.raises(ValueError, match="512"):
        tfa.flash_attention(q640, k640, v640)


# heads the kernels take after padding (72 → 80 on the wgmma kernels, 200
# → 256, 384 → 512) and the D 512 kernels: T and S off the tiles,
# GQA, segments with rows that see no key, a q_offset, non-causal S != T
@pytest.mark.cuda
@pytest.mark.parametrize("D,T,S,Hkv,causal,q_offset,segments", [
    (72, 300, 364, 2, True, 64, True), (200, 300, 300, 2, True, 0, False),
    (200, 300, 364, 4, True, 64, True), (384, 300, 364, 2, True, 64, True),
    (384, 200, 330, 4, False, 0, False), (512, 300, 364, 2, True, 64, True),
    (512, 300, 300, 4, True, 0, False), (512, 200, 330, 1, False, 0, False)])
def test_flash_takes_every_head_dim_up_to_512_on_card(
        cuda_device, D, T, S, Hkv, causal, q_offset, segments):
    _flash_check(cuda_device, D + T + Hkv, 2, T, S, 4, Hkv, D, causal,
                 q_offset, segments)


# (head_dim, G) of the dense families the engine serves beside 128 x {1,
# 4, 8}: Gemma-2-9B (256, 2), Phi-3-mini (96, 1), MiniCPM-2B (64, 1),
# StarCoder2-7B (128, 9), GLM-4-9B (128, 16), StarCoder's MQA (128, 48)
FAMILY_SHAPES = [(256, 2), (96, 1), (64, 1), (128, 9), (128, 16), (128, 48)]
FAMILY_IDS = [f"hd{h}-g{g}" for h, g in FAMILY_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}] + WINDOW_CAP,
                         ids=["plain", "window", "cap", "both"])
@pytest.mark.parametrize("hd,G", FAMILY_SHAPES, ids=FAMILY_IDS)
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_family_shapes_extend_kernel_matches_plain_on_card(cuda_device, mode,
                                                           hd, G, opts):
    """The extend kernel at every head width and group the zoo needs, in
    every KV mode, with and without the window and the cap: the extend
    bounds, padded lane zeros, and with an option the off-control."""
    gen = torch.Generator(device=cuda_device).manual_seed(hd + G)
    hkv, T = 2, 200 if G < 16 else 60
    k, v, kv = _mode_rows(gen, cuda_device, mode, hkv, hd=hd)
    gain = 8.0 if opts else 1.0
    q = gain * torch.randn((4, T, hkv * G, hd), generator=gen,
                           device=cuda_device, dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    offs = torch.tensor([0, 150, 3, 0], **i32)
    lens = torch.tensor([T, 150 + T, 3 + T - 9, 0], **i32)
    rows = torch.tensor([3, 1, 0, 2], **i32)
    launches = tra.ragged_attention.launches + \
        tra.ragged_attention.launches_int8 + tra.ragged_attention.launches_int4
    got = tra.ragged_attention(q, k, v, lens, offs, rows,
                               layer=torch.tensor([1], **i32), **kv, **opts)
    want = tra.ragged_attention_plain(q.float(), k.float() if mode == "bf16"
                                      else k, v.float() if mode == "bf16"
                                      else v, lens, offs, rows, layer=1,
                                      **kv, **opts)
    torch.cuda.synchronize()
    assert tra.ragged_attention.launches + \
        tra.ragged_attention.launches_int8 + \
        tra.ragged_attention.launches_int4 == launches + 1
    diff = (got.float() - want).abs()
    assert bool((diff <= 2e-2 + RND * want.abs()).all())
    assert _lane_rel(got, want, (0, 1, 2)) <= 1e-2
    assert bool((got[3] == 0).all())
    if opts:
        off = tra.ragged_attention_plain(
            q.float(), k.float() if mode == "bf16" else k,
            v.float() if mode == "bf16" else v, lens, offs, rows, layer=1,
            **kv)
        assert (got.float() - off).abs().max().item() > \
            10 * diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}] + WINDOW_CAP,
                         ids=["plain", "window", "cap", "both"])
@pytest.mark.parametrize("hd,G", FAMILY_SHAPES, ids=FAMILY_IDS)
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_family_shapes_decode_kernel_matches_plain_on_card(cuda_device, mode,
                                                           hd, G, opts):
    """The decode kernel at every head width and group the zoo needs
    (G 48 over blocks of 8 heads), every KV mode, the window and the cap:
    row writes exact (packed bytes and scales too), the decode bounds,
    and two calls on the same inputs agree bitwise."""
    lens = (300, 0, 201, 512)
    out, want, state, plain, args = _decode_case(
        cuda_device, 7 * hd + G, mode, 2, G, lens, 512, opts,
        q_gain=8.0 if opts else 1.0, hd=hd)
    for got_t, want_t in zip(state, plain):
        assert torch.equal(got_t, want_t)
    diff = (out.float() - want).abs()
    assert bool((diff <= 3e-3 + RND * want.abs()).all())
    assert _lane_rel(out, want, (0, 2, 3)) <= 8e-3
    assert bool((out[1] == 0).all())
    q, kn, vn, lens_t, rows, kv = args
    again = tra.ragged_decode_attention(
        q, kn, vn, *state[:2], lens_t, rows,
        layer=torch.tensor([1], dtype=torch.int32, device=cuda_device),
        **dict(kv, **dict(zip(("k_scales", "v_scales"), state[2:]))),
        **opts)[0]
    torch.cuda.synchronize()
    assert torch.equal(again, out)


def _extend_case(dev, seed, mode, hd, G, T, Sr, lanes, opts, gain=1.0,
                 hkv=2):
    """One extend call through the kernel and through the twin on the
    same rows of Sr tokens; lanes: (q_offset, tokens), kv_len = q_offset +
    tokens (0 tokens: a padded lane) → (got, want, call, twin), call()
    and twin(**options) repeating them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, v, kv = _mode_rows(gen, dev, mode, hkv, Sr, hd)
    q = gain * torch.randn((4, T, hkv * G, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=dev)
    offs = torch.tensor([o for o, _ in lanes], **i32)
    lens = torch.tensor([o + n if n else 0 for o, n in lanes], **i32)
    rows = torch.tensor([3, 1, 0, 2], **i32)
    layer = torch.tensor([1], **i32)

    def call():
        return tra.ragged_attention(q, k, v, lens, offs, rows, layer=layer,
                                    **kv, **opts)

    def twin(**options):
        return tra.ragged_attention_plain(
            q.float(), k.float() if mode == "bf16" else k,
            v.float() if mode == "bf16" else v, lens, offs, rows, layer=1,
            **kv, **options)
    got, want = call(), twin(**opts)
    torch.cuda.synchronize()
    return got, want, call, twin


def _extend_bounds(got, want, lanes, opts, twin):
    """The extend bounds (bf16 rounding of the output on top), lane rel
    1e-2, padded lanes zero, and with an option the off-control."""
    diff = (got.float() - want).abs()
    assert bool((diff <= 2e-2 + RND * want.abs()).all()), diff.max().item()
    live = [i for i, (_, n) in enumerate(lanes) if n]
    assert _lane_rel(got, want, live) <= 1e-2
    for i, (_, n) in enumerate(lanes):
        if not n:
            assert bool((got[i] == 0).all())
    if opts:
        assert (got.float() - twin()).abs().max().item() > \
            10 * diff.max().item()


# extend_d256_kernel (head_dim 256): rows of 1024, T 700, so that a block
# walks many 64-key tiles; a q_offset off the tile (300), kv_lens off the
# tile (700, 1000, 687), int4 walks across 256-token segments, a padded
# lane; a window of 300 whose lower edge cuts tiles inside blocks, the cap
D256_LANES = ((0, 700), (300, 700), (37, 650), (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}] + [dict(window=300), dict(
    logit_cap=50.0), dict(window=300, logit_cap=50.0)],
    ids=["plain", "window", "cap", "both"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_extend_d256_kernel_matches_plain_on_card(cuda_device, mode, G,
                                                  opts):
    """gemma-7b's MHA (G 1) and Gemma-2-9B's G 2 at head_dim 256: the
    extend bounds against the twin in every KV mode, with and without the
    window and the cap (q scaled by 8 with an option)."""
    got, want, _, twin = _extend_case(
        cuda_device, 256 + G, mode, 256, G, 700, 1024, D256_LANES, opts,
        gain=8.0 if opts else 1.0)
    _extend_bounds(got, want, D256_LANES, opts, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_extend_d256_kernel_is_bitwise_repeatable_on_card(cuda_device,
                                                          mode):
    """Two calls of extend_d256_kernel on the same inputs agree bitwise
    (no atomics in its reduction), with the window and the cap."""
    got, _, call, _ = _extend_case(cuda_device, 7, mode, 256, 2, 700, 1024,
                                   D256_LANES,
                                   dict(window=300, logit_cap=50.0))
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(again, got)


# head widths on and off the kernels' compile-time ones, one or more for
# each route: 16, 48 and 64 (extend_kernel<64>), 80 and 96
# (extend_kernel<96>: three 32-column boxes under the 64-byte swizzle),
# 112 (extend_kernel<128>), 160 and 208 (extend_d256_kernel); StableLM-3B's
# heads are 80 wide, Phi-3-mini's 96, MiniCPM-2B's 64
PADDED_HEAD_DIMS = [16, 48, 64, 80, 96, 112, 160, 208]


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(window=100, logit_cap=50.0), {}],
                         ids=["window-cap", "plain"])
@pytest.mark.parametrize("hd", PADDED_HEAD_DIMS)
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_ragged_kernels_take_every_head_dim_on_card(cuda_device, mode, hd,
                                                    opts):
    """Both kernels at head_dims that are multiples of 16 on and off the
    kernels' widths (the columns up to the kernel's width read as zeros),
    every KV mode, with the window and the cap (q scaled by 8) and
    without, G 2, lanes at q_offsets 150 and 3 (prefix hits): the extend
    bounds with the off-control; decode row writes exact, the decode
    bounds, the off-control."""
    lanes = ((0, 200), (150, 200), (3, 191), (0, 0))
    gain = 8.0 if opts else 1.0
    got, want, _, twin = _extend_case(cuda_device, hd, mode, hd, 2, 200, 512,
                                      lanes, opts, gain=gain)
    _extend_bounds(got, want, lanes, opts, twin)
    out, want, state, plain, args = _decode_case(
        cuda_device, 3 * hd, mode, 2, 2, (300, 0, 201, 512), 512, opts,
        q_gain=gain, hd=hd)
    for got_t, want_t in zip(state, plain):
        assert torch.equal(got_t, want_t)
    diff = (out.float() - want).abs()
    assert bool((diff <= 3e-3 + RND * want.abs()).all()), diff.max().item()
    assert _lane_rel(out, want, (0, 2, 3)) <= 8e-3
    assert bool((out[1] == 0).all())
    if not opts:
        return
    q, kn, vn, lens_t, rows, kv = args
    off = tra.ragged_decode_attention_plain(
        q.float(), kn, vn, *[t.clone() for t in plain[:2]], lens_t, rows,
        layer=1, **dict(kv, **dict(zip(("k_scales", "v_scales"),
                                       [t.clone() for t in plain[2:]]))))[0]
    assert (out.float() - off).abs().max().item() > 10 * diff.max().item()


# extend_kernel at its narrow widths over rows of 1024, T 700, so that a
# block walks many 128-key tiles: lanes at q_offsets 300 and 37 (prefix
# hits; kv_lens 1000 and 687 off the tiles, int4 across 256-token
# segments) and a padded lane; MiniCPM-2B (64, G 1), Qwen2-0.5B's 14 query
# heads over 2 KV heads (64, G 7), StableLM-3B (80, G 1), Phi-3-mini
# (96, G 1); the window of 300 cuts tiles inside blocks
NARROW_SHAPES = [(64, 1), (64, 7), (80, 1), (96, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}, dict(window=300),
                                  dict(window=300, logit_cap=50.0)],
                         ids=["plain", "window", "both"])
@pytest.mark.parametrize("hd,G", NARROW_SHAPES,
                         ids=[f"hd{h}-g{g}" for h, g in NARROW_SHAPES])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_extend_narrow_kernel_prefix_hits_on_card(cuda_device, mode, hd, G,
                                                  opts):
    """extend_kernel<64> and <96> against the twin in every KV mode, at
    lanes that extend a cached prefix, with G 1 and 7, with and without
    the window and the cap (q scaled by 8 with an option): the extend
    bounds and the off-control."""
    got, want, _, twin = _extend_case(
        cuda_device, 64 * hd + G, mode, hd, G, 700, 1024, D256_LANES, opts,
        gain=8.0 if opts else 1.0)
    _extend_bounds(got, want, D256_LANES, opts, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_extend_narrow_kernel_is_bitwise_repeatable_on_card(cuda_device,
                                                            mode, hd):
    """Two calls of extend_kernel<64> / <96> on the same inputs agree
    bitwise (no atomics in its reduction), with the window and the cap."""
    got, _, call, _ = _extend_case(cuda_device, 11, mode, hd, 1, 700, 1024,
                                   D256_LANES,
                                   dict(window=300, logit_cap=50.0))
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_extend_routes_name_no_mma_kernel_on_card(cuda_device):
    """The profiler's names of the extend launches at every route's head
    widths (16 to 256) and every KV mode: extend_kernel at the width
    kernel_head_width gives (<= 128), extend_d256_kernel above, and no
    extend_mma_kernel anywhere; one launch a call on launches_w<width>."""
    from torch.profiler import ProfilerActivity, profile
    lanes = ((0, 60), (40, 60), (0, 0), (5, 30))
    for hd in (16, 48, 64, 80, 96, 112, 128, 208, 256):
        w = tra.kernel_head_width(hd)
        want = f"extend_kernel<{w}," if w <= 128 else "extend_d256_kernel<"
        for mode in ("bf16", "int8", "int4"):
            before = getattr(tra.ragged_attention, f"launches_w{w}")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _extend_case(cuda_device, hd, mode, hd, 2, 60, 256, lanes,
                             {})
            names = [e.key for e in prof.key_averages()
                     if "extend" in e.key]
            assert names and all(want in n for n in names), (hd, names)
            assert not any("mma" in n for n in names), (hd, names)
            assert getattr(tra.ragged_attention,
                           f"launches_w{w}") == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [72, 264])
def test_ragged_kernels_refuse_head_dims_off_the_rule_on_card(cuda_device,
                                                              hd):
    """A head_dim that is not a multiple of 16, or is above 256, raises in
    both kernels with a message that names the rule (no fallback to the
    twins)."""
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    k, v, _ = _mode_rows(gen, cuda_device, "bf16", 2, 256, hd)
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    q = torch.randn((4, 8, 4, hd), **bf)
    lens = torch.tensor([8, 8, 8, 0], **i32)
    rows = torch.tensor([0, 1, 2, 3], **i32)
    calls = tra.ragged_attention_plain.calls
    with pytest.raises(ValueError, match="multiple of 16 from 16 to 256"):
        tra.ragged_attention(q, k, v, lens, torch.zeros(4, **i32), rows,
                             layer=1)
    with pytest.raises(ValueError, match="multiple of 16 from 16 to 256"):
        tra.ragged_decode_attention(
            q[:, :1], torch.randn((4, 2, hd), **bf),
            torch.randn((4, 2, hd), **bf), k, v, lens, rows, layer=1)
    assert tra.ragged_attention_plain.calls == calls


@pytest.mark.cuda
def test_flash_takes_head_dim_256_on_card(cuda_device):
    """A head_dim-256 model's unmasked batch of T >= 128 (Gemma v1
    offline, DPO over a Gemma policy) goes to the flash kernels by `mha`'s
    rule (head_dim % 128 == 0): forward and backward at D 256 against the
    fp32 twin (before the D 256 kernels this raised)."""
    from aurora_tpu_torch.ops.attention import mha
    q, k, v, g = _flash_inputs(cuda_device, 256, 2, 256, 256, 4, 2, 256)
    counters = ("launches_fwd", "launches_dkv", "launches_dq")
    launches = [getattr(tfa.flash_attention, c) for c in counters]
    (got,), got_g = _grads(lambda *a: mha(*a, causal=True), q, k, v, g)
    (want,), want_g = _grads(
        lambda *a: tfa.flash_attention_plain(*a, causal=True)[0],
        q.float(), k.float(), v.float(), g.float())
    torch.cuda.synchronize()
    assert [getattr(tfa.flash_attention, c) for c in counters] == [
        n + 1 for n in launches]
    assert (got.float() - want).abs().max().item() <= 2e-2
    for name, a, b in zip("qkv", got_g, want_g):
        assert _grad_rel(a, b) <= 1.5e-2, name


# The D 256 and D 512 kernels (two warpgroups splitting the head's
# columns) off their tiles: T and S off 16, 32 and 64, the diagonal
# across tiles, GQA, segments with rows that see no key, non-causal with
# S != T; and google/gemma-7b's training shape (16 heads, T 2048)
WIDE_WIDTHS = [256, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDE_WIDTHS)
@pytest.mark.parametrize("B,T,S,H,Hkv,causal,q_offset,segments", [
    (2, 300, 300, 4, 4, True, 0, False), (2, 300, 364, 4, 2, True, 64, True),
    (2, 200, 330, 4, 4, False, 0, False), (2, 300, 300, 4, 1, False, 0, True),
    (1, 2048, 2048, 16, 16, True, 0, False), (2, 77, 77, 4, 4, True, 0, False),
    (1, 130, 200, 4, 2, True, 70, False), (2, 64, 100, 4, 4, False, 0, False),
    (1, 129, 129, 2, 2, True, 0, True)])
def test_flash_wide_kernels_match_plain_on_card(cuda_device, B, T, S, H, Hkv,
                                                causal, q_offset, segments,
                                                width):
    _flash_check(cuda_device, width + T + Hkv, B, T, S, H, Hkv, width,
                 causal, q_offset, segments)


def _flash_fwd_op(q, k, v, causal=True, q_offset=0, segs=(None, None)):
    qf, kf, vf, qs, ks = tfa._card_inputs(q, k, v, *segs)
    return torch.ops.aurora_tpu_torch.flash_fwd(
        qf, kf, vf, qs, ks, causal, q.shape[-1] ** -0.5, q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDE_WIDTHS)
def test_flash_wide_forward_masks_whole_rows_on_card(cuda_device, width):
    """Query rows whose segment id no key carries see nothing: out 0 and
    lse -2.3819763e38 (the reference's mask value), at T off the 64- and
    128-row q tiles and S off the 32- and 64-key tiles; the other rows'
    lse within 1e-4 of the fp32 twin's."""
    q, k, v, _ = _flash_inputs(cuda_device, 31, 2, 203, 203, 4, 2, width)
    seg = torch.zeros((2, 203), dtype=torch.int32, device=cuda_device)
    seg[:, 90:] = 1
    qseg = seg.clone()
    qseg[1, 150:] = 7
    qseg[0, :5] = 7
    out, lse = _flash_fwd_op(q, k, v, segs=(qseg, seg))
    _, want = tfa.flash_attention_plain(
        q.float(), k.float(), v.float(), causal=True, q_segment_ids=qseg,
        kv_segment_ids=seg)
    torch.cuda.synchronize()
    dead = (qseg == 7)                              # [B, T]
    assert bool((out[dead] == 0).all())
    assert bool((lse.transpose(1, 2)[dead] == -2.3819763e38).all())
    live = ~dead
    assert (lse.transpose(1, 2)[live]
            - want.transpose(1, 2)[live]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDE_WIDTHS)
def test_flash_wide_forward_is_bitwise_repeatable_on_card(cuda_device,
                                                          width):
    q, k, v, _ = _flash_inputs(cuda_device, 12, 2, 333, 333, 4, 4, width)
    runs = [_flash_fwd_op(q, k, v) for _ in range(3)]
    torch.cuda.synchronize()
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDE_WIDTHS)
def test_flash_wide_backward_is_deterministic_on_card(cuda_device, width):
    q, k, v, g = _flash_inputs(cuda_device, 9, 2, 300, 300, 4, 4, width)
    runs = [_grads(lambda *a: tfa.flash_attention(*a, causal=True),
                   q, k, v, g)[1] for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


@pytest.mark.cuda
def test_remat_policies_on_card(cuda_device):
    """One bf16 train step of a 2-layer model with 128-wide heads (so the
    flash kernels run) under each remat setting: the same loss and grad
    norm; the forward kernel runs once a layer without remat and with
    dots_saveable (its output is kept), twice with full remat and with
    dots_with_no_batch_dims_saveable (recomputed)."""
    import dataclasses

    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.train import trainer

    tiny = AuroraConfig.tiny()
    llm = dataclasses.replace(LlamaConfig.tiny(vocab_size=512),
                              hidden_size=256, intermediate_size=512,
                              num_hidden_layers=2, num_attention_heads=2,
                              num_key_value_heads=2)
    cfg = dataclasses.replace(tiny, llm=llm, projector=dataclasses.replace(
        tiny.projector, llm_hidden_size=256))
    ids = torch.randint(3, 500, (2, 128), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
    got = {}
    for remat, policy in ((False, None), (True, None),
                          (True, "dots_with_no_batch_dims_saveable"),
                          (True, "dots_saveable")):
        model = init_aurora(cfg, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(
                                cuda_device).manual_seed(0))
        tcfg = trainer.TrainConfig(remat=remat, remat_policy=policy,
                                   max_steps=10)
        before = tfa.flash_attention.launches_fwd
        _, m = trainer.make_train_step(cfg, tcfg)(
            trainer.init_train_state(model, tcfg),
            {"input_ids": ids, "labels": ids})
        got[(remat, policy)] = (m["loss"].item(), m["grad_norm"].item(),
                                tfa.flash_attention.launches_fwd - before)
    base = got[(False, None)]
    for key, (loss, gnorm, _) in got.items():
        assert abs(loss - base[0]) <= 1e-5 * abs(base[0]), key
        assert abs(gnorm - base[1]) <= 1e-5 * base[1], key
    assert [n for _, _, n in got.values()] == [2, 4, 4, 2]


@pytest.mark.cuda
def test_dense_generate_repeats_on_card(cuda_device):
    """The caption path's dense greedy decode (masked attention over a KV
    cache, `mha_reference`) run three times on the same prompt: equal
    tokens and logprobs, bit for bit. SDPA's cuDNN backend, which PyTorch
    picks for these masked calls on an H100, did not repeat (chip_smoke
    `[infer-beam]`); `llama_apply` keeps it off over a KV cache
    (ops/attention.py `REPEATABLE_SDPA`). 7B widths and the
    caption's 1,423-token prompt at 8 layers: with cuDNN allowed the
    decode failed to repeat here, at 2 layers it repeated."""
    from aurora_tpu_torch.generate.engine import generate
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel

    cfg = LlamaConfig(vocab_size=32000, hidden_size=4096,
                      intermediate_size=8192, num_hidden_layers=8,
                      num_attention_heads=32, num_key_value_heads=32)
    model = build(LlamaModel, cfg, device=cuda_device, dtype=torch.bfloat16,
                  generator=torch.Generator(cuda_device).manual_seed(0))
    ids = torch.randint(3, 32000, (1, 1423), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
    emb = model.embed_tokens[ids].detach()
    mask = torch.ones(ids.shape, dtype=torch.bool, device=cuda_device)
    runs = [generate(model, cfg, emb, mask, max_new_tokens=16,
                     return_logprobs=True, eos_ids=(-1,)) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r.tokens, runs[0].tokens)
        assert torch.equal(r.logprobs, runs[0].logprobs)


_VIT_REPEAT = r'''
import hashlib, sys
import torch
from aurora_tpu_torch.models.init import build
from aurora_tpu_torch.models.vit import ViTConfig, VisionTransformer, vit_encode
dev = torch.device("cuda", 0)
if sys.argv[1] == "sdpa-first":   # another masked SDPA call first
    q = torch.randn((4, 32, 300, 128), device=dev, dtype=torch.bfloat16)
    torch.nn.functional.scaled_dot_product_attention(
        q, q, q, attn_mask=torch.ones((300, 300), dtype=torch.bool,
                                      device=dev).tril())
cfg = ViTConfig.dfn5b_vit_h_378()
vit = build(VisionTransformer, cfg, device=dev, dtype=torch.bfloat16,
            generator=torch.Generator(dev).manual_seed(0))
px = torch.randn((8, 3, 378, 378), device=dev,
                 generator=torch.Generator(dev).manual_seed(1))
with torch.no_grad():
    out = vit_encode(vit, px.to(torch.bfloat16), kept_ratio=0.2)
print(hashlib.md5(out.float().cpu().numpy().tobytes()).hexdigest())
'''


@pytest.mark.cuda
def test_vit_encode_repeats_across_processes_on_card(cuda_device):
    """ViT-H/14-378 with ToMe at kept ratio 0.2 on 8 frames, encoded in
    three fresh processes (one after another masked SDPA call): the same
    bits. Its attention carries ToMe's size bias, a masked SDPA call, for
    which PyTorch picks cuDNN attention on an H100; there the embeddings
    differed from one process to the next (chip_smoke's bf16 serving and
    caption numbers with them), so the ViT keeps to `REPEATABLE_SDPA`."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    outs = [subprocess.run([sys.executable, "-c", _VIT_REPEAT, arg], env=env,
                           capture_output=True, text=True, timeout=300,
                           check=True).stdout.strip()
            for arg in ("fresh", "fresh", "sdpa-first")]
    assert len(outs[0]) == 32 and len(set(outs)) == 1, outs


@pytest.mark.cuda
def test_train_step_repeats_on_card(cuda_device):
    """A masked, packed multimodal train step with everything trainable
    (the language stage: ViT-H/14-378 at 4 layers, Vicuna-7B widths at 2
    layers, kept ratio 0.2, bf16), taken twice from the same weights: the
    same loss, grad norm and updated weights, bit for bit. With SDPA's
    default backends the backward did not repeat on an H100 (chip_smoke
    `[train-cli]`'s resumed grad norms differed in the 7th digit); the
    step runs under `train.trainer.repeatable_step`."""
    import dataclasses
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    from aurora_tpu_torch.train.trainer import (TrainConfig,
                                                init_train_state,
                                                make_train_step)
    base = AuroraConfig.auroracap_7b()
    cfg = dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, num_hidden_layers=4),
        llm=dataclasses.replace(base.llm, num_hidden_layers=2))
    tcfg = TrainConfig(lr=2e-5, max_steps=10, kept_ratio=0.2)
    g = torch.Generator(cuda_device).manual_seed(2)
    T = 600
    ids = torch.randint(3, 32000, (2, T), device=cuda_device, generator=g)
    ids[:, 1] = ids[:, 300] = -200
    segs = torch.zeros((2, T), dtype=torch.int64, device=cuda_device)
    segs[:, 300:] = 1
    mask = torch.ones((2, T), dtype=torch.bool, device=cuda_device)
    mask[1, 500:] = False
    segs[1, 500:] = -1
    labels = torch.where(mask & (ids >= 0), ids, -100)
    px = torch.randn((2, 2, 3, 378, 378), device=cuda_device, generator=g)
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask,
             "segment_ids": segs, "pixel_values": px.to(torch.bfloat16)}
    runs = []
    for _ in range(2):
        model = init_aurora(cfg, device=cuda_device, dtype=torch.bfloat16,
                            generator=torch.Generator(
                                cuda_device).manual_seed(0))
        state = init_train_state(model, tcfg)
        state, m = make_train_step(cfg, tcfg)(state, batch)
        runs.append((m["loss"].item(), m["grad_norm"].item(),
                     {k: v.clone() for k, v in model.state_dict().items()}))
        del model, state
    assert runs[0][:2] == runs[1][:2], (runs[0][:2], runs[1][:2])
    assert all(torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())


@pytest.mark.cuda
def test_http_server_streams_what_it_answers_on_card(cuda_device):
    """The port's HTTP server (serve/api.py) on the card at 8 layers of 7B
    widths, W4 stripes + int8 KV: a streamed /generate and the same
    request sent plain (each from an empty prefix cache) give the same
    text; the W4A8 and int8 attention kernels launch, the plain twins
    never."""
    import http.client
    import json

    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine

    class Tok:
        eos_token_id = 2

        def encode(self, text, add_special_tokens=True):
            return [1] + [b + 3 for b in text.encode()]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(0x4E00 + i) for i in ids if i > 2)

    cfg = LlamaConfig(vocab_size=32000, hidden_size=4096,
                      intermediate_size=11008, num_hidden_layers=8,
                      num_attention_heads=32, num_key_value_heads=32,
                      rope_linear_scaling=4.0)
    model = build(LlamaModel, cfg, device=cuda_device, dtype=torch.bfloat16,
                  generator=torch.Generator(cuda_device).manual_seed(0))
    engine = ServeEngine(model, cfg, EngineConfig(
        weight_quant="int4", kv_quant="int8", max_batch=4,
        max_seq_len=512, prefill_buckets=(64,)), tokenizer=Tok())
    del model
    kernels = [(tra.ragged_attention, "launches_int8"),
               (tra.ragged_decode_attention, "launches_int8"),
               (tqm.w4a8_matmul_tiled, "launches")]
    plains = [(tra.ragged_attention_plain, "calls"),
              (tra.ragged_decode_attention_plain, "calls"),
              (tqm.w4a8_matmul_tiled_plain, "calls")]
    for obj, attr in kernels + plains:
        setattr(obj, attr, 0)
    body = {"text": "USER: Describe the video in detail. ASSISTANT:",
            "max_new_tokens": 24, "temperature": 0.0}

    def send(port, path, payload):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", path, json.dumps(payload),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    with ServerThread(ServingLoop(engine, Tok())) as srv:
        status, plain = send(srv.port, "/generate", body)
        assert status == 200
        assert send(srv.port, "/flush_cache", {})[0] == 200
        status, raw = send(srv.port, "/generate", {**body, "stream": True})
        assert status == 200
    events = [ln[6:] for ln in raw.decode().splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    streamed = "".join(json.loads(e)["text"] for e in events[:-1])
    assert streamed == json.loads(plain)["text"] and streamed
    assert all(getattr(obj, attr) > 0 for obj, attr in kernels)
    assert all(getattr(obj, attr) == 0 for obj, attr in plains)


def _gmm_inputs(dev, seed, M, K, N, E, layout, int8):
    """Sorted rows xs [M, K] bf16, experts [E, K, N] (bf16, or int8 with
    fp32 scales) and offsets by `layout`: "spread" (random sizes, some 0),
    "one" (expert 1 takes every row, the others none)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    if int8:
        w = torch.randint(-127, 128, (E, K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((E, N), generator=gen, device=dev) * 1e-3 + 1e-4
    else:
        w = (torch.randn((E, K, N), generator=gen, device=dev)
             * 0.05).to(torch.bfloat16)
        scale = None
    if layout == "one":
        sizes = torch.zeros(E, dtype=torch.int64)
        sizes[1] = M
    else:
        cuts = torch.sort(torch.randint(0, M + 1, (E - 1,),
                                        generator=torch.Generator()
                                        .manual_seed(seed))).values
        edges = torch.cat([torch.zeros(1, dtype=torch.int64), cuts,
                           torch.full((1,), M)])
        sizes = edges[1:] - edges[:-1]
        sizes[0] = 0                        # an expert with no rows
        sizes[-1] = M - sizes[:-1].sum()
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         sizes.cumsum(0)]).to(torch.int32).to(dev)
    return xs, w, scale, offsets


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["spread", "one"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M,K,N,E", [(8, 4096, 1024, 8),
                                     (4096, 4096, 1024, 8),
                                     (48, 2048, 768, 128),
                                     (777, 2048, 1408, 64),
                                     (37, 1408, 2048, 64),
                                     (32, 2048, 768, 8),
                                     (33, 2048, 768, 8),
                                     (24, 1440, 784, 8),
                                     (600, 1440, 784, 8)])
def test_moe_grouped_mm_kernel_matches_plain_on_card(cuda_device, M, K, N, E,
                                                     int8, layout):
    """The grouped-expert kernel against its plain twin (the same bf16
    rows, the same dequantized experts bf16(q)·bf16(s)): fp32 output
    within 1e-5 of max |want| (only the fp32 order of the sum differs),
    bf16 output within one bf16 rounding of the twin's fp32 result;
    an expert with no rows and one with every row; repeated launches
    bitwise equal. Both plans of `moe_plan`: decode at up to 4 rows an
    expert (M 32 at E 8, its edge, with token tiles of 16), extend past
    it (M 33); K 1440 off the 64-k stages, N 784 off the column tiles."""
    from aurora_tpu_torch.ops import moe as tmoe
    xs, w, scale, offs = _gmm_inputs(cuda_device, M + E, M, K, N, E, layout,
                                     int8)
    want = tmoe.moe_grouped_mm_reference(xs, w, offs, scale,
                                         out_dtype=torch.float32)
    plan = tmoe.moe_plan(M, K, N, E, int8)
    before = tmoe.moe_grouped_mm.launches
    by_plan = getattr(tmoe.moe_grouped_mm, "launches_" + plan.kind)
    got = tmoe.moe_grouped_mm(xs, w, offs, scale, out_dtype=torch.float32)
    again = tmoe.moe_grouped_mm(xs, w, offs, scale, out_dtype=torch.float32)
    got16 = tmoe.moe_grouped_mm(xs, w, offs, scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tmoe.moe_grouped_mm.launches == before + 3
    assert getattr(tmoe.moe_grouped_mm, "launches_" + plan.kind) \
        == by_plan + 3
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert ((got16.float() - want).abs()
            <= 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()).all()


def _gmm_into(out, xs, w, scale, offs):
    """The kernel's C entry point by `moe_plan`, into a given output
    (the wrapper allocates its own) → the plan."""
    from aurora_tpu_torch.ops import moe as tmoe
    from aurora_tpu_torch.ops.cuda_build import load_library
    (M, K), (E, _, N) = xs.shape, w.shape
    quant = w.dtype == torch.int8
    plan = tmoe.moe_plan(M, K, N, E, quant, torch.cuda.get_device_properties(
        xs.device).multi_processor_count)
    err = load_library().aurora_moe_grouped_mm(
        xs.data_ptr(), w.data_ptr(), scale.data_ptr() if quant else 0,
        offs.data_ptr(), out.data_ptr(), M, K, N, E, int(quant),
        int(out.dtype == torch.float32), int(plan.kind == "decode"),
        plan.tokens, plan.grid[0],
        torch.cuda.current_stream(xs.device).cuda_stream)
    assert err == 0
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("M,kind", [(20, "decode"), (700, "extend")])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_moe_grouped_mm_leaves_rows_outside_the_groups_on_card(
        cuda_device, M, kind, int8):
    """Rows before offsets[0] and past offsets[E] (an output filled with
    NaN): the kernel leaves them NaN in both plans, and the rows inside
    are the wrapper's, bit for bit."""
    from aurora_tpu_torch.ops import moe as tmoe
    E, K, N = 8, 1024, 1024
    xs, w, scale, _ = _gmm_inputs(cuda_device, M, M, K, N, E, "spread",
                                  int8)
    lo, hi = 5, M - 7
    cuts = torch.sort(torch.randint(lo, hi + 1, (E - 1,), generator=torch
                                    .Generator().manual_seed(M))).values
    offs = torch.cat([torch.tensor([lo]), cuts, torch.tensor([hi])]).to(
        torch.int32).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.full((M, N), float("nan"), dtype=dtype,
                         device=cuda_device)
        assert _gmm_into(out, xs, w, scale, offs).kind == kind
        want = tmoe.moe_grouped_mm(xs, w, offs, scale, out_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.isnan(out[:lo]).all() and torch.isnan(out[hi:]).all()
        assert torch.equal(out[lo:hi], want[lo:hi])
        assert not torch.isnan(out[lo:hi]).any()


@pytest.mark.cuda
def test_moe_grouped_mm_rejects_what_the_kernel_does_not_take(cuda_device):
    """No fallback: fp32 rows, a K off the 32-step, a scale without int8
    weights and CPU offsets raise instead of running the twin."""
    from aurora_tpu_torch.ops import moe as tmoe
    xs, w, _, offs = _gmm_inputs(cuda_device, 0, 16, 64, 32, 4, "spread",
                                 False)
    for args in ((xs.float(), w, offs, None),
                 (xs[:, :48].contiguous(), w[:, :48].contiguous(), offs,
                  None),
                 (xs, w, offs.cpu(), None)):
        with pytest.raises((TypeError, ValueError)):
            tmoe.moe_grouped_mm(*args)
    with pytest.raises(TypeError):
        tmoe.moe_grouped_mm(xs, w, offs, torch.ones((4, 32),
                                                    device=cuda_device))


def _moe_layer(dev, int8, shared=True):
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve import engine as teng
    cfg = LlamaConfig(vocab_size=512, hidden_size=1024,
                      intermediate_size=1536, num_hidden_layers=1,
                      num_attention_heads=8, num_key_value_heads=2,
                      num_experts=8, num_experts_per_tok=2)
    model = build(lambda c, device, dtype: LlamaModel(
        c, device=device, dtype=dtype, shared_inter=512 if shared else 0,
        shared_gate=shared), cfg, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(dev).manual_seed(0))
    if int8:
        model = teng.quantize_weights_int8(model)
    return cfg, model.layers[0]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_moe_layer_makes_no_host_sync_on_card(cuda_device, int8):
    """A MoE layer's MLP (routing, the sort, the offsets, three grouped
    products, the combine, the gated shared expert) at 4 decode rows and
    at a 2 x 300 extend, under torch.cuda.set_sync_debug_mode("error"):
    nothing waits on the card."""
    from aurora_tpu_torch.models.llama import moe_layer_mlp
    from aurora_tpu_torch.ops import moe as tmoe
    cfg, lp = _moe_layer(cuda_device, int8)
    xs = [torch.randn(shape, device=cuda_device).to(torch.bfloat16)
          for shape in ((4, 1, 1024), (2, 300, 1024))]
    with torch.no_grad():
        for x in xs:                    # build and warm up first
            moe_layer_mlp(cfg, lp, x, grouped=True)
        torch.cuda.synchronize()
        before = tmoe.moe_grouped_mm.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [moe_layer_mlp(cfg, lp, x, grouped=True) for x in xs]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tmoe.moe_grouped_mm.launches == before + 12
    for x, out in zip(xs, outs):
        want = moe_layer_mlp(cfg, lp, x, grouped=False)
        assert torch.isfinite(out).all()
        assert ((out.float() - want.float()).abs().max()
                <= 2e-2 * want.float().abs().max())


def _serve_twice(model, cfg, prompts, **ecfg):
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    outs = []
    for _ in range(2):
        eng = ServeEngine(model, cfg, EngineConfig(
            max_batch=len(prompts), max_seq_len=1024, kv_chunk=512,
            prefill_buckets=(512,), decode_steps=4, **ecfg), seed=0)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=str(i), input_ids=list(p),
                                    max_new_tokens=16, eos_ids=(),
                                    logprobs=True))
        done = {}
        while eng.has_work():
            done.update({r.rid: r for r in eng.step()})
        outs.append({k: (r.output_ids, r.output_logprobs)
                     for k, r in done.items()})
        del eng
    return outs


@pytest.mark.cuda
def test_moe_engines_repeat_on_card(cuda_device):
    """Mixtral-8x7B's widths at 2 layers (W8, int8 KV: the grouped kernel
    on int8 experts) and DeepSeek-V2-Lite's at 3 layers (bf16 latents,
    the fp32 expert path's two-part down product), 4 prompts of 400-500
    ids, 16 greedy tokens: two engines over the same weights give the
    same tokens and logprobs, bit for bit."""
    import dataclasses

    from aurora_tpu_torch.models.deepseek_v2 import (DeepseekV2Config,
                                                     init_deepseek_v2)
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve import engine as teng
    from aurora_tpu_torch.serve.mla import deepseek_serving_params
    gen = torch.Generator(cuda_device).manual_seed(0)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(3, 32000, (int(n),), generator=rng).tolist()
               for n in torch.randint(400, 500, (4,), generator=rng)]
    cfg = dataclasses.replace(LlamaConfig.mistral_7b(), num_hidden_layers=2,
                              sliding_window=None, rope_theta=1e6,
                              num_experts=8, num_experts_per_tok=2)
    model = teng.fuse_serving_weights(teng.quantize_weights_int8(build(
        LlamaModel, cfg, device=cuda_device, dtype=torch.bfloat16,
        generator=gen)))
    a, b = _serve_twice(model, cfg, prompts, weight_quant="int8",
                        kv_quant="int8")
    assert a == b
    del model
    d = dataclasses.replace(DeepseekV2Config.v2_lite(), num_hidden_layers=3)
    ds = deepseek_serving_params(init_deepseek_v2(d, gen, cuda_device,
                                                  torch.bfloat16), d)
    a, b = _serve_twice(ds, ds.cfg, [[t % d.vocab_size for t in p]
                                     for p in prompts])
    assert a == b


_INTERNVIT_REPEAT = r'''
import hashlib, sys
import torch
from aurora_tpu_torch.models.init import build
from aurora_tpu_torch.models.internvl import (InternViT, InternViTConfig,
                                              internvit_encode)
dev = torch.device("cuda", 0)
if sys.argv[1] == "sdpa-first":   # another masked SDPA call first
    q = torch.randn((4, 32, 300, 128), device=dev, dtype=torch.bfloat16)
    torch.nn.functional.scaled_dot_product_attention(
        q, q, q, attn_mask=torch.ones((300, 300), dtype=torch.bool,
                                      device=dev).tril())
cfg = InternViTConfig(attention_bias=True)
vit = build(InternViT, cfg, device=dev, dtype=torch.bfloat16,
            generator=torch.Generator(dev).manual_seed(0))
px = torch.randn((2, 3, 448, 448), device=dev,
                 generator=torch.Generator(dev).manual_seed(1))
with torch.no_grad():
    outs = [internvit_encode(vit, px.to(torch.bfloat16)) for _ in range(2)]
assert torch.equal(outs[0], outs[1])
print(hashlib.md5(outs[0].float().cpu().numpy().tobytes()).hexdigest())
'''


@pytest.mark.cuda
def test_internvit_encode_repeats_on_card(cuda_device):
    """InternViT-300M (InternVL3-8B's tower: 24 layers, hidden 1024, 448
    px, q/k/v biases) on 2 tiles, encoded twice in each of three fresh
    processes (one after another masked SDPA call): the same bits. Its
    attention keeps to `REPEATABLE_SDPA`, as the CLIP tower's does."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    outs = [subprocess.run([sys.executable, "-c", _INTERNVIT_REPEAT, arg],
                           env=env, capture_output=True, text=True,
                           timeout=300, check=True).stdout.strip()
            for arg in ("fresh", "fresh", "sdpa-first")]
    assert len(outs[0]) == 32 and len(set(outs)) == 1, outs


@pytest.mark.cuda
def test_internvl_serving_wave_on_card(cuda_device):
    """InternVLServing at a small config whose decoder has head_dim 128
    (hidden 512, GQA 4/2, 2 layers; InternViT 2 layers at 448 px, 256
    visual tokens a tile): 2 requests of 1 and 2 tiles, 8 greedy tokens,
    bf16 KV. The extend wave runs extend_kernel<128> (one launch a
    layer, none at another width), the decode kernel one a layer and a
    step, and the tokens equal those of the same engine on the plain
    twins."""
    from unittest import mock

    import numpy as np

    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.internvl import (InternViT,
                                                  InternViTConfig,
                                                  InternVLConfig,
                                                  InternVLModel,
                                                  InternVLProjector)
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve import engine as teng
    from aurora_tpu_torch.serve.multimodal import InternVLServing

    class Tok:
        def encode(self, text, add_special_tokens=True):
            ids = [3 + b % 200 for b in text.encode()]
            return [1] + ids if add_special_tokens else ids

    cfg = InternVLConfig(
        vision=InternViTConfig(hidden_size=256, intermediate_size=512,
                               num_hidden_layers=2, num_attention_heads=4,
                               attention_bias=True),
        text=LlamaConfig(vocab_size=256, hidden_size=512,
                         intermediate_size=1024, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2))
    kw = dict(device=cuda_device, dtype=torch.bfloat16,
              generator=torch.Generator(cuda_device).manual_seed(0))
    model = InternVLModel(cfg, build(InternViT, cfg.vision, **kw),
                          build(InternVLProjector, cfg, **kw),
                          build(LlamaModel, cfg.text, **kw))
    with torch.no_grad():       # wide logit gaps: no near ties
        model.text.lm_head.weight.mul_(10.0)
    rng = np.random.default_rng(0)
    tiles = [rng.standard_normal((n, 3, 448, 448)).astype(np.float32)
             for n in (1, 2)]
    prompts = ["<image> Describe the picture.", "<image><image> Compare."]
    L = cfg.text.num_hidden_layers

    def serve():
        mm = InternVLServing(model, Tok())
        eng = teng.ServeEngine(mm.llm_params, mm.llm_cfg, teng.EngineConfig(
            max_batch=2, max_seq_len=640, kv_chunk=128,
            prefill_buckets=(640,), decode_steps=4,
            disable_radix_cache=True), embed_fn=mm.embed_fn, seed=0)
        for i, (text, px) in enumerate(zip(prompts, tiles)):
            eng.add_request(mm.build_request(str(i), text, px,
                                             max_new_tokens=8, eos_ids=()))
        done = {}
        while eng.has_work():
            done.update({r.rid: r.output_ids for r in eng.step()})
        return done, eng._steps

    for name in ("launches", *(f"launches_w{w}" for w in
                               tra.KERNEL_WIDTHS)):
        setattr(tra.ragged_attention, name, 0)
    tra.ragged_decode_attention.launches = 0
    got, steps = serve()
    assert tra.ragged_attention.launches == L
    assert tra.ragged_attention.launches_w128 == L
    assert sum(getattr(tra.ragged_attention, f"launches_w{w}")
               for w in tra.KERNEL_WIDTHS) == L
    assert tra.ragged_decode_attention.launches == L * steps
    with mock.patch.multiple(
            teng, ragged_attention=tra.ragged_attention_plain,
            ragged_decode_attention=tra.ragged_decode_attention_plain):
        want, _ = serve()
    assert sorted(got) == ["0", "1"]
    assert got == want
