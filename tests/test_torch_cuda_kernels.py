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
extend bounds. W4A8 matmul: max |Δ| /
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
agree bitwise. The remat policies of a bf16 train step on the card give
the same loss and grad norm (1e-5) and keep or recompute the flash
forward as their names say. The dense greedy decode of the caption path
repeats bit for bit.
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


def _mode_rows(gen, dev, mode, hkv, Sr=512):
    """bf16, int8 or packed int4 rows of Sr tokens → (k, v, the KV
    keyword arguments of both functions' extend call)."""
    if mode == "bf16":
        kw = dict(device=dev, dtype=torch.bfloat16)
        k = torch.randn((2, 4, hkv, Sr, 128), generator=gen, **kw)
        v = torch.randn((2, 4, hkv, Sr, 128), generator=gen, **kw)
        return k, v, {}
    if mode == "int8":
        k, v, ks, vs = _int8_rows(gen, dev, hkv, Sr)
        return k, v, dict(k_scales=ks, v_scales=vs)
    k, v, ks, vs = _int4_rows(gen, dev, hkv, Sr)
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


def _decode_case(dev, seed, mode, hkv, G, lens, Sr, opts, q_gain=1.0):
    """One decode call through the kernel and through the twin on copies
    of the same rows → (out, want, state, plain): the state tensors (rows
    and scales) as the kernel left them and as the twin did."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, v, kv = _mode_rows(gen, dev, mode, hkv, Sr)
    if mode != "bf16":
        kv = dict(kv, kv_maxq=7.0 if mode == "int4" else 127.0)
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = q_gain * torch.randn((4, 1, hkv * G, 128), generator=gen, **bf)
    kn = torch.randn((4, hkv, 128), generator=gen, **bf)
    vn = torch.randn((4, hkv, 128), generator=gen, **bf)
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
    and the launch counts; with segments (S = T + q_offset) three
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
    counters = ("launches_fwd", "launches_dkv", "launches_dq")
    launches = [getattr(tfa.flash_attention, c) for c in counters]
    (got,), got_g = _grads(
        lambda *a: tfa.flash_attention(*a, **kw), q, k, v, g)
    (want,), want_g = _grads(
        lambda *a: tfa.flash_attention_plain(*a, **kw)[0],
        q.float(), k.float(), v.float(), g.float())
    torch.cuda.synchronize()
    assert [getattr(tfa.flash_attention, c) for c in counters] == [
        n + 1 for n in launches]
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
    q, k, v, _ = _flash_inputs(cuda_device, 6, 1, 128, 128, 2, 2, 128)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), k.float(), v.float())
    q72, k72, v72, _ = _flash_inputs(cuda_device, 7, 1, 128, 128, 2, 2, 72)
    with pytest.raises(ValueError):          # head_dim % 16 != 0
        tfa.flash_attention(q72, k72, v72)


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
    (models/llama.py `_REPEATABLE_SDPA`). 7B widths and the
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
