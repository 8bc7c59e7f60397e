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
(int8: values and scales) are exact. W4A8 matmul: max |Δ| / max |want|
≤ 1e-5 with fp32 output (only the fp32 order of the group sum differs),
and bf16 output within one bf16 rounding of the twin's; repeated launches
agree bitwise.
"""


def _lane_rel(got, want, lanes):
    return max(((got[i].float() - want[i]).abs().max()
                / want[i].abs().max()).item() for i in lanes)

import pytest
import torch

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
@pytest.mark.parametrize("G", [1, 4])
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
@pytest.mark.parametrize("G", [1, 4])
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
