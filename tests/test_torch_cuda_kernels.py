"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

bf16 inputs; the twin computes in fp32 from the same bf16 values.
Tolerances, max abs error (chip_smoke.py's bounds): 2e-2 for extend
(bf16 output rounding plus bf16 probabilities in the PV product), 3e-3
for decode (fp32 probabilities); decode row writes exact.
"""

import pytest
import torch

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
