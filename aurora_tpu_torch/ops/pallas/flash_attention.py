"""Flash attention, forward and backward — the training attention
(aurora_tpu/ops/pallas/flash_attention.py `flash_attention`,
`flash_attention_lse`).

Layout [B, T, H, D] at the API, as in the reference. k/v [B, S, Hkv, D]
with Hkv dividing H: the KV heads are repeated to H before the kernels
(autograd sums dK/dV over the repeats, as JAX's autodiff of `jnp.repeat`
does). Options: `causal` with `q_offset` (position of q[:, 0] among the
keys), `scale` (default D^-0.5) and segment ids [B, T] / [B, S]
(attention only within equal ids). A query row that sees no key gives out
0 and lse -2.3819763e38, with zero gradients, as the reference's kernels
do.

CPU tensors take the plain twin `flash_attention_plain`, differentiated by
autograd. CUDA tensors run the three hand-written kernels of
csrc/flash_attention.cu through `_FlashFunction`: the forward saves `out`
and `lse`; the backward computes Δ = rowsum(dO∘O) in fp32 (minus the lse
cotangent, for `flash_attention_lse`), as the reference does outside its
kernels, then launches the dK/dV and the dQ kernels. The kernels take bf16
heads of 16, 32, ..., 128, 256 or 512 columns; a head of another width up
to 512 is padded with zero columns to the next of them (`_kernel_width`,
`_pad_head`: Q·Kᵀ is unchanged and the padded columns of O, dQ, dK and dV
are zero, so the result is exact) and sliced back, with the scale of the
caller's width. Wider heads, and anything else the kernels do not take,
raise; there is no fallback from a kernel to the twin. The forward launch
is the custom op `aurora_tpu_torch::flash_fwd`, so that a
selective-checkpoint policy can keep its output (models/remat.py).

Counters, each raised by the launcher of its kernel:
`flash_attention.launches_fwd`, `.launches_dkv` and `.launches_dq` count
every launch; `.launches_fwd_d512`, `.launches_dkv_d512` and
`.launches_dq_d512` count those at kernel width 512 among them;
`flash_attention_lse.launches` counts the forwards launched through
`flash_attention_lse` (ring attention's blocks);
`flash_attention_plain.calls` counts the twin's calls.
"""

from typing import Optional, Tuple

import torch

_NEG_INF = -2.3819763e38   # the reference's mask value
MAX_HEAD_DIM = 512         # the widest head the kernels take


def _repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    if k.shape[2] == H:
        return k
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of Hkv={k.shape[2]}")
    return k.repeat_interleave(H // k.shape[2], dim=2)


def _visible(T: int, S: int, causal: bool, q_offset: int, q_seg, kv_seg,
             device) -> torch.Tensor:
    """[B or 1, 1, T, S] bool: which keys each query row sees."""
    mask = torch.ones((1, 1, T, S), dtype=torch.bool, device=device)
    if causal:
        t = torch.arange(T, device=device)[:, None] + q_offset
        mask = mask & (t >= torch.arange(S, device=device)[None, :])
    if q_seg is not None:
        mask = mask & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None,
                          q_segment_ids=None, kv_segment_ids=None,
                          q_offset: int = 0):
    """fp32 twin of the kernels → (out [B, T, H, D] in q's dtype, lse
    [B, H, T] fp32), with the kernels' masking: logits off the visible set
    take -2.3819763e38, p is 0 there, and out = Σ p v / max(Σ p, 1e-30),
    lse = m + log(max(Σ p, 1e-30)). Differentiable by autograd (the row max
    is held constant, which leaves every gradient unchanged)."""
    flash_attention_plain.calls += 1
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    H = q.shape[2]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = _visible(q.shape[1], k.shape[1], causal, int(q_offset),
                    q_segment_ids, kv_segment_ids, q.device)
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, v.float()) / l.transpose(1, 2)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


flash_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dims(q, k):
    B, T, H, D = q.shape
    return B, T, k.shape[1], H, D


@torch.library.custom_op("aurora_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_seg: Optional[torch.Tensor],
                  kv_seg: Optional[torch.Tensor], causal: bool,
                  scale: float, q_offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    from aurora_tpu_torch.ops.cuda_build import load_library
    lib = load_library()
    B, T, S, H, D = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = lib.aurora_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, S, H, D, int(causal),
        int(q_offset), float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention: forward launch failed "
                           f"(cudaError {err})")
    flash_attention.launches_fwd += 1
    if D == MAX_HEAD_DIM:
        flash_attention.launches_fwd_d512 += 1
    return out, lse


def _bwd_args(q, k, g, lse, delta, q_seg, kv_seg, causal, scale,
              q_offset):
    B, T, S, H, D = _dims(q, k)
    head = (g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if kv_seg is None else kv_seg.data_ptr())
    tail = (B, T, S, H, D, int(causal), int(q_offset), float(scale),
            _stream(q))
    return head, tail


def bwd_dkv(q, k, v, g, lse, delta, q_seg, kv_seg, causal, scale,
            q_offset):
    """The dK/dV kernel: g = dO like q, lse and delta [B, H, T] fp32 →
    (dk, dv) like k."""
    from aurora_tpu_torch.ops.cuda_build import load_library
    head, tail = _bwd_args(q, k, g, lse, delta, q_seg, kv_seg, causal,
                           scale, q_offset)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = load_library().aurora_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *head, dk.data_ptr(),
        dv.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"flash_attention: dK/dV launch failed "
                           f"(cudaError {err})")
    flash_attention.launches_dkv += 1
    if q.shape[-1] == MAX_HEAD_DIM:
        flash_attention.launches_dkv_d512 += 1
    return dk, dv


def bwd_dq(q, k, v, g, lse, delta, q_seg, kv_seg, causal, scale, q_offset):
    """The dQ kernel: as `bwd_dkv` → dq like q."""
    from aurora_tpu_torch.ops.cuda_build import load_library
    head, tail = _bwd_args(q, k, g, lse, delta, q_seg, kv_seg, causal,
                           scale, q_offset)
    dq = torch.empty_like(q)
    err = load_library().aurora_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *head, dq.data_ptr(),
        *tail)
    if err != 0:
        raise RuntimeError(f"flash_attention: dQ launch failed "
                           f"(cudaError {err})")
    flash_attention.launches_dq += 1
    if q.shape[-1] == MAX_HEAD_DIM:
        flash_attention.launches_dq_d512 += 1
    return dq


class _FlashFunction(torch.autograd.Function):
    """(out, lse) of the kernels; gradients for q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale, q_offset):
        out, lse = torch.ops.aurora_tpu_torch.flash_fwd(
            q, k, v, q_seg, kv_seg, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.args = (causal, scale, q_offset)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        g_out = g_out.contiguous()
        delta = (g_out.float() * out.float()).sum(-1).transpose(1, 2)
        if g_lse is not None:
            # ∂lse_t/∂s_ts = p_ts, so the lse cotangent folds into Δ
            delta = delta - g_lse.float()
        args = (q, k, v, g_out, lse, delta.contiguous(), q_seg, kv_seg,
                *ctx.args)
        dk, dv = bwd_dkv(*args)
        dq = bwd_dq(*args)
        return dq, dk, dv, None, None, None, None, None


def _kernel_width(D: int) -> int:
    """The head width a kernel takes for a head of D columns: D itself
    for a multiple of 16 up to 128 (the TMA boxes read zeros past it),
    the next multiple of 16 below that, then 256, then 512; wider heads
    raise."""
    if D <= 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the CUDA kernels take head_dim "
                         f"1 to {MAX_HEAD_DIM}, got {D}")
    if D <= 128:
        return -(-D // 16) * 16
    return 256 if D <= 256 else MAX_HEAD_DIM


def _pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [..., D] with zero columns appended up to `width` (x itself when
    D == width)."""
    D = x.shape[-1]
    return x if D == width else torch.nn.functional.pad(x, (0, width - D))


def _card_inputs(q, k, v, q_segment_ids, kv_segment_ids):
    """Check what the kernels take; → contiguous q, k, v with the KV heads
    repeated and the head padded to the kernels' width (`_kernel_width`),
    and int32 segment planes (or None)."""
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, T, H, D] and k = v [B, S, Hkv, D] "
                         f"expected, got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or T == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} / "
                         f"{tuple(k.shape)} do not match")
    W = _kernel_width(D)
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {label} must be bfloat16 on the card, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"{q.device}")
    q = _pad_head(q.contiguous(), W)
    k, v = (_pad_head(_repeat_kv(x, H).contiguous(), W) for x in (k, v))
    segs = [None, None]
    for i, (label, s, n) in enumerate((("q_segment_ids", q_segment_ids, T),
                                       ("kv_segment_ids", kv_segment_ids,
                                        k.shape[1]))):
        if s is None:
            continue
        if tuple(s.shape) != (B, n) or s.device != q.device:
            raise ValueError(f"{name}: {label} must be [{B}, {n}] on "
                             f"{q.device}, got {tuple(s.shape)} on "
                             f"{s.device}")
        segs[i] = s.to(torch.int32).contiguous()
    return q, k, v, segs[0], segs[1]


def _flash(q, k, v, causal, scale, q_segment_ids, kv_segment_ids, q_offset):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, scale=scale, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    q, k, v, qs, ks = _card_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    out, lse = _FlashFunction.apply(q, k, v, qs, ks, bool(causal),
                                    float(scale), int(q_offset))
    return (out if out.shape[-1] == D else out[..., :D]), lse


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None, q_offset: int = 0) -> torch.Tensor:
    """Flash attention, API-compatible with ops.attention.mha_reference.
    q [B, T, H, D]; k, v [B, S, Hkv, D] → [B, T, H, D] in q's dtype."""
    return _flash(q, k, v, causal, scale, q_segment_ids, kv_segment_ids,
                  q_offset)[0]


flash_attention.launches_fwd = 0
flash_attention.launches_dkv = 0
flash_attention.launches_dq = 0
flash_attention.launches_fwd_d512 = 0
flash_attention.launches_dkv_d512 = 0
flash_attention.launches_dq_d512 = 0


def flash_attention_lse(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, q_offset: int = 0):
    """Flash attention returning (out [B, T, H, D], lse [B, H, T] fp32),
    with a differentiable lse (its cotangent folds into Δ of the backward
    kernels): the building block of ring attention's online merge
    (parallel/ring.py). `flash_attention_lse.launches` counts its forward
    launches on the card."""
    if q.device.type == "cuda":
        flash_attention_lse.launches += 1
    return _flash(q, k, v, causal, scale, None, None, q_offset)


flash_attention_lse.launches = 0
