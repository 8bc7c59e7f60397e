#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

AuroraCap-7B caption serving at full published widths with random bf16
weights (seeded): uint8 frames → CLIP normalize → ViT-H/14 with ToMe →
projector → fusion → one batched extend → 256-token greedy decode via
`aurora_tpu_torch.serve.engine.ServeEngine`, first with bf16 weights and
bf16 KV, then with the LLM quantized on the card to W8 weights and int8
KV, to W4 weights and int8 KV, and (the same W4 weights) nibble-packed
int4 KV, then int8 KV again with the W4 weights in the fused-MLP and in
the flat layout; both quantized models keep an int8 LM head. Then
Mistral-7B at full widths and depth (random bf16 weights) serving prompts
longer than its 4096-token sliding window with bf16, int8 and packed int4
KV, so that the window runs through both attention kernels. Then the
training step of bench.py's training stage
(`aurora_tpu_torch.train.trainer.make_train_step`): Vicuna-7B widths at
depth 4, seq 2048, batch 4, bf16, AdamW, full remat, text-only batches
without an attention mask, so that attention runs the flash kernels.
Phases, one line each; any failure raises and exits non-zero:

1. device        — requires CUDA; prints the card's name and power limit
2. build         — compiles the CUDA kernels from aurora_tpu_torch/csrc;
                   prints the registers a thread, local (spill) bytes a
                   thread and shared bytes a block of each flash kernel,
                   of the extend kernel in each KV mode, of the decode
                   kernel in each KV mode for 1 and 4 query heads a KV
                   head, and of the W8A8, W4A16 and W4A8 weight streamers
                   and the fused W4 MLP's tile kernel for up to 8 and up
                   to 64 token rows
3. kernels       — each kernel and mode vs its plain PyTorch twin at the
                   slice's shapes: both attention kernels with bf16, int8
                   and packed int4 KV (bf16 in, fp32 reference; decode row
                   and scale writes exact, int4 mate nibbles included),
                   then in every mode with a window of 512, a logit cap
                   of 50 and both, and at Mistral-7B's shapes (rows of
                   7168, Hkv 8, a 6144-token extend, decode past the
                   window) with its window of 4096, each windowed or
                   capped result also 10x further from the twin without
                   the option than from the twin with it; every decode
                   case called twice more must repeat its output
                   bitwise; decode lengths on the decode kernel's split
                   boundaries (256, 257, 512, 1025, 1536, 1792; with a
                   window of 512 whose edge falls on and inside a
                   split); the
                   W4A8 (stripe and flat layouts), W4A16 and W8A8 matmuls
                   at the 7B's four decode projections, B 4 and B 64
                   (W8A8 bitwise the twin's, the others bitwise
                   repeatable), the fused W4 MLP at one 7B layer's MLP,
                   B 4 and B 64 (bitwise repeatable, every output within
                   the bound fused_mlp_w4_bound derives, the fp32 control
                   outside it; beside the two-call W4A8 path of the same
                   layer), the W8A8 path's
                   one-launch activation quantizer (bitwise
                   quantize_activations); these kernels and their
                   library calls are timed as CUDA-graph replays
                   (`ms`, `library_ms`) and as eager single calls
                   (`eager_ms`, `library_eager_ms`)
4. serve         — bf16: 4 requests of 8 frames each to 256 tokens; the
                   bf16 kernels' launch counts must rise and the plain
                   twins' stay 0
5. logits        — one bf16 extend wave's logits through the kernels vs
                   through the plain twins, on the same engine state
6. serve-w8kv8   — the LLM quantized to W8 on the card (the bf16 source
                   kept; quantize_weights_int8, fuse_serving_weights,
                   timed), the same 4 requests (new clips) with int8 KV; the
                   int8 attention, W8A8 and activation quantizer launch
                   counts must rise and every plain twin's stay 0
7. logits-w8kv8  — as 5, on the W8 + int8-KV engine; then the W8 model
                   is freed
8. quantize      — the LLM to W4 on the card (quantize_weights_int4,
                   fuse_serving_weights, the bf16 source freed), timed
9. serve-w4kv8   — the same 4 requests (new clips) with W4 weights and
                   int8 KV; the int8 attention and W4A8 launch counts must
                   rise (W4A8: 4 a layer and a decode step, as in every W4
                   run: the fused MLP's 1 beside 2) and every plain twin's
                   stay 0
10. logits-w4kv8 — as 5, on the W4 + int8-KV engine, then one decode
                   step's logits (1 token a lane) through the kernels vs
                   through the plain twins
11. serve-w4kv4  — the same W4 weights with packed int4 KV (new clips);
                   the int4 attention and W4A8 launch counts must rise and
                   every plain twin's stay 0
12. logits-w4kv4 — as 5, on the W4 + int4-KV engine
13. serve-w4kv8-fused — the same W4 weights laid out first (timed) with
                   the fused MLP (`EngineConfig(w4_fused_mlp=True)`, the
                   reference's AURORA_W4_FUSED_MLP=1), int8 KV, new clips;
                   the fused-MLP, W4A8 (qkv, o) and int8 attention launch
                   counts must rise and every plain twin's stay 0
14. logits-w4kv8-fused — as 10 (the decode step runs the fused MLP)
15. serve-w4kv8-flat — the same W4 weights in the reference's flat layout
                   (`w4_tiled=False`, its AURORA_W4_TILED=0); the flat
                   W4A8 launch count must rise, the stripe W4A8's stay 0,
                   every plain twin's stay 0
16. logits-w4kv8-flat — as 10, on the flat-layout engine
    serve-mistral-bf16 / -kv8 / -kv4 — the AuroraCap weights freed,
                   Mistral-7B (32 layers, GQA 32/8, window 4096, random
                   bf16 weights) serves 4 prompts of 5,000-6,100 random
                   token ids in one extend wave, then 256 (bf16 KV) or
                   64 (int8, packed int4 KV) greedy tokens each; the
                   windowed launch counts must be 32 a wave and 32 a
                   decode step, the plain twins' 0
    logits-mistral-* — as 10 (extend wave and one decode step), with
                   its bound's reason
17. kernels flash — the flash forward, dK/dV and dQ kernels vs the fp32
                   twin (out, lse, dQ/dK/dV from one seeded dO) at the
                   training shape (B 4, T 2048, H 32, D 128, causal),
                   again with segment ids and q_offset 128 (T 384, S 512) and
                   with GQA and a random lse cotangent through
                   flash_attention_lse (Hkv 8); backward bitwise
                   repeatable; timed against the twin and against
                   F.scaled_dot_product_attention (the yardstick only)
18. train        — one warm-up and 5 timed steps; losses and grad norms
                   finite, each flash kernel's launch count rises (the
                   forward twice a layer with remat), the plain twins' stay 0
19. train-parity — one depth-2 step with the kernels and one through
                   mha_reference (the same batch with an all-true
                   attention_mask), same weights: loss, grad norm and each
                   layer's q/k/v/o weight gradients
20. the kernels' JSON line (each kernel's bound and library time
   included; the windowed entries from Mistral's shapes and runs), then
   {"ok": true, "device": {...}} last.

float32 references run with TF32 disabled for matmuls and cuDNN
convolutions, so they are true fp32.
"""

import gc
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SEED = 0
KEPT_RATIO = 0.2          # the bench's AuroraCap-7B setting: 171 tokens/frame
N_FRAMES = 8
N_REQUESTS = 4
MAX_NEW = 256
# Kernel vs fp32 plain twin, bf16 inputs and output. Each kernel has its
# own bounds, set from the errors measured on an H100 with some room
# (PERF.md): the max abs error over all lanes, and per active lane the
# max abs error over that lane's max |output| (random V averaged over
# many keys gives small outputs, which an abs bound alone would hide).
EXTEND_ABS_TOL = 2e-2     # measured 1.05e-2
EXTEND_REL_TOL = 1e-2     # measured 3.0e-3
DECODE_ABS_TOL = 3e-3     # measured 6.3e-4
DECODE_REL_TOL = 8e-3     # measured 2.6e-3
# A windowed or capped kernel result must differ from the twin's without
# the option by more than this many times its error against the twin with
# it: the option reached the kernel.
OFF_CONTROL = 10.0
# With int8 KV the dequantized values are not bf16 numbers (a one-key
# lane's output is v8 * vs itself), so the abs bounds sit on top of the
# output's own bf16 rounding: |got - want| <= tol + 2^-8 |want|.
INT8_ROUNDING = 2.0 ** -8
# W4A8 matmul vs its twin with fp32 output: the int32 group partials are
# exact on both sides, only the fp32 order of the group sum differs
W4A8_REL_TOL = 1e-5       # max |Δ| / max |want|
# W8A8 matmul vs its twin with fp32 output: exact int32 sums and the same
# two fp32 multiplies on both sides
W8A8_REL_TOL = 1e-5       # max |Δ| / max |want|
# W4A16 matmul vs its twin with fp32 output: exact bf16 products on both
# sides, fp32 sums in another order
W4A16_REL_TOL = 1e-5      # max |Δ| / max |want|
# fused W4 MLP vs its bf16 twin with fp32 output: each output within the
# bound that quant_matmul.fused_mlp_w4_bound derives from the two orders
# of the gate/up and down sums (near-tie bf16 activations that may round
# the other way, times |Wd|, plus the fp32 slack of the down sum); the
# same MLP in fp32 (the twin's compute_dtype=float32) must fall outside it
# somewhere, and at least FUSED_MLP_CONTROL_SHARE of its outputs must
FUSED_MLP_CONTROL_SHARE = 0.5
LOGITS_REL_TOL = 5e-2     # max |Δlogits| / max |logits| after 32 bf16 layers
LOGITS_W4_REL_TOL = 5e-2  # the same on the W4 + int8-KV engines (all
                          # three layouts)
# One decode step's logits, kernels vs twins, on the three W4 + int8-KV
# engines: in decode every projection quantizes its input per token to
# int8 (W4A8), so, as in the W8 extend below, the decode attention
# kernel's bf16 rounding flips activation codes in every layer (measured
# on an H100: 4.42e-2 fused MLP, 7.34e-2 flat; PERF.md)
LOGITS_DECODE_REL_TOL = 2e-1
# The W8 extend quantizes every projection's input per token to int8, and
# int4 KV rounds K/V onto 15 levels: the kernel's bf16 attention output
# flips codes of those quantizers in every layer, which spreads the
# kernel-vs-twin difference further than in the two engines above
# (measured on an H100: 1.18e-1 / 1.16e-1 for W8 + int8 KV, 4.05e-2 for
# W4 + int4 KV; PERF.md)
LOGITS_W8_REL_TOL = 2.5e-1
LOGITS_W4KV4_REL_TOL = 1e-1
# Mistral-7B serving (bf16 weights): prompt lengths (all past the 4096-
# token window; bucket 6144, rows of 7168) and the three KV runs: name,
# kv_quant, launch counter of the mode, new tokens per request (every
# int8 / int4 decode step already lies past the window, so fewer do)
MISTRAL_PROMPT = (5000, 6100)
MISTRAL_RUNS = (("bf16", "none", "launches", 256),
                ("kv8", "int8", "launches_int8", 64),
                ("kv4", "int4", "launches_int4", 64))
# One extend wave's and one decode step's logits, kernels vs twins, after
# 32 layers of random bf16 weights, which amplify single bf16 roundings:
# the decode check runs both sides over the same KV rows, and the windowed
# decode kernel, within 2.4e-4 of its twin per call, still moves one
# step's logits by 3.2-4.0e-2. Measured on an H100 (PERF.md): extend
# 5.41e-2 / 5.46e-2 / 6.50e-2 (bf16 / int8 / int4 KV), decode 3.68e-2 /
# 3.98e-2 / 3.23e-2; the bound sits at 2.3-2.8x the extend readings
MISTRAL_LOGITS_TOL = {"bf16": 1.5e-1, "kv8": 1.5e-1, "kv4": 1.5e-1}
MISTRAL_LOGITS_REASON = {
    "bf16": "32 random bf16 layers amplify single bf16 roundings",
    "kv8": "as bf16, and a rounding can flip an int8 KV code",
    "kv4": "as bf16, and a rounding can flip an int4 KV code (15 levels)"}
# window and cap cases of the attention kernels at the serving shapes: a
# window of 512 (lanes of 1392-1656 keys), Gemma2's cap of 50 on q scaled
# by 8 (scores of std ~8, so the cap bends them), and both
SERVING_OPTIONS = (dict(window=512), dict(logit_cap=50.0, q_gain=8.0),
                   dict(window=512, logit_cap=50.0, q_gain=8.0))
# the kernels at Mistral-7B's shapes: rows of 7168 tokens, Hkv 8, an
# extend of 6144 tokens at offset 0, decode queries past the window
MISTRAL_CASE = dict(S=7168, T=6144, offs=(0, 0, 0, 0),
                    lens=(6144, 6100, 5000, 0), dlens=(7168, 4097, 0, 5000),
                    window=4096)
KV_MODES = ("bf16", "int8", "int4")
# decode lengths on the decode kernel's split boundaries (splits of 256
# keys) at the serving shape, lane 2 inactive as in every case: the new
# token last and first in a split, a full row; with a window of 512 its
# lower edge on a boundary (768 - 512) and inside a split (1000 - 512)
SPLIT_BOUNDARY_CASES = (dict(dlens=(256, 257, 0, 1536)),
                        dict(dlens=(1792, 512, 0, 1025)),
                        dict(dlens=(768, 1000, 0, 513), window=512))
# the 7B's decode projections (fused streams): name, K, N
W4_SHAPES = (("qkv", 4096, 12288), ("o", 4096, 4096),
             ("gateup", 4096, 22016), ("down", 11008, 4096))
# the weight kernels' row counts: chip_smoke's 4 lanes, and the most
# decode rows the engine sends (MAX_TOKENS)
WEIGHT_ROWS = (4, 64)
# Flash kernels vs their fp32 twin, bf16 inputs: out max abs, per query
# row max abs over the row's max |out|, lse max abs, and per gradient
# max |Δ| / max |want|; measured on an H100 (PERF.md): 1.03e-2, 6.2e-3,
# 1.4e-6, 5.0e-3
FLASH_ABS_TOL = 2e-2
FLASH_ROW_TOL = 1.5e-2
FLASH_LSE_TOL = 1e-4
FLASH_GRAD_TOL = 1.5e-2
# one depth-2 bf16 train step, kernels vs mha_reference (SDPA): relative
# difference of the loss and of the grad norm (measured 1.2e-5, 1.9e-6),
# and over each layer's q/k/v/o weight gradients the worst max |Δ| / max
# |want| (measured 1.96e-2; median over the 8 weights 1.21e-2)
TRAIN_PARITY_TOL = 1e-3
TRAIN_GRAD_TOL = 4e-2
# steps of bench.py's training stage (train/bench_stage.py)
TRAIN_STEPS = 6
# H100 SXM5 data sheet: dense bf16 tensor-core peak, int8 peak, HBM rate
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def lane_rel_err(got, want, lanes):
    """max over `lanes` of max|got - want| / max|want| within the lane."""
    return max(((got[i].float() - want[i]).abs().max()
                / want[i].abs().max()).item() for i in lanes)


def cuda_ms(fn, reps=5):
    """Median milliseconds of fn() on the current stream (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, reps=5, inner=20):
    """Median milliseconds of one fn() replayed from a CUDA graph: CUDA
    events around `inner` back-to-back replays, after a warm-up call and
    the capture. This is the device time of what fn launches without the
    host's time to issue it (a Python wrapper's ~0.1 ms would otherwise
    be most of a decode kernel's reading), as the engine's decode block
    will run once it is captured (ROADMAP queue 1 item 2)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return float(np.median(times))


def least_ms(ops, nbytes, peak=PEAK_BF16):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grad_ms(torch, outs, leaves, cots, reps=5):
    """Median ms of one backward through a kept graph."""
    return cuda_ms(lambda: torch.autograd.grad(outs, leaves, cots,
                                               retain_graph=True), reps)


class ByteTokenizer:
    """Stand-in tokenizer (no tokenizer files exist): BOS 1, then one id
    per UTF-8 byte, offset past the special ids."""

    def encode(self, text, add_special_tokens=True):
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([1] + ids) if add_special_tokens else ids


def attention_case(torch, ra, dev, g, hkv, mode, L=32, S=1792, T=1536,
                   offs=(0, 256, 0, 0), lens=(1392, 256 + 1400, 1536, 0),
                   dlens=(1648, 700, 0, 1), window=None, logit_cap=0.0,
                   q_gain=1.0):
    """Both attention kernels vs their plain twins at the serving shapes
    (L = 32, S = 1792, hd = 128) or at Mistral's (S = 7168), with bf16 KV,
    int8 KV on the kv_quantize grid or nibble-packed int4 KV on its
    maxq-7 grid (`mode`), with GQA, permuted rows, a query offset > 0 and
    a padded / inactive lane, optionally with a sliding window and a
    logit cap (q scaled by q_gain so that scores reach the cap) →
    {"extend"|"decode": {err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}. With an option on, the kernel's result must differ from
    the twin's without it by more than OFF_CONTROL times its error (the
    option reached the kernel), both taken over the query rows the option
    changes. The library call (bf16 KV, no cap) is one
    F.scaled_dot_product_attention over the lanes' rows, gathered (and
    for GQA repeated to Hq heads) beforehand, with a boolean mask; for a
    windowed decode over each lane's last `window` keys only."""
    import torch.nn.functional as F
    B, hd, Hq = 4, 128, 32
    w = window or 0
    opts = dict(window=window, logit_cap=logit_cap)
    bf = dict(device=dev, dtype=torch.bfloat16)
    i32 = dict(device=dev, dtype=torch.int32)
    k = torch.randn((L, B, hkv, S, hd), generator=g, **bf)
    v = torch.randn((L, B, hkv, S, hd), generator=g, **bf)
    kv, dkv = {}, {}            # the extend's and the decode's KV options
    if mode != "bf16":
        maxq = 127.0 if mode == "int8" else 7.0
        (k, ks), (v, vs) = ra.kv_quantize(k, maxq), ra.kv_quantize(v, maxq)
        kv = dict(k_scales=ks, v_scales=vs)
        if mode == "int4":
            k, v = ra.pack_int4_rows(k), ra.pack_int4_rows(v)
            kv["kv_pack"] = True
        dkv = dict(kv, kv_maxq=maxq)
    # int8 / int4 KV, and the option cases (a window leaves fewer keys to
    # average, q_gain peaks the softmax): outputs approach single V rows,
    # so the output's own bf16 rounding enters the bound
    rnd = INT8_ROUNDING if kv or w or logit_cap else 0.0
    lay = min(17, L - 1)
    layer = torch.tensor([lay], **i32)
    rows_l = [2, 0, 3, 1]
    rows = torch.tensor(rows_l, **i32)
    # bytes of one key (K and V, with their scales when quantized) of one
    # KV head
    key_bytes = {"bf16": 4 * hd, "int8": 2 * hd + 8, "int4": hd + 8}[mode]
    library = mode == "bf16" and not logit_cap
    if library:     # the lanes' rows, for the library call
        krow = torch.stack([k[lay, r] for r in rows_l])   # [B, Hkv, S, hd]
        vrow = torch.stack([v[lay, r] for r in rows_l])
        if hkv != Hq:
            krow = krow.repeat_interleave(Hq // hkv, dim=1)
            vrow = vrow.repeat_interleave(Hq // hkv, dim=1)
    spos = torch.arange(S, device=dev)
    tag = dict(kv=mode, hkv=hkv, S=S, T=T, window=w, cap=logit_cap,
               dlens=",".join(map(str, dlens)))

    q = q_gain * torch.randn((B, T, Hq, hd), generator=g, **bf)
    offs_t = torch.tensor(offs, **i32)
    lens_t = torch.tensor(lens, **i32)
    got = ra.ragged_attention(q, k, v, lens_t, offs_t, rows, layer=layer,
                              **kv, **opts)
    want = ra.ragged_attention_plain(q.float(), k, v, lens_t, offs_t, rows,
                                     layer=lay, **kv, **opts)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    err_e = diff.max().item()
    rel_e = lane_rel_err(got, want, (0, 1, 2))
    check(bool(torch.isfinite(got).all()), "extend output not finite")
    check(bool((got[3] == 0).all()), "padded extend lane not zero")
    check(bool((diff <= EXTEND_ABS_TOL + rnd * want.abs()).all()),
          f"extend {tag} err {err_e}")
    check(rel_e <= EXTEND_REL_TOL, f"extend {tag} rel {rel_e}")
    control = {}
    if w or logit_cap:
        # on the query rows the option changes: with a window those whose
        # window cuts keys (position >= w), with the cap alone every row
        off = ra.ragged_attention_plain(q.float(), k, v, lens_t, offs_t,
                                        rows, layer=lay, **kv)
        qpos = offs_t[:, None] + torch.arange(T, device=dev)
        cut = (qpos < lens_t[:, None]) & (qpos >= w)
        control["extend_err_cut"] = diff[cut].max().item()
        control["extend_off_diff"] = (got.float() - off)[cut].abs().max() \
            .item()
        del off
        check(control["extend_off_diff"]
              > OFF_CONTROL * control["extend_err_cut"],
              f"extend {tag}: {control}")
    def extend_kernel():
        return ra.ragged_attention(q, k, v, lens_t, offs_t, rows,
                                   layer=layer, **kv, **opts)
    ms_e = graph_ms(extend_kernel)
    eager_e = cuda_ms(extend_kernel)
    ms_ep = cuda_ms(lambda: ra.ragged_attention_plain(
        q, k, v, lens_t, offs_t, rows, layer=lay, **kv, **opts), reps=3)
    # work of these inputs: query t of lane i (position p = off + t) sees
    # the keys in [max(0, p - w + 1), min(p + 1, len)); K/V rows read from
    # the lane's first visible key up to its length
    seen, read = 0, 0
    for o, n in zip(offs, lens):
        if n <= 0:
            continue
        p = o + np.arange(T)
        lo = np.maximum(p - w + 1, 0) if w else np.zeros_like(p)
        seen += int(np.maximum(np.minimum(p + 1, n) - lo, 0).sum())
        read += n - (max(o - w + 1, 0) if w else 0)
    extend_bound = least_ms(seen * Hq * 4 * hd,
                            2 * q.numel() * 2 + read * hkv * key_bytes)
    lib_e = None
    if library:
        qpos = offs_t[:, None].long() + torch.arange(T, device=dev)
        emask = ((spos[None, None, :] <= qpos[:, :, None])
                 & (spos[None, None, :] < lens_t[:, None, None]))
        if w:
            emask &= spos[None, None, :] > qpos[:, :, None] - w
        emask = emask[:, None]
        qt = q.transpose(1, 2)
        def extend_library():
            return F.scaled_dot_product_attention(qt, krow, vrow,
                                                  attn_mask=emask)
        lib_e = graph_ms(extend_library)
        eager_lib_e = cuda_ms(extend_library)
        del emask
    del q, got, want, diff

    qd = q_gain * torch.randn((B, 1, Hq, hd), generator=g, **bf)
    kn = torch.randn((B, hkv, hd), generator=g, **bf)
    vn = torch.randn((B, hkv, hd), generator=g, **bf)
    vn[3, 1] = 0                          # an all-zero token: the 1e-8 floor
    dlens_t = torch.tensor(dlens, **i32)
    state = [k, v] + [kv[n] for n in ("k_scales", "v_scales") if n in kv]
    plain = [t.clone() for t in state]
    pkv = dict(dkv, **dict(zip(("k_scales", "v_scales"), plain[2:])))
    out = ra.ragged_decode_attention(qd, kn, vn, k, v, dlens_t, rows,
                                     layer=layer, **dkv, **opts)[0]
    want = ra.ragged_decode_attention_plain(qd.float(), kn, vn, *plain[:2],
                                            dlens_t, rows, layer=lay,
                                            **pkv, **opts)[0]
    torch.cuda.synchronize()
    # int4: the packed bytes, mate nibbles included
    check(all(torch.equal(a, b) for a, b in zip(state, plain)),
          f"decode {tag} row/scale writes differ from the plain twin")
    diff = (out.float() - want).abs()
    err_d = diff.max().item()
    rel_d = lane_rel_err(out, want, (0, 1, 3))
    check(bool((out[2] == 0).all()), "inactive decode lane not zero")
    check(bool((diff <= DECODE_ABS_TOL + rnd * want.abs()).all()),
          f"decode {tag} err {err_d}")
    check(rel_d <= DECODE_REL_TOL, f"decode {tag} rel {rel_d}")
    # two more calls on the same inputs (each rewrites the same token in
    # place): the splits' partials merge in split order whichever block
    # merges, so the output repeats bitwise
    for _ in range(2):
        again = ra.ragged_decode_attention(qd, kn, vn, k, v, dlens_t, rows,
                                           layer=layer, **dkv, **opts)[0]
        check(torch.equal(again, out),
              f"decode {tag} is not bitwise repeatable")
    if w or logit_cap:
        off = ra.ragged_decode_attention_plain(qd.float(), kn, vn, *plain[:2],
                                               dlens_t, rows, layer=lay,
                                               **pkv)[0]
        cut = (dlens_t > 0) & (dlens_t > w)     # lanes the option changes
        control["decode_err_cut"] = diff[cut].max().item()
        control["decode_off_diff"] = (out.float() - off)[cut].abs().max() \
            .item()
        check(control["decode_off_diff"]
              > OFF_CONTROL * control["decode_err_cut"],
              f"decode {tag}: {control}")
    def decode_kernel():
        return ra.ragged_decode_attention(qd, kn, vn, k, v, dlens_t, rows,
                                          layer=layer, **dkv, **opts)
    ms_d = graph_ms(decode_kernel, inner=100)
    eager_d = cuda_ms(decode_kernel, reps=20)
    ms_dp = cuda_ms(lambda: ra.ragged_decode_attention_plain(
        qd, kn, vn, *plain[:2], dlens_t, rows, layer=lay, **pkv, **opts),
        reps=20)
    # the KV rows each lane reads (its last w keys with a window), the new
    # tokens, q and out
    keys = sum(min(n, w) if w else n for n in dlens)
    decode_bound = least_ms(keys * Hq * 4 * hd,
                            keys * hkv * key_bytes
                            + 2 * qd.numel() * 2 + 2 * kn.numel() * 2)
    lib_d = None
    if library:
        qdt = qd.transpose(1, 2)
        if w:       # each lane's last w keys, gathered beforehand
            nd = [min(n, w) for n in dlens]
            W = max(nd)
            start = torch.tensor([n - m for n, m in zip(dlens, nd)],
                                 device=dev)
            idx = (start[:, None] + torch.arange(W, device=dev)).clamp(
                max=S - 1)
            kw_ = torch.stack([krow[i][:, idx[i]] for i in range(B)])
            vw_ = torch.stack([vrow[i][:, idx[i]] for i in range(B)])
            dmask = (torch.arange(W, device=dev)[None, :]
                     < torch.tensor(nd, device=dev)[:, None])
            dmask = dmask[:, None, None, :]
            kd, vd = kw_, vw_
        else:
            dmask = (spos[None, :] < dlens_t[:, None])[:, None, None, :]
            kd, vd = krow, vrow

        def decode_library():
            return F.scaled_dot_product_attention(qdt, kd, vd,
                                                  attn_mask=dmask)
        lib_d = graph_ms(decode_library, inner=100)
        eager_lib_d = cuda_ms(decode_library, reps=20)
        del kd, vd
    # ms: CUDA-graph replays (device time); eager_ms: one call between
    # two events, the host's issue time included (PRs 1-7's readings)
    phase("kernels", **tag, extend_err=f"{err_e:.3e}",
          extend_rel=f"{rel_e:.3e}", extend_ms=f"{ms_e:.4f}",
          extend_eager_ms=f"{eager_e:.4f}",
          extend_plain_ms=f"{ms_ep:.3f}",
          extend_bound_ms=f"{extend_bound[0]:.4f}",
          extend_library_ms=lib_e and f"{lib_e:.4f}",
          extend_library_eager_ms=lib_e and f"{eager_lib_e:.4f}",
          decode_err=f"{err_d:.3e}", decode_rel=f"{rel_d:.3e}",
          decode_ms=f"{ms_d:.4f}", decode_eager_ms=f"{eager_d:.4f}",
          decode_plain_ms=f"{ms_dp:.4f}",
          decode_bound_ms=f"{decode_bound[0]:.4f}",
          decode_library_ms=lib_d and f"{lib_d:.4f}",
          decode_library_eager_ms=lib_d and f"{eager_lib_d:.4f}",
          **{k_: f"{x:.3e}" for k_, x in control.items()},
          tol=f"extend:{EXTEND_ABS_TOL}/{EXTEND_REL_TOL},"
              f"decode:{DECODE_ABS_TOL}/{DECODE_REL_TOL}"
              + (f",+{rnd:g}|want|" if rnd else "")
              + (f",off>{OFF_CONTROL}x" if control else ""))
    del k, v, state, plain, kv, dkv, pkv
    if library:
        del krow, vrow
    torch.cuda.empty_cache()
    return {"extend": dict(err=err_e, ms=ms_e, plain_ms=ms_ep,
                           library_ms=lib_e, bound_ms=extend_bound[0],
                           bound_by=extend_bound[1]),
            "decode": dict(err=err_d, ms=ms_d, plain_ms=ms_dp,
                           library_ms=lib_d, bound_ms=decode_bound[0],
                           bound_by=decode_bound[1])}


def weight_sums():
    """Sums over the four projections of one weight kernel at one row
    count: max abs error, graph and eager ms of the kernel and of its
    library call, the plain twin's ms, bytes and operations."""
    return dict(err=0.0, ms=0.0, eager_ms=0.0, plain_ms=0.0,
                library_ms=0.0, library_eager_ms=0.0, nbytes=0, ops=0)


def add_times(acc, kernel, plain=None, library=None):
    """Time `kernel` and `library` (CUDA-graph replays and eager calls)
    and `plain` (eager, 3 calls) into the sums `acc`; a library of None
    leaves its sums None. Returns the readings as phase-line fields."""
    t, te = graph_ms(kernel), cuda_ms(kernel, reps=20)
    acc["ms"] += t
    acc["eager_ms"] += te
    out = dict(ms=f"{t:.4f}", eager_ms=f"{te:.4f}")
    if plain is not None:
        tp = cuda_ms(plain, reps=3)
        acc["plain_ms"] += tp
        out["plain_ms"] = f"{tp:.4f}"
    if library is None or acc["library_ms"] is None:
        acc["library_ms"] = acc["library_eager_ms"] = None
    else:
        tl, tle = graph_ms(library), cuda_ms(library, reps=20)
        acc["library_ms"] += tl
        acc["library_eager_ms"] += tle
        out.update(library_ms=f"{tl:.4f}", library_eager_ms=f"{tle:.4f}")
    return out


def finish_sums(acc, peak):
    """acc with its bound (ms, by) from the summed bytes and operations."""
    acc["bound"] = least_ms(acc["ops"], acc["nbytes"], peak)
    return acc


def w4a8_phase(torch, qm, quantize_w4, dev, g, shapes=W4_SHAPES,
               rows=WEIGHT_ROWS):
    """The W4A8 kernel vs its plain twin at the 7B's four decode
    projections, B 4 and B 64, each run twice (bitwise equal) → {B:
    weight_sums of the four} (bound: packed weights, scales, activations
    and output once each, int8 operations at the int8 peak; no library
    call); the plain twin is timed at B 4 only."""
    accs = {B: weight_sums() for B in rows}
    for acc in accs.values():
        acc["library_ms"] = acc["library_eager_ms"] = None
    # rows past 4 from a generator of their own, so that the B 4 inputs
    # and the later phases' stay
    g64 = torch.Generator(device=dev).manual_seed(SEED + qm.MAX_TOKENS)
    for name, K, N in shapes:
        w = torch.randn((N, K), generator=g, device=dev) * 0.02
        packed, scale = quantize_w4(w)
        del w
        for B, acc in accs.items():
            h = torch.randn((B, K), generator=g if B == 4 else g64,
                            device=dev, dtype=torch.bfloat16)
            got = qm.w4a8_matmul_tiled(h, packed, scale,
                                       out_dtype=torch.float32)
            again = qm.w4a8_matmul_tiled(h, packed, scale,
                                         out_dtype=torch.float32)
            got16 = qm.w4a8_matmul_tiled(h, packed, scale)
            want = qm.w4a8_matmul_tiled_plain(h, packed, scale,
                                              out_dtype=torch.float32)
            torch.cuda.synchronize()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            check(torch.equal(got, again), f"w4a8 {name} B{B}: runs differ")
            check(rel <= W4A8_REL_TOL, f"w4a8 {name} B{B}: rel err {rel}")
            # bf16 output: one bf16 rounding of the twin, plus the fp32 slack
            bound = want.abs() * INT8_ROUNDING \
                + W4A8_REL_TOL * want.abs().max()
            check(bool(((got16.float() - want).abs() <= bound).all()),
                  f"w4a8 {name} B{B}: bf16 output off the twin")
            times = add_times(
                acc, lambda: qm.w4a8_matmul_tiled(h, packed, scale),
                plain=((lambda: qm.w4a8_matmul_tiled_plain(h, packed, scale))
                       if B == 4 else None))
            phase("kernels", w4a8=name, B=B, K=K, N=N, rel_err=f"{rel:.3e}",
                  tol=W4A8_REL_TOL, bitwise_repeat=True, **times,
                  weight_mb=f"{(packed.numel() + 4 * scale.numel()) / 1e6:.1f}")
            acc["err"] = max(acc["err"], (got - want).abs().max().item())
            acc["nbytes"] += packed.numel() + 4 * scale.numel() \
                + 2 * h.numel() + 2 * B * N
            acc["ops"] += 2 * B * K * N
            del got, again, got16, want
        del packed, scale
    torch.cuda.empty_cache()
    return {B: finish_sums(acc, PEAK_INT8) for B, acc in accs.items()}


def int4pack_call(torch, packed, scale, h):
    """The library yardstick of W4A16: (a function making one
    torch._weight_int4pack_mm on the same W4 weights, converted once
    beforehand by torch._convert_weight_to_int4pack with a zero point of
    0, and its result), or (None, the reason) where this torch lacks the
    op or refuses the layout. packed [N, K/2] / scale [N, K/g] as
    quantize_w4 gives them (grid values in [-8, 7])."""
    N, K = packed.shape[0], 2 * packed.shape[1]
    group = K // scale.shape[1]
    b = packed.view(torch.uint8).to(torch.int32)
    u = torch.stack([(b & 0xF) ^ 8, (b >> 4) ^ 8], -1).reshape(N, K)
    try:
        # unsigned nibbles u = q + 8: the op computes (u - 8) * s + zero;
        # even inputs in the high nibble, as the op's packer expects
        w = torch._convert_weight_to_int4pack(
            ((u[:, 0::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([scale.t(), torch.zeros_like(scale.t())],
                         -1).to(torch.bfloat16).contiguous()
        out = torch._weight_int4pack_mm(h, w, group, sz)
        return (lambda: torch._weight_int4pack_mm(h, w, group, sz)), out
    except (AttributeError, RuntimeError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def w4_flat_phase(torch, qm, quantize_w4, dev, g, shapes=W4_SHAPES,
                  rows=WEIGHT_ROWS):
    """The flat-layout W4A8 and W4A16 kernels vs their plain twins at the
    7B's four decode projections, B 4 and B 64, fp32 output, each run
    twice (bitwise equal) → {("w4a8" | "w4a16", B): weight_sums}; both
    move the same bytes: packed weights, scales, activations and output
    once each. W4A16's library yardstick is torch._weight_int4pack_mm
    (int4pack_call); the plain twins are timed at B 4 only."""
    res = {}
    # rows past 4 from a generator of their own, so that the B 4 inputs
    # and the later phases' stay
    g64 = torch.Generator(device=dev).manual_seed(SEED + qm.MAX_TOKENS)
    for kname, kernel, plain, tol in (
            ("w4a8", qm.w4a8_matmul, qm.w4a8_matmul_plain, W4A8_REL_TOL),
            ("w4a16", qm.w4a16_matmul, qm.w4a16_matmul_plain,
             W4A16_REL_TOL)):
        peak = PEAK_INT8 if kname == "w4a8" else PEAK_BF16
        accs = {B: weight_sums() for B in rows}
        if kname == "w4a8":
            for acc in accs.values():
                acc["library_ms"] = acc["library_eager_ms"] = None
        for name, K, N in shapes:
            w = torch.randn((N, K), generator=g, device=dev) * 0.02
            packed, scale = quantize_w4(w)
            pk, s = qm.w4_to_flat(packed, scale)
            del w
            for B, acc in accs.items():
                h = torch.randn((B, K), generator=g if B == 4 else g64,
                                device=dev, dtype=torch.bfloat16)
                got = kernel(h, pk, s, out_dtype=torch.float32)
                again = kernel(h, pk, s, out_dtype=torch.float32)
                want = plain(h, pk, s, out_dtype=torch.float32)
                torch.cuda.synchronize()
                rel = ((got - want).abs().max() / want.abs().max()).item()
                check(torch.equal(got, again),
                      f"{kname} {name} B{B}: runs differ")
                check(rel <= tol, f"{kname} {name} B{B}: rel err {rel}")
                lib, lib_fields = None, {}
                if acc["library_ms"] is not None:
                    lib, lib_out = int4pack_call(torch, packed, scale, h)
                    if lib is None:
                        lib_fields = dict(library="none",
                                          reason=repr(lib_out))
                    else:
                        lib_fields = dict(library_rel=(
                            f"{((lib_out.float() - want).abs().max() / want.abs().max()).item():.3e}"))
                times = add_times(
                    acc, lambda: kernel(h, pk, s),
                    plain=(lambda: plain(h, pk, s)) if B == 4 else None,
                    library=lib)
                phase("kernels", **{kname: name}, layout="flat", B=B, K=K,
                      N=N, rel_err=f"{rel:.3e}", tol=tol,
                      bitwise_repeat=True, **times, **lib_fields)
                acc["err"] = max(acc["err"], (got - want).abs().max().item())
                acc["nbytes"] += pk.numel() + 4 * s.numel() + 2 * h.numel() \
                    + 2 * B * N
                acc["ops"] += 2 * B * K * N
                del got, again, want, lib
            del pk, s, packed, scale
        for B, acc in accs.items():
            res[(kname, B)] = finish_sums(acc, peak)
    torch.cuda.empty_cache()
    return res


def fused_mlp_check(torch, qm, h, tiles, label):
    """The fused W4 MLP kernel on h vs its bf16 twin, fp32 and bf16
    output: bitwise repeatable, finite, every output within
    qm.fused_mlp_w4_bound (where the tree has it), and the fp32 control
    outside that bound on at least FUSED_MLP_CONTROL_SHARE of the outputs
    → phase-line fields."""
    got = qm.fused_mlp_w4(h, *tiles, out_dtype=torch.float32)
    again = qm.fused_mlp_w4(h, *tiles, out_dtype=torch.float32)
    got16 = qm.fused_mlp_w4(h, *tiles)
    want = qm.fused_mlp_w4_plain(h, *tiles, out_dtype=torch.float32,
                                 compute_dtype=torch.bfloat16)
    # control: the same MLP computed in fp32 (no bf16 rounding of the
    # activation or the down weights)
    f32 = qm.fused_mlp_w4_plain(h, *tiles, out_dtype=torch.float32,
                                compute_dtype=torch.float32)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    check(torch.equal(got, again), f"fused_mlp_w4 {label}: runs differ")
    check(bool(torch.isfinite(got).all()), f"fused_mlp_w4 {label}: not "
                                           f"finite")
    out = dict(rel_err=f"{err / want.abs().max().item():.3e}",
               max_abs_err=f"{err:.3e}", bitwise_repeat=True,
               fp32_control_rel=f"{((f32 - want).abs().max() / want.abs().max()).item():.3e}")
    bound_fn = getattr(qm, "fused_mlp_w4_bound", None)
    if bound_fn is None:
        out["bound"] = "none (a tree without fused_mlp_w4_bound)"
        return err, out
    bound = bound_fn(h, *tiles)
    check(bool((diff <= bound).all()),
          f"fused_mlp_w4 {label}: {int((diff > bound).sum())} outputs past "
          f"the bound (worst |Δ| / bound {(diff / bound).max().item():.3g})")
    check(bool(((got16.float() - want).abs()
                <= want.abs() * INT8_ROUNDING + 2 * bound).all()),
          f"fused_mlp_w4 {label}: bf16 output off the twin")
    outside = ((f32 - want).abs() > bound).float().mean().item()
    check(outside >= FUSED_MLP_CONTROL_SHARE,
          f"fused_mlp_w4 {label}: the fp32 control is outside the bound on "
          f"only {outside:.3f} of the outputs")
    out.update(err_over_bound=f"{(diff / bound).max().item():.3e}",
               bound_rel_max=f"{(bound.max() / want.abs().max()).item():.3e}",
               fp32_control_outside=f"{outside:.3f}")
    return err, out


def fused_two_call(torch, qm, gu, dn, x):
    """The MLP as the engine runs it without the fused kernel:
    w4a8_matmul_tiled gateup, silu·mul, w4a8_matmul_tiled down (gu, dn:
    stripe (packed, scale) pairs)."""
    gate, up = qm.w4a8_matmul_tiled(x, *gu).chunk(2, dim=-1)
    return qm.w4a8_matmul_tiled(torch.nn.functional.silu(gate) * up, *dn)


def fused_mlp_phase(torch, qm, quantize_w4, dev, g, D=4096, I=11008, B=4):
    """The fused W4 MLP kernel vs its bf16 twin at one 7B layer's MLP,
    B 4 and B 64 (`fused_mlp_check`), with kernel, twin and bound ms;
    and, as the fusion's yardstick, the separate-call path of the same
    layer (w4a8_matmul_tiled gateup, silu·mul, w4a8_matmul_tiled down,
    as the engine runs it without the fused MLP), both as CUDA-graph
    replays and eager calls, at B 4 and B 64 → weight_sums at B 4 with
    two_call_ms (graph) and the B 64 readings beside."""
    gu = quantize_w4(torch.randn((2 * I, D), generator=g, device=dev) * 0.02)
    dn = quantize_w4(torch.randn((D, I), generator=g, device=dev) * 0.02)
    tiles = qm.w4_mlp_tile_layout(*qm.w4_to_flat(*gu), *qm.w4_to_flat(*dn))
    h = torch.randn((B, D), generator=g, device=dev, dtype=torch.bfloat16)
    err, fields = fused_mlp_check(torch, qm, h, tiles, f"B{B}")
    grid = getattr(qm, "fused_mlp_grid", None)
    if grid is not None:
        fields["clusters"] = "{}x{}/{}ch".format(tiles[0].shape[0],
                                                 *grid(B, *tiles[:3]))
    acc = weight_sums()
    acc["library_ms"] = acc["library_eager_ms"] = None
    times = add_times(acc, lambda: qm.fused_mlp_w4(h, *tiles),
                      plain=lambda: qm.fused_mlp_w4_plain(h, *tiles))

    def two_call(x):
        return fused_two_call(torch, qm, gu, dn, x)

    t2, t2e = graph_ms(lambda: two_call(h)), cuda_ms(lambda: two_call(h),
                                                      reps=20)
    # the engine sends up to MAX_TOKENS decode rows: both paths at 64
    # (from a generator of their own, so the later phases' inputs stay)
    g64 = torch.Generator(device=dev).manual_seed(SEED + qm.MAX_TOKENS)
    h64 = torch.randn((qm.MAX_TOKENS, D), generator=g64, device=dev,
                      dtype=torch.bfloat16)
    err64, fields64 = fused_mlp_check(torch, qm, h64, tiles,
                                      f"B{qm.MAX_TOKENS}")
    if grid is not None:
        fields64["clusters"] = "{}x{}/{}ch".format(
            tiles[0].shape[0], *grid(qm.MAX_TOKENS, *tiles[:3]))
    t64 = graph_ms(lambda: qm.fused_mlp_w4(h64, *tiles))
    t64e = cuda_ms(lambda: qm.fused_mlp_w4(h64, *tiles), reps=20)
    t2_64 = graph_ms(lambda: two_call(h64))
    acc["err"] = max(err, err64)
    wbytes = sum(x.numel() * x.element_size() for x in tiles)
    acc["nbytes"] = wbytes + 2 * h.numel() + 2 * B * D
    acc["ops"] = 2 * B * D * 3 * I
    finish_sums(acc, PEAK_INT8)
    acc.update(two_call_ms=t2, ms_b64=t64, eager_ms_b64=t64e,
               two_call_ms_b64=t2_64,
               bound_b64=least_ms(2 * qm.MAX_TOKENS * D * 3 * I,
                                  wbytes + 4 * qm.MAX_TOKENS * D, PEAK_INT8))
    phase("kernels", fused_mlp_w4=f"B{B}/D{D}/I{I}", **fields, **times,
          two_call_ms=f"{t2:.4f}", two_call_eager_ms=f"{t2e:.4f}",
          bound_ms=f"{acc['bound'][0]:.4f}", weight_mb=f"{wbytes / 1e6:.1f}")
    phase("kernels", fused_mlp_w4=f"B{qm.MAX_TOKENS}/D{D}/I{I}", **fields64,
          ms=f"{t64:.4f}", eager_ms=f"{t64e:.4f}",
          two_call_ms=f"{t2_64:.4f}",
          bound_ms=f"{acc['bound_b64'][0]:.4f}")
    del gu, dn, tiles
    torch.cuda.empty_cache()
    return acc


def w8a8_phase(torch, qm, quantize_w8, dev, g, shapes=W4_SHAPES,
               rows=WEIGHT_ROWS):
    """The W8A8 kernel vs its plain twin at the 7B's four decode
    projections, B 4 and B 64: bitwise the twin's with fp32 and with bf16
    output; timed beside torch._int_mm's int32 product on the same int8
    operands (the rows zero-padded to at least 32, as the engine's extend
    pads them) → {B: weight_sums} (bound: int8 weights, their scales,
    activations and scales and output once each, int8 operations at the
    int8 peak); the plain twin is timed at B 4 only."""
    accs = {B: weight_sums() for B in rows}
    g64 = torch.Generator(device=dev).manual_seed(SEED + qm.MAX_TOKENS)
    for name, K, N in shapes:
        w8, s_w = quantize_w8(torch.randn((N, K), generator=g, device=dev)
                              * 0.02)
        for B, acc in accs.items():
            h8, s_a = qm.quantize_activations(torch.randn(
                (B, K), generator=g if B == 4 else g64, device=dev,
                dtype=torch.bfloat16))
            got = qm.w8a8_matmul(h8, s_a, w8, s_w, out_dtype=torch.float32)
            got16 = qm.w8a8_matmul(h8, s_a, w8, s_w)
            want = qm.w8a8_matmul_plain(h8, s_a, w8, s_w,
                                        out_dtype=torch.float32)
            torch.cuda.synchronize()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            check(rel <= W8A8_REL_TOL, f"w8a8 {name} B{B}: rel err {rel}")
            check(torch.equal(got, want), f"w8a8 {name} B{B}: fp32 output "
                                          f"not bitwise the twin's")
            check(torch.equal(got16, want.to(torch.bfloat16)),
                  f"w8a8 {name} B{B}: bf16 output not bitwise the twin's")
            hp = torch.nn.functional.pad(h8, (0, 0, 0, max(32, B) - B))
            wt = w8.t()
            times = add_times(
                acc, lambda: qm.w8a8_matmul(h8, s_a, w8, s_w),
                plain=((lambda: qm.w8a8_matmul_plain(h8, s_a, w8, s_w))
                       if B == 4 else None),
                library=lambda: torch._int_mm(hp, wt))
            phase("kernels", w8a8=name, B=B, K=K, N=N, rel_err=f"{rel:.3e}",
                  bitwise=True, tol=W8A8_REL_TOL, **times,
                  weight_mb=f"{(w8.numel() + 4 * s_w.numel()) / 1e6:.1f}")
            acc["err"] = max(acc["err"], (got - want).abs().max().item())
            acc["nbytes"] += w8.numel() + 4 * s_w.numel() + h8.numel() \
                + 4 * B + 2 * B * N
            acc["ops"] += 2 * B * K * N
            del got, got16, want, hp, wt
        del w8, s_w
    torch.cuda.empty_cache()
    return {B: finish_sums(acc, PEAK_INT8) for B, acc in accs.items()}


def quantize_phase(torch, qm, dev, shapes=W4_SHAPES, B=4):
    """The one-launch activation quantizer of the W8A8 decode path vs
    quantize_activations (its plain twin, ~8 launches) on the four
    projections' bf16 inputs, B 4 (from a generator of its own): h8 and
    s_a bitwise equal → weight_sums (bound: bf16 in, int8 and scales out
    once each; err is 0 when every check passed)."""
    gq = torch.Generator(device=dev).manual_seed(SEED + 9)
    acc = weight_sums()
    acc["library_ms"] = acc["library_eager_ms"] = None
    for name, K, _ in shapes:
        h = torch.randn((B, K), generator=gq, device=dev,
                        dtype=torch.bfloat16)
        h8, s_a = qm.quantize_rows(h)
        w8, ws_a = qm.quantize_activations(h)
        torch.cuda.synchronize()
        check(torch.equal(h8, w8) and torch.equal(s_a, ws_a),
              f"quantize_rows {name}: not bitwise quantize_activations")
        times = add_times(acc, lambda: qm.quantize_rows(h),
                          plain=lambda: qm.quantize_activations(h))
        phase("kernels", quantize_rows=name, B=B, K=K, bitwise=True, **times)
        acc["nbytes"] += 2 * B * K + B * K + 4 * B
        acc["ops"] += 3 * B * K
    return finish_sums(acc, PEAK_BF16)


def flash_case(torch, fa, dev, g, B, T, H, Hkv, q_offset=0,
               segments=False, with_lse=False, timed=False):
    """The flash kernels vs the fp32 twin on one seeded case (causal, D =
    128): out, lse, and dQ/dK/dV from one backward with a random dO (and
    a random lse cotangent with with_lse); a second backward must agree
    bitwise → errors, and with timed (H == Hkv, no segments) the kernels',
    the twin's and SDPA's times and the three kernels' bounds."""
    import torch.nn.functional as F
    D, S = 128, T + q_offset
    bf = dict(device=dev, dtype=torch.bfloat16)
    q = torch.randn((B, T, H, D), generator=g, **bf)
    k = torch.randn((B, S, Hkv, D), generator=g, **bf)
    v = torch.randn((B, S, Hkv, D), generator=g, **bf)
    dout = torch.randn((B, T, H, D), generator=g, **bf)
    kw = dict(causal=True, q_offset=q_offset)
    segs = (None, None)
    if segments:
        # three packed documents; the last row's tail carries an id no
        # key has, so those queries see nothing
        seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
        seg[:, S // 3:] = 1
        seg[:, 2 * S // 3:] = 2
        qseg = seg[:, q_offset:].clone()
        qseg[-1, 3 * T // 4:] = 9
        segs = (qseg, seg)
        kw.update(q_segment_ids=qseg, kv_segment_ids=seg)
    cots = [dout]
    if with_lse:
        cots.append(torch.randn((B, H, T), generator=g, device=dev))

    def run(fn, leaves):
        outs = fn(*leaves)
        outs = outs if with_lse else outs[:1]
        cot = [c.to(outs[0].dtype) if i == 0 else c
               for i, c in enumerate(cots)]
        return outs, torch.autograd.grad(outs, leaves, cot)

    def kernel(*a):
        if with_lse:
            return fa.flash_attention_lse(*a, **kw)
        return fa.flash_attention(*a, **kw), None

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (out, *lse), grads = run(kernel, leaves)
    _, again = run(kernel, [t.clone().requires_grad_() for t in (q, k, v)])
    fleaves = [t.float().requires_grad_() for t in (q, k, v)]
    (w_out, *w_lse), w_grads = run(
        lambda *a: fa.flash_attention_plain(*a, **kw), fleaves)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "flash backward is not bitwise repeatable")
    diff = (out.float() - w_out).abs()
    res = {"out_err": diff.max().item(),
           "row_rel": (diff.amax(-1) / w_out.abs().amax(-1).clamp_min(
               1e-6)).max().item()}
    if with_lse:
        res["lse_err"] = (lse[0] - w_lse[0]).abs().max().item()
    else:   # the kernels' lse of the same inputs, through the forward op
        qf, kf, vf, qs, ks = fa._card_inputs(q, k, v, *segs)
        _, lse_k = torch.ops.aurora_tpu_torch.flash_fwd(
            qf, kf, vf, qs, ks, True, D ** -0.5, q_offset)
        w_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw)[1]
        res["lse_err"] = (lse_k - w_lse).abs().max().item()
    for name, a, b in zip(("dq", "dk", "dv"), grads, w_grads):
        res[name + "_err"] = (a.float() - b).abs().max().item()
        res[name + "_rel"] = ((a.float() - b).abs().max()
                              / b.abs().max()).item()
    if segments:
        check(bool((out[-1, 3 * T // 4:] == 0).all()),
              "flash rows that see no key are not zero")
    check(bool(torch.isfinite(out).all())
          and all(bool(torch.isfinite(t).all()) for t in grads),
          "flash outputs not finite")
    check(res["out_err"] <= FLASH_ABS_TOL, f"flash out err {res}")
    check(res["row_rel"] <= FLASH_ROW_TOL, f"flash out row rel {res}")
    check(res["lse_err"] <= FLASH_LSE_TOL, f"flash lse err {res}")
    check(all(res[n + "_rel"] <= FLASH_GRAD_TOL for n in ("dq", "dk", "dv")),
          f"flash grad rel {res}")
    del out, lse, grads, again, w_out, w_lse, w_grads, fleaves
    if timed:
        res.update(flash_times(torch, F, fa, q, k, v, dout))
    phase("kernels", flash=f"B{B}/T{T}/S{S}/H{H}/Hkv{Hkv}/D{D}",
          q_offset=q_offset, segments=segments, lse_cotangent=with_lse,
          **{k_: (f"{x:.4g}" if isinstance(x, float) else x)
             for k_, x in res.items()},
          tol=f"{FLASH_ABS_TOL}/{FLASH_ROW_TOL}/{FLASH_LSE_TOL}/"
              f"{FLASH_GRAD_TOL}")
    torch.cuda.empty_cache()
    return res


def flash_times(torch, F, fa, q, k, v, dout):
    """Each flash kernel alone, the wrapper forward + backward, the fp32
    twin's and SDPA's (is_causal) forward, backward and forward +
    backward — CUDA-event medians — with the three kernels' bounds at
    these inputs."""
    B, T, H, D = q.shape
    scale = D ** -0.5
    out, lse = torch.ops.aurora_tpu_torch.flash_fwd(q, k, v, None, None,
                                                    True, scale, 0)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    args = (q, k, v, dout, lse, delta, None, None, True, scale, 0)
    t = {"fwd_ms": cuda_ms(lambda: torch.ops.aurora_tpu_torch.flash_fwd(
        q, k, v, None, None, True, scale, 0), reps=10),
         "dkv_ms": cuda_ms(lambda: fa.bwd_dkv(*args), reps=10),
         "dq_ms": cuda_ms(lambda: fa.bwd_dq(*args), reps=10)}
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    t["fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        fa.flash_attention(*leaves, causal=True), leaves, dout), reps=10)
    fleaves = [x.float().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        t["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            *fleaves, causal=True), reps=3)
    t["plain_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        fa.flash_attention_plain(*fleaves, causal=True)[0], fleaves,
        dout.float()), reps=3)
    w_out = fa.flash_attention_plain(*fleaves, causal=True)[0]
    t["plain_bwd_ms"] = grad_ms(torch, w_out, fleaves, dout.float(), reps=3)
    del w_out, fleaves
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)
    with torch.no_grad():
        t["library_fwd_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), reps=10)
    t["library_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), leaves,
        dout.transpose(1, 2)), reps=10)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    t["library_bwd_ms"] = grad_ms(torch, lib_out, leaves,
                                  dout.transpose(1, 2), reps=10)
    # each visible (query, key) pair costs 2D multiply-adds per product:
    # forward QK^T and PV; dK/dV S^T, dP^T, dV, dK; dQ S, dP, dQ
    pairs = B * H * int(np.minimum(np.arange(T) + 1, T).sum())
    elem = q.numel() * 2
    rows = B * H * T * 4
    t["fwd_bound"] = least_ms(pairs * 4 * D, 4 * elem + rows)
    t["dkv_bound"] = least_ms(pairs * 8 * D, 6 * elem + 2 * rows)
    t["dq_bound"] = least_ms(pairs * 6 * D, 5 * elem + 2 * rows)
    # achieved TFLOP/s; SDPA's backward at the 5 products (10 D a pair)
    # of its own algorithm, ours at 14 D
    for name, ms, per_pair in (
            ("fwd", t["fwd_ms"], 4), ("dkv", t["dkv_ms"], 8),
            ("dq", t["dq_ms"], 6), ("library_fwd", t["library_fwd_ms"], 4),
            ("library_bwd", t["library_bwd_ms"], 10)):
        t[name + "_tflops"] = pairs * per_pair * D / ms / 1e9
    return t


def train_phase(torch, bs, dev, card, counters, plains):
    """bench.py's training stage on the port (train/bench_stage.py): 1
    warm-up + 5 timed steps, every count set to 0 just before and read
    just after → the flash kernels' launch counts."""
    from aurora_tpu_torch.train.metrics import megatron_tflops_per_device
    from aurora_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)
    torch.cuda.reset_peak_memory_stats()
    cfg = bs.aurora_config()
    model = bs.init_model(cfg, dev, SEED + 3)
    tcfg = bs.train_config()
    state = init_train_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    batch = bs.text_batch(cfg, dev)
    for obj, attr in counters + plains:
        setattr(obj, attr, 0)
    times = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        phase("train-step", step=i, ms=f"{times[-1] * 1e3:.1f}",
              loss=f"{loss:.5f}", grad_norm=f"{gnorm:.5f}",
              lr=f"{m['lr']:.4e}")
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"step {i}: loss {loss} grad_norm {gnorm}")
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in counters + plains}
    step_s = float(np.median(times[1:]))
    llm = cfg.llm
    B, T = batch["input_ids"].shape
    tflops = megatron_tflops_per_device(
        B * T, step_s, llm.hidden_size, llm.num_hidden_layers,
        llm.vocab_size, T, intermediate=llm.intermediate_size)
    n_layer_steps = llm.num_hidden_layers * TRAIN_STEPS
    fwd, dkv, dq = (counts[f"{obj.__name__}.{attr}"]
                    for obj, attr in counters)
    phase("train", card=repr(card),
          config=f"vicuna-7b-widths/L{llm.num_hidden_layers}/seq{T}/"
                 f"b{B}/bf16/adamw/remat-full/text-no-mask",
          step_ms=f"{step_s * 1e3:.1f}",
          tokens_per_s=f"{B * T / step_s:.1f}",
          tflops=f"{tflops:.1f}",
          mfu_pct=f"{tflops * 1e12 / PEAK_BF16 * 100:.1f}",
          first_step_ms=f"{times[0] * 1e3:.1f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          launches=json.dumps(counts).replace(" ", ""))
    check(fwd >= 2 * n_layer_steps and dkv >= n_layer_steps
          and dq >= n_layer_steps, f"flash launches {counts}")
    check(all(counts[f"{obj.__name__}.{attr}"] == 0 for obj, attr in plains),
          f"plain twins ran: {counts}")
    return fwd, dkv, dq


def train_parity(torch, bs, fa, dev):
    """One depth-2 step at the training widths through the flash kernels
    and one through mha_reference (SDPA), from the same weights: the
    second batch adds an all-true attention_mask, the same function,
    which `mha` sends off the kernels → relative differences of the loss
    and the grad norm, and the worst of each layer's q/k/v/o weight
    gradients (max |Δ| / max |want|)."""
    from aurora_tpu_torch.train.trainer import (Optimizer,
                                                init_train_state,
                                                make_train_step)

    class Recording(Optimizer):
        """The step's optimizer, keeping the attention weights' grads."""

        def update(self, grads, state, model, gnorm=None):
            self.grads = {n: g.clone() for n, g in zip(self.names, grads)
                          if n.split(".")[-2] in ("q", "k", "v", "o")}
            super().update(grads, state, model, gnorm)

    cfg = bs.aurora_config(layers=2)
    model = bs.init_model(cfg, dev, SEED + 4)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = bs.train_config()
    batch = bs.text_batch(cfg, dev, seed=6)
    masked = dict(batch, attention_mask=torch.ones_like(
        batch["input_ids"], dtype=torch.bool))
    got = []
    for b in (batch, masked):
        model.load_state_dict(weights)
        state = init_train_state(model, tcfg)
        opt = Recording(model, tcfg)
        launches = fa.flash_attention.launches_fwd
        _, m = make_train_step(cfg, tcfg, opt)(state, b)
        got.append((m["loss"].item(), m["grad_norm"].item(),
                    fa.flash_attention.launches_fwd - launches, opt.grads))
    (lk, gk, nk, wk), (lr_, gr, nr, wr) = got
    check(nk > 0 and nr == 0, f"flash launches {nk} / {nr}")
    check(len(wk) == 4 * cfg.llm.num_hidden_layers and set(wk) == set(wr),
          f"attention weight grads {sorted(wk)}")
    rel_loss, rel_gn = abs(lk - lr_) / abs(lr_), abs(gk - gr) / gr
    rel_w = {n: ((wk[n].float() - wr[n].float()).abs().max()
                 / wr[n].float().abs().max()).item() for n in wr}
    worst = max(rel_w, key=rel_w.get)
    phase("train-parity", layers=2, loss_kernels=f"{lk:.6f}",
          loss_sdpa=f"{lr_:.6f}", grad_norm_kernels=f"{gk:.6f}",
          grad_norm_sdpa=f"{gr:.6f}", rel_loss=f"{rel_loss:.3e}",
          rel_grad_norm=f"{rel_gn:.3e}", tol=TRAIN_PARITY_TOL,
          attn_grad_rel_worst=f"{rel_w[worst]:.3e}", worst_leaf=worst,
          attn_grad_rel_median=f"{float(np.median(list(rel_w.values()))):.3e}",
          grad_tol=TRAIN_GRAD_TOL)
    check(rel_loss <= TRAIN_PARITY_TOL and rel_gn <= TRAIN_PARITY_TOL,
          f"train parity {rel_loss} / {rel_gn}")
    check(rel_w[worst] <= TRAIN_GRAD_TOL,
          f"train parity attention grads {rel_w}")


def serve(torch, engine, reqs, counters, max_new=MAX_NEW):
    """Drive the engine through `reqs` with every count in `counters` set
    to 0 just before; check max_new tokens each → (wall s, counts)."""
    for obj, attr in counters:
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    for r in reqs:
        engine.add_request(r)
    done = {}
    while engine.has_work():
        for r in engine.step():
            done[r.rid] = r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in counters}
    from aurora_tpu_torch.serve.scheduler import FinishReason
    V = engine.cfg.vocab_size
    check(len(done) == len(reqs), f"{len(done)} requests finished")
    for r in done.values():
        check(r.finished == FinishReason.LENGTH and r.error is None,
              f"{r.rid}: finished={r.finished} error={r.error}")
        check(len(r.output_ids) == max_new,
              f"{r.rid}: {len(r.output_ids)} tokens")
        check(all(0 <= t < V for t in r.output_ids), f"{r.rid}: bad ids")
    return wall, counts


def logits_check(torch, engine_mod, runner, embed, reqs, tol, name, plain,
                 decode=False, decode_tol=LOGITS_DECODE_REL_TOL,
                 reason=None):
    """One extend wave's logits (each request's prompt embeds, `embed(r)`
    [n_i, D], in a lane of the smallest bucket that holds them all)
    through the kernels and through the plain twins (patched into the
    engine module, and into models/llama.py for the fused MLP, for that
    call only); with `decode`, then one decode step of every lane (the
    kernels' greedy token at the position after its prompt) both ways.
    Each decode forward writes its own token's K/V before it attends, so
    the second overwrites the first's."""
    import contextlib
    from aurora_tpu_torch.models import llama as llama_mod

    def plain_twins():
        stack = contextlib.ExitStack()
        for mod in (engine_mod, llama_mod):
            names = {k: v for k, v in plain.items() if hasattr(mod, k)}
            if names:
                stack.enter_context(mock.patch.multiple(mod, **names))
        return stack

    dev = runner.device
    plens = [len(r.input_ids) for r in reqs]
    T = min(b for b in runner.ecfg.prefill_buckets if b >= max(plens))
    n = len(reqs)
    embeds = torch.zeros((n, T, runner.cfg.hidden_size),
                         dtype=torch.bfloat16, device=dev)
    for i, r in enumerate(reqs):
        embeds[i, :plens[i]] = embed(r)
    row_ids = np.arange(n, dtype=np.int32)
    offs = np.zeros(n, np.int32)
    lens = np.asarray(plens, np.int32)
    logits_k = runner.extend(embeds, row_ids, offs, lens)
    with plain_twins():
        logits_p = runner.extend(embeds, row_ids, offs, lens)
    fields = {}
    if decode:
        ids = torch.as_tensor(row_ids, device=dev)
        pos = torch.as_tensor(lens, device=dev)
        x = runner.model.embed_tokens[logits_k.argmax(-1)][:, None]

        def step():
            with torch.no_grad():
                h = engine_mod._forward_rows(runner.model, runner.cfg, x,
                                             runner.rows, ids, pos, pos + 1,
                                             runner.layer_ids)
                return engine_mod._lm_head(runner.model, h)

        dec_k = step()
        with plain_twins():
            dec_p = step()
        check(bool(torch.isfinite(dec_k).all()),
              f"{name} decode logits not finite")
        dec_rel = ((dec_k - dec_p).abs().max() / dec_p.abs().max()).item()
        dec_agree = int((dec_k.argmax(-1) == dec_p.argmax(-1)).sum())
        fields = dict(decode_rel_err=f"{dec_rel:.3e}",
                      decode_tol=decode_tol,
                      decode_argmax_agree=f"{dec_agree}/{n}")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), f"{name} logits not finite")
    check(tuple(logits_k.shape) == (n, runner.cfg.vocab_size),
          f"{name} logits shape")
    rel = ((logits_k - logits_p).abs().max()
           / logits_p.abs().max()).item()
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    if reason:
        fields["reason"] = repr(reason)
    phase(name, rel_err=f"{rel:.3e}", tol=tol, argmax_agree=f"{agree}/{n}",
          **fields)
    check(rel <= tol, f"{name} rel err {rel}")
    if decode:
        check(dec_rel <= decode_tol, f"{name} decode rel err {dec_rel}")


def mistral_phase(torch, engine_mod, ra, dev, card, plains):
    """Mistral-7B at its published widths and depth, random bf16 weights
    from the seed, serving N_REQUESTS prompts of MISTRAL_PROMPT random
    token ids (all longer than the 4096-token window, so the window masks
    real keys in every extend wave and decode step) through ServeEngine
    with bf16, int8 and packed int4 KV; each run's windowed launch counts
    (32 a wave, 32 a decode step), the twins' (0), and its logits check →
    {run: (windowed extend launches, windowed decode launches)}."""
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    cfg = LlamaConfig.mistral_7b()
    L, w = cfg.num_hidden_layers, cfg.sliding_window
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm = build(LlamaModel, cfg, device=dev, dtype=torch.bfloat16,
                generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size()
                    for p in llm.parameters()) / 1e9
    rng = np.random.default_rng(SEED + 7)
    plens = rng.integers(MISTRAL_PROMPT[0], MISTRAL_PROMPT[1] + 1,
                         size=N_REQUESTS)
    check(plens.min() > w, f"prompts {plens} within the window {w}")
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in plens]
    plain = {"ragged_attention": ra.ragged_attention_plain,
             "ragged_decode_attention": ra.ragged_decode_attention_plain}
    out = {}
    for run, kv_quant, counter, max_new in MISTRAL_RUNS:
        ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=6400,
                            kv_chunk=1024, prefill_buckets=(6144,),
                            decode_steps=16, kv_quant=kv_quant,
                            disable_radix_cache=True)
        check(ecfg.s_row == 7168, f"s_row {ecfg.s_row}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(llm, cfg, ecfg, device=dev, seed=SEED)
        check(engine.runner.model is llm, f"{run}: the model was not served "
                                          "as given")
        waves = []
        extend_wave = engine._extend_wave

        def counted_wave(wave, extend_wave=extend_wave):
            waves.append(len(wave))
            return extend_wave(wave)

        engine._extend_wave = counted_wave
        counters = [(ra.ragged_attention, "launches_window"),
                    (ra.ragged_decode_attention, "launches_window"),
                    (ra.ragged_attention, counter),
                    (ra.ragged_decode_attention, counter)] + plains
        reqs = [Request(rid=f"m{i}", input_ids=list(p),
                        max_new_tokens=max_new, eos_ids=())
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, max_new)
        ext_w, dec_w, ext_n, dec_n = (counts[f"{f.__name__}.{a}"]
                                      for f, a in counters[:4])
        steps = engine._steps
        phase("serve-mistral-" + run, card=repr(card),
              config=f"mistral-7b/L{L}/window{w}/bf16-weights/kv-{run}",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=max_new, waves=len(waves), init_s=f"{init_s:.1f}",
              weight_gb=f"{weight_gb:.2f}",
              extend_s_per_wave=f"{engine.t_extend_s / len(waves):.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps,
              tokens_per_s=f"{N_REQUESTS * max_new / wall:.1f}",
              wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        check(len(waves) == 1 and waves[0] == N_REQUESTS, f"waves {waves}")
        check(ext_w == L * len(waves) == ext_n,
              f"windowed extend launches {ext_w} / {ext_n}, waves {waves}")
        check(dec_w == L * steps == dec_n,
              f"windowed decode launches {dec_w} / {dec_n}, steps {steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        logits_check(torch, engine_mod, engine.runner,
                     lambda r: llm.embed_tokens[torch.tensor(r.input_ids,
                                                             device=dev)],
                     reqs, MISTRAL_LOGITS_TOL[run], "logits-mistral-" + run,
                     plain, decode=True, decode_tol=MISTRAL_LOGITS_TOL[run],
                     reason=MISTRAL_LOGITS_REASON[run])
        out[run] = (ext_w, dec_w)
        del engine, counted_wave
        gc.collect()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    from aurora_tpu_torch.ops import cuda_build
    from aurora_tpu_torch.ops.pallas import flash_attention as fa
    from aurora_tpu_torch.ops.pallas import quant_matmul as qm
    from aurora_tpu_torch.ops.pallas import ragged_attention as ra
    from aurora_tpu_torch.serve import engine as engine_mod
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import (_PLACEHOLDER_BASE,
                                                   AuroraCapServing)
    from aurora_tpu_torch.train import bench_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(card, flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    attrs = {n: cuda_build.kernel_attrs(n)
             for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                       *(f"ragged_extend_{m}" for m in KV_MODES),
                       *(f"ragged_decode_{m}_g{g}" for m in KV_MODES
                         for g in (1, 4)),
                       *(f"{k}_b{b}" for k in ("w8a8", "w4a16", "w4a8",
                                                "w4a8_flat", "fused_mlp")
                         for b in (8, 64)))}
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          nvcc_seconds=f"{cuda_build.build_seconds:.1f}",
          library=cuda_build.library_path().name,
          **{n: "regs={regs}/local={local_bytes}/smem={smem}".format(**a)
             for n, a in attrs.items()})

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    kres = {(mode, hkv): attention_case(torch, ra, dev, g, hkv, mode)
            for mode in ("bf16", "int8", "int4") for hkv in (32, 8)}
    # the sliding window and the logit cap (Gemma2's 50) at the serving
    # shapes, then the window at Mistral-7B's (from a generator of their
    # own, so the later phases' inputs stay)
    gw = torch.Generator(device=dev).manual_seed(SEED + 6)
    for mode in ("bf16", "int8", "int4"):
        for hkv in (32, 8):
            for opts in SERVING_OPTIONS:
                attention_case(torch, ra, dev, gw, hkv, mode, **opts)
    mres = {mode: attention_case(torch, ra, dev, gw, 8, mode, **MISTRAL_CASE)
            for mode in ("bf16", "int8", "int4")}
    # decode lengths on the split boundaries (2 layers of rows suffice)
    for mode in KV_MODES:
        for hkv in (32, 8):
            for case in SPLIT_BOUNDARY_CASES:
                attention_case(torch, ra, dev, gw, hkv, mode, L=2, **case)
    torch.cuda.empty_cache()
    w4res = w4a8_phase(torch, qm, engine_mod._w4, dev, g)
    flat_res = w4_flat_phase(torch, qm, engine_mod._w4, dev, g)
    mlp_res = fused_mlp_phase(torch, qm, engine_mod._w4, dev, g)
    w8res = w8a8_phase(torch, qm, engine_mod._w8, dev, g)
    qres = quantize_phase(torch, qm, dev)
    flash_res = [
        flash_case(torch, fa, dev, g, bench_stage.BATCH, bench_stage.SEQ,
                   32, 32, timed=True),
        flash_case(torch, fa, dev, g, 2, 384, 8, 8, q_offset=128,
                   segments=True),
        flash_case(torch, fa, dev, g, 2, 1024, 32, 8, with_lse=True)]
    flash_t = flash_res[0]

    # ---- main path at full width, bf16 ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = AuroraConfig.auroracap_7b()
    t0 = time.perf_counter()
    model = init_aurora(cfg, device=dev, dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mm = AuroraCapServing(model, ByteTokenizer(), kept_ratio=KEPT_RATIO,
                          image_size=cfg.vit.image_size)
    n_vis = mm.n_visual_tokens()
    check(n_vis == 171, f"visual tokens per frame {n_vis} != 171")
    rng = np.random.default_rng(SEED)
    size = cfg.vit.image_size
    # four clips for each served configuration (the embed cache would skip
    # the ViT on a repeated clip), one more to warm the ViT
    runs = ("bf16", "w8kv8", "w4kv8", "w4kv4", "w4kv8-fused", "w4kv8-flat")
    clips = [rng.integers(0, 256, size=(N_FRAMES, size, size, 3),
                          dtype=np.uint8)
             for _ in range(len(runs) * N_REQUESTS + 1)]
    prompt = " ".join(["<image>"] * N_FRAMES) + \
        "\nDescribe the video in detail."

    def requests(run):
        first = runs.index(run) * N_REQUESTS
        return [mm.build_request(f"clip{i}", prompt, clips[i],
                                 max_new_tokens=MAX_NEW, eos_ids=())
                for i in range(first, first + N_REQUESTS)]

    reqs = requests("bf16")
    P = len(reqs[0].input_ids)
    for r in reqs:
        n_ph = sum(t >= _PLACEHOLDER_BASE for t in r.input_ids)
        check(n_ph == N_FRAMES * 171, f"{r.rid}: {n_ph} visual tokens")
    # warm the ViT (cuDNN/cuBLAS set-up) on a clip the runs do not use
    warm = mm.build_request("warm", prompt, clips[-1], max_new_tokens=1)
    mm._visual_groups(warm)
    torch.cuda.synchronize()

    vit_times = []

    def timed_embed_fn(req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mm.embed_fn(req)
        torch.cuda.synchronize()
        vit_times.append(time.perf_counter() - t)
        return out

    def report(engine, wall, counts):
        vit_s = float(np.mean(vit_times))
        llm_extend_s = engine.t_extend_s - sum(vit_times)
        decode_ms = engine.t_decode_s / max(engine._steps, 1) * 1e3
        return dict(card=repr(card), requests=N_REQUESTS, prompt_tokens=P,
                    visual_tokens=N_FRAMES * n_vis,
                    vit_proj_s_per_clip=f"{vit_s:.4f}",
                    extend_s=f"{llm_extend_s:.4f}",
                    decode_ms_per_step=f"{decode_ms:.3f}",
                    decode_steps=engine._steps,
                    tokens_per_s=f"{N_REQUESTS * MAX_NEW / wall:.1f}",
                    wall_s=f"{wall:.2f}",
                    peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                    launches=json.dumps(counts).replace(" ", ""))

    kernels = {"bf16": [(ra.ragged_attention, "launches"),
                        (ra.ragged_decode_attention, "launches")],
               "w8kv8": [(ra.ragged_attention, "launches_int8"),
                         (ra.ragged_decode_attention, "launches_int8"),
                         (qm.w8a8_matmul, "launches"),
                         (qm.quantize_rows, "launches")],
               "w4kv8": [(ra.ragged_attention, "launches_int8"),
                         (ra.ragged_decode_attention, "launches_int8"),
                         (qm.w4a8_matmul_tiled, "launches")],
               "w4kv4": [(ra.ragged_attention, "launches_int4"),
                         (ra.ragged_decode_attention, "launches_int4"),
                         (qm.w4a8_matmul_tiled, "launches")],
               "w4kv8-fused": [(ra.ragged_attention, "launches_int8"),
                               (ra.ragged_decode_attention, "launches_int8"),
                               (qm.w4a8_matmul_tiled, "launches"),
                               (qm.fused_mlp_w4, "launches")],
               "w4kv8-flat": [(ra.ragged_attention, "launches_int8"),
                              (ra.ragged_decode_attention, "launches_int8"),
                              (qm.w4a8_matmul, "launches")]}
    # launches a layer and a decode step of the W4 runs' weight kernels
    # (the extend waves, of more than MAX_TOKENS rows, dequantize instead)
    per_step = {"w4kv8": {(qm.w4a8_matmul_tiled, "launches"): 4},
                "w4kv4": {(qm.w4a8_matmul_tiled, "launches"): 4},
                "w4kv8-fused": {(qm.w4a8_matmul_tiled, "launches"): 2,
                                (qm.fused_mlp_w4, "launches"): 1},
                "w4kv8-flat": {(qm.w4a8_matmul, "launches"): 4}}
    # kernels a run must not launch: the other W4A8 layout, and W4A16,
    # which no serving path calls (its count in the JSON line is the one
    # the flat-layout run reads)
    absent = {"w4kv8-fused": [(qm.w4a8_matmul, "launches"),
                              (qm.w4a16_matmul, "launches")],
              "w4kv8-flat": [(qm.w4a8_matmul_tiled, "launches"),
                             (qm.fused_mlp_w4, "launches"),
                             (qm.w4a16_matmul, "launches")]}
    plains = [(ra.ragged_attention_plain, "calls"),
              (ra.ragged_decode_attention_plain, "calls"),
              (qm.w4a8_matmul_tiled_plain, "calls"),
              (qm.w8a8_matmul_plain, "calls"),
              (qm.w4a8_matmul_plain, "calls"),
              (qm.w4a16_matmul_plain, "calls"),
              (qm.fused_mlp_w4_plain, "calls")]
    counters = sorted({c for ks in (*kernels.values(), *absent.values())
                       for c in ks},
                      key=lambda c: (c[0].__name__, c[1])) + plains
    # the plain twins patched into the engine module for each logits check
    plain_patch = {"bf16": {"ragged_attention": ra.ragged_attention_plain},
                   "w8kv8": {"ragged_attention": ra.ragged_attention_plain,
                             "w8a8_matmul": qm.w8a8_matmul_plain},
                   "w4kv8": {"ragged_attention": ra.ragged_attention_plain,
                             "w4a8_matmul_tiled":
                                 qm.w4a8_matmul_tiled_plain},
                   "w4kv4": {"ragged_attention": ra.ragged_attention_plain,
                             "w4a8_matmul_tiled":
                                 qm.w4a8_matmul_tiled_plain}}
    # the three W4 + int8-KV runs also check a decode step, so their
    # patches take the decode attention too; the fused MLP is called from
    # models/llama.py
    decode_plain = {"ragged_attention": ra.ragged_attention_plain,
                    "ragged_decode_attention":
                        ra.ragged_decode_attention_plain}
    plain_patch["w4kv8"] = {**decode_plain,
                            "w4a8_matmul_tiled": qm.w4a8_matmul_tiled_plain}
    plain_patch["w4kv8-fused"] = {
        **decode_plain, "w4a8_matmul_tiled": qm.w4a8_matmul_tiled_plain,
        "fused_mlp_w4": qm.fused_mlp_w4_plain}
    plain_patch["w4kv8-flat"] = {**decode_plain,
                                 "w4a8_matmul": qm.w4a8_matmul_plain}
    tols = {"bf16": LOGITS_REL_TOL, "w8kv8": LOGITS_W8_REL_TOL,
            "w4kv8": LOGITS_W4_REL_TOL, "w4kv4": LOGITS_W4KV4_REL_TOL,
            "w4kv8-fused": LOGITS_W4_REL_TOL,
            "w4kv8-flat": LOGITS_W4_REL_TOL}
    launches = {}
    run_counts = {}

    def engine_config(weight_quant="none", kv_quant="none", **layout):
        return EngineConfig(max_batch=N_REQUESTS, kv_chunk=256,
                            prefill_buckets=(1536,), decode_steps=16,
                            disable_radix_cache=True,
                            max_seq_len=P + MAX_NEW,
                            weight_quant=weight_quant, kv_quant=kv_quant,
                            **layout)

    def serve_run(run, llm, names, weight_quant="none", kv_quant="none",
                  layout=None, **fields):
        """Serve the run's 4 requests from `llm` as given; check its
        kernels' launch counts rose and every plain twin's stayed 0; then
        its logits check. names: (serve phase, logits phase); layout: the
        W4 layout switches of EngineConfig."""
        vit_times.clear()
        ecfg = engine_config(weight_quant, kv_quant, **(layout or {}))
        engine = ServeEngine(llm, cfg.llm, ecfg, embed_fn=timed_embed_fn,
                             device=dev, seed=SEED)
        check(engine.runner.model is llm, f"{run}: the model was not "
                                          "served as given")
        reqs = requests(run)
        wall, counts = serve(torch, engine, reqs, counters)
        phase(names[0], **fields, **report(engine, wall, counts))
        run_counts[run] = counts
        launches[run] = [counts[f"{f.__name__}.{a}"] for f, a in
                         kernels[run]]
        check(all(n > 0 for n in launches[run]), f"launches {counts}")
        for (f, a), n in per_step.get(run, {}).items():
            want = n * cfg.llm.num_hidden_layers * engine._steps
            check(counts[f"{f.__name__}.{a}"] == want,
                  f"{run}: {f.__name__}.{a} = {counts[f'{f.__name__}.{a}']}"
                  f", {n} a layer and a decode step make {want}")
        check(all(counts[f"{f.__name__}.{a}"] == 0
                  for f, a in plains + absent.get(run, [])),
              f"plain twins or another layout's kernel ran: {counts}")
        logits_check(torch, engine_mod, engine.runner, mm.embed_fn, reqs,
                     tols[run], names[1], plain_patch[run],
                     decode=run in ("w4kv8", "w4kv8-fused", "w4kv8-flat"))
        del engine
        torch.cuda.empty_cache()

    def layer_gb(llm):
        return sum(b.numel() * b.element_size()
                   for b in llm.layers.buffers()) / 1e9

    def head_gb(llm):
        return sum(b.numel() * b.element_size()
                   for b in llm.lm_head.buffers()) / 1e9

    serve_run("bf16", model.llm, ("serve", "logits"), init_s=f"{init_s:.1f}")

    # ---- W8 weights + int8 KV (the bf16 source kept) ------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm_w8 = engine_mod.fuse_serving_weights(
        engine_mod.quantize_weights_int8(model.llm))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    serve_run("w8kv8", llm_w8, ("serve-w8kv8", "logits-w8kv8"),
              weight_quant="int8", kv_quant="int8",
              quantize_s=f"{quant_s:.2f}",
              w8_weight_gb=f"{layer_gb(llm_w8) + head_gb(llm_w8):.3f}")
    del llm_w8
    gc.collect()
    torch.cuda.empty_cache()

    # ---- W4 weights + int8 KV, then + packed int4 KV -------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm_w4 = engine_mod.fuse_serving_weights(
        engine_mod.quantize_weights_int4(model.llm, free_source=True))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase("quantize", seconds=f"{quant_s:.2f}",
          w4_layer_gb=f"{layer_gb(llm_w4):.3f}",
          int8_head_gb=f"{head_gb(llm_w4):.3f}")
    w4_gb = f"{layer_gb(llm_w4) + head_gb(llm_w4):.3f}"
    serve_run("w4kv8", llm_w4, ("serve-w4kv8", "logits-w4kv8"),
              weight_quant="int4", kv_quant="int8", w4_weight_gb=w4_gb)
    torch.cuda.reset_peak_memory_stats()
    serve_run("w4kv4", llm_w4, ("serve-w4kv4", "logits-w4kv4"),
              weight_quant="int4", kv_quant="int4", w4_weight_gb=w4_gb)

    # ---- the same W4 weights in the fused-MLP and the flat layouts --------
    for run, layout in (("w4kv8-fused", dict(w4_fused_mlp=True)),
                        ("w4kv8-flat", dict(w4_tiled=False))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm_laid = engine_mod.w4_decode_layout(
            llm_w4, cfg.llm, engine_config("int4", "int8", **layout))
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t0
        check(llm_laid is not llm_w4, f"{run}: the layout did not change")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        serve_run(run, llm_laid, ("serve-" + run, "logits-" + run),
                  weight_quant="int4", kv_quant="int8", layout=layout,
                  layout_s=f"{layout_s:.2f}",
                  w4_weight_gb=f"{layer_gb(llm_laid) + head_gb(llm_laid):.3f}")
        del llm_laid
        gc.collect()
        torch.cuda.empty_cache()

    # ---- Mistral-7B: the sliding window on the serving path -------------
    del llm_w4, model, mm
    gc.collect()
    torch.cuda.empty_cache()
    mistral = mistral_phase(torch, engine_mod, ra, dev, card, plains)

    # ---- training at 7B widths (bench.py's training stage) --------------
    flash_counters = [(fa.flash_attention, "launches_fwd"),
                      (fa.flash_attention, "launches_dkv"),
                      (fa.flash_attention, "launches_dq")]
    launches_fwd, launches_dkv, launches_dq = train_phase(
        torch, bench_stage, dev, card, flash_counters,
        plains + [(fa.flash_attention_plain, "calls")])
    torch.cuda.empty_cache()
    train_parity(torch, bench_stage, fa, dev)

    def entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
              bound_ms, library_ms, **extra):
        return {"name": name, "route": "cuda",
                "source": f"aurora_tpu_torch/csrc/{source}",
                "replaces": f"aurora_tpu/ops/pallas/{replaces}",
                "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms[0],
                "bound_by": bound_ms[1], "library_ms": library_ms, **extra}

    def weight_entry(name, source, replaces, launches, acc, acc64=None,
                     **extra):
        """ms and library_ms: CUDA-graph replays (device time), summed
        over the four projections at B 4; eager single calls beside them,
        and the B 64 readings where the phase took them."""
        if acc64 is not None:
            extra.update(ms_b64=acc64["ms"], eager_ms_b64=acc64["eager_ms"],
                         library_ms_b64=acc64["library_ms"],
                         bound_ms_b64=acc64["bound"][0],
                         max_abs_err=max(acc["err"], acc64["err"]))
        return entry(name, source, replaces, launches,
                     extra.pop("max_abs_err", acc["err"]), acc["ms"],
                     acc["plain_ms"], acc["bound"], acc["library_ms"],
                     eager_ms=acc["eager_ms"],
                     library_eager_ms=acc["library_eager_ms"], **extra)

    def attn_entry(name, source, replaces, launches, mode, kind):
        r = kres[(mode, 32)][kind]   # the Vicuna shape: Hq = Hkv = 32
        err = max(kres[(mode, h)][kind]["err"] for h in (32, 8))
        return entry(name, source, replaces, launches, err, r["ms"],
                     r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                     r["library_ms"])

    def window_entry(name, source, replaces, launches, mode, kind):
        r = mres[mode][kind]        # Mistral-7B's shapes, window 4096
        return entry(f"{name}[{mode},window]", source, replaces, launches,
                     r["err"], r["ms"], r["plain_ms"],
                     (r["bound_ms"], r["bound_by"]), r["library_ms"])

    def flash_err(*names):
        return max(res[n] for res in flash_res for n in names)

    kernels = [
        attn_entry("ragged_attention[bf16]", "ragged_extend.cu",
                   "ragged_attention.py:287", launches["bf16"][0], "bf16",
                   "extend"),
        attn_entry("ragged_decode_attention[bf16]", "ragged_decode.cu",
                   "ragged_attention.py:645", launches["bf16"][1], "bf16",
                   "decode"),
        attn_entry("ragged_attention[int8]", "ragged_extend.cu",
                   "ragged_attention.py:287", launches["w4kv8"][0], "int8",
                   "extend"),
        attn_entry("ragged_decode_attention[int8]", "ragged_decode.cu",
                   "ragged_attention.py:645", launches["w4kv8"][1], "int8",
                   "decode"),
        attn_entry("ragged_attention[int4]", "ragged_extend.cu",
                   "ragged_attention.py:287", launches["w4kv4"][0], "int4",
                   "extend"),
        attn_entry("ragged_decode_attention[int4]", "ragged_decode.cu",
                   "ragged_attention.py:645", launches["w4kv4"][1], "int4",
                   "decode"),
        # the sliding window at Mistral-7B's shapes; launches from the
        # Mistral runs (every launch there is windowed)
        *(window_entry(name, source, "ragged_attention.py:" + line,
                       mistral[run][i], mode, kind)
          for mode, run in (("bf16", "bf16"), ("int8", "kv8"),
                            ("int4", "kv4"))
          for i, (name, source, line, kind) in enumerate((
              ("ragged_attention", "ragged_extend.cu", "287", "extend"),
              ("ragged_decode_attention", "ragged_decode.cu", "645",
               "decode")))),
        # ms: the four decode projections of one layer at B = 4, summed,
        # as CUDA-graph replays; launches from the W4 + int8-KV run
        weight_entry("w4a8_matmul_tiled", "w4a8_matmul.cu",
                     "quant_matmul.py:305", launches["w4kv8"][2], w4res[4],
                     w4res[64]),
        # the same four projections in the flat layout (and at B 64);
        # launches from the flat-layout run
        weight_entry("w4a8_matmul", "w4a8_matmul.cu",
                     "quant_matmul.py:204", launches["w4kv8-flat"][2],
                     flat_res[("w4a8", 4)], flat_res[("w4a8", 64)]),
        # no serving path calls it (nor the reference's): timed at the
        # same four projections; launches as read after the flat-layout
        # run, whose counts were all set to 0 before it
        weight_entry("w4a16_matmul", "w4_flat_matmul.cu",
                     "quant_matmul.py:104",
                     run_counts["w4kv8-flat"]["w4a16_matmul.launches"],
                     flat_res[("w4a16", 4)], flat_res[("w4a16", 64)]),
        # one 7B layer's MLP at B = 4; launches from the fused-MLP run
        weight_entry("fused_mlp_w4", "fused_mlp_w4.cu",
                     "quant_matmul.py:474", launches["w4kv8-fused"][3],
                     mlp_res, two_call_ms=mlp_res["two_call_ms"],
                     ms_b64=mlp_res["ms_b64"],
                     eager_ms_b64=mlp_res["eager_ms_b64"],
                     bound_ms_b64=mlp_res["bound_b64"][0],
                     two_call_ms_b64=mlp_res["two_call_ms_b64"]),
        # the same four projections (and at B 64); library: torch._int_mm's
        # int32 product on the same operands
        weight_entry("w8a8_matmul", "w8a8_matmul.cu", "quant_matmul.py:41",
                     launches["w8kv8"][2], w8res[4], w8res[64]),
        # the W8A8 decode path's activation quantizer, at the four
        # projections' inputs, B 4: it replaces the reference's jnp
        # quantize_activations (no Pallas kernel there); launches from the
        # W8 + int8-KV run
        weight_entry("quantize_rows", "w8a8_matmul.cu",
                     "quant_matmul.py:527", launches["w8kv8"][3], qres),
        # flash at B 4, T 2048, H 32, D 128, causal; the two backward
        # kernels share the twin's and SDPA's backward times
        entry("flash_attention_fwd", "flash_attention.cu",
              "flash_attention.py:121", launches_fwd,
              flash_err("out_err"), flash_t["fwd_ms"],
              flash_t["plain_fwd_ms"], flash_t["fwd_bound"],
              flash_t["library_fwd_ms"]),
        entry("flash_attention_bwd_dkv", "flash_attention.cu",
              "flash_attention.py:176", launches_dkv,
              flash_err("dk_err", "dv_err"), flash_t["dkv_ms"],
              flash_t["plain_bwd_ms"], flash_t["dkv_bound"],
              flash_t["library_bwd_ms"]),
        entry("flash_attention_bwd_dq", "flash_attention.cu",
              "flash_attention.py:237", launches_dq, flash_err("dq_err"),
              flash_t["dq_ms"], flash_t["plain_bwd_ms"],
              flash_t["dq_bound"], flash_t["library_bwd_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
