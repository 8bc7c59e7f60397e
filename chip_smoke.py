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
    infer-load     — an xtuner-format directory written by this script
                   (the LLM at Vicuna-7B widths and 2 layers as two bf16
                   safetensors shards and an index, ViT-H/14-378 whole as
                   one fp16 file, the projector as an fp32 .bin; ~2.7 GB)
                   loaded onto the card in bf16 by
                   models.convert.load_auroracap_dir: every tensor equal to
                   the written one after the same cast; bytes, seconds,
                   GB/s; the directory is deleted
4. serve         — bf16: 4 requests of 8 frames each to 256 tokens; the
                   bf16 kernels' launch counts must rise and the plain
                   twins' stay 0
    infer          — cli/infer.caption (the inference.py path: generate/
                   engine.py over a dense KV cache, SDPA, cuBLAS) on the
                   bf16 model, the first resize-crop video read and
                   preprocessed on the card, 64 greedy tokens; equal to
                   ServeEngine's tokens for the same fused prompt up to a
                   near tie (2e-2); prefill s, decode ms/token, tokens/s
    infer-beam     — the same prompt with 4 beams and 32 tokens: EOS-
                   trimmed, its mean token log-probability at least
                   greedy's less 1e-2 (one bf16 forward scores each);
                   num_beams=1 repeats infer's tokens exactly
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
    resize-crop    — 4 synthetic videos (16 frames of 360x640 uint8, as
                   bench.py writes them) saved as .npy, read by the port's
                   read_video (8 frames), resized and center-cropped on the
                   card by clip_resize_crop_device; the same function on
                   the CPU must agree within 1 level of 0-255
    serve-prefix   — the reference engine's defaults (max_batch 8, 8192
                   pool slots, max_seq_len 2048, buckets 32/128/512/2048,
                   LPM, the radix cache on its C++ tree, which must be the
                   one in use) on the same W4 weights with int8 KV: the 4
                   clips as uint8, the first prompt of each of VDC's five
                   caption pools on each (vicuna template, 64 greedy
                   tokens): the first prompt of every clip, then the other
                   16 at 8 lanes, each of which must hit at least its
                   clip's visual prefix; check_memory() must find no
                   leaked slot and flush_cache() must empty the tree
    serve-prefix-off — the same 20 requests with the radix cache off; its
                   tokens must equal the radix run's up to the first flip,
                   which must sit on a top-2 logprob gap below 2e-2
    runtime        — serve.runtime.Runtime over the same W4 weights with
                   int8 KV at EngineConfig's defaults: 8 text prompts
                   (ByteTokenizer), 64 tokens; then again (the prefix cache
                   flushed) with a 4-character stop string from inside
                   request 0's text: request 0 finishes "stop" with its
                   text cut just before the stop and its tokens the first
                   run's up to it, the other 7 keep their tokens; both runs
                   launch the int8 attention and W4A8 kernels, no plain twin
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
# [serve-prefix]: VDC asks each video for five captions; the first prompt of
# each of its pools (lmms-eval's tasks/vdc/utils.py, copied verbatim into
# aurora_tpu/eval/tasks/vdc_prompts.py): detailed, background, short, main
# object, camera
VDC_PROMPTS = (
    "Please imagine the video based on the sequence of frames, and provide "
    "a faithfully detailed description of this video in more than three "
    "sentences.",
    "The images are given containing equally spaced video frames.Summary of "
    "the background. This should also include the objects, location, "
    "weather, and time.",
    "Write a one-sentence summary of the video.",
    "Description of the main subject actions or status sequence. This "
    "suggests including the main subjects (person, object, animal, or none) "
    "and their attributes, their action, their position, and movements "
    "during the video frames.",
    "Summary of the view shot, camera movement and changes in shooting "
    "angles in the sequence of video frames.")
PREFIX_VIDEOS = 4
PREFIX_VIDEO_SHAPE = (16, 360, 640, 3)   # bench.py's synthetic videos
PREFIX_MAX_NEW = 64
# [infer-load]: the xtuner directory's LLM at Vicuna-7B widths, cut to this
# depth (the ViT and projector whole): about 2.7 GB on disk
INFER_LOAD_LAYERS = 2
# [infer] / [infer-beam] / [runtime]
INFER_PROMPT = "Describe the video in detail."
INFER_MAX_NEW = 64
INFER_BEAMS = 4
INFER_BEAM_MAX_NEW = 32
RUNTIME_PROMPTS = 8
RUNTIME_MAX_NEW = 64
# the radix run's tokens against the radix-off run's: equal until the first
# flip, which must sit on a top-2 logprob gap below this (the near-tie
# contract of tests/test_torch_engine_quant.py)
NEAR_TIE = 2e-2
# [infer-beam]: the beam's mean token log-probability against greedy's, both
# from one bf16 forward each: half the near-tie gap, the drift between two
# decode paths' top-1 log-probabilities that NEAR_TIE allows
BEAM_SCORE_TOL = NEAR_TIE / 2
# the card's resize-crop against the CPU's, levels of 0-255 after rounding
RESIZE_TOL = 1.0
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
    will run once it is captured (ROADMAP queue 1 item 3)."""
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
    per UTF-8 byte, offset past the special ids; EOS 2. decode gives one
    character a non-special id (the byte for ASCII, else a CJK-block
    character), so that any 32000-token output reads as text and a stop
    string of C characters spans exactly C tokens."""

    eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([1] + ids) if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) if i < 131 else chr(0x4E00 + i)
                       for i in ids if i > 2)


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


def near_tie(got, want):
    """got / want: {rid: Request} run greedy with logprobs. Tokens must be
    equal up to the first step where they differ, whose top-2 logprob gap
    in `want` must be below NEAR_TIE → (flips, the largest gap at a flip,
    the worst top-1 logprob difference before a flip)."""
    flips, worst_gap, worst_lp = 0, 0.0, 0.0
    for rid, w in want.items():
        g = got[rid]
        check(len(g.output_ids) == len(w.output_ids), f"{rid}: lengths")
        for j, (gt, wt) in enumerate(zip(g.output_ids, w.output_ids)):
            worst_lp = max(worst_lp, abs(g.output_top_logprobs[j][0][1]
                                         - w.output_top_logprobs[j][0][1]))
            if gt != wt:
                top = w.output_top_logprobs[j]
                gap = top[0][1] - top[1][1]
                check(gap < NEAR_TIE, f"{rid}: token {j} flipped on a top-2 "
                                      f"gap of {gap}")
                flips += 1
                worst_gap = max(worst_gap, gap)
                break
    return flips, worst_gap, worst_lp


def write_videos(tmp, n):
    """The first n of the synthetic .npy videos (bench.py's shape) from
    one seeded stream → their paths; [infer] reads the first of
    [resize-crop]'s."""
    host = np.random.default_rng(SEED + 8)
    paths = []
    for i in range(n):
        paths.append(os.path.join(tmp, f"v{i}.npy"))
        np.save(paths[-1], host.integers(0, 255, size=PREFIX_VIDEO_SHAPE,
                                         dtype=np.uint8))
    return paths


def prefix_phase(torch, engine_mod, mm, llm, llm_cfg, dev, card, kernels,
                 plains):
    """[resize-crop], [serve-prefix] and [serve-prefix-off]: the front of
    the path from video files, then AuroraCap serving at the reference
    engine's defaults with the radix cache on and off (module docstring).
    kernels: the (function, counter) pairs the runs must launch, the W4A8
    one last; plains: those that must stay 0."""
    import tempfile
    from aurora_tpu_torch.data.preprocess import clip_resize_crop_device
    from aurora_tpu_torch.data.video import read_video
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    size = mm.image_size
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_videos(tmp, PREFIX_VIDEOS)
        t0 = time.perf_counter()
        videos = [read_video(p, N_FRAMES) for p in paths]
        read_s = time.perf_counter() - t0
    check(all(v.shape == (N_FRAMES,) + PREFIX_VIDEO_SHAPE[1:]
              for v in videos), f"read_video: {[v.shape for v in videos]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    crops = [clip_resize_crop_device(torch.as_tensor(v, device=dev), size,
                                     size) for v in videos]
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0
    err = max((c.cpu() - clip_resize_crop_device(torch.as_tensor(v), size,
                                                 size)).abs().max().item()
              for c, v in zip(crops, videos))
    phase("resize-crop", videos=PREFIX_VIDEOS,
          video=f"{PREFIX_VIDEO_SHAPE[0]}x{PREFIX_VIDEO_SHAPE[1]}x"
                f"{PREFIX_VIDEO_SHAPE[2]}", frames=N_FRAMES,
          read_s=f"{read_s:.4f}", resize_s=f"{resize_s:.4f}",
          max_abs_err_vs_cpu=err, tol=RESIZE_TOL)
    check(err <= RESIZE_TOL, f"resize-crop card vs CPU {err}")
    clips = [c.to(torch.uint8).cpu().numpy() for c in crops]
    check(all(c.shape == (N_FRAMES, size, size, 3) for c in clips),
          "crop shapes")
    images = " ".join(["<image>"] * N_FRAMES)
    prompts = [f"USER: {images}\n{q} ASSISTANT:" for q in VDC_PROMPTS]

    def waves():
        def req(v, q):
            return mm.build_request(f"v{v}q{q}", prompts[q], clips[v],
                                    max_new_tokens=PREFIX_MAX_NEW,
                                    eos_ids=(), logprobs=True)
        return ([req(v, 0) for v in range(PREFIX_VIDEOS)],
                [req(v, q) for v in range(PREFIX_VIDEOS)
                 for q in range(1, len(prompts))])

    first, second = waves()
    # the ViT (ToMe merges added in a fixed order) repeats bit for bit: the
    # two runs below each encode their clips
    embeds = []
    for _ in range(2):
        mm._cache.clear()
        embeds.append(mm.embed_fn(first[0]).float())
    vit_diff = (embeds[0] - embeds[1]).abs().max().item()
    check(vit_diff == 0, f"the ViT repeats within {vit_diff}")
    shared = {}
    for v in range(PREFIX_VIDEOS):
        ids = [r.input_ids for r in first + second
               if r.rid.startswith(f"v{v}q")]
        shared[v] = len(os.path.commonprefix(ids))
    submitted = sum(len(r.input_ids) for r in first + second)
    copy_s = {"_load_prefix": 0.0, "_store_prompt": 0.0}

    def timed(name):
        fn = getattr(engine_mod, name)

        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            copy_s[name] += time.perf_counter() - t
            return out
        return call

    out = {}
    for run, radix_off in (("serve-prefix", False), ("serve-prefix-off",
                                                      True)):
        ecfg = EngineConfig(weight_quant="int4", kv_quant="int8",
                            disable_radix_cache=radix_off)
        engine = ServeEngine(llm, llm_cfg, ecfg, embed_fn=mm.embed_fn,
                             device=dev, seed=SEED)
        check(engine.runner.model is llm, f"{run}: the model was not served "
                                          "as given")
        mm._cache.clear()    # each run encodes its clips once, in wave 1
        done, marks = {}, []
        run_counts = {}
        for name in copy_s:
            copy_s[name] = 0.0
        t0 = time.perf_counter()
        for wave in waves():
            ext, dec, steps = (engine.t_extend_s, engine.t_decode_s,
                               engine._steps)
            with mock.patch.multiple(engine_mod, **{
                    n: timed(n) for n in copy_s}):
                _, c = serve(torch, engine, wave, kernels + plains,
                             PREFIX_MAX_NEW)
            run_counts = {k: run_counts.get(k, 0) + n for k, n in c.items()}
            done.update({r.rid: r for r in wave})
            marks.append((engine.t_extend_s - ext, engine.t_decode_s - dec,
                          engine._steps - steps))
        wall = time.perf_counter() - t0
        mem = engine.check_memory()
        L = llm_cfg.num_hidden_layers
        fields = dict(
            card=repr(card), tree=engine.radix_impl,
            config="auroracap-7b/w4-stripes/kv-int8/reference-engine-defaults",
            max_batch=ecfg.max_batch, num_slots=ecfg.num_slots,
            max_seq_len=ecfg.max_seq_len,
            buckets="/".join(map(str, ecfg.prefill_buckets)),
            policy=ecfg.policy.value, requests=len(done),
            new_tokens=PREFIX_MAX_NEW,
            n_cached=",".join(f"{r}:{done[r].n_cached}" for r in done),
            hit_tokens=f"{sum(r.n_cached for r in done.values())}"
                       f"/{submitted}",
            extend_s_wave1=f"{marks[0][0]:.4f}",
            extend_s_wave2=f"{marks[1][0]:.4f}",
            prefix_load_s=f"{copy_s['_load_prefix']:.4f}",
            prompt_store_s=f"{copy_s['_store_prompt']:.4f}",
            decode_ms_per_step_wave2_8_lanes=(
                f"{marks[1][1] / max(marks[1][2], 1) * 1e3:.3f}"),
            decode_steps=engine._steps, wall_s=f"{wall:.2f}",
            check_memory=json.dumps(mem).replace(" ", ""),
            slot_usage=engine.decode_stats()["slot_usage"],
            launches=json.dumps(run_counts).replace(" ", ""))
        flushed = engine.flush_cache()
        fields["flush_cache"] = flushed
        phase(run, **fields)
        check(mem["leaked"] == 0, f"{run}: leaked slots {mem}")
        check(flushed == 0 and engine.check_memory()["free"]
              == ecfg.num_slots, f"{run}: flush left {flushed} tokens")
        check(all(run_counts[f"{f.__name__}.{a}"] > 0 for f, a in kernels),
              f"{run}: launches {run_counts}")
        check(all(run_counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"{run}: plain twins ran: {run_counts}")
        if kernels:   # every extend wave holds more than MAX_TOKENS rows
            f, a = kernels[-1]
            want = 4 * L * engine._steps
            check(run_counts[f"{f.__name__}.{a}"] == want,
                  f"{run}: {f.__name__}.{a} {run_counts} != 4 a layer and "
                  f"a decode step, {want}")
        if radix_off:
            check(engine.radix_impl == "null", engine.radix_impl)
            check(all(r.n_cached == 0 for r in done.values()),
                  f"{run}: a hit with the cache off")
        else:
            check(engine.radix_impl == "native",
                  f"the radix tree is {engine.radix_impl}: "
                  f"{engine.radix_error}")
            for r in done.values():
                v, q = int(r.rid[1]), int(r.rid[3])
                check(q == 0 or r.n_cached >= shared[v],
                      f"{r.rid}: {r.n_cached} cached tokens, the clip's "
                      f"shared prefix is {shared[v]}")
        out[run] = done
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    flips, gap, lp = near_tie(out["serve-prefix"], out["serve-prefix-off"])
    phase("serve-prefix-parity", requests=len(out["serve-prefix"]),
          vit_repeat_max_diff=vit_diff, flips=flips,
          worst_flip_gap=f"{gap:.3e}", near_tie=NEAR_TIE,
          worst_top1_logprob_diff=f"{lp:.3e}")


def _write_safetensors(torch, path, tensors):
    """{name: CPU tensor} → one .safetensors file, written here without
    the port's reader: an 8-byte little-endian header length, the JSON
    header (padded to 8 bytes), then each tensor's raw bytes."""
    codes = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + off


def hf_llm_names(cfg):
    """(HF name, the port's LlamaModel name, shape) of a llama checkpoint."""
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    yield "model.embed_tokens.weight", "embed_tokens", (V, D)
    yield "model.norm.weight", "final_norm", (D,)
    yield "lm_head.weight", "lm_head.weight", (V, D)
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"model.layers.{i}.", f"layers.{i}."
        yield hf + "input_layernorm.weight", ours + "input_norm", (D,)
        yield (hf + "post_attention_layernorm.weight",
               ours + "post_attn_norm", (D,))
        for theirs, name, shape in (
                ("self_attn.q_proj", "q", (D, D)),
                ("self_attn.k_proj", "k", (D, D)),
                ("self_attn.v_proj", "v", (D, D)),
                ("self_attn.o_proj", "o", (D, D)),
                ("mlp.gate_proj", "gate", (I, D)),
                ("mlp.up_proj", "up", (I, D)),
                ("mlp.down_proj", "down", (D, I))):
            yield hf + theirs + ".weight", ours + name + ".weight", shape


def hf_vit_names(cfg):
    """(HF CLIPVisionModel name, the port's VisionTransformer name or None
    for the unused post_layernorm, shape)."""
    D, I, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    e = "vision_model.embeddings."
    yield e + "class_embedding", "class_embedding", (D,)
    yield e + "patch_embedding.weight", "patch_embed.weight", (D, 3, p, p)
    yield (e + "position_embedding.weight", "position_embedding",
           (cfg.num_positions, D))
    for suf in ("weight", "bias"):
        yield f"vision_model.pre_layrnorm.{suf}", f"pre_layernorm.{suf}", (D,)
        yield f"vision_model.post_layernorm.{suf}", None, (D,)
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"vision_model.encoder.layers.{i}.", f"layers.{i}."
        for theirs, name, shape in (
                ("layer_norm1", "ln1", None), ("layer_norm2", "ln2", None),
                ("self_attn.q_proj", "q", (D, D)),
                ("self_attn.k_proj", "k", (D, D)),
                ("self_attn.v_proj", "v", (D, D)),
                ("self_attn.out_proj", "o", (D, D)),
                ("mlp.fc1", "fc1", (I, D)), ("mlp.fc2", "fc2", (D, I))):
            out = shape[0] if shape else D
            yield hf + theirs + ".weight", ours + name + ".weight", \
                shape or (D,)
            yield hf + theirs + ".bias", ours + name + ".bias", (out,)


def infer_load_phase(torch, dev, card):
    """[infer-load]: an xtuner-format directory at AuroraCap-7B's widths
    (the LLM cut to INFER_LOAD_LAYERS layers) written by this script, read
    by the port's load_auroracap_dir onto the card in bf16; every tensor
    must equal the written one after the same cast, bit for bit."""
    import dataclasses
    import shutil
    from aurora_tpu_torch.models.convert import load_auroracap_dir
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.models.vit import ViTConfig
    llm_cfg = dataclasses.replace(LlamaConfig.vicuna_7b_v15_16k(),
                                  num_hidden_layers=INFER_LOAD_LAYERS)
    vit_cfg = ViTConfig.dfn5b_vit_h_378()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "infer_load")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "visual_encoder"))
    os.makedirs(os.path.join(root, "projector"))
    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def rand(shape, dtype):
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(
            dtype).cpu()

    want = {}       # part → {the port's name: the tensor as written}
    t0 = time.perf_counter()
    # the LLM: bf16, two shards and their index
    llm = {hf: rand(shape, torch.bfloat16)
           for hf, _, shape in hf_llm_names(llm_cfg)}
    want["llm"] = {ours: llm[hf] for hf, ours, _ in hf_llm_names(llm_cfg)}
    names = list(llm)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    nbytes = 0
    for fn, keys in shards.items():
        nbytes += _write_safetensors(torch, os.path.join(root, fn),
                                     {k: llm[k] for k in keys})
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {
            k: fn for fn, keys in shards.items() for k in keys}}, f)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"model_type": "llama",
                   "architectures": ["LlamaForCausalLM"],
                   "vocab_size": llm_cfg.vocab_size,
                   "hidden_size": llm_cfg.hidden_size,
                   "intermediate_size": llm_cfg.intermediate_size,
                   "num_hidden_layers": llm_cfg.num_hidden_layers,
                   "num_attention_heads": llm_cfg.num_attention_heads,
                   "num_key_value_heads": llm_cfg.num_key_value_heads,
                   "max_position_embeddings":
                       llm_cfg.max_position_embeddings,
                   "rms_norm_eps": llm_cfg.rms_norm_eps,
                   "rope_theta": llm_cfg.rope_theta,
                   "rope_scaling": {"type": "linear", "factor": 4.0},
                   "hidden_act": "silu", "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)
    del llm
    # the vision tower: fp16, one file
    vit = {hf: rand(shape, torch.float16)
           for hf, _, shape in hf_vit_names(vit_cfg)}
    want["vit"] = {ours: vit[hf] for hf, ours, _ in hf_vit_names(vit_cfg)
                   if ours is not None}
    ve = os.path.join(root, "visual_encoder")
    nbytes += _write_safetensors(torch, os.path.join(ve, "model.safetensors"), vit)
    with open(os.path.join(ve, "config.json"), "w") as f:
        json.dump({"model_type": "clip_vision_model",
                   "hidden_size": vit_cfg.hidden_size,
                   "intermediate_size": vit_cfg.intermediate_size,
                   "num_hidden_layers": vit_cfg.num_hidden_layers,
                   "num_attention_heads": vit_cfg.num_attention_heads,
                   "image_size": vit_cfg.image_size,
                   "patch_size": vit_cfg.patch_size,
                   "layer_norm_eps": vit_cfg.layer_norm_eps,
                   "hidden_act": "quick_gelu", "torch_dtype": "float16"}, f)
    del vit
    # the projector: fp32, torch.save
    Dv, D = vit_cfg.hidden_size, llm_cfg.hidden_size
    pj = {"model.0.weight": rand((D, Dv), torch.float32),
          "model.0.bias": rand((D,), torch.float32),
          "model.2.weight": rand((D, D), torch.float32),
          "model.2.bias": rand((D,), torch.float32)}
    want["pj"] = {f"layers.{int(k[6]) // 2}.{k.split('.')[-1]}": v
                  for k, v in pj.items()}
    pj_dir = os.path.join(root, "projector")
    torch.save(pj, os.path.join(pj_dir, "pytorch_model.bin"))
    nbytes += os.path.getsize(os.path.join(pj_dir, "pytorch_model.bin"))
    with open(os.path.join(pj_dir, "config.json"), "w") as f:
        json.dump({"model_type": "projector", "visual_hidden_size": Dv,
                   "llm_hidden_size": D, "depth": 2, "hidden_act": "gelu",
                   "bias": True}, f)
    write_s = time.perf_counter() - t0
    del pj
    gc.collect()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_auroracap_dir(root, llm_dtype=torch.bfloat16,
                                vit_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mods = {"llm": loaded[0], "vit": loaded[2], "pj": loaded[4]}
    check(loaded[1] == llm_cfg, f"LLM config {loaded[1]} != {llm_cfg}")
    check(loaded[3] == vit_cfg, f"ViT config {loaded[3]} != {vit_cfg}")
    n_tensors = mismatched = 0
    for part, mod in mods.items():
        sd = mod.state_dict()
        check(sorted(sd) == sorted(want[part]),
              f"{part}: loaded names differ from the written ones")
        for name, t in sd.items():
            n_tensors += 1
            check(t.device == dev and t.dtype == torch.bfloat16,
                  f"{part}.{name}: {t.device} {t.dtype}")
            mismatched += not torch.equal(
                t, want[part][name].to(dev).to(torch.bfloat16))
    shutil.rmtree(root)
    phase("infer-load", card=repr(card),
          layout="xtuner:llm-2-bf16-shards+vit-fp16+projector-fp32-bin",
          llm=f"vicuna-7b-widths/{INFER_LOAD_LAYERS}-layers",
          vit="vit-h-14-378/32-layers", tensors=n_tensors,
          mismatched=mismatched, bytes=nbytes, write_s=f"{write_s:.2f}",
          load_s=f"{load_s:.3f}", load_gb_per_s=f"{nbytes / load_s / 1e9:.3f}")
    check(mismatched == 0, f"{mismatched} tensors differ from the written")
    del loaded, mods
    gc.collect()
    torch.cuda.empty_cache()


def _timed_llama_apply(torch, times):
    """llama_apply with each call's seconds appended to `times` (a
    synchronize before and after)."""
    from aurora_tpu_torch.models.llama import llama_apply as real

    def call(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out
    return call


def seq_score(torch, model, embeds, tokens):
    """Mean log-probability of `tokens` after the prompt `embeds` [1, T, D]
    in one forward (the beam test's length-penalised score with
    length_penalty 1)."""
    from aurora_tpu_torch.models.llama import llama_apply
    emb = model.llm.embed_tokens
    ids = torch.tensor(tokens, device=emb.device)
    x = torch.cat([embeds, emb[ids][None]], dim=1)
    with torch.no_grad():
        logits = llama_apply(model.llm, model.cfg.llm, inputs_embeds=x,
                             attention_mask=torch.ones(
                                 x.shape[:2], dtype=torch.bool,
                                 device=emb.device))
    T = embeds.shape[1]
    lp = torch.log_softmax(logits[0, T - 1:-1].float(), dim=-1)
    return lp.gather(1, ids[:, None]).sum().item() / len(tokens)


def infer_phase(torch, model, cfg, mm, ecfg, dev, card):
    """[infer] and [infer-beam]: cli/infer.caption at full width and depth
    on the bf16 model, from the first [resize-crop] video through the
    device preprocessing; its greedy tokens against ServeEngine's for the
    same fused prompt (near-tie rule), then 4 beams, then num_beams=1."""
    import tempfile
    from types import SimpleNamespace
    from aurora_tpu_torch.cli import infer as infer_mod
    from aurora_tpu_torch.data.preprocess import clip_resize_crop_device
    from aurora_tpu_torch.data.text import build_video_prompt
    from aurora_tpu_torch.data.video import read_video
    from aurora_tpu_torch.serve.engine import ServeEngine
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE
    size = cfg.vit.image_size
    with tempfile.TemporaryDirectory() as tmp:
        frames = read_video(write_videos(tmp, 1)[0], N_FRAMES)
    tok = ByteTokenizer()
    px = infer_mod.preprocess_frames(frames, size, dev)
    captured = {}
    real_generate, real_beam = infer_mod.generate, infer_mod.beam_generate

    def generate(*a, **k):
        captured["embeds"] = a[2]
        captured["result"] = real_generate(*a, return_logprobs=True, **k)
        return captured["result"]

    def beam_generate(*a, **k):
        captured["embeds"] = a[2]
        captured["beam"] = real_beam(*a, **k)
        return captured["beam"]

    def run(num_beams, max_new):
        times = []
        timed = _timed_llama_apply(torch, times)
        with mock.patch.multiple(infer_mod, generate=generate,
                                 beam_generate=beam_generate), \
                mock.patch("aurora_tpu_torch.generate.engine.llama_apply",
                           timed), \
                mock.patch("aurora_tpu_torch.generate.beam.llama_apply",
                           timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text = infer_mod.caption(model, cfg, tok, pixel_values=px,
                                     prompt=INFER_PROMPT,
                                     token_kept_ratio=KEPT_RATIO,
                                     num_beams=num_beams,
                                     max_new_tokens=max_new,
                                     image_size=size)
            torch.cuda.synchronize()
        return text, time.perf_counter() - t0, times

    infer_mod.caption(model, cfg, tok, pixel_values=px, prompt=INFER_PROMPT,
                      token_kept_ratio=KEPT_RATIO, max_new_tokens=2)  # warm
    text, wall, times = run(1, INFER_MAX_NEW)
    res = captured["result"]
    n = int(res.lengths[0])
    greedy = res.tokens[0, :n].tolist()
    lps = res.logprobs[0, :n].tolist()
    prompt_tokens = captured["embeds"].shape[1]
    check(text == tok.decode([t for t in greedy if t not in (2,)]),
          "caption text is not its tokens")
    # the serving engine on the same fused prompt (bf16 kernels)
    crops = clip_resize_crop_device(torch.as_tensor(frames, device=dev),
                                    size, size)
    clip = crops.to(torch.uint8).cpu().numpy()
    prompt_text = build_video_prompt(INFER_PROMPT, N_FRAMES,
                                     PROMPT_TEMPLATE.vicuna)
    req = mm.build_request("infer", prompt_text, clip,
                           max_new_tokens=INFER_MAX_NEW, eos_ids=(2,),
                           logprobs=True)
    check(len(req.input_ids) == prompt_tokens,
          f"engine prompt {len(req.input_ids)} != caption's {prompt_tokens}")
    mm._cache.clear()
    engine = ServeEngine(model.llm, cfg.llm, ecfg, embed_fn=mm.embed_fn,
                         device=dev, seed=SEED)
    engine.add_request(req)
    while engine.has_work():
        engine.step()
    del engine
    got = SimpleNamespace(output_ids=greedy,
                          output_top_logprobs=[[(t, lp)] for t, lp in
                                               zip(greedy, lps)])
    flips, gap, lp_diff = near_tie({"infer": got}, {"infer": req})
    decode_s = sum(times[1:])
    phase("infer", card=repr(card), config="auroracap-7b/bf16/dense-kv",
          video=f"{PREFIX_VIDEO_SHAPE[0]}x{PREFIX_VIDEO_SHAPE[1]}x"
                f"{PREFIX_VIDEO_SHAPE[2]}.npy", frames=N_FRAMES,
          prompt_tokens=prompt_tokens, new_tokens=n,
          caption_s=f"{wall:.3f}", prefill_s=f"{times[0]:.4f}",
          decode_ms_per_token=f"{decode_s / max(len(times) - 1, 1) * 1e3:.3f}",
          tokens_per_s=f"{n / wall:.1f}",
          vs_engine_flips=flips, worst_flip_gap=f"{gap:.3e}",
          near_tie=NEAR_TIE, worst_top1_logprob_diff=f"{lp_diff:.3e}")
    check(n == INFER_MAX_NEW or greedy[-1] == 2, f"{n} tokens, no EOS")

    text_b, wall_b, times_b = run(INFER_BEAMS, INFER_BEAM_MAX_NEW)
    toks_b, n_b = captured["beam"]
    beam = toks_b[:n_b].tolist()
    check(1 <= n_b <= INFER_BEAM_MAX_NEW and 2 not in beam[:-1],
          f"beam: {n_b} tokens, EOS inside")
    check(text_b == tok.decode(beam), "beam text is not its tokens")
    embeds = captured["embeds"]

    def trimmed(ts):
        return ts[:-1] if ts and ts[-1] == 2 else ts
    b_score = seq_score(torch, model, embeds, trimmed(beam))
    g_score = seq_score(torch, model, embeds,
                        trimmed(greedy[:INFER_BEAM_MAX_NEW]))
    beam_step_ms = sum(times_b[1:]) / max(len(times_b) - 1, 1) * 1e3
    text_1, _, _ = run(1, INFER_MAX_NEW)
    one = captured["result"].tokens[0, :int(captured["result"].lengths[0])]
    phase("infer-beam", card=repr(card), beams=INFER_BEAMS,
          max_new=INFER_BEAM_MAX_NEW, new_tokens=n_b,
          beam_s=f"{wall_b:.3f}", prefill_s=f"{times_b[0]:.4f}",
          decode_ms_per_step=f"{beam_step_ms:.3f}",
          beam_score=f"{b_score:.6f}", greedy_score=f"{g_score:.6f}",
          tol=BEAM_SCORE_TOL, beams1_equal_greedy=one.tolist() == greedy)
    check(np.isfinite(b_score) and np.isfinite(g_score), "scores not finite")
    check(b_score >= g_score - BEAM_SCORE_TOL,
          f"beam score {b_score} below greedy's {g_score}")
    check(one.tolist() == greedy and text_1 == text,
          "num_beams=1 differs from [infer]'s greedy tokens")


def runtime_phase(torch, llm, llm_cfg, dev, card, kernels, plains):
    """[runtime]: serve.runtime.Runtime over the W4-stripe + int8-KV engine
    at EngineConfig's defaults: 8 prompts, 64 tokens, then again with a
    stop string taken from inside request 0's text."""
    from aurora_tpu_torch.serve.engine import EngineConfig
    from aurora_tpu_torch.serve.runtime import Runtime
    tok = ByteTokenizer()
    rt = Runtime(llm, llm_cfg, tok, engine_config=EngineConfig(
        weight_quant="int4", kv_quant="int8"))
    check(rt.engine.runner.model is llm, "runtime: the model was not "
                                         "served as given")
    prompts = [f"USER: {VDC_PROMPTS[i % len(VDC_PROMPTS)]} ({i}) ASSISTANT:"
               for i in range(RUNTIME_PROMPTS)]

    def run(**kw):
        for obj, attr in kernels + plains:
            setattr(obj, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rt.generate(prompts, max_new_tokens=RUNTIME_MAX_NEW, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            f"{obj.__name__}.{attr}": getattr(obj, attr)
            for obj, attr in kernels + plains}

    first, wall1, counts1 = run()
    check(rt.flush_cache() == 0, "runtime: flush left cached tokens")
    text0 = first[0]["text"]
    check(len(text0) >= 8, f"request 0's text {text0!r}")
    # the first 4 characters inside request 0's text that the fewest other
    # texts hold (a random model may repeat itself across prompts)
    stop = min((text0[i:i + 4] for i in range(1, len(text0) - 3)),
               key=lambda c: sum(c in o["text"] for o in first[1:]))
    second, wall2, counts2 = run(stop=[stop])
    stopped = [i for i, o in enumerate(first) if stop in o["text"]]
    n_tokens = sum(len(o["output_ids"]) for o in first)
    phase("runtime", card=repr(card),
          config="auroracap-7b-llm/w4-stripes/kv-int8/engine-defaults",
          prompts=len(prompts), max_new=RUNTIME_MAX_NEW,
          tokens=n_tokens, wall_s=f"{wall1:.3f}",
          tokens_per_s=f"{n_tokens / wall1:.1f}",
          stop=json.dumps(stop), stop_wall_s=f"{wall2:.3f}",
          stopped=",".join(map(str, stopped)),
          req0_tokens=f"{len(second[0]['output_ids'])}/"
                      f"{len(first[0]['output_ids'])}",
          req0_finish=second[0]["finish_reason"],
          launches=json.dumps(counts1).replace(" ", ""),
          launches_stop=json.dumps(counts2).replace(" ", ""))
    check(second[0]["finish_reason"] == "stop",
          f"request 0 finished with {second[0]['finish_reason']}")
    for i, (a, b) in enumerate(zip(first, second)):
        if i not in stopped:
            check(b == a, f"request {i} changed, though its text holds no "
                          "stop")
            continue
        ids = a["output_ids"]
        cut = next(k for k in range(1, len(ids) + 1)
                   if stop in tok.decode(ids[:k]))
        check(b["finish_reason"] == "stop"
              and b["text"] == a["text"][:a["text"].find(stop)],
              f"request {i}: {b['finish_reason']}, text not cut just "
              "before the stop")
        check(b["output_ids"] == ids[:cut],
              f"request {i}: tokens are not the first run's up to the stop")
    for counts in (counts1, counts2):
        check(all(counts[f"{f.__name__}.{a}"] > 0 for f, a in kernels),
              f"runtime: launches {counts}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"runtime: plain twins ran: {counts}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()


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

    # ---- checkpoint loading from an xtuner-format directory --------------
    torch.cuda.empty_cache()
    infer_load_phase(torch, dev, card)

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

    # ---- the inference.py caption path on the same bf16 model -------------
    torch.cuda.reset_peak_memory_stats()
    infer_phase(torch, model, cfg, mm, engine_config(), dev, card)
    torch.cuda.empty_cache()

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

    # ---- from video files, at the reference engine's defaults --------------
    torch.cuda.reset_peak_memory_stats()
    prefix_phase(torch, engine_mod, mm, llm_w4, cfg.llm, dev, card,
                 kernels["w4kv8"], plains)

    # ---- the in-process Runtime at the engine's defaults, stop strings ----
    runtime_phase(torch, llm_w4, cfg.llm, dev, card, kernels["w4kv8"],
                  plains)

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
