#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

AuroraCap-7B caption serving at full published widths (AURORA_LAYERS of
the LLM's 32 layers) with random bf16 weights (seeded): uint8 frames → CLIP normalize → ViT-H/14 with ToMe →
projector → fusion → one batched extend → 256-token greedy decode via
`aurora_tpu_torch.serve.engine.ServeEngine`, first with bf16 weights and
bf16 KV, then with the LLM quantized on the card to W8 weights and int8
KV, to W4 weights and int8 KV, and (the same W4 weights) nibble-packed
int4 KV, then int8 KV again with the W4 weights in the fused-MLP and in
the flat layout; both quantized models keep an int8 LM head. Then
Mistral-7B at full widths (MISTRAL_LAYERS layers; random bf16 weights)
serving prompts longer than its 4096-token sliding window with bf16, int8 and packed int4
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
                   and scale writes exact, int4 mate nibbles included) and
                   int8 KV on the int4 grid (kv_maxq 7, EngineConfig(
                   kv_grid_bits=4)) at the serving shapes,
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
                   GB/s
    eval           — eval.models.AuroraCapEval built on the card from that
                   directory (ByteTokenizer for its missing tokenizer
                   files), kept ratio 0.2; simple_evaluate over VDC's five
                   built-in tasks on 8 synthetic 8 x 360 x 640 .npy videos
                   (40 docs through generate_batch, 64 tokens): every
                   prediction a non-empty string, results.json written;
                   then post_eval.score_captions over the detailed
                   subset's 8 captions, one QA each, the judge the port's
                   HTTP server in a thread on the same LLM (48 tokens a
                   call): n = 8; docs/s, judge answers/s, parsed judge
                   outputs (random weights: no gate), the ragged bf16
                   kernels' launches
    train-cli      — cli/train.run (the training CLI, in-process) over that
                   directory, bf16: synthetic 480x640 PNGs written here
                   (their rows use all five PNG filters) and llava-format
                   jsons; the pretrain stage at batch 4 (the stage's 16,
                   cut), 6 steps, checkpoints at 3 and 6; a second run
                   resumed from a copy of the step-3 checkpoint must log
                   the first run's losses and grad norms at steps 4-6 and
                   end with its projector, bit for bit; the LLM and the
                   ViT unchanged bit for bit; the flash kernels launch 0
                   times (every batch is masked, as in the reference) and
                   no plain twin runs (in every train-cli phase); step ms,
                   tgs, TFLOP/s, exposed data wait, peak GB, checkpoint GB
                   and s, restore s
    train-cli-vision — copy-cfg's vision stage with grad_accum 2 through
                   --config: 4 steps of one 4-frame sample (slowfast, kept
                   ratio 0.1): 2 updates, the ViT moved, the LLM unchanged
    train-cli-packed — the language stage packed to 4096 (kept ratio 0.1):
                   3 steps, every batch with segment ids, a pack of at
                   least 2 documents; one pack's loss within
                   PACKED_LOSS_TOL of the same documents unpacked; one
                   batch's forward and backward under repeatable_step and
                   under SDPA's default backends, timed in turns
    train-cli-qlora — the language stage with --lora_r 64 --quant int4: 3
                   steps; the quantized and float base GB; the whole base
                   (int4 codes, scales, the float rest) unchanged bit for
                   bit, every adapter moved, lora.json written; then the
                   directory is deleted
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
    serve-kv4grid  — the stripe W4 weights, int8 KV rows on the int4 grid
                   (kv_grid_bits=4), 4 new clips, 64 tokens with logprobs:
                   every K/V row value in [-7, 7] with both ends hit; the
                   tokens against the same requests at grid 8 (flips and
                   their top-2 gaps, matched prefix, |dlogprob|; grids
                   differ, so no near-tie gate); extend s, decode ms a
                   step, launches (int8 attention, W4A8), no twin
    serve-a8-prefill — the same requests through the A8 prefill (w4_prefill
                   ="a8"), as serve-kv4grid against the bf16 prefill;
                   _w4dot's A8 branch within 3% rel L2 of its bf16 branch
                   (and above 1e-6) at a 7B layer's four projections, 256
                   rows; one extend wave of 4 x 1536 rows each way, timed
                   alternating (bf16, a8, a8, bf16, twice) and traced once
                   (tools/profile_serve.trace_device): device ms split into
                   attention, dense matmuls (cuBLAS, torch._int_mm) and the
                   rest (the dequantizing / requantizing elementwise chain)
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
    serve-http     — the HTTP server (serve/api.py, a thread on 127.0.0.1)
                   over the same weights and engine configuration, the
                   ViT behind /generate's videos: cli/bench_serving's 16
                   requests, 8 in flight, 64 tokens (requests/s, tokens/s,
                   p50/p90/p99); runtime's 8 prompts through
                   /v1/completions, each Runtime's tokens up to a near
                   tie; a streamed chat equal to the same chat alone (time
                   to the first chunk); a video, then a second question
                   on it that hits its prefix; an abort in mid-decode;
                   the ops endpoints 200, /v1/embeddings 400 on W4; the
                   decode step's wall with 8 chats plain and with the same
                   8 streamed beside two new clips' ViT (plain, streamed,
                   streamed, plain); the kernels launch, no twin
                   a 3,000-token prompt (chunked prefill); /generate
                   under the VDC judge's regex, a chat under choices, a
                   bad pattern (400); a lang.py judge program (regex gen,
                   yes/no select) through RuntimeEndpoint, run_batch of 8
    serve-http-update — /update_weights on a second server at Vicuna-7B
                   widths and 2 layers from two HF directories written
                   here: other tokens after the swap, equal to a fresh
                   engine's on the new weights; every live tensor at its
                   address; a missing directory 400, the tokens kept
    serve-chunked  — the same W4 weights, int8 KV, 8 lanes, the engine's
                   default buckets, radix on, at inference.py's kept ratio
                   0.8: two 8x360x640 .npy videos (read_video, the card's
                   resize-crop) whose ~4.9k-token prompts prefill in 3
                   chunks of 2048 while 6 text prompts decode, each of
                   which gains a token every step of a chunk; their tokens
                   against the same requests in one wave (bucket 5120) up
                   to a near tie; 32 extend launches at q_offsets > 0 a
                   later chunk; a second question on a video hits its
                   prefix; a third video aborted after its first chunk
                   adds nothing to the tree and leaks nothing
    serve-constrained — the same weights at 16 lanes, ByteTokenizer: the
                   judge regex's token table at V = 32000 (build s); 8
                   requests under it alone, every text full-matching, in
                   fewer decode steps than half a request's tokens
                   (jump-forward); then 8 regex, 4 choice (VDC's aspects)
                   and 4 free requests in one batch, the free lanes equal
                   to their run alone up to a near tie; decode ms a step
                   with masks and without; no leak, no twin
    serve-mistral-bf16 / -kv8 / -kv4 — the AuroraCap weights freed,
                   Mistral-7B (MISTRAL_LAYERS of its 32 layers, GQA 32/8,
                   window 4096, random bf16 weights) serves 4 prompts of
                   5,000-6,100 random token ids in one extend wave, then
                   256 (bf16 KV) or 64 (int8, packed int4 KV) greedy
                   tokens each; the windowed launch counts must be one a
                   layer a wave and one a layer a
                   decode step, the plain twins' 0
    logits-mistral-* — as 10 (extend wave and one decode step), with
                   its bound's reason
    serve-chunked-mistral — serve-mistral-kv8's prompts at the engine's
                   default buckets: 3 chunks each, the window reaching
                   keys of earlier chunks; 32 windowed extend launches a
                   chunk step (those at q_offsets > 0 counted); tokens
                   against the one-wave run up to a near tie
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
   included; the windowed entries from Mistral's shapes and runs; the
   flash entries' launches_train_cli from the train-cli phases), then
   {"ok": true, "device": {...}} last.

Then the dense zoo: `[kernels]` also holds both attention
kernels at the zoo's published (head_dim, G) in every KV mode
(FAMILY_SHAPES: Gemma-2-9B 256/2, Phi-3-mini 96/1, MiniCPM-2B 64/1,
StarCoder2-7B 128/9, GLM-4-9B 128/16, StarCoder 128/48, Qwen2-0.5B
64/7), the extend
kernel at Gemma-2-9B's served extend (the `[serve-gemma2-*]` prompts in
one 6144 wave, rows of 6144, hd 256: `extend_d256_kernel`) with the even
layers' window 4096 and cap 50 and with neither, timed beside SDPA, at
Phi-3-mini's (the `[serve-phi3-mini-*]` prompts in one 4096 wave, rows of
4096, hd 96, window 2047: `extend_kernel<96>`) and at StableLM-3B's (the
`[serve-stablelm-*]` prompts in one 2048 wave, rows of 2304, hd 80), timed
beside SDPA (Phi-3's with the band mask), and
flash
forward and backward at D 256 (gemma-7b's 16 heads, T 2048) and at D
512 (the widest head the kernels take) against their twins, timed beside
SDPA (with the backend SDPA picks), and D 384 (padded to 512) and D 512
with GQA, segments and a q_offset; after the Mistral runs,
`[serve-gemma2-*]` serves Gemma-2-9B at full width and depth (random
bf16 weights, 4 prompts of 5,000-6,000 ids, 64 greedy tokens) with bf16
KV twice (bit for bit), int8 KV, packed int4 KV and W4 weights + int8
KV, each with its launch counts and a logits check of one extend wave
and one decode step against the twins, `[serve-qwen2-*]` Qwen2-7B
(4 layers, qkv biases, G 7) with W8 and W4 weights + int8 KV, and
`[serve-stablelm-*]` StableLM-3B-4E1T (STABLELM_3B through the port's
converter: head_dim 80, which both ragged kernels run padded to 96;
4 layers, 4 prompts of 1,000-2,000 ids, 32 tokens) with bf16, int8 and
packed int4 KV, each with its launch counts and the logits of a wave and
a decode step against the twins, and `[serve-phi3-mini-*]` Phi-3-mini-4k
whole (PHI3_MINI, microsoft/Phi-3-mini-4k-instruct's config, through the
port's converter from a fused random checkpoint tree: head_dim 96, MHA,
window 2047; 4 prompts of 3,000-4,000 ids in one wave, 32 tokens) with
bf16 KV twice (bit for bit), int8 and packed int4 KV: every extend launch
on `extend_kernel<96>` and windowed, the logits of a wave and a decode
step against the twins; after
`[train-parity]`, `[train-dpo]` takes 3 DPO steps (train/preference.py)
at Vicuna-7B widths (2 layers, 4 unmasked pairs of 2048 tokens) twice,
losses bit for bit, and `[train-dpo-gemma]` 2 steps at gemma-7b's widths
(head_dim 256, 1 layer), both through the flash kernels. Every phase
line ends with at_s, the seconds since the script started.

The MoE and MLA families: `[kernels-moe]` holds the grouped-expert
kernel (csrc/moe_grouped_mm.cu, the counterpart of the reference's
`lax.ragged_dot`) against its plain twin at Mixtral-8x7B's, Qwen3-30B-
A3B's and DeepSeek-V2-Lite's expert shapes, at 4 tokens and 4 x 2048,
with bf16 and int8 experts, timed beside torch._grouped_mm, each case
with the plan it took (decode at 4 tokens, extend at 4 x 2048) and its
share of the bound; after the Qwen2 runs `[serve-mixtral-w8kv8]` (twice, bit for bit) and
`[serve-mixtral-w4kv8]` serve Mixtral-8x7B whole (32 layers, 8 experts
top-2; random bf16 weights quantized a layer at a time, int8 experts,
int8 KV), `[serve-qwen3moe]` Qwen3-30B-A3B's widths at 8 layers (128
experts top-8, bf16, int8 KV) and `[serve-deepseek-v2-lite]` DeepSeek-
V2-Lite whole (27 layers, MLA over latent rows, YaRN, the radix cache
on; twice, bit for bit, then a wave of prefix hits), 4 prompts of
1,500-2,000 ids and 64 tokens each, with their launch counts (the
grouped kernel's wave on its extend plan, every decode step on its
decode plan), the distinct experts a decode step touches, and the logits of a wave and a
decode step against the twins; `[mla-moe-fp32]` holds DeepSeek's fp32
expert path on the kernel against its fp32 twin.

The vision zoo, after the Phi-3-mini runs: `[serve-internvl-*]` serves
InternVL3-8B whole (INTERNVL3_8B, OpenGVLab/InternVL3-8B-hf's config:
InternViT-300M at 448 px, the pixel shuffle to 256 tokens a tile, the
Qwen2.5-7B decoder, hd 128, G 7) from random bf16 weights in the -hf key
names through `internvl_params_from_hf` and `InternVLServing`, radix
cache on: 4 requests of 1 or 2 tiles and ~40 text ids in two waves of
two (the third repeats the first one's tile and must hit its prefix), 64
tokens, bf16 KV twice (bit for bit) and int8 KV, every extend launch on
`extend_kernel<128>`, the logits of a wave and a decode step against the
twins; `[internvl-vision]` holds InternViT + projector against their fp32
twin and times them a tile. `[serve-siglip]` writes an xtuner directory
with google/siglip-so400m-patch14-384's tower (SigLIP names, a patch
bias, no CLS) beside Vicuna-7B's widths at 4 layers, loads it with
`load_auroracap_dir` and serves 4 clips of 8 frames through
AuroraCapServing at kept ratio 0.2, int8 KV: the visual token count (no
CLS) spans each request's fused placeholders, one extend launch a
layer; `[siglip-vision]` holds one clip's visual groups against their
fp32 twin under the bf16 pass's ToMe merges.

Serving across devices, after [infer] on the [serve] phases' weights:
`[serve-tp2]` / `[serve-tp2-w8kv8]` serve the 4 clips on
EngineConfig(tp=2) with both shards on this card, bf16 and W8 + int8 KV,
TP_MAX_NEW tokens, beside the tp 1 engine on the same requests: a
wave's logits against tp 1's and against the twins at the [serve]
phases' bounds, TP_FORCED_STEPS decode forwards fed tp 1's tokens held
to tp 1's logits a step at LOGITS_DECODE_REL_TOL (and the same forwards
without the second shard's partials, a planted fault, beyond it), the
tokens' near-tie contract reported (`[tp2-vs-tp1-*]`), every extend and
decode launch twice tp 1's at half the heads, W8A8 at the shards'
widths. `[serve-tp2-mixtral]`: Mixtral-8x7B at full width,
TP_MIXTRAL_LAYERS layers, W8 + int8 KV, tp 2 against tp 1 with tp 1's
routing replayed into both shards: a wave's logits at TP_MIXTRAL_TOL
(a wave without the second shard's MLP partials beyond it) and the fed
decode forwards at LOGITS_DECODE_REL_TOL, the grouped kernel at N =
7,168. `[serve-dp2]`:
MultiReplicaController with two bf16 replicas on this card sharing the
weights, DP_REQUESTS clips under shortest_queue and round_robin, each
replica bit for bit one engine on its requests; no slot leaks. `[export]` / `[export-huggingface]`: the
weights with EXPORT_LAYERS LLM layers written by models/export.py in bf16
and loaded back bit for bit.

Sequence parallelism and the training mesh, after `[flash-d512]`: every
rank a process on this card (`run_ranks` starts `chip_smoke.py
--rank-phase NAME DIR` under a torchrun environment, the kernels built
once first), the collectives over gloo through host memory, so these
phases measure correctness, launches and peak memory a rank, not NCCL,
NVLink or distinct cards. `[kernels]` flash_lse holds
`flash_attention_lse` at one ring block (B 1, T 4,096, H 32, D 128;
causal, and at q_offset -1, the stripe layout's, whose first row sees no
key) against its fp32 twin with an lse cotangent, timed beside the twin
and SDPA; `[sp-attn]` runs ring (contiguous, zigzag and stripe on
pre-split sequences, GQA with Hkv 8), Ulysses, hybrid u 2 × r 2 and the
varlen ring (4 segments) on 4 ranks at B 1, T 16,384, H 32, D 128, bf16:
each rank's out and dQ/dK/dV against the one-process kernels on the
whole sequence (SP_OUT_TOL / SP_GRAD_TOL, beside a planted dropped K/V
block), each rank's flash and flash_attention_lse launches equal to the
ring's case rules; `[train-sp]` takes one step of train/bench_stage.py's
model at 7B widths, 2 layers, 1 × 16,384 tokens, full remat, on sp 4
(ring) and sp 2 × tp 2 (Ulysses): loss and grad norm against the
one-process step on the card (beside planted faults: a dropped K/V
block, the second tp shard's partials dropped), launches a rank by the
rules, step ms and peak GB a rank; `[train-dp2]` (2 steps, the ranks'
parameters bit for bit) and `[train-fsdp2]` (each rank half the
trainable bytes) at seq 2048, 2 rows, against the one-process loss.

`python3 chip_smoke.py --only train-cli` runs infer-load and the four
train-cli phases alone; `--only train-parallel` the multi-rank phases
above; `--only kernels`, `--only serve-gemma2` (the
Gemma-2, Qwen2 and StableLM runs), `--only serve-phi3` (the Phi-3-mini
runs), `--only train-dpo`, `--only
serve-moe` (the
MoE and MLA phases above), `--only serve-internvl`, `--only
serve-siglip` and `--only serve-parallel` (the serving-across-devices
and export phases) the newer phases (no kernel JSON line, no final
line); `--only` repeats.

float32 references run with TF32 disabled for matmuls and cuDNN
convolutions, so they are true fp32.
"""

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SEED = 0
# LLM depth of the AuroraCap-7B serving path and of Mistral-7B: 16 of
# their 32 layers at full width, so that the script, the zoo's runs
# included, stays within about 500 s on an H100
AURORA_LAYERS = 16
MISTRAL_LAYERS = 16
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
    "bf16": "random bf16 layers amplify single bf16 roundings",
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
# the dense zoo's (head_dim, Hq, Hkv) at their published configs, for
# both attention kernels in every KV mode beside the serving shapes
# (L 4 layers of rows: the kernels read one layer)
FAMILY_SHAPES = (("gemma2-9b", 256, 16, 8), ("phi3-mini", 96, 32, 32),
                 ("minicpm-2b", 64, 36, 36), ("starcoder2-7b", 128, 36, 4),
                 ("glm-4-9b", 128, 32, 2), ("starcoder", 128, 48, 1),
                 ("qwen2-0.5b", 64, 14, 2))
FAMILY_L = 4
# flash at D 256: google/gemma-7b's 16 heads at T 2048
FLASH_D256 = dict(B=2, T=2048, H=16, Hkv=16, D=256)
# flash at D 512, the widest head the kernels take (no family of the zoo
# has a head past 256): 8 heads at T 2048
FLASH_D512 = dict(B=1, T=2048, H=8, Hkv=8, D=512)
# Gemma-2-9B served at full width and depth: prompts past its window of
# 4096 (so that the alternation of windowed and global layers matters)
GEMMA2_PROMPT = (5000, 6000)
GEMMA2_MAX_NEW = 64
GEMMA2_RUNS = (("bf16", "none", "none", "launches"),
               ("bf16-again", "none", "none", "launches"),
               ("kv8", "none", "int8", "launches_int8"),
               ("kv4", "none", "int4", "launches_int4"),
               ("w4kv8", "int4", "int8", "launches_int8"))
GEMMA2_LOGITS_TOL = 1.5e-1    # Mistral's bound; 42 layers and two caps
GEMMA2_LOGITS_REASON = ("42 random bf16 layers amplify single bf16 "
                        "roundings (Mistral's bound)")
# Gemma-2-9B's served extend in [kernels]: one wave of the [serve-gemma2-*]
# runs' 4 prompt lengths (their own draw, gemma2_prompt_lens) at the
# engine's bucket of 6144 from position 0, in rows of 6144 tokens, Hq 16,
# Hkv 8, hd 256 (extend_d256_kernel); with the even layers' window 4096
# and cap 50, then with neither (which gives SDPA's time)
GEMMA2_SERVED_OPTIONS = (dict(window=4096, logit_cap=50.0), {})
# stabilityai/stablelm-3b-4e1t's config.json (transformers.StableLmConfig's
# defaults), read through the port's converter: head_dim 2560 / 32 = 80,
# which the ragged kernels run padded to 96; served at STABLELM_LAYERS of
# its 32 layers, random bf16 weights, 4 prompts of STABLELM_PROMPT ids,
# STABLELM_MAX_NEW greedy tokens, in every KV mode
STABLELM_3B = dict(model_type="stablelm", vocab_size=50304, hidden_size=2560,
                   intermediate_size=6912, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=32,
                   hidden_act="silu", max_position_embeddings=4096,
                   layer_norm_eps=1e-5, rope_theta=10000, rope_scaling=None,
                   use_qkv_bias=False, qk_layernorm=False,
                   use_parallel_residual=False, partial_rotary_factor=0.25,
                   tie_word_embeddings=False)
STABLELM_LAYERS = 4
STABLELM_PROMPT = (1000, 2000)
STABLELM_MAX_NEW = 32
STABLELM_RUNS = (("bf16", "none", "launches"),
                 ("kv8", "int8", "launches_int8"),
                 ("kv4", "int4", "launches_int4"))
# an extend wave's and a decode step's logits against the twins after 4
# random bf16 layers: AuroraCap's bf16 bound, and the int4 KV one (a
# rounding can flip one of 15 levels)
STABLELM_LOGITS_TOL = {"bf16": LOGITS_REL_TOL, "kv8": LOGITS_REL_TOL,
                       "kv4": LOGITS_W4KV4_REL_TOL}
# microsoft/Phi-3-mini-4k-instruct's config.json (the fields the port's
# converter reads): head_dim 3072 / 32 = 96, MHA, a sliding window of 2047
# on every layer. Served whole (32 layers), random bf16 weights written as
# the checkpoint's fused tree (qkv_proj, gate_up_proj) and converted by
# `llama_params_from_hf`: 4 prompts of PHI3_PROMPT ids in one wave of the
# PHI3_BUCKET bucket (rows of PHI3_BUCKET), PHI3_MAX_NEW greedy tokens,
# bf16 KV twice (bit for bit), int8 KV, packed int4 KV
PHI3_MINI = dict(model_type="phi3", vocab_size=32064, hidden_size=3072,
                 intermediate_size=8192, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=32,
                 hidden_act="silu", max_position_embeddings=4096,
                 rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
                 sliding_window=2047, attention_bias=False,
                 tie_word_embeddings=False)
PHI3_PROMPT = (3000, 4000)
PHI3_BUCKET = 4096
PHI3_MAX_NEW = 32
PHI3_RUNS = (("bf16", "none", "launches"),
             ("bf16-again", "none", "launches"),
             ("kv8", "int8", "launches_int8"),
             ("kv4", "int4", "launches_int4"))
PHI3_LOGITS_TOL = 1.5e-1    # Mistral's bound: 32 random bf16 layers
PHI3_LOGITS_REASON = ("32 random bf16 layers amplify single bf16 roundings "
                      "(Mistral's bound)")
# OpenGVLab/InternVL3-8B-hf's config.json, written inline (the fields the
# port's converters read): InternViT-300M (448 px, patch 14, 24 layers,
# q/k/v biases, LayerScale, mean pooling), the pixel shuffle at 0.5 (256
# visual tokens a tile), and Qwen2.5-7B (the port's qwen2_7b widths, G 7,
# hd 128, qkv biases, rope theta 1e6; the -hf config's vocab). Served
# whole from random bf16 weights in the -hf key names through
# `internvl_params_from_hf`: 4 requests of 1 or 2 tiles and ~40 text ids,
# INTERNVL_MAX_NEW greedy tokens, two waves of two (the third request
# repeats the first one's tile, so the second wave hits its prefix), bf16
# KV twice (bit for bit) and int8 KV
INTERNVL3_8B = {
    "vision_config": dict(hidden_size=1024, intermediate_size=4096,
                          num_hidden_layers=24, num_attention_heads=16,
                          image_size=[448, 448], patch_size=[14, 14],
                          layer_norm_eps=1e-6, norm_type="layer_norm",
                          use_qk_norm=False, attention_bias=True,
                          layer_scale_init_value=0.1, use_mean_pooling=True,
                          use_absolute_position_embeddings=True,
                          hidden_act="gelu"),
    "text_config": dict(model_type="qwen2", vocab_size=151674,
                        hidden_size=3584, intermediate_size=18944,
                        num_hidden_layers=28, num_attention_heads=28,
                        num_key_value_heads=4, hidden_act="silu",
                        max_position_embeddings=32768, rms_norm_eps=1e-6,
                        rope_theta=1000000.0, use_sliding_window=False,
                        tie_word_embeddings=False),
    "downsample_ratio": 0.5, "projector_hidden_act": "gelu"}
INTERNVL_PROMPTS = (
    (1, "Describe this image in detail, including its colours."),
    (2, "What differs between these two pictures? Answer briefly."),
    (1, "List every object you can see in the image, one per line."),
    (2, "Which of the two images looks brighter, and why do you think so?"))
INTERNVL_MAX_NEW = 64
INTERNVL_BUCKET = 1024
INTERNVL_RUNS = (("bf16", "none", "launches"),
                 ("bf16-again", "none", "launches"),
                 ("kv8", "int8", "launches_int8"))
# the logits of a wave against the twins at the 5e-2 that the Qwen2
# phase's W4 run and the bf16 engines hold (measured on an H100
# 2.50-2.73e-2 over 28 layers); a decode step at logits_check's default,
# as in the Qwen2 phase (measured 1.92e-2)
INTERNVL_LOGITS_TOL = LOGITS_REL_TOL
# InternViT + projector (bf16, SDPA) against the same modules in fp32
# (max |Δ| / max |want| over a request's tiles)
VISUAL_REL_TOL = 5e-2
# google/siglip-so400m-patch14-384's vision config as an xtuner
# directory's visual_encoder/, beside Vicuna-7B-v1.5-16k's widths cut to
# SIGLIP_LLM_LAYERS layers; AuroraCap serving at kept ratio 0.2, 4 clips
# of 8 frames, bf16 weights, int8 KV, SIGLIP_MAX_NEW greedy tokens
SIGLIP_SO400M = dict(model_type="siglip", hidden_size=1152,
                     intermediate_size=4304, num_hidden_layers=27,
                     num_attention_heads=16, image_size=384, patch_size=14,
                     layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh")
SIGLIP_LLM_LAYERS = 4
SIGLIP_MAX_NEW = 64
# Qwen2-7B at its widths, 4 layers: qkv biases drawn N(0, 1) so that they
# act, G 7, rope theta 1e6
# The MoE and MLA families: the grouped-expert kernel at each family's
# expert shape (name, D, F, E, k), at a decode's 4 tokens and a wave of
# 4 x 2048; Mixtral-8x7B whole at W8 and W4 (int8 experts), Qwen3-30B-A3B
# at QWEN3MOE_LAYERS of its 48 layers, DeepSeek-V2-Lite whole, each
# serving N_REQUESTS prompts of MOE_PROMPT random ids, MOE_MAX_NEW tokens
MOE_SHAPES = (("mixtral-8x7b", 4096, 14336, 8, 2),
              ("qwen3-30b-a3b", 2048, 768, 128, 8),
              ("deepseek-v2-lite", 2048, 1408, 64, 6))
MOE_TOKENS = (4, 4 * 2048)
MOE_PROMPT = (1500, 2000)
MOE_MAX_NEW = 64
MOE_SEQ = 2112            # prompt + new tokens a row holds (2304 a row)
QWEN3MOE_LAYERS = 8
# mistralai/Mixtral-8x7B-v0.1's config.json
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, rope_theta=1e6,
                    rms_norm_eps=1e-5, num_experts=8, num_experts_per_tok=2)
# Qwen/Qwen3-30B-A3B's config.json (its dense intermediate_size, 6144,
# serves no layer: every layer is sparse, moe_intermediate_size 768)
QWEN3_30B_A3B = dict(vocab_size=151936, hidden_size=2048,
                     intermediate_size=768, num_hidden_layers=48,
                     num_attention_heads=32, num_key_value_heads=4,
                     head_dim_override=128, qk_norm=True,
                     max_position_embeddings=40960, rope_theta=1e6,
                     rms_norm_eps=1e-6, num_experts=128,
                     num_experts_per_tok=8, moe_router_mode="softmax_topk",
                     moe_norm_topk=True)
# deepseek-ai/DeepSeek-V2-Lite's config.json (the fields the converter
# reads), YaRN as it ships
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "n_shared_experts": 2, "n_routed_experts": 64,
    "routed_scaling_factor": 1.0, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "greedy", "n_group": 1, "topk_group": 1,
    "num_experts_per_tok": 6, "moe_layer_freq": 1,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 163840,
    "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"}}
# the grouped kernel against its twin: fp32 sums in another order, then
# one bf16 rounding of the same value: |Δ| <= 2^-8 |want| + MOE_ABS_TOL
# max |want|
MOE_ABS_TOL = 1e-5
# logits of a wave and a decode step, kernels against twins, the twins'
# pass on the kernels' routing (logits_check's replay): without it a
# token whose router sits on a near tie routes apart and moves its whole
# MLP output, and 32 random layers of that gave a rel err of 1.02 and
# 0/4 argmax agreement (PERF.md §6). With it: Mistral's bound for
# bf16 and W4 weights (measured on an H100 5.79e-2 Mixtral W4, 6.5e-3
# Qwen3-MoE, 1.66e-2 DeepSeek-V2-Lite), the W8 engines' for W8 (its
# per-token activation codes flip; measured 1.20e-1 Mixtral W8)
MOE_LOGITS_TOL = {"none": 1.5e-1, "int4": 1.5e-1, "int8": LOGITS_W8_REL_TOL}
MOE_LOGITS_REASON = ("random bf16 layers amplify single bf16 roundings; "
                     "routing replayed from the kernels' pass")
# DeepSeek's fp32 expert path on the card (bf16 high + low parts of the
# fp32 activation into the down product) against the fp32 twin at one
# MoE layer: max |Δ| / max |want| of the bf16 output
MLA_MOE_TOL = 1e-2
QWEN2_LAYERS = 4
QWEN2_RUNS = (("w8kv8", "int8", "int8"), ("w4kv8", "int4", "int8"))
# the AuroraCap runs' bounds: the same per-token requantization
QWEN2_LOGITS_TOL = {"w8kv8": LOGITS_W8_REL_TOL, "w4kv8": LOGITS_W4_REL_TOL}
# DPO at Vicuna-7B widths, 2 layers: 4 unmasked pairs of 2048 tokens (the
# first 512 of each the prompt), 3 steps, twice from the same weights
DPO_LAYERS = 2
DPO_PAIRS = 4
DPO_SEQ = 2048
DPO_PROMPT = 512
DPO_STEPS = 3
# the same step over google/gemma-7b's widths (head_dim 256: the D 256
# flash kernels), one layer, one pair, one step
GEMMA7B = dict(vocab_size=256000, hidden_size=3072, intermediate_size=24576,
               num_attention_heads=16, num_key_value_heads=16,
               head_dim_override=256, rms_norm_eps=1e-6,
               max_position_embeddings=8192, tie_word_embeddings=True,
               hidden_act="gelu_tanh", scale_embeddings=True,
               norm_upcast_mul=True)
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
# Sequence parallelism and the training mesh, on this one card: every rank
# a process on cuda:0, the collectives over gloo through host memory
# (parallel/collectives.py); NCCL, NVLink and distinct cards are not
# exercised. [sp-attn]: Vicuna-7B's attention widths, B 1, T 16,384 over
# 4 ranks, bf16; each rank's out and dQ/dK/dV against the one-process
# flash kernels on the whole sequence, max |Δ| / max |want| (measured on
# an H100, PERF.md: out 4.6e-3 to 6.1e-3, grads up to 9.2e-3;
# Ulysses 0; the planted dropped K/V block 0.934)
SP_RANKS = 4
SP_T, SP_H, SP_D = 16384, 32, 128
SP_ULYSSES = 2                      # hybrid: u 2 × r 2
SP_SEGMENTS = (0, 3000, 7500, 12000, 16384)   # the varlen ring's packing
SP_CASES = {"ring": dict(mode="ring"),
            "ring-zigzag": dict(mode="ring", layout="zigzag"),
            "ring-stripe": dict(mode="ring", layout="stripe"),
            "ring-gqa": dict(mode="ring", Hkv=8),
            "ulysses": dict(mode="ulysses"),
            "hybrid": dict(mode="hybrid"),
            "ring-varlen": dict(mode="ring", segments=True)}
SP_OUT_TOL = 1.5e-2
SP_GRAD_TOL = 2e-2
# [train-sp]: the AuroraCap step of train/bench_stage.py at 7B widths,
# TRAIN_SP_LAYERS layers, text batch 1 x TRAIN_SP_SEQ, full remat; loss
# and grad norm relative to the one-process step on the card (measured
# 5.1e-6 / 1.1e-5 on the sp 4 ring, 8.5e-7 / 1.8e-5 on sp 2 x tp 2; the
# planted faults move the loss 1.2e-3 and 4.6e-4)
TRAIN_SP_LAYERS = 2
TRAIN_SP_SEQ = 16384
TRAIN_SP_MESHES = {"sp4-ring": (dict(sp=4), dict(sp_mode="ring")),
                   "sp2-tp2-ulysses": (dict(sp=2, tp=2),
                                       dict(sp_mode="ulysses"))}
TRAIN_SP_LOSS_TOL = 1e-4
TRAIN_SP_GNORM_TOL = 2e-4
# [train-dp2] / [train-fsdp2]: 2 ranks, 7B widths, 2 layers, 2 rows of
# TRAIN_DP_SEQ (one a rank), TRAIN_DP_STEPS steps, each step's loss and
# grad norm against the one-process steps at the [train-sp] bounds; the
# planted faults skip the dp sum or the fsdp gather's transpose (its
# sum). fsdp's memory: a rank's peak at TRAIN_FSDP_DEEP layers less its
# peak at TRAIN_SP_LAYERS, a layer, at most ZeRO-3's (its shard, the
# two moments and the shard's gradient: 4 shards) and half a whole
# layer; a layer's whole parameters kept past its end (the planted
# fault) add a whole layer
TRAIN_DP_SEQ = 2048
TRAIN_DP_STEPS = 2
TRAIN_FSDP_DEEP = 6
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
# [serve-http]: cli/bench_serving's load (requests, in flight at once, prompt
# characters, greedy tokens each), then the other requests' new tokens;
# /update_weights on a second server at Vicuna-7B widths and this depth
HTTP_LOAD = dict(num_requests=16, concurrency=8, prompt_len=128,
                 max_tokens=64)
HTTP_MAX_NEW = 64
HTTP_LANES = 8            # chats plain, then streamed beside 2 videos
HTTP_ABORT_MAX_NEW = 1500
HTTP_UPDATE_LAYERS = 2
HTTP_UPDATE_MAX_NEW = 32
# [serve-chunked]: AuroraCap at inference.py's default kept ratio (8 frames
# of 605 visual tokens: ~4.9k-token prompts, 3 chunks of the engine's
# largest bucket, 2048), 2 videos of 8 x 360 x 640 admitted beside 6 text
# prompts already decoding, then one more video aborted after its first
# chunk; the one-wave run's bucket; the pool holds both videos' prompts
CHUNKED_KEPT_RATIO = 0.8
CHUNKED_VIDEO_SHAPE = (8, 360, 640, 3)
CHUNKED_INCUMBENTS = 6
CHUNKED_MAX_NEW = 64
CHUNKED_ONE_WAVE = 5120
CHUNKED_SLOTS = 16384
# [serve-constrained]: the VDC judge's answer (aurora_tpu/eval/judge.py's
# dict) as a regex, VDC's five caption aspects as choices
JUDGE_REGEX = r"\{'pred': '(yes|no)', 'score': [0-5]\}"
ASPECTS = ("detailed", "background", "short", "main object", "camera")
CONSTRAINED_MAX_NEW = 48
CONSTRAINED_FREE_MAX_NEW = 32
# [serve-http]: the long prompt's characters (one ByteTokenizer id each)
HTTP_LONG_PROMPT = 3000
# [serve-kv4grid] / [serve-a8-prefill]: 4 new clips of 8 frames served with
# W4 stripes + int8 KV at the int4 grid (EngineConfig(kv_grid_bits=4), the
# reference's AURORA_KV_BITS=4) and through the A8 prefill (w4_prefill=
# "a8", its AURORA_W4_PREFILL=a8), against the same requests at grid 8 with
# the bf16 prefill; tokens each (depth cut from MAX_NEW: the runs compare
# prefixes); the A8 branch's rel L2 from the bf16 branch at a 7B layer's
# four projections (tests/test_w4_prefill_a8.py:48's gate, and above
# 1e-6: the branch ran), over this many token rows (> MAX_TOKENS: the
# prefill branch); extend-wave timings a mode, alternating
SURFACE_MAX_NEW = 64
A8_REL_TOL = 0.03
A8_ROWS = 256
SURFACE_WAVE_REPS = 2
# [eval]: AuroraCapEval on [infer-load]'s directory at the eval CLI's
# kept ratio (its docstring's example), VDC's five subsets over this many
# synthetic 8-frame videos (one doc each a subset), tokens a doc; the
# judge's generated tokens a call (depth cut from JudgeClient's 256: random
# weights), one QA a video
EVAL_KEPT_RATIO = 0.2
EVAL_VIDEOS = 8
EVAL_MAX_NEW = 64
JUDGE_MAX_TOKENS = 48
EVAL_QA = ({"question": "What is the camera doing?",
            "answer": "It pans slowly to the left."},)
# the radix run's tokens against the radix-off run's: equal until the first
# flip, which must sit on a top-2 logprob gap below this (the near-tie
# contract of tests/test_torch_engine_quant.py)
NEAR_TIE = 2e-2
# [serve-tp2], [serve-tp2-w8kv8], [serve-dp2]: new tokens a request; the
# Mixtral depth of [serve-tp2-mixtral] (of its 32 layers, full width);
# [serve-dp2]'s clips and each replica's radix pool (4 prompts of 1,406
# tokens); the LLM layers [export] writes beside the whole tower
TP_MAX_NEW = 64
TP_MIXTRAL_LAYERS = 4
# tp 2 against tp 1 after a wave: decode forwards fed tp 1's tokens
# (teacher forcing), each step's logits held at LOGITS_DECODE_REL_TOL
TP_FORCED_STEPS = 8
# [tp2-vs-tp1-mixtral]: its own bound on a wave's logits (tp 1's routing
# replayed into both shards), between the sound reading (4.88e-2, PR 25)
# and what one shard's MLP partial zeroed in every layer reads; each tp
# bound is checked against such a planted fault in the same call
TP_MIXTRAL_TOL = 1e-1
DP_REQUESTS = 8
DP_SLOTS = 6144
EXPORT_LAYERS = 4
# [infer-beam]: the beam's mean token log-probability against greedy's, both
# from one bf16 forward each: half the near-tie gap, the drift between two
# decode paths' top-1 log-probabilities that NEAR_TIE allows
BEAM_SCORE_TOL = NEAR_TIE / 2
# the card's resize-crop against the CPU's, levels of 0-255 after rounding
RESIZE_TOL = 1.0
# [train-cli*]: the train CLI (cli/train.run) over [infer-load]'s xtuner
# directory at full width (Vicuna-7B widths at INFER_LOAD_LAYERS layers,
# ViT-H/14-378 whole), bf16, from a llava-format json of synthetic PNGs
# written here; ByteTokenizer for the directory's missing tokenizer files
TRAIN_CLI_IMAGES = 16
TRAIN_CLI_IMAGE_SHAPE = (480, 640, 3)
TRAIN_CLI_BATCH = 4        # the pretrain stage's batch of 16, cut to 4
TRAIN_CLI_STEPS = 6        # [train-cli]: checkpoints at 3 and 6
TRAIN_CLI_CKPT = 3
TRAIN_CLI_VISION_STEPS = 4     # grad_accum 2: two updates
TRAIN_CLI_VISION_FRAMES = 4
TRAIN_CLI_PACK = 4096
TRAIN_CLI_PACKED_STEPS = 3
TRAIN_CLI_QLORA_STEPS = 3
TRAIN_CLI_LORA_R = 64
# one packed batch's loss against the same documents unpacked, relative,
# bf16: the reference's mean over the valid tokens counts the same tokens
# either way (each document starts with ignored labels), so they differ
# only by rounding: RoPE at other absolute positions and other matmul
# shapes in bf16, through 2 layers
PACKED_LOSS_TOL = 1e-2
# H100 SXM5 data sheet: dense bf16 tensor-core peak, int8 peak, HBM rate
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


_T0 = time.perf_counter()


def phase(name, **fields):
    """One line of a phase; at_s: seconds since the script started (where
    the run's time goes)."""
    fields["at_s"] = f"{time.perf_counter() - _T0:.1f}"
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

    bos_token_id = 1
    eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([1] + ids) if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) if i < 131 else chr(0x4E00 + i)
                       for i in ids if i > 2)

    def id_of(self, piece):
        """The id that decodes to `piece` (one character); the empty
        decode of a special id (0, 1, EOS) gives EOS."""
        if not piece:
            return self.eos_token_id
        c = ord(piece)
        return c + 3 if c < 128 else c - 0x4E00


def attention_case(torch, ra, dev, g, hkv, mode, L=32, S=1792, T=1536,
                   offs=(0, 256, 0, 0), lens=(1392, 256 + 1400, 1536, 0),
                   dlens=(1648, 700, 0, 1), window=None, logit_cap=0.0,
                   q_gain=1.0, hd=128, Hq=32, family=None):
    """Both attention kernels vs their plain twins at the serving shapes
    (L = 32, S = 1792, hd = 128) or at Mistral's (S = 7168), with bf16 KV,
    int8 KV on the kv_quantize grid, int8 KV on the maxq-7 grid
    ("int4grid": EngineConfig(kv_grid_bits=4), kv_maxq 7 into the decode
    kernel) or nibble-packed int4 KV on that grid (`mode`), with GQA, permuted rows, a query offset > 0 and
    a padded / inactive lane (where lens / dlens hold a 0), optionally
    with a sliding window and a
    logit cap (q scaled by q_gain so that scores reach the cap) →
    {"extend"|"decode": {err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}. With an option on, the kernel's result must differ from
    the twin's without it by more than OFF_CONTROL times its error (the
    option reached the kernel), both taken over the query rows the option
    changes. The library call (bf16 KV, no cap) is one
    F.scaled_dot_product_attention over the lanes' rows, gathered (and
    for GQA repeated to Hq heads) beforehand, with a boolean mask; for a
    windowed decode over each lane's last `window` keys only. hd, Hq:
    the zoo's other head widths and groups (FAMILY_SHAPES)."""
    import torch.nn.functional as F
    B = 4
    w = window or 0
    opts = dict(window=window, logit_cap=logit_cap)
    bf = dict(device=dev, dtype=torch.bfloat16)
    i32 = dict(device=dev, dtype=torch.int32)
    k = torch.randn((L, B, hkv, S, hd), generator=g, **bf)
    v = torch.randn((L, B, hkv, S, hd), generator=g, **bf)
    kv, dkv = {}, {}            # the extend's and the decode's KV options
    if mode != "bf16":
        maxq = 127.0 if mode == "int8" else 7.0     # int4, int4grid
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
    key_bytes = {"bf16": 4 * hd, "int8": 2 * hd + 8, "int4grid": 2 * hd + 8,
                 "int4": hd + 8}[mode]
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
    if family:
        tag.update(family=family, hd=hd, Hq=Hq)

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
    rel_e = lane_rel_err(got, want, [i for i, n in enumerate(lens) if n > 0])
    check(bool(torch.isfinite(got).all()), "extend output not finite")
    check(all(bool((got[i] == 0).all()) for i, n in enumerate(lens)
              if n <= 0), "padded extend lane not zero")
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
    vn[3, min(1, hkv - 1)] = 0        # an all-zero token: the 1e-8 floor
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
    rel_d = lane_rel_err(out, want, [i for i, n in enumerate(dlens) if n > 0])
    check(all(bool((out[i] == 0).all()) for i, n in enumerate(dlens)
              if n <= 0), "inactive decode lane not zero")
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
               segments=False, with_lse=False, timed=False, D=128):
    """The flash kernels vs the fp32 twin on one seeded case (causal, D =
    128, 256, 512, or a width the launcher pads): out, lse, and dQ/dK/dV
    from one
    backward with a random dO (and a random lse cotangent with
    with_lse); a second backward must agree bitwise → errors, and with
    timed (H == Hkv, no segments) the kernels', the twin's and SDPA's
    times and the three kernels' bounds."""
    import torch.nn.functional as F
    S = T + q_offset
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
    these inputs, and the backend SDPA picks for them."""
    from torch.nn.attention import SDPBackend
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
    t["library_backend"] = SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, None, 0.0, True)).name
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

        def update(self, grads, state, model, gnorm=None, norm=None):
            self.grads = {n: g.clone() for n, g in zip(self.names, grads)
                          if n.split(".")[-2] in ("q", "k", "v", "o")}
            super().update(grads, state, model, gnorm, norm)

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


class RoutingTape:
    """Records what the functions it wraps return (a MoE router's
    weights and experts) on one pass and hands the same results back, in
    the same order, on the next."""

    def __init__(self, targets):
        self.targets, self.tape, self.at = targets, [], None

    def _wrap(self, fn):
        def inner(*a, **k):
            if self.at is None:
                out = fn(*a, **k)
                self.tape.append(out)
                return out
            self.at += 1
            return self.tape[self.at - 1]
        return inner

    def patched(self, replay: bool):
        stack = contextlib.ExitStack()
        self.at = 0 if replay else None
        if not replay:
            self.tape = []
        for mod, attr in self.targets:
            stack.enter_context(mock.patch.object(
                mod, attr, self._wrap(getattr(mod, attr))))
        return stack


def logits_check(torch, engine_mod, runner, embed, reqs, tol, name, plain,
                 decode=False, decode_tol=LOGITS_DECODE_REL_TOL,
                 reason=None, replay=()):
    """One extend wave's logits (each request's prompt embeds, `embed(r)`
    [n_i, D], in a lane of the smallest bucket that holds them all)
    through the kernels and through the plain twins (patched into the
    engine module, into models/llama.py for the fused MLP and into
    ops/moe.py for the grouped-expert product, for that call only); with `decode`, then one decode step of every lane (the
    kernels' greedy token at the position after its prompt) both ways.
    Each decode forward writes its own token's K/V before it attends, so
    the second overwrites the first's. replay: (module, name) of MoE
    routing functions whose results the twins' pass takes from the
    kernels' pass (RoutingTape), so that a router decision on a near tie,
    which moves its token's whole MLP output, cannot route the two
    passes apart and the check holds the arithmetic."""
    from aurora_tpu_torch.models import llama as llama_mod
    from aurora_tpu_torch.ops import moe as moe_mod

    def plain_twins():
        stack = contextlib.ExitStack()
        for mod in (engine_mod, llama_mod, moe_mod):
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
    tape = RoutingTape(replay)
    with tape.patched(False):
        logits_k = runner.extend(embeds, row_ids, offs, lens)
    with plain_twins(), tape.patched(True):
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
                                             runner.layer_ids, tp=runner.tp)
                return engine_mod._lm_head(runner.model, h)

        with tape.patched(False):
            dec_k = step()
        with plain_twins(), tape.patched(True):
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
    """Mistral-7B at its published widths (MISTRAL_LAYERS of its 32
    layers), random bf16 weights
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
    cfg = dataclasses.replace(LlamaConfig.mistral_7b(),
                              num_hidden_layers=MISTRAL_LAYERS)
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
                        max_new_tokens=max_new, eos_ids=(),
                        logprobs=run == "kv8")
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, max_new)
        if run == "kv8":
            one_wave = {r.rid: r for r in reqs}
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
    out["chunked"] = mistral_chunked(torch, ra, llm, cfg, prompts, one_wave,
                                     dev, card, plains)
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mistral_chunked(torch, ra, llm, cfg, prompts, one_wave, dev, card,
                    plains):
    """[serve-chunked-mistral]: [serve-mistral-kv8]'s prompts at the
    engine's default buckets, so that each prefills in 3 chunks of at most
    2048 and the 4096-token window of the later chunks reaches keys that
    earlier chunks wrote: windowed extend launches 32 a chunk step, those
    at q_offsets > 0 counted; tokens against the one-wave run (bucket
    6144) under the near-tie rule → (windowed extend launches, windowed
    decode launches)."""
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    L, max_new = cfg.num_hidden_layers, 64
    ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=6400,
                        kv_chunk=1024, decode_steps=16, kv_quant="int8",
                        disable_radix_cache=True)
    engine = ServeEngine(llm, cfg, ecfg, device=dev, seed=SEED)
    offsets = offset_extends(engine, ra.ragged_attention, "launches_window")
    chunk_s = timed_chunks(torch, engine)
    counters = [(ra.ragged_attention, "launches_window"),
                (ra.ragged_decode_attention, "launches_window"),
                (ra.ragged_attention, "launches_int8"),
                (ra.ragged_decode_attention, "launches_int8")] + plains
    reqs = [Request(rid=f"m{i}", input_ids=list(p), max_new_tokens=max_new,
                    eos_ids=(), logprobs=True)
            for i, p in enumerate(prompts)]
    wall, counts = serve(torch, engine, reqs, counters, max_new)
    ext_w, dec_w, ext_n, dec_n = (counts[f"{f.__name__}.{a}"]
                                  for f, a in counters[:4])
    at_offset = [n for off, n in offsets if off > 0]
    flips, gap, lp = near_tie({r.rid: r for r in reqs}, one_wave)
    steps = engine._steps
    phase("serve-chunked-mistral", card=repr(card),
          config=f"mistral-7b/L{L}/window{cfg.sliding_window}/bf16-weights/"
                 "kv-int8",
          buckets="/".join(map(str, ecfg.prefill_buckets)),
          prompt_tokens=",".join(str(len(p)) for p in prompts),
          new_tokens=max_new,
          chunk_extend_s=",".join(f"{t:.4f}" for t in chunk_s),
          decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
          decode_steps=steps, wall_s=f"{wall:.2f}",
          windowed_extend_launches=ext_w,
          windowed_extend_launches_at_offset=",".join(map(str, at_offset)),
          flips=flips, worst_flip_gap=f"{gap:.3e}", near_tie=NEAR_TIE,
          worst_top1_logprob_diff=f"{lp:.3e}",
          launches=json.dumps(counts).replace(" ", ""))
    check(len(chunk_s) == 3, f"{len(chunk_s)} chunk steps")
    check(ext_w == ext_n == 3 * L and at_offset == [L, L],
          f"windowed extend launches {ext_w} / {ext_n}, at q_offsets > 0 "
          f"{at_offset}")
    check(dec_w == dec_n == L * steps,
          f"windowed decode launches {dec_w} / {dec_n}, steps {steps}")
    check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
          f"plain twins ran: {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return ext_w, dec_w


def near_tie(got, want, strict=True):
    """got / want: {rid: Request} run greedy with logprobs. Tokens must be
    equal up to the first step where they differ, whose top-2 logprob gap
    in `want` must be below NEAR_TIE (strict=False: counted, not checked,
    for two configurations that differ by design) → (flips, the largest
    gap at a flip, the worst top-1 logprob difference before a flip)."""
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
                check(not strict or gap < NEAR_TIE,
                      f"{rid}: token {j} flipped on a top-2 gap of {gap}")
                flips += 1
                worst_gap = max(worst_gap, gap)
                break
    return flips, worst_gap, worst_lp


def matched_prefix(got, want):
    """tests/test_quant_quality.py's `_divergence`: (the share of tokens
    equal before each request's first difference, the mean |Δ logprob| of
    the chosen tokens over that prefix)."""
    match = total = 0
    dlp = []
    for rid, w in want.items():
        g = got[rid]
        total += min(len(g.output_ids), len(w.output_ids))
        for a, b, la, lb in zip(w.output_ids, g.output_ids,
                                w.output_logprobs, g.output_logprobs):
            if a != b:
                break
            match += 1
            dlp.append(abs(la - lb))
    return match / max(total, 1), float(np.mean(dlp)) if dlp else 0.0


def write_videos(tmp, n, shape=PREFIX_VIDEO_SHAPE, seed=SEED + 8):
    """The first n of the synthetic .npy videos (bench.py's shape unless
    given) from one seeded stream → their paths; [infer] reads the first
    of [resize-crop]'s."""
    host = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        paths.append(os.path.join(tmp, f"v{i}.npy"))
        np.save(paths[-1], host.integers(0, 255, size=shape, dtype=np.uint8))
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


def offset_extends(engine, kernel, counter):
    """Wrap engine.runner.extend → the list it fills: for each extend call
    of the engine, (its lanes' largest q_offset, the rise of the extend
    kernel's `counter` during the call)."""
    calls, real = [], engine.runner.extend

    def extend(embeds, row_ids, q_offsets, kv_lens):
        n0 = getattr(kernel, counter)
        out = real(embeds, row_ids, q_offsets, kv_lens)
        calls.append((int(np.max(q_offsets)), getattr(kernel, counter) - n0))
        return out

    engine.runner.extend = extend
    return calls


def timed_chunks(torch, engine):
    """Wrap engine._prefill_chunk → the list of its calls' seconds (the
    card synchronized on both sides)."""
    times, real = [], engine._prefill_chunk

    def chunk(work):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(work)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)

    engine._prefill_chunk = chunk
    return times


def chunked_phase(torch, ra, mm, llm, llm_cfg, dev, card, kernels, plains):
    """[serve-chunked]: AuroraCap-7B (W4 stripes + int8 KV, 8 lanes, the
    engine's default buckets, radix on) at inference.py's kept ratio 0.8:
    two synthetic videos read by read_video and resized on the card, whose
    ~4.9k-token prompts take 3 chunks each, admitted while 6 text prompts
    decode; the incumbents gain a token every step of a chunk; the videos'
    tokens against the same requests in one wave (bucket 5120) under the
    near-tie rule; a second question on a finished video hits its prefix;
    a third video aborted after its first chunk adds nothing to the tree
    and leaks nothing. kernels: the (function, counter) pairs the run must
    launch, the int8 extend first; plains: those that must stay 0."""
    import tempfile
    from aurora_tpu_torch.data.preprocess import clip_resize_crop_device
    from aurora_tpu_torch.data.video import read_video
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import \
        _PLACEHOLDER_BASE as placeholder_base
    from aurora_tpu_torch.serve.scheduler import Request
    tok = ByteTokenizer()
    size = mm.image_size
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_videos(tmp, 3, CHUNKED_VIDEO_SHAPE, SEED + 9)
        clips = []
        for path in paths:
            v = torch.as_tensor(read_video(path, N_FRAMES), device=dev)
            clips.append(clip_resize_crop_device(v, size, size).to(
                torch.uint8).cpu().numpy())
    images = " ".join(["<image>"] * N_FRAMES)

    def video_req(rid, v, q, logprobs=True):
        return mm.build_request(
            rid, f"USER: {images}\n{VDC_PROMPTS[q]} ASSISTANT:", clips[v],
            kept_ratio=CHUNKED_KEPT_RATIO, max_new_tokens=CHUNKED_MAX_NEW,
            eos_ids=(), logprobs=logprobs)

    def videos():
        return [video_req(f"video{v}", v, 0) for v in range(2)]

    # the longest prompt served: the videos, the second question, the abort
    P = max(len(r.input_ids) for r in videos() + [
        video_req("x", 0, 1), video_req("x", 2, 0)])
    bucket = max(EngineConfig().prefill_buckets)
    check(2 * bucket < P <= CHUNKED_ONE_WAVE,
          f"video prompts of {P} tokens: not 3 chunks of {bucket}")
    incumbents = [Request(
        rid=f"text{i}", input_ids=tok.encode(
            f"USER: {VDC_PROMPTS[i % len(VDC_PROMPTS)]} ({i}) ASSISTANT:"),
        max_new_tokens=CHUNKED_MAX_NEW, eos_ids=())
        for i in range(CHUNKED_INCUMBENTS)]
    common = dict(weight_quant="int4", kv_quant="int8",
                  max_seq_len=P + CHUNKED_MAX_NEW)
    ecfg = EngineConfig(num_slots=CHUNKED_SLOTS, **common)
    vit_s = []

    def timed_embed_fn(req):
        """mm.embed_fn, its seconds kept (the ViT runs at admission)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mm.embed_fn(req)
        torch.cuda.synchronize()
        vit_s.append(time.perf_counter() - t)
        return out

    engine = ServeEngine(llm, llm_cfg, ecfg, embed_fn=timed_embed_fn,
                         device=dev, seed=SEED)
    check(engine.runner.model is llm, "serve-chunked: the model was not "
                                      "served as given")
    for obj, attr in kernels + plains:
        setattr(obj, attr, 0)
    offsets = offset_extends(engine, *kernels[0])
    chunk_s = timed_chunks(torch, engine)
    done = {}

    def step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = len(chunk_s)
        for r in engine.step():
            done[r.rid] = r
        torch.cuda.synchronize()
        return time.perf_counter() - t, len(chunk_s) > n

    t0 = time.perf_counter()
    for r in incumbents:
        engine.add_request(r)
    step()
    step()                          # the 6 decode
    vids = videos()
    for r in vids:
        engine.add_request(r)
    with_chunk, without, interleaved = [], [], 0
    while engine.has_work():
        before = {r.rid: len(r.output_ids) for r in incumbents}
        wall, chunked = step()
        if chunked:
            with_chunk.append(wall)
            for r in incumbents:
                gained = len(r.output_ids) - before[r.rid]
                check(gained == 1 or r.finished is not None,
                      f"{r.rid} gained {gained} tokens in a step with a "
                      "chunk")
            interleaved += 1
        elif all(r.output_ids for r in vids):
            without.append(wall)
    wall = time.perf_counter() - t0
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in kernels + plains}
    check(len(chunk_s) == 3 and interleaved == 3,
          f"{len(chunk_s)} chunk calls, {interleaved} steps with a chunk")
    video_chunks, video_vit_s = list(chunk_s), list(vit_s)
    for r in incumbents + vids:
        check(done[r.rid].finished.value == "length"
              and len(r.output_ids) == CHUNKED_MAX_NEW,
              f"{r.rid}: {r.finished} {len(r.output_ids)} tokens")
    check(all(r.n_cached == 0 for r in vids), "the videos hit a prefix")
    chunk_offsets = [n for off, n in offsets if off > 0]
    check(len(chunk_offsets) == 2 and all(
        n == llm_cfg.num_hidden_layers for n in chunk_offsets),
        f"extends at q_offsets > 0: {offsets}")
    mem1 = engine.check_memory()
    check(mem1["leaked"] == 0, f"serve-chunked: {mem1}")
    # a second question on video 0: its prefix is cached
    q2 = video_req("video0q2", 0, 1)
    shared = len(os.path.commonprefix([q2.input_ids, vids[0].input_ids]))
    engine.add_request(q2)
    while "video0q2" not in done:
        step()
    check(q2.n_cached >= shared and q2.extend_len_pending <= bucket,
          f"the second question cached {q2.n_cached} of {shared} shared "
          "tokens")
    # a third video aborted after its first chunk
    cached = engine.radix.total_cached_tokens()
    x = video_req("abort", 2, 0)
    engine.add_request(x)
    step()
    check(x.prefill_active and x.prefill_done == bucket,
          f"after one step: prefill_active {x.prefill_active}, "
          f"{x.prefill_done} done")
    check(engine.abort("abort"), "abort refused")
    step()
    mem = engine.check_memory()
    hit = len(engine.radix.match_prefix(x.input_ids)[0])
    text_head = next(i for i, t in enumerate(x.input_ids)
                     if t >= placeholder_base)
    check(done["abort"].finished.value == "abort" and not x.output_ids
          and x.prefill_embeds is None and not x.prefix_locked,
          f"abort: {x.finished} {len(x.output_ids)} tokens")
    check(mem["leaked"] == 0 and engine.radix.total_cached_tokens() == cached
          and hit <= text_head,
          f"abort: {mem}, {engine.radix.total_cached_tokens()} cached "
          f"against {cached}, its prompt hits {hit}")
    decode_ms = engine.t_decode_s / max(engine._steps, 1) * 1e3
    steps = engine._steps
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # the same two videos in one wave
    one = ServeEngine(llm, llm_cfg, EngineConfig(
        prefill_buckets=(CHUNKED_ONE_WAVE,), disable_radix_cache=True,
        **common), embed_fn=mm.embed_fn, device=dev, seed=SEED)
    ref = videos()
    one_wall, one_counts = serve(torch, one, ref, kernels + plains,
                                 CHUNKED_MAX_NEW)
    flips, gap, lp = near_tie({r.rid: r for r in vids},
                              {r.rid: r for r in ref})
    phase("serve-chunked", card=repr(card),
          config="auroracap-7b/w4-stripes/kv-int8/8-lanes/radix",
          kept_ratio=CHUNKED_KEPT_RATIO,
          video=f"{CHUNKED_VIDEO_SHAPE[0]}x{CHUNKED_VIDEO_SHAPE[1]}x"
                f"{CHUNKED_VIDEO_SHAPE[2]}",
          prompt_tokens=",".join(str(len(r.input_ids)) for r in vids),
          max_seq_len=ecfg.max_seq_len, num_slots=ecfg.num_slots,
          buckets="/".join(map(str, ecfg.prefill_buckets)),
          incumbents=CHUNKED_INCUMBENTS, new_tokens=CHUNKED_MAX_NEW,
          chunk_extend_s=",".join(f"{t:.4f}" for t in video_chunks),
          abort_chunk_s=f"{chunk_s[-1]:.4f}",
          admission_embed_s=",".join(f"{t:.4f}" for t in video_vit_s),
          step_ms_with_chunk=",".join(f"{t * 1e3:.3f}" for t in with_chunk),
          step_ms_without_chunk=f"{np.mean(without) * 1e3:.3f}",
          decode_ms_per_step=f"{decode_ms:.3f}", decode_steps=steps,
          wall_s=f"{wall:.2f}", one_wave_wall_s=f"{one_wall:.2f}",
          extend_launches_at_offset=",".join(map(str, chunk_offsets)),
          second_question_cached=f"{q2.n_cached}/{len(q2.input_ids)}",
          abort_check_memory=json.dumps(mem).replace(" ", ""),
          flips=flips, worst_flip_gap=f"{gap:.3e}", near_tie=NEAR_TIE,
          worst_top1_logprob_diff=f"{lp:.3e}",
          launches=json.dumps(counts).replace(" ", ""),
          launches_one_wave=json.dumps(one_counts).replace(" ", ""))
    for c in (counts, one_counts):
        check(all(c[f"{f.__name__}.{a}"] > 0 for f, a in kernels),
              f"serve-chunked: launches {c}")
        check(all(c[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"serve-chunked: plain twins ran: {c}")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def constrained_phase(torch, ra, llm, llm_cfg, dev, card, kernels, plains):
    """[serve-constrained]: AuroraCap-7B's LLM (W4 stripes + int8 KV) at
    EngineConfig's defaults but 16 lanes, ByteTokenizer: the TokenFSM of
    the judge's regex built at V = 32000; 8 requests under it alone (every
    text full-matches, decode steps fewer than half a request's tokens:
    jump-forward); then 8 regex, 4 choice (VDC's five aspects) and 4 free
    requests in one batch (every constrained text inside its constraint;
    the free lanes' tokens equal to their run alone up to a near tie);
    decode ms a step with masks against without; the jump extends."""
    from aurora_tpu_torch.serve import fsm
    from aurora_tpu_torch.serve.constrained import ChoiceConstraint
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    import re
    tok = ByteTokenizer()
    V = llm_cfg.vocab_size
    fsm._FSM_CACHE.clear()
    t0 = time.perf_counter()
    table = fsm.get_token_fsm(JUDGE_REGEX, tok, V)
    build_s = time.perf_counter() - t0
    ecfg = EngineConfig(weight_quant="int4", kv_quant="int8", max_batch=16)
    engine = ServeEngine(llm, llm_cfg, ecfg, tokenizer=tok, device=dev,
                         seed=SEED)
    check(engine.runner.model is llm, "serve-constrained: the model was "
                                      "not served as given")
    decode_ms = {True: [], False: []}
    real_block = engine.runner.decode_block

    def decode_block(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_block(*a, **k)
        decode_ms[a[5] is not None].append((time.perf_counter() - t) * 1e3)
        return out

    engine.runner.decode_block = decode_block
    jumps = {"calls": 0, "extends": 0, "launches": 0}
    extends = offset_extends(engine, *kernels[0])
    real_jump = engine._maybe_jump

    def maybe_jump(req):
        n = len(extends)
        fired = real_jump(req)
        jumps["calls"] += fired
        jumps["extends"] += len(extends) - n
        jumps["launches"] += sum(k for _, k in extends[n:])
        return fired

    engine._maybe_jump = maybe_jump

    def prompt(i, what):
        return tok.encode(f"USER: {what} ({i}) ASSISTANT:")

    def regex_reqs():
        return [Request(rid=f"judge{i}", input_ids=prompt(
            i, "Is the caption right? Answer as a dict."),
            max_new_tokens=CONSTRAINED_MAX_NEW, eos_ids=(2,),
            constraint=fsm.RegexConstraint(JUDGE_REGEX, tok, V,
                                           eos_ids=(2,)))
            for i in range(8)]

    def free_reqs():
        return [Request(rid=f"free{i}", input_ids=prompt(i, VDC_PROMPTS[i]),
                        max_new_tokens=CONSTRAINED_FREE_MAX_NEW,
                        eos_ids=(), logprobs=True) for i in range(4)]

    def drive(reqs):
        for obj, attr in kernels + plains:
            setattr(obj, attr, 0)
        steps, done = engine._steps, {}
        for r in reqs:
            engine.add_request(r)
        while engine.has_work():
            done.update({r.rid: r for r in engine.step()})
        check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} done")
        return done, engine._steps - steps, {
            f"{obj.__name__}.{attr}": getattr(obj, attr)
            for obj, attr in kernels + plains}

    def text(r):
        return tok.decode([t for t in r.output_ids if t != 2])

    # 1. the regex alone: jump-forward
    judged, steps1, counts1 = drive(regex_reqs())
    for r in judged.values():
        check(re.fullmatch(JUDGE_REGEX, text(r)) is not None
              and r.finished.value == "stop", f"{r.rid}: {text(r)!r}")
    fewest = min(len(r.output_ids) for r in judged.values())
    check(steps1 < fewest / 2, f"{steps1} decode steps for outputs of "
                               f"{fewest} tokens or more")
    jumps1 = dict(jumps)
    engine.flush_cache()
    # 2. regex, choices and free lanes in one batch
    masked_before = len(decode_ms[True])
    choice_reqs = [Request(rid=f"aspect{i}", input_ids=prompt(
        i, "Which aspect does this caption describe?"),
        max_new_tokens=CONSTRAINED_MAX_NEW, eos_ids=(2,),
        constraint=ChoiceConstraint.from_strings(tok, ASPECTS))
        for i in range(4)]
    mixed, steps2, counts2 = drive(regex_reqs() + choice_reqs + free_reqs())
    engine.flush_cache()
    for r in mixed.values():
        if r.rid.startswith("judge"):
            check(re.fullmatch(JUDGE_REGEX, text(r)) is not None,
                  f"{r.rid}: {text(r)!r}")
        elif r.rid.startswith("aspect"):
            check(text(r) in ASPECTS, f"{r.rid}: {text(r)!r}")
    # 3. the free lanes alone
    alone, steps3, counts3 = drive(free_reqs())
    flips, gap, lp = near_tie({k: v for k, v in mixed.items()
                               if k.startswith("free")}, alone)
    mem = engine.check_memory()
    phase("serve-constrained", card=repr(card),
          config="auroracap-7b-llm/w4-stripes/kv-int8/16-lanes",
          regex=json.dumps(JUDGE_REGEX), vocab=V,
          token_fsm_build_s=f"{build_s:.3f}",
          dfa_states=table.dfa.trans.shape[0],
          regex_tokens=",".join(str(len(r.output_ids))
                                for r in judged.values()),
          regex_decode_steps=steps1, regex_jumps=jumps1["calls"],
          regex_jump_extends=jumps1["extends"],
          jump_extends=jumps["extends"],
          jump_extend_launches=jumps["launches"],
          mixed_decode_steps=steps2, alone_decode_steps=steps3,
          masked_decode_steps=len(decode_ms[True]) - masked_before,
          decode_ms_masked=f"{np.mean(decode_ms[True]):.3f}",
          decode_ms_unmasked=f"{np.mean(decode_ms[False]):.3f}",
          aspects=",".join(text(mixed[f"aspect{i}"]) for i in range(4)),
          answer0=json.dumps(text(judged["judge0"])),
          free_flips=flips, worst_flip_gap=f"{gap:.3e}", near_tie=NEAR_TIE,
          worst_top1_logprob_diff=f"{lp:.3e}",
          check_memory=json.dumps(mem).replace(" ", ""),
          launches=json.dumps(counts2).replace(" ", ""))
    check(mem["leaked"] == 0, f"serve-constrained: {mem}")
    check(decode_ms[True] and decode_ms[False], "no masked or no unmasked "
                                                "decode step")
    # the regex-only run may decode no step at all: its extends (the
    # jumps' among them) must launch
    f, a = kernels[0]
    check(counts1[f"{f.__name__}.{a}"] > 0, f"serve-constrained: {counts1}")
    for c in (counts2, counts3):
        check(all(c[f"{f.__name__}.{a}"] > 0 for f, a in kernels),
              f"serve-constrained: launches {c}")
    for c in (counts1, counts2, counts3):
        check(all(c[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"serve-constrained: plain twins ran: {c}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts2


def engine_surface_phase(torch, engine_mod, qm, mm, llm, llm_cfg, dev, card,
                         kernels, plains):
    """[serve-kv4grid] and [serve-a8-prefill] (module docstring) → the
    kernels' launches of each run, {run: [counts in `kernels` order]}.
    kernels: the (function, counter) pairs the runs must launch (the int8
    attention kernels and the stripe W4A8, in that order); plains: those
    that must stay 0."""
    from aurora_tpu_torch.serve.engine import (DeviceRunner, EngineConfig,
                                               ServeEngine)
    from aurora_tpu_torch.tools import profile_serve
    size = mm.image_size
    rng = np.random.default_rng(SEED + 11)
    clips = [rng.integers(0, 256, size=(N_FRAMES, size, size, 3),
                          dtype=np.uint8) for _ in range(N_REQUESTS)]
    prompt = " ".join(["<image>"] * N_FRAMES) + "\n" + INFER_PROMPT

    def requests():
        return [mm.build_request(f"s{i}", prompt, c,
                                 max_new_tokens=SURFACE_MAX_NEW, eos_ids=(),
                                 logprobs=True) for i, c in enumerate(clips)]

    for r in requests():        # the ViT outside every run's extend
        mm.prewarm(r)
    P = len(requests()[0].input_ids)
    base = dict(max_batch=N_REQUESTS, kv_chunk=256, prefill_buckets=(1536,),
                decode_steps=16, disable_radix_cache=True,
                max_seq_len=P + SURFACE_MAX_NEW, weight_quant="int4",
                kv_quant="int8")
    runs = (("grid8", {}), ("serve-kv4grid", dict(kv_grid_bits=4)),
            ("serve-a8-prefill", dict(w4_prefill="a8")))
    out, launches = {}, {}
    for run, knob in runs:
        ecfg = EngineConfig(**base, **knob)
        engine = ServeEngine(llm, llm_cfg, ecfg, embed_fn=mm.embed_fn,
                             device=dev, seed=SEED)
        reqs = requests()
        wall, counts = serve(torch, engine, reqs, kernels + plains,
                             SURFACE_MAX_NEW)
        launches[run] = [counts[f"{f.__name__}.{a}"] for f, a in kernels]
        check(all(n > 0 for n in launches[run]), f"{run}: {counts}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"{run}: plain twins ran: {counts}")
        out[run] = dict(
            done={r.rid: r for r in reqs}, wall=wall, counts=counts,
            extend_s=engine.t_extend_s,
            decode_ms=engine.t_decode_s / max(engine._steps, 1) * 1e3)
        if run == "serve-kv4grid":
            # every K/V value written: on the 16-level grid, its ends hit
            rows = engine.runner.rows
            lo = min(int(rows[n].min()) for n in ("k", "v"))
            hi = max(int(rows[n].max()) for n in ("k", "v"))
            out[run]["rows_range"] = (lo, hi)
            check(lo == -7 and hi == 7, f"{run}: KV rows span [{lo}, {hi}]")
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    def report(run):
        o = out[run]
        flips, gap, lp = near_tie(o["done"], out["grid8"]["done"],
                                  strict=False)
        match, dlp = matched_prefix(o["done"], out["grid8"]["done"])
        return dict(
            card=repr(card), requests=N_REQUESTS, prompt_tokens=P,
            new_tokens=SURFACE_MAX_NEW,
            extend_s=f"{o['extend_s']:.4f}",
            extend_s_grid8_bf16_prefill=f"{out['grid8']['extend_s']:.4f}",
            decode_ms_per_step=f"{o['decode_ms']:.3f}",
            decode_ms_per_step_grid8=f"{out['grid8']['decode_ms']:.3f}",
            wall_s=f"{o['wall']:.2f}",
            flips_vs_grid8_bf16_prefill=f"{flips}/{N_REQUESTS}",
            worst_flip_gap=f"{gap:.3e}", near_tie=NEAR_TIE,
            matched_prefix=f"{match:.3f}", mean_abs_dlogprob=f"{dlp:.3e}",
            worst_top1_logprob_diff=f"{lp:.3e}",
            launches=json.dumps(o["counts"]).replace(" ", ""))

    lo, hi = out["serve-kv4grid"]["rows_range"]
    phase("serve-kv4grid", **report("serve-kv4grid"),
          config="auroracap-7b/w4-stripes/kv-int8-rows-at-int4-grid",
          kv_rows_min=lo, kv_rows_max=hi)

    # the A8 branch against the bf16 branch at a 7B layer's four
    # projections, on A8_ROWS random bf16 token rows
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    lp0 = llm.layers[0]
    rel = {}
    for name in ("qkv", "o", "gateup", "down"):
        w = getattr(lp0, name)
        h = torch.randn((A8_ROWS, w.packed.shape[1] * 2), generator=g,
                        device=dev).to(torch.bfloat16)
        ref = engine_mod._w4dot(h, w).double()
        a8 = engine_mod._w4dot(h, w, a8_prefill=True).double()
        rel[name] = ((a8 - ref).norm() / ref.norm()).item()
    check(all(1e-6 < r < A8_REL_TOL for r in rel.values()),
          f"A8 prefill rel L2 {rel}, bound (1e-6, {A8_REL_TOL})")

    # one extend wave of N_REQUESTS × P tokens, each prefill mode on its
    # own rows: timed alternating, then one traced wave each, its device
    # time split by kernel family (tools/profile_serve.py)
    embeds = (0.02 * torch.randn((N_REQUESTS, 1536, llm_cfg.hidden_size),
                                 generator=g, device=dev)).to(torch.bfloat16)
    lanes = np.arange(N_REQUESTS, dtype=np.int32)
    zeros = np.zeros(N_REQUESTS, np.int32)
    lens = np.full(N_REQUESTS, P, np.int32)
    runners = {m: DeviceRunner(llm, llm_cfg, EngineConfig(
        **base, w4_prefill=m), dev, SEED) for m in ("bf16", "a8")}

    def wave(m):
        return runners[m].extend(embeds, lanes, zeros, lens).cpu()

    logits = {m: wave(m) for m in runners}          # warm both
    wave_s = {m: [] for m in runners}
    for _ in range(SURFACE_WAVE_REPS):
        for m in ("bf16", "a8", "a8", "bf16"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            wave(m)
            wave_s[m].append(time.perf_counter() - t)
    split = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "profile_a8")
    os.makedirs(trace_dir, exist_ok=True)
    for m in runners:
        _, evs = profile_serve.trace_device(
            lambda: wave(m), os.path.join(trace_dir, f"extend_{m}.json"),
            torch.cuda.synchronize, acts)
        fam = profile_serve.family_ms(evs, 1)
        dense = profile_serve.matmul_ms(evs, 1)
        split[m] = {"device": sum(d for _, _, d in evs) / 1e3,
                    "attention": fam["attention"], "dense_matmul": dense,
                    "rest": fam["other"] - dense}
    lg = {m: logits[m].float() for m in logits}
    logit_rel = ((lg["a8"] - lg["bf16"]).norm() / lg["bf16"].norm()).item()
    del runners, logits, embeds
    gc.collect()
    torch.cuda.empty_cache()
    med = {m: float(np.median(v)) for m, v in wave_s.items()}
    phase("serve-a8-prefill", **report("serve-a8-prefill"),
          config="auroracap-7b/w4-stripes/kv-int8/a8-prefill",
          w4dot_rel_l2=",".join(f"{k}:{v:.3e}" for k, v in rel.items()),
          tol=f"(1e-6,{A8_REL_TOL})",
          wave=f"{N_REQUESTS}x{P}/bucket-1536",
          wave_ms_bf16=f"{med['bf16'] * 1e3:.1f}",
          wave_ms_a8=f"{med['a8'] * 1e3:.1f}",
          wave_logits_rel_l2_a8_vs_bf16=f"{logit_rel:.3e}",
          **{f"wave_device_ms_{m}_{k}": f"{v:.2f}"
             for m, d in split.items() for k, v in d.items()})
    return launches


def random_module(torch, module, g, dtype, model_init=False):
    """`module`, built on the meta device, with each tensor of its state
    dict drawn N(0, 0.02²) from `g` on g's device in `dtype`, in state-dict
    order; model_init: norm scales one and biases zero instead, as
    models/init.py draws a model → the module."""
    sd = {}
    for name, t in module.state_dict().items():
        norm = t.dim() == 1 and ("norm" in name or ".ln" in name)
        if model_init and name.endswith("bias"):
            x = torch.zeros(t.shape, dtype=dtype, device=g.device)
        elif model_init and norm:
            x = torch.ones(t.shape, dtype=dtype, device=g.device)
        else:
            x = (torch.randn(t.shape, generator=g, device=g.device)
                 * 0.02).to(dtype)
        sd[name] = x
    module.load_state_dict(sd, assign=True)
    return module


def write_llm_dir(torch, root, cfg, g, max_shard_bytes=5 * 1024 ** 3,
                  model_init=False):
    """A HF llama directory written by models/export.py (the LLM drawn by
    `random_module` in bf16, `llama_state_dict`, `llama_config_dict`,
    `_write`) → (the model, bytes)."""
    from aurora_tpu_torch.models import export
    from aurora_tpu_torch.models.llama import LlamaModel
    llm = random_module(torch, LlamaModel(cfg, device="meta"), g,
                        torch.bfloat16, model_init)
    return llm, export._write(export.llama_state_dict(llm, cfg,
                                                      torch.bfloat16),
                              export.llama_config_dict(cfg), root,
                              max_shard_bytes)


def write_xtuner_dir(torch, root, llm_cfg, vit_cfg, g, model_init=False):
    """An xtuner-format directory under `root`, written by models/export.py:
    the LLM in two bf16 safetensors shards and their index
    (`write_llm_dir`), the vision tower (CLIP or SigLIP names,
    `vit_state_dict`) in one fp16 file, the projector
    (`projector_state_dict`) as an fp32 torch.save .bin, each with its
    config.json. Weights from `g` by `random_module` (model_init: norm
    scales one, biases zero). → ({part: {the port's name: the tensor as
    written}}, bytes)."""
    from aurora_tpu_torch.models import export
    from aurora_tpu_torch.models.llama import LlamaModel
    from aurora_tpu_torch.models.projector import Projector, ProjectorConfig
    from aurora_tpu_torch.models.vit import VisionTransformer
    shutil.rmtree(root, ignore_errors=True)
    want = {}       # part → {the port's name: the tensor as written}
    # the LLM: bf16, half the bytes plus the largest tensor a shard:
    # exactly two shards
    sizes = [t.numel() * 2 for t in LlamaModel(llm_cfg, device="meta")
             .state_dict().values()]
    llm, nbytes = write_llm_dir(torch, root, llm_cfg, g,
                                sum(sizes) // 2 + max(sizes), model_init)
    check(os.path.exists(os.path.join(root, "model-00002-of-00002."
                                            "safetensors")),
          "the LLM is not in two shards")
    want["llm"] = llm.state_dict()
    # the vision tower: fp16, one file
    vit = random_module(torch, VisionTransformer(vit_cfg, device="meta"), g,
                        torch.float16, model_init)
    want["vit"] = vit.state_dict()
    nbytes += export._write(
        export.vit_state_dict(vit, vit_cfg, torch.float16),
        export.vit_config_dict(vit_cfg), os.path.join(root, "visual_encoder"))
    # the projector: fp32, torch.save
    pj_cfg = ProjectorConfig(visual_hidden_size=vit_cfg.hidden_size,
                             llm_hidden_size=llm_cfg.hidden_size)
    pj = random_module(torch, Projector(pj_cfg, device="meta"), g,
                       torch.float32, model_init)
    want["pj"] = pj.state_dict()
    pj_dir = os.path.join(root, "projector")
    os.makedirs(pj_dir)
    torch.save(export.projector_state_dict(pj),
               os.path.join(pj_dir, "pytorch_model.bin"))
    nbytes += os.path.getsize(os.path.join(pj_dir, "pytorch_model.bin"))
    with open(os.path.join(pj_dir, "config.json"), "w") as f:
        json.dump(export.projector_config_dict(pj_cfg), f)
    return want, nbytes


def infer_load_phase(torch, dev, card):
    """[infer-load]: an xtuner-format directory at AuroraCap-7B's widths
    (the LLM cut to INFER_LOAD_LAYERS layers) written by this script, read
    by the port's load_auroracap_dir onto the card in bf16; every tensor
    must equal the written one after the same cast, bit for bit. → the
    directory, which [eval] reads and then deletes."""
    import dataclasses
    from aurora_tpu_torch.models.convert import load_auroracap_dir
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.models.vit import ViTConfig
    llm_cfg = dataclasses.replace(LlamaConfig.vicuna_7b_v15_16k(),
                                  num_hidden_layers=INFER_LOAD_LAYERS)
    vit_cfg = ViTConfig.dfn5b_vit_h_378()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "infer_load")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    t0 = time.perf_counter()
    want, nbytes = write_xtuner_dir(torch, root, llm_cfg, vit_cfg, g)
    write_s = time.perf_counter() - t0
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
    return root


def eval_phase(torch, ra, root, dev, card, plains):
    """[eval] (module docstring): AuroraCapEval from [infer-load]'s
    xtuner directory on the card, simple_evaluate over VDC's five subsets
    on synthetic videos through generate_batch, then VDCScore
    (post_eval.score_captions) against the port's HTTP server in a
    thread serving the same LLM. The directory holds no tokenizer files:
    ByteTokenizer stands in for AutoTokenizer."""
    import dataclasses
    import tempfile
    from aurora_tpu_torch.cli import infer as infer_mod
    from aurora_tpu_torch.eval import api as eval_api
    from aurora_tpu_torch.eval import post_eval
    from aurora_tpu_torch.eval.evaluator import simple_evaluate
    from aurora_tpu_torch.eval.judge import JudgeClient
    from aurora_tpu_torch.eval.models import AuroraCapEval
    from aurora_tpu_torch.eval.tasks.vdc import SUBSETS
    from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine

    class CountingJudge(JudgeClient):
        """JudgeClient counting its chat calls and its parsed scores."""
        calls = parsed = 0

        def chat(self, *a, **k):
            self.calls += 1
            return super().chat(*a, **k)

        def score_qa(self, *a):
            out = super().score_qa(*a)
            self.parsed += 1
            return out

    tok = ByteTokenizer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(infer_mod, "auto_tokenizer",
                           lambda *a, **k: tok):
        ev = AuroraCapEval(root, token_merge_ratio=EVAL_KEPT_RATIO,
                           num_frames=N_FRAMES, max_new_tokens=EVAL_MAX_NEW)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(ev.model.llm.embed_tokens.device == dev, "AuroraCapEval not on "
                                                   "the card")
    counters = [(ra.ragged_attention, "launches"),
                (ra.ragged_decode_attention, "launches")]
    tasks = [f"vdc_{s}_test" for s in SUBSETS]
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_videos(tmp, EVAL_VIDEOS, shape=CHUNKED_VIDEO_SHAPE,
                             seed=SEED + 13)
        names = [os.path.basename(p)[:-4] for p in paths]
        for subset, name in zip(SUBSETS, tasks):
            path = os.path.join(tmp, f"{subset}.jsonl")
            with open(path, "w") as f:
                for n in names:
                    f.write(json.dumps({"video_name": n, "caption": "c",
                                        "qa_list": list(EVAL_QA),
                                        "_root": tmp}) + "\n")
            # the built-in task (its hooks as registered) on these docs
            eval_api.register_task(dataclasses.replace(
                eval_api.get_task(name).cfg, dataset_path=path,
                generation_kwargs={"max_new_tokens": EVAL_MAX_NEW,
                                   "temperature": 0.0}))
        for obj, attr in counters + plains:
            setattr(obj, attr, 0)
        out_dir = os.path.join(tmp, "results")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simple_evaluate(ev, tasks, log_samples=True,
                              output_dir=out_dir)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        counts = {f"{o.__name__}.{a}": getattr(o, a)
                  for o, a in counters + plains}
        wrote = os.path.exists(os.path.join(out_dir, "results.json"))
    preds = [s_["pred"] for t in tasks for s_ in res["samples"][t]]
    n_docs = len(preds)
    check(wrote, "results.json not written")
    check(n_docs == EVAL_VIDEOS * len(tasks), f"{n_docs} predictions")
    check(all(isinstance(p_, str) and p_ for p_ in preds),
          "an empty or non-string prediction")
    check(all(counts[f"{o.__name__}.{a}"] > 0 for o, a in counters),
          f"eval launches {counts}")
    check(all(counts[f"{o.__name__}.{a}"] == 0 for o, a in plains),
          f"eval: plain twins ran: {counts}")

    # VDCScore of one subset's captions, the judge over HTTP
    for obj, attr in counters:
        setattr(obj, attr, 0)
    # the serve CLI's --max-seq-len (a judge prompt is ~2k ByteTokenizer ids)
    engine = ServeEngine(ev.model.llm, ev.cfg.llm, EngineConfig(
        max_seq_len=4096, kv_dtype=ev.model.llm.embed_tokens.dtype),
        device=dev, tokenizer=tok)
    captions = [{"video_name": n, "pred": s_["pred"]} for n, s_ in
                zip(names, res["samples"]["vdc_detailed_test"])]
    gt = [{"video_name": n, "qa_list": list(EVAL_QA)} for n in names]
    with ServerThread(ServingLoop(engine, tok)) as srv:
        judge = CountingJudge(srv.url, max_tokens=JUDGE_MAX_TOKENS)
        t0 = time.perf_counter()
        scores = post_eval.score_captions(captions, gt, judge)
        judge_s = time.perf_counter() - t0
    judge_counts = {f"{o.__name__}.{a}": getattr(o, a) for o, a in counters}
    phase("eval", card=repr(card),
          config="auroracap-7b-widths/llm-2-layers/bf16",
          tasks=",".join(tasks), videos=EVAL_VIDEOS,
          video="x".join(map(str, CHUNKED_VIDEO_SHAPE)),
          kept_ratio=EVAL_KEPT_RATIO, new_tokens=EVAL_MAX_NEW,
          load_s=f"{load_s:.2f}", docs=n_docs, eval_s=f"{eval_s:.2f}",
          docs_per_s=f"{n_docs / eval_s:.3f}",
          launches=json.dumps(counts).replace(" ", ""),
          judge_calls=judge.calls, judge_s=f"{judge_s:.2f}",
          judge_answers_per_s=f"{judge.calls / judge_s:.3f}",
          judge_parsed=f"{judge.parsed}/{len(captions) * len(EVAL_QA)}",
          judge_max_tokens=JUDGE_MAX_TOKENS, vdcscore_n=scores["n"],
          vdcscore_acc=f"{scores['acc']:.1f}",
          vdcscore_score=f"{scores['score']:.3f}",
          judge_launches=json.dumps(judge_counts).replace(" ", ""))
    check(scores["n"] == EVAL_VIDEOS, f"score_captions n={scores['n']}")
    check(all(judge_counts[f"{o.__name__}.{a}"] > 0 for o, a in counters),
          f"judge launches {judge_counts}")
    del engine, ev
    gc.collect()
    torch.cuda.empty_cache()
    return [counts[f"{o.__name__}.{a}"] + judge_counts[f"{o.__name__}.{a}"]
            for o, a in counters]


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
    return prompts, first


def http_call(url, method, path, body=None, timeout=600):
    """One request to a server at `url` → (status, the JSON answer)."""
    import http.client
    import urllib.parse
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def http_stream(url, path, body, timeout=600):
    """One streamed request → (its deltas joined, seconds to the first
    chunk, seconds to the end)."""
    import http.client
    import urllib.parse
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            check(False, f"{path} streamed: {r.status} {r.read()}")
        text, first = "", None
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if first is None:
                first = time.perf_counter() - t0
            if line == "data: [DONE]":
                break
            e = json.loads(line[6:])
            check("error" not in e, f"{path} streamed: {e}")
            c = e["choices"][0] if "choices" in e else e
            text += c["delta"]["content"] if "delta" in c else c["text"]
        return text, first, time.perf_counter() - t0
    finally:
        conn.close()


def http_phase(torch, llm, llm_cfg, mm, dev, card, kernels, plains,
               runtime_prompts, runtime_first):
    """[serve-http]: the port's HTTP server (serve/api.py, in a thread on
    127.0.0.1) over the W4-stripe + int8-KV engine at EngineConfig's
    defaults, AuroraCap's ViT behind /generate's videos, ByteTokenizer:
    cli/bench_serving's load; [runtime]'s prompts through /v1/completions,
    each equal to Runtime's tokens up to a near tie; a streamed chat equal
    to the same chat sent alone; a video and a second question on it,
    which hits its prefix; an abort in mid-decode; the decode step's wall
    with 8 chats plain and with the same 8 streamed beside two videos'
    ViT (the GIL's cost); the ops endpoints; /v1/embeddings refused on
    W4; a prompt of 3,000 tokens, past the largest bucket (chunked
    prefill); /generate under the judge's regex, a chat under choices, a
    bad pattern (400); a lang.py judge program (a gen under the regex, a
    yes/no select) through RuntimeEndpoint, run_batch of 8. The engine
    takes the serve CLI's max_seq_len, 4096. The int8 attention and W4A8
    kernels launch, no plain twin does."""
    import re
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from aurora_tpu_torch import lang
    from aurora_tpu_torch.cli import bench_serving
    from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    tok = ByteTokenizer()
    engine = ServeEngine(llm, llm_cfg, EngineConfig(weight_quant="int4",
                                                    kv_quant="int8",
                                                    max_seq_len=4096),
                         embed_fn=mm.embed_fn, tokenizer=tok)
    check(engine.runner.model is llm, "serve-http: the model was not "
                                      "served as given")
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "serve_http")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    videos = write_videos(tmp, 5)
    for obj, attr in kernels + plains:
        setattr(obj, attr, 0)
    out = {}
    t_phase = time.perf_counter()

    def decode_ms(fn):
        """fn() → (its result, the engine's decode ms a step meanwhile)."""
        s0, d0 = engine._steps, engine.t_decode_s
        res = fn()
        return res, (engine.t_decode_s - d0) / max(engine._steps - s0,
                                                   1) * 1e3

    srv = ServerThread(ServingLoop(engine, tok, mm=mm), "auroracap").start()
    url = srv.url
    try:
        # 1. load, through cli/bench_serving's client
        load, out["load_decode_ms_per_step"] = decode_ms(
            lambda: bench_serving.run(url, **HTTP_LOAD))
        check(load["ok"] == HTTP_LOAD["num_requests"], f"load: {load}")
        # 2. [runtime]'s prompts, all at once, against Runtime's tokens
        with ThreadPoolExecutor(len(runtime_prompts)) as pool:
            comps = list(pool.map(lambda p: http_call(
                url, "POST", "/v1/completions",
                {"prompt": p, "max_tokens": RUNTIME_MAX_NEW,
                 "temperature": 0.0, "logprobs": 5}), runtime_prompts))
        equal, flips, worst_gap = 0, 0, 0.0
        for i, ((status, body), want) in enumerate(zip(comps,
                                                       runtime_first)):
            check(status == 200, f"completion {i}: {status} {body}")
            lp = body["choices"][0]["logprobs"]
            got = [tok.id_of(t) for t in lp["tokens"]]
            want = [t if t > 2 else tok.eos_token_id
                    for t in want["output_ids"]]
            if got == want:
                equal += 1
                continue
            j = next((k for k, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            top = sorted(lp["top_logprobs"][min(j, len(got) - 1)].values(),
                         reverse=True)
            gap = top[0] - top[1] if len(top) > 1 else float("inf")
            check(gap < NEAR_TIE, f"completion {i}: token {j} is not "
                                  f"Runtime's, on a top-2 gap of {gap}")
            flips += 1
            worst_gap = max(worst_gap, gap)
        out.update(runtime_equal=f"{equal}/{len(comps)}", flips=flips,
                   worst_flip_gap=f"{worst_gap:.3e}", near_tie=NEAR_TIE)
        # 3. a streamed chat against the same chat alone (each from an
        # empty cache, so that both extend the whole prompt)
        chat = {"messages": [{"role": "user", "content": VDC_PROMPTS[2]}],
                "max_tokens": HTTP_MAX_NEW, "temperature": 0.0}
        http_call(url, "POST", "/flush_cache", {})
        status, plain = http_call(url, "POST", "/v1/chat/completions", chat)
        check(status == 200, f"chat: {status} {plain}")
        http_call(url, "POST", "/flush_cache", {})
        text, ttfc, stream_s = http_stream(url, "/v1/chat/completions", chat)
        check(text == plain["choices"][0]["message"]["content"],
              f"streamed chat {text!r} != {plain}")
        out.update(stream_chars=len(text), stream_first_chunk_s=f"{ttfc:.4f}",
                   stream_s=f"{stream_s:.3f}")
        # 4. a video, then a second question on it: its prefix is cached
        http_call(url, "POST", "/flush_cache", {})
        cached = []
        for q in (0, 2):
            status, v = http_call(url, "POST", "/generate", {
                "video_path": videos[0], "num_frames": N_FRAMES,
                "text": VDC_PROMPTS[q], "max_new_tokens": HTTP_MAX_NEW,
                "temperature": 0.0})
            check(status == 200 and v["output_ids"], f"video: {v}")
            cached.append((v["meta_info"]["prompt_tokens"], http_call(
                url, "GET", "/get_model_info")[1]["memory"]["cached"]))
        (p1, c1), (p2, c2) = cached
        n_vis = N_FRAMES * mm.n_visual_tokens()
        check(c1 >= p1 > n_vis, f"video 1: {p1} prompt tokens, {c1} cached")
        check(c2 - c1 <= p2 - n_vis, f"video 2 cached {c2 - c1} of its {p2} "
                                     "prompt tokens anew: no prefix hit")
        out.update(video_prompt_tokens=f"{p1},{p2}",
                   video_cached=f"{c1},{c2}")
        # 5. an abort in mid-decode
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(http_call, url, "POST", "/generate", {
                "text": f"USER: {INFER_PROMPT} ASSISTANT:",
                "max_new_tokens": HTTP_ABORT_MAX_NEW, "temperature": 0.0,
                "rid": "long"})
            for _ in range(6000):
                if http_call(url, "GET", "/decode_stats")[1]["running"]:
                    break
                time.sleep(0.005)
            time.sleep(0.2)
            aborted = http_call(url, "POST", "/abort_request",
                                {"rid": "long"})
            status, long = fut.result(timeout=600)
        n_long = long["meta_info"]["completion_tokens"]
        check(aborted == (200, {"aborted": True}) and status == 200
              and long["meta_info"]["finish_reason"] == "abort"
              and n_long < HTTP_ABORT_MAX_NEW, f"abort: {aborted} {long}")
        out["aborted_after_tokens"] = n_long

        # 6. the GIL: 8 chats sent plain, then the same 8 streamed with two
        # new clips' requests (1 token each) sent once all 8 decode, so
        # that their read, resize and ViT run in the server's worker
        # threads beside the 8-lane decode; twice each, in turns
        chats = [{"messages": [{"role": "user",
                                "content": f"{VDC_PROMPTS[i % 5]} ({i})"}],
                  "max_tokens": HTTP_MAX_NEW, "temperature": 0.0}
                 for i in range(HTTP_LANES)]

        def lanes(streamed, clips=()):
            send = ((lambda c: http_stream(url, "/v1/chat/completions", c))
                    if streamed else
                    (lambda c: http_call(url, "POST", "/v1/chat/completions",
                                         c)))
            with ThreadPoolExecutor(HTTP_LANES + len(clips)) as pool:
                futs = [pool.submit(send, c) for c in chats]
                for _ in range(6000 if clips else 0):
                    if http_call(url, "GET", "/decode_stats")[1][
                            "running"] == HTTP_LANES:
                        break
                    time.sleep(0.005)
                vids = [pool.submit(http_call, url, "POST", "/generate", {
                    "video_path": v, "num_frames": N_FRAMES,
                    "text": VDC_PROMPTS[1], "max_new_tokens": 1})
                    for v in clips]
                res = [f.result() for f in futs + vids]
            check(streamed or all(r[0] == 200 for r in res),
                  f"plain chats: {res}")
            check(all(r[0] == 200 for r in res[HTTP_LANES:]),
                  f"videos beside streams: {res[HTTP_LANES:]}")

        gil = []
        for streamed, clips in ((False, ()), (True, videos[1:3]),
                                (True, videos[3:5]), (False, ())):
            http_call(url, "POST", "/flush_cache", {})
            gil.append(decode_ms(lambda: lanes(streamed, clips))[1])
        out["plain_decode_ms_per_step"] = f"{gil[0]:.3f},{gil[3]:.3f}"
        out["streams_videos_decode_ms_per_step"] = f"{gil[1]:.3f},{gil[2]:.3f}"
        # 7. the ops endpoints, and the offline forward refused on W4
        for method, path in (("POST", "/flush_cache"), ("GET", "/health"),
                             ("GET", "/v1/models"),
                             ("GET", "/get_model_info"),
                             ("GET", "/decode_stats")):
            status, body = http_call(url, method, path,
                                     {} if method == "POST" else None)
            check(status == 200, f"{path}: {status} {body}")
        status, body = http_call(url, "POST", "/v1/embeddings",
                                 {"input": "hello"})
        check(status == 400, f"/v1/embeddings on W4: {status} {body}")
        # 8. a prompt past the largest bucket: prefilled in chunks
        long_text = (" ".join(VDC_PROMPTS) * 8)[:HTTP_LONG_PROMPT - 1]
        t0 = time.perf_counter()
        status, body = http_call(url, "POST", "/generate", {
            "text": long_text, "max_new_tokens": 16, "temperature": 0.0})
        check(status == 200 and body["meta_info"]["prompt_tokens"]
              == HTTP_LONG_PROMPT and body["output_ids"],
              f"long prompt: {status} {body}")
        out.update(long_prompt_tokens=body["meta_info"]["prompt_tokens"],
                   long_prompt_s=f"{time.perf_counter() - t0:.3f}")
        # 9. constrained: a regex, choices, a bad pattern
        status, body = http_call(url, "POST", "/generate", {
            "text": "USER: Is the caption right? ASSISTANT:",
            "max_new_tokens": 48, "temperature": 0.0, "regex": JUDGE_REGEX})
        check(status == 200 and re.fullmatch(JUDGE_REGEX, body["text"]),
              f"regex /generate: {status} {body}")
        out["regex_answer"] = json.dumps(body["text"])
        status, body = http_call(url, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Which aspect?"}],
            "max_tokens": 16, "temperature": 0.0,
            "choices_constraint": list(ASPECTS)})
        check(status == 200 and body["choices"][0]["message"]["content"]
              in ASPECTS, f"choices chat: {status} {body}")
        out["choice_answer"] = body["choices"][0]["message"]["content"]
        status, body = http_call(url, "POST", "/generate", {
            "text": "x", "max_new_tokens": 4, "regex": "a{99999}"})
        check(status == 400, f"bad pattern: {status} {body}")
        # 10. a lang.py judge program, 8 at once

        @lang.function
        def judge(s, caption):
            s += lang.user(f"Caption: {caption}. Is it right?")
            s += lang.assistant(lang.gen("verdict", max_tokens=48,
                                         regex=JUDGE_REGEX))
            s += lang.user("Are you sure?")
            s += lang.assistant(lang.select("sure", ["yes", "no"]))

        t0 = time.perf_counter()
        states = judge.run_batch(
            [{"caption": VDC_PROMPTS[i % len(VDC_PROMPTS)][:60]}
             for i in range(8)], backend=lang.RuntimeEndpoint(url),
            num_threads=8)
        for st in states:
            check(re.fullmatch(JUDGE_REGEX, st["verdict"])
                  and st["sure"] in ("yes", "no"), f"lang: {st.captured}")
        out.update(lang_programs=len(states),
                   lang_s=f"{time.perf_counter() - t0:.3f}",
                   lang_sure=",".join(st["sure"] for st in states))
    finally:
        srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in kernels + plains}
    phase("serve-http", card=repr(card),
          config="auroracap-7b-llm/w4-stripes/kv-int8/engine-defaults/"
                 "max-seq-4096",
          seconds=f"{time.perf_counter() - t_phase:.1f}",
          requests=load["num_requests"], concurrency=load["concurrency"],
          max_tokens=HTTP_LOAD["max_tokens"], wall_s=load["wall_s"],
          requests_per_s=load["requests_per_s"],
          output_tokens_per_s=load["output_tokens_per_s"],
          p50_s=load["latency_s"]["p50"], p90_s=load["latency_s"]["p90"],
          p99_s=load["latency_s"]["p99"],
          **{k: (f"{v:.3f}" if isinstance(v, float) else v)
             for k, v in out.items()},
          launches=json.dumps(counts).replace(" ", ""))
    check(all(counts[f"{f.__name__}.{a}"] > 0 for f, a in kernels),
          f"serve-http: launches {counts}")
    check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
          f"serve-http: plain twins ran: {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def http_update_phase(torch, dev, card, plains):
    """[serve-http-update]: /update_weights on a second, short-lived server
    (W4 stripes + int8 KV at EngineConfig's defaults) at Vicuna-7B widths
    and HTTP_UPDATE_LAYERS layers, from two HF directories of bf16
    safetensors written here: the swap answers 200 and gives other
    tokens, every live tensor keeps its address, a missing directory
    answers 400 and leaves the tokens as they were, and the tokens equal
    those of an engine built fresh from the second directory."""
    import dataclasses
    import shutil
    from aurora_tpu_torch.models.convert import (llama_params_from_hf,
                                                 load_torch_state_dict)
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    cfg = dataclasses.replace(LlamaConfig.vicuna_7b_v15_16k(),
                              num_hidden_layers=HTTP_UPDATE_LAYERS)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "serve_http_update")
    shutil.rmtree(root, ignore_errors=True)
    dirs, nbytes = [], 0
    t_phase = t0 = time.perf_counter()
    for k in range(2):
        g = torch.Generator(device=dev).manual_seed(SEED + 20 + k)
        dirs.append(os.path.join(root, f"w{k}"))
        nbytes += write_llm_dir(torch, dirs[-1], cfg, g, model_init=True)[1]
    write_s = time.perf_counter() - t0

    def load(d):
        return llama_params_from_hf(load_torch_state_dict(d), cfg,
                                    torch.bfloat16, dev)

    tok = ByteTokenizer()
    ecfg = EngineConfig(weight_quant="int4", kv_quant="int8")
    engine = ServeEngine(load(dirs[0]), cfg, ecfg, tokenizer=tok)
    live = engine.runner.model.state_dict()
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    q = {"text": f"USER: {INFER_PROMPT} ASSISTANT:",
         "max_new_tokens": HTTP_UPDATE_MAX_NEW, "temperature": 0.0}
    for obj, attr in plains:
        setattr(obj, attr, 0)
    srv = ServerThread(ServingLoop(engine, tok)).start()
    url = srv.url
    try:
        def ids():
            status, body = http_call(url, "POST", "/generate", q)
            check(status == 200, f"generate: {status} {body}")
            return body["output_ids"]

        before = ids()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status, up = http_call(url, "POST", "/update_weights",
                               {"model_dir": dirs[1]})
        update_s = time.perf_counter() - t0
        check(status == 200 and up["success"], f"update: {status} {up}")
        after = ids()
        check(after != before, "the swap left the tokens as they were")
        status, miss = http_call(url, "POST", "/update_weights",
                                 {"model_dir": os.path.join(root, "nope")})
        check(status == 400 and miss["success"] is False,
              f"missing directory: {status} {miss}")
        http_call(url, "POST", "/flush_cache", {})
        check(ids() == after, "a refused update changed the tokens")
    finally:
        srv.stop()
    moved = sum(t.data_ptr() != ptrs[k] for k, t in
                engine.runner.model.state_dict().items())
    check(moved == 0, f"{moved} live tensors moved")
    del engine, live
    gc.collect()
    fresh = ServeEngine(load(dirs[1]), cfg, ecfg, tokenizer=tok)
    fresh.add_request(Request(rid="fresh", input_ids=tok.encode(q["text"]),
                              max_new_tokens=HTTP_UPDATE_MAX_NEW,
                              eos_ids=(tok.eos_token_id,)))
    done = []
    while fresh.has_work():
        done += fresh.step()
    check(done[0].output_ids == after, "the swapped server's tokens are "
                                       "not a fresh engine's")
    counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
              for obj, attr in plains}
    check(all(v == 0 for v in counts.values()),
          f"serve-http-update: plain twins ran: {counts}")
    phase("serve-http-update", card=repr(card),
          config=f"vicuna-7b-widths/{HTTP_UPDATE_LAYERS}-layers/w4-stripes/"
                 "kv-int8", seconds=f"{time.perf_counter() - t_phase:.1f}",
          dir_bytes=nbytes // 2,
          write_s=f"{write_s:.2f}", update_s=f"{update_s:.3f}",
          tensors=len(ptrs), moved=moved, tokens=len(after),
          equal_fresh=True, missing_dir_status=400)
    del fresh
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def write_png(path, rgb):
    """[H, W, 3] uint8 → an 8-bit RGB PNG: rows Sub-filtered but for every
    60th row from row 3 on, which takes Average, Paeth, None and Up in
    turn, so that the reader meets all five filters."""
    import struct
    import zlib
    h, w, c = rgb.shape
    raw = rgb.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), raw[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), raw[:, :-c]])
    ul = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(raw), left, up, (left + up) // 2, paeth])
    ftype = np.ones(h, np.int64)
    for k, f in enumerate((3, 4, 0, 2)):
        ftype[3 + k::60] = f
    filt = ((raw - preds[ftype, np.arange(h)]) % 256).astype(np.uint8)
    body = np.hstack([ftype[:, None].astype(np.uint8), filt]).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body, 1)) + chunk(b"IEND", b""))


def write_train_data(root):
    """[train-cli*]'s data under `root`: TRAIN_CLI_IMAGES synthetic PNGs
    (smooth color fields with a little noise, from a seeded stream) and
    three llava-format jsons: one image a record with short captions
    (pretrain, QLoRA), TRAIN_CLI_VISION_FRAMES images a record (vision),
    one image a record with long captions (language, packed) → paths."""
    rng = np.random.default_rng(SEED + 14)
    imgs = os.path.join(root, "images")
    os.makedirs(imgs)
    h, w, _ = TRAIN_CLI_IMAGE_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(TRAIN_CLI_IMAGES):
        ph = rng.uniform(0, 6.3, size=3)
        sc = rng.uniform(20, 90, size=3)
        img = np.stack([127 + 110 * np.sin(xx / sc[k] + ph[k])
                        * np.cos(yy / sc[(k + 1) % 3]) for k in range(3)], -1)
        img += rng.normal(0, 3, size=img.shape)
        write_png(os.path.join(imgs, f"img{i}.png"),
                  np.clip(np.round(img), 0, 255).astype(np.uint8))
    words = ("a", "red", "car", "moves", "slowly", "past", "the", "old",
             "bridge", "while", "two", "people", "watch", "from", "river",
             "bank", "under", "grey", "sky", "camera", "pans", "left")

    def caption(n):
        return " ".join(rng.choice(words, size=n)) + "."

    def record(images, n_words):
        marks = " ".join(["<image>"] * len(images))
        return {"image": images if len(images) > 1 else images[0],
                "conversations": [
                    {"from": "human", "value": marks + "\nDescribe it."},
                    {"from": "gpt", "value": caption(n_words)}]}

    def img(i):
        return f"img{i % TRAIN_CLI_IMAGES}.png"

    sets = {
        "pretrain": [record([img(i)], 40)
                     for i in range(TRAIN_CLI_STEPS * TRAIN_CLI_BATCH)],
        "vision": [record([img(i * TRAIN_CLI_VISION_FRAMES + k) for k in
                           range(TRAIN_CLI_VISION_FRAMES)], 40)
                   for i in range(TRAIN_CLI_VISION_STEPS)],
        "language": [record([img(i)], 130) for i in range(72)]}
    paths = {"images": imgs}
    for name, recs in sets.items():
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(recs, f)
    return paths


def train_cli_phases(torch, model_dir, dev, card, counters, plains):
    """[train-cli], [train-cli-vision], [train-cli-packed] and
    [train-cli-qlora] (module docstring): cli/train.run in-process over
    [infer-load]'s directory → the flash kernels' launches over the four
    (0: every step is masked, so attention runs mha_reference, as in the
    reference)."""
    from aurora_tpu_torch.cli import infer as infer_mod
    from aurora_tpu_torch.cli import train as train_cli
    from aurora_tpu_torch.cli.cfg_tools import copy_cfg
    from aurora_tpu_torch.data.collate import (SoftPackerMM,
                                               default_collate_fn,
                                               packed_collate_mm)
    from aurora_tpu_torch.data.dataset import AuroraDataset
    from aurora_tpu_torch.models.aurora import (aurora_forward,
                                                num_visual_tokens)
    from aurora_tpu_torch.train.quant import quantize_base
    from aurora_tpu_torch.train.trainer import repeatable_step
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    data = write_train_data(root)
    write_s = time.perf_counter() - t0
    tok = ByteTokenizer()
    launches = {f"{o.__name__}.{a}": 0 for o, a in counters}
    no_tok = mock.patch.object(infer_mod, "auto_tokenizer",
                               lambda *a, **k: tok)

    def run_cli(name, *argv):
        work = os.path.join(root, name)
        for obj, attr in counters + plains:
            setattr(obj, attr, 0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with no_tok:
            t = time.perf_counter()
            res = train_cli.run(train_cli.parse_args([
                "--model_path", model_dir, "--image_folder",
                data["images"], "--work_dir", work, "--log_interval", "1",
                "--device", str(dev), *argv]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = {f"{o.__name__}.{a}": getattr(o, a)
                  for o, a in counters + plains}
        check(all(v == 0 for v in counts.values()),
              f"{name}: flash launched or a plain twin ran: {counts}")
        for k in launches:
            launches[k] += counts[k]
        timed = res.history[1:] or res.history
        fields = dict(
            card=repr(card), steps=len(res.history),
            step_ms=f"{np.median([h['step_s'] for h in timed]) * 1e3:.1f}",
            tgs=f"{np.median([h['tgs'] for h in timed]):.1f}",
            tflops=f"{np.median([h['tflops'] for h in timed]):.2f}",
            data_wait_ms=f"{np.mean([h['data_s'] for h in timed]) * 1e3:.2f}",
            first_step_ms=f"{res.history[0]['step_s'] * 1e3:.1f}",
            loss=f"{res.history[-1]['loss']:.5f}", wall_s=f"{wall:.1f}",
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            ckpt=",".join(f"{c['step']}:{c['gb']:.3f}GB/{c['s']:.2f}s"
                          for c in res.saves),
            launches=json.dumps(counts).replace(" ", ""))
        check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                  for h in res.history), f"{name}: a loss is not finite")
        return res, work, fields

    def fresh():
        with no_tok:
            return infer_mod.load_model(model_dir, torch.bfloat16, dev)[0]

    def same(a, b, prefix=""):
        sa, sb = a.state_dict(), b.state_dict()
        return sorted(sa) == sorted(sb) and all(
            torch.equal(sa[k], sb[k]) for k in sa if k.startswith(prefix))

    config = (f"auroracap-7b-widths/llm-{INFER_LOAD_LAYERS}-layers/"
              f"vit-h-14-378/bf16")
    # ---- pretrain, checkpoints at 3 and 6, then resumed from 3 ----------
    common = ("--stage", "pretrain", "--data", data["pretrain"],
              "--batch_size", str(TRAIN_CLI_BATCH), "--max_steps",
              str(TRAIN_CLI_STEPS), "--checkpoint_interval",
              str(TRAIN_CLI_CKPT))
    first, work, fields = run_cli("pretrain", *common)
    ckpts = os.path.join(work, "checkpoints")
    check(sorted(os.listdir(ckpts), key=int) == [str(TRAIN_CLI_CKPT),
                                                  str(TRAIN_CLI_STEPS)],
          f"checkpoints {os.listdir(ckpts)}")
    shutil.copytree(os.path.join(ckpts, str(TRAIN_CLI_CKPT)),
                    os.path.join(root, "resumed", "checkpoints",
                                 str(TRAIN_CLI_CKPT)))
    shutil.rmtree(work)
    second, _, rfields = run_cli("resumed", *common, "--resume")
    check(second.start == TRAIN_CLI_CKPT, f"resumed at {second.start}")
    want = [(h["step"], h["loss"], h["grad_norm"])
            for h in first.history[TRAIN_CLI_CKPT:]]
    got = [(h["step"], h["loss"], h["grad_norm"]) for h in second.history]
    ref = fresh()
    frozen = same(first.model.llm, ref.llm) and same(
        first.model.visual_encoder, ref.visual_encoder)
    moved = not same(first.model.projector, ref.projector)
    proj_equal = same(first.model.projector, second.model.projector)
    phase("train-cli", config=config + f"/pretrain/b{TRAIN_CLI_BATCH}",
          data_write_s=f"{write_s:.2f}", **fields,
          restore_s=f"{second.restore_s:.2f}",
          resumed_losses=json.dumps([g[1] for g in got]).replace(" ", ""),
          resumed_equal=got == want, projector_equal=proj_equal,
          frozen_equal=frozen, projector_moved=moved,
          resumed_step_ms=rfields["step_ms"])
    check(got == want, f"resumed {got} != uninterrupted {want}")
    check(proj_equal, "the resumed run's projector differs")
    check(frozen, "the frozen LLM or ViT moved")
    check(moved, "the projector did not move")
    del first, second, ref
    gc.collect()

    # ---- vision: copy-cfg, grad_accum 2, ViT trainable, slowfast ---------
    cfg_path = os.path.join(root, "vision_stage.json")
    check(copy_cfg(["vision", cfg_path]) == 0, "copy-cfg vision failed")
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["train"]["grad_accum"] = 2
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    res, work, fields = run_cli(
        "vision", "--stage", "vision", "--config", cfg_path, "--data",
        data["vision"], "--max_steps", str(TRAIN_CLI_VISION_STEPS))
    ref = fresh()
    updates = res.state.opt_state["count"]
    vit_moved = not same(res.model.visual_encoder, ref.visual_encoder)
    llm_equal = same(res.model.llm, ref.llm)
    phase("train-cli-vision", config=config + "/vision/b1/grad-accum-2/"
          f"frames-{TRAIN_CLI_VISION_FRAMES}", **fields, updates=updates,
          slowfast=res.model.cfg.slowfast, kept_ratio=raw["train"][
              "kept_ratio"], vit_moved=vit_moved, llm_equal=llm_equal)
    check(updates == TRAIN_CLI_VISION_STEPS // 2, f"{updates} updates")
    check(res.model.cfg.slowfast, "slowfast is off")
    check(vit_moved, "the ViT did not move")
    check(llm_equal, "the frozen LLM moved")
    shutil.rmtree(work)
    del res, ref
    gc.collect()

    # ---- language, packed to 4096 ------------------------------------------
    seen = []
    to_device = train_cli._batch_to_device

    def spy(batch, device, dtype):
        seen.append(batch["segment_ids"].max(axis=1).tolist()
                    if "segment_ids" in batch else None)
        return to_device(batch, device, dtype)

    with mock.patch.object(train_cli, "_batch_to_device", spy):
        res, work, fields = run_cli(
            "packed", "--stage", "language", "--data", data["language"],
            "--pack_max_length", str(TRAIN_CLI_PACK), "--max_steps",
            str(TRAIN_CLI_PACKED_STEPS))
    shutil.rmtree(work)
    check(all(s is not None for s in seen), "a batch without segment_ids")
    docs = max(max(s) for s in seen) + 1
    # one pack against the same documents unpacked, on the trained model
    n_vis = num_visual_tokens(res.model.cfg, 0.1, 378, 378)
    ds = AuroraDataset(data["language"], tok, image_folder=data["images"],
                       template=PROMPT_TEMPLATE.vicuna, device=dev)
    packer = SoftPackerMM(ds.text_data, TRAIN_CLI_PACK, n_visual_tokens=n_vis,
                          dataset=ds)
    members = next(p for p in packer.packs if len(p) >= 2)
    losses = []
    with torch.no_grad():
        for batch in (packed_collate_mm([packer[packer.packs.index(members)]]),
                      default_collate_fn([ds[i] for i in members])):
            b = to_device(batch, dev, res.model.llm.embed_tokens.dtype)
            loss, n = aurora_forward(
                res.model, b["input_ids"], b["pixel_values"],
                attention_mask=b["attention_mask"], labels=b["labels"],
                kept_ratio=0.1, mode="loss",
                segment_ids=b.get("segment_ids"))
            losses.append((float(loss), int(n)))
    rel = abs(losses[0][0] - losses[1][0]) / abs(losses[1][0])
    # what repeatability costs: the forward and backward of one batch of 4
    # packs under repeatable_step (SDPA's math backend, deterministic
    # algorithms) and under SDPA's default backends, in turns
    batch = to_device(packed_collate_mm(
        [packer[i] for i in range(TRAIN_CLI_BATCH)]), dev,
        res.model.llm.embed_tokens.dtype)
    live = [p for p in res.model.parameters() if p.requires_grad]

    def fwd_bwd():
        loss, _ = aurora_forward(
            res.model, batch["input_ids"], batch["pixel_values"],
            attention_mask=batch["attention_mask"], labels=batch["labels"],
            kept_ratio=0.1, mode="loss", remat=True,
            segment_ids=batch["segment_ids"])
        torch.autograd.grad(loss, live, allow_unused=True)

    sdpa_ms = {"repeatable": [], "default": []}
    for mode in ("default", "repeatable", "repeatable", "default"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with (repeatable_step() if mode == "repeatable"
              else contextlib.nullcontext()):
            fwd_bwd()
        torch.cuda.synchronize()
        sdpa_ms[mode].append((time.perf_counter() - t) * 1e3)
    phase("train-cli-packed", config=config + f"/language/b{TRAIN_CLI_BATCH}/"
          f"pack-{TRAIN_CLI_PACK}", **fields,
          fwd_bwd_ms_repeatable=",".join(f"{t:.1f}"
                                         for t in sdpa_ms["repeatable"]),
          fwd_bwd_ms_default_sdpa=",".join(f"{t:.1f}"
                                           for t in sdpa_ms["default"]),
          docs_in_a_pack_max=docs, packs=len(packer),
          packed_loss=f"{losses[0][0]:.6f}", unpacked_loss=f"{losses[1][0]:.6f}",
          loss_tokens=losses[0][1], packed_vs_unpacked_rel=f"{rel:.3e}",
          tol=PACKED_LOSS_TOL, compared_docs=len(members))
    check(docs >= 2, f"no pack holds two documents: {seen}")
    check(losses[0][1] == losses[1][1], f"token counts {losses}")
    check(rel <= PACKED_LOSS_TOL, f"packed loss {losses[0][0]} vs unpacked "
                                  f"{losses[1][0]}")
    del res, ds, packer, batch, live
    gc.collect()

    # ---- language, QLoRA over an int4 base -----------------------------------
    res, work, fields = run_cli(
        "qlora", "--stage", "language", "--data", data["pretrain"],
        "--batch_size", str(TRAIN_CLI_BATCH), "--max_steps",
        str(TRAIN_CLI_QLORA_STEPS), "--lora_r", str(TRAIN_CLI_LORA_R),
        "--quant", "int4")
    with open(os.path.join(work, "lora.json")) as f:
        marker = json.load(f)
    ref = quantize_base(fresh(), bits=4)
    base_equal = same(res.model, ref)
    moved = sum(bool(ab["b"].abs().max() > 0)
                for ab in res.state["adapters"].values())
    phase("train-cli-qlora", config=config + f"/language/b{TRAIN_CLI_BATCH}/"
          f"lora-r{TRAIN_CLI_LORA_R}/int4", **fields,
          quantized_base_gb=f"{res.base_bytes['quantized'] / 1e9:.3f}",
          float_gb=f"{res.base_bytes['float'] / 1e9:.3f}",
          base_equal=base_equal,
          adapters_moved=f"{moved}/{len(res.state['adapters'])}",
          lora_json=json.dumps(marker).replace(" ", ""))
    check(base_equal, "the quantized base changed")
    check(moved == len(res.state["adapters"]), "an adapter did not move")
    check(marker == {"r": TRAIN_CLI_LORA_R, "alpha": 16, "quant": "int4"},
          f"lora.json {marker}")
    del res, ref
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches


def family_kernel_phase(torch, ra, fa, dev):
    """[kernels] at the zoo's published shapes (FAMILY_SHAPES): both
    attention kernels in every KV mode against their twins, timed beside
    SDPA (bf16), and at Gemma-2-9B's served extend (gemma2_served_case,
    GEMMA2_SERVED_OPTIONS; keys ("gemma2-9b-served", mode, served_tag)),
    at Phi-3-mini's (window 2047, SDPA with the band mask) and
    StableLM-3B's (hd 80) (SERVED_CASES; keys (family, mode));
    then flash forward and backward at D 256 (google/
    gemma-7b's heads) timed, and a D 256 case with GQA, segments and a
    q_offset; then at D 512 (FLASH_D512) timed, and D 384 (padded to 512)
    and D 512 cases with GQA, segments and a q_offset → ({(family,
    mode): attention_case's result}, {width: (flash timed result, flash
    results)})."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    res = {}
    for fam, hd, Hq, hkv in FAMILY_SHAPES:
        for mode in KV_MODES:
            res[(fam, mode)] = attention_case(torch, ra, dev, g, hkv, mode,
                                              L=FAMILY_L, hd=hd, Hq=Hq,
                                              family=fam)
    # Gemma-2-9B's served extend (from a generator of its own, so that the
    # flash cases' inputs stay)
    gs = torch.Generator(device=dev).manual_seed(SEED + 14)
    for mode in KV_MODES:
        for opts in GEMMA2_SERVED_OPTIONS:
            res[("gemma2-9b-served", mode, served_tag(opts))] = \
                attention_case(torch, ra, dev, gs, 8, mode,
                               **gemma2_served_case(), **opts)
    # Phi-3-mini's windowed and StableLM-3B's served extends (a generator
    # of their own)
    gn = torch.Generator(device=dev).manual_seed(SEED + 17)
    for fam, hkv, case in SERVED_CASES:
        for mode in KV_MODES:
            res[(fam, mode)] = attention_case(torch, ra, dev, gn, hkv, mode,
                                              **case())
    fl = FLASH_D256
    timed = flash_case(torch, fa, dev, g, fl["B"], fl["T"], fl["H"],
                       fl["Hkv"], timed=True, D=fl["D"])
    other = flash_case(torch, fa, dev, g, 2, 384, 8, 4, q_offset=128,
                       segments=True, D=fl["D"])
    fw = FLASH_D512
    timed512 = flash_case(torch, fa, dev, g, fw["B"], fw["T"], fw["H"],
                          fw["Hkv"], timed=True, D=fw["D"])
    wide = [flash_case(torch, fa, dev, g, 1, 384, 4, 2, q_offset=128,
                       segments=True, D=d) for d in (384, 512)]
    return res, {"d256": (timed, [timed, other]),
                 "d512": (timed512, [timed512, *wide])}


def gemma2_prompt_lens(rng=None):
    """The [serve-gemma2-*] runs' prompt lengths: the first draw of their
    generator (SEED + 12)."""
    rng = np.random.default_rng(SEED + 12) if rng is None else rng
    return rng.integers(GEMMA2_PROMPT[0], GEMMA2_PROMPT[1] + 1,
                        size=N_REQUESTS)


def gemma2_served_case():
    """attention_case's arguments at Gemma-2-9B's served extend: the
    runs' 4 prompts in one wave of the 6144 bucket from position 0, rows
    of 6144 tokens, Hq 16, hd 256 (Hkv 8 is the caller's); decode one
    token past each prompt."""
    plens = tuple(int(n) for n in gemma2_prompt_lens())
    return dict(L=FAMILY_L, S=6144, T=6144, offs=(0,) * N_REQUESTS,
                lens=plens, dlens=tuple(n + 1 for n in plens), hd=256,
                Hq=16, family="gemma2-9b-served")


def phi3_prompt_lens(rng=None):
    """The [serve-phi3-mini-*] runs' prompt lengths: the first draw of
    their generator (SEED + 16)."""
    rng = np.random.default_rng(SEED + 16) if rng is None else rng
    return rng.integers(PHI3_PROMPT[0], PHI3_PROMPT[1] + 1, size=N_REQUESTS)


def phi3_served_case():
    """attention_case's arguments at Phi-3-mini's served extend: the
    [serve-phi3-mini-*] runs' 4 prompts in one wave of the PHI3_BUCKET
    bucket from position 0, rows of PHI3_BUCKET tokens, Hq 32, hd 96, the
    window of 2047 (Hkv 32 is the caller's); decode one token past each
    prompt."""
    plens = tuple(int(n) for n in phi3_prompt_lens())
    return dict(L=FAMILY_L, S=PHI3_BUCKET, T=PHI3_BUCKET,
                offs=(0,) * N_REQUESTS, lens=plens,
                dlens=tuple(n + 1 for n in plens), hd=96, Hq=32,
                window=PHI3_MINI["sliding_window"], family="phi3-mini-served")


def stablelm_served_case():
    """attention_case's arguments at StableLM-3B's served extend: the
    [serve-stablelm-*] runs' 4 prompts (the first draw of their generator,
    SEED + 15) in one wave of their 2048 bucket from position 0, rows of
    2304 tokens (their engine's 2080, rounded up to kv_chunk 256), Hq 32,
    hd 80 (Hkv 32 is the caller's)."""
    plens = tuple(int(n) for n in np.random.default_rng(SEED + 15).integers(
        STABLELM_PROMPT[0], STABLELM_PROMPT[1] + 1, size=N_REQUESTS))
    return dict(L=FAMILY_L, S=2304, T=2048, offs=(0,) * N_REQUESTS,
                lens=plens, dlens=tuple(n + 1 for n in plens), hd=80, Hq=32,
                family="stablelm-3b-served")


# the served extends that [kernels] times beside the family shapes:
# (family, Hkv, case)
SERVED_CASES = (("phi3-mini-served", 32, phi3_served_case),
                ("stablelm-3b-served", 32, stablelm_served_case))


def served_tag(opts):
    return "window-cap" if opts else "none"


def extend_kernel_name(hd):
    """The csrc/ragged_extend.cu kernel that runs head_dim hd (a multiple
    of 16 up to 256), as the profiler names it: extend_kernel at the
    narrowest of its widths 64, 96 and 128 that holds hd, else
    extend_d256_kernel."""
    w = next((w for w in (64, 96, 128) if w >= hd), None)
    return f"extend_kernel<{w}>" if w else "extend_d256_kernel"


def gemma2_phase(torch, engine_mod, ra, qm, dev, card, plains):
    """Gemma-2-9B at full width and depth (models/gemma2.py's preset, a
    copy of google/gemma-2-9b's config), random bf16 weights from the
    seed, through `gemma2_serving_config` / `gemma2_serving_params` and
    ServeEngine: N_REQUESTS prompts of GEMMA2_PROMPT random ids in one
    wave, GEMMA2_MAX_NEW greedy tokens, with bf16 KV (twice: the second
    run's tokens and logprobs must equal the first's bit for bit), int8
    KV, packed int4 KV, and W4 weights + int8 KV. Each run: the ragged
    kernels' launch counts (every layer a wave and a decode step; the
    twins 0), the W4 run's W4A8 launches (4 a layer a decode step), and
    the logits of one extend wave and one decode step against the same
    engine on the plain twins → {run: launch counts}."""
    from aurora_tpu_torch.models.gemma2 import (Gemma2Config,
                                                gemma2_serving_params,
                                                init_gemma2)
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    gcfg = Gemma2Config.gemma2_9b()
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm = gemma2_serving_params(init_gemma2(gcfg, gen, device=dev,
                                            dtype=torch.bfloat16),
                                free_source=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = llm.cfg
    L = cfg.num_hidden_layers
    weight_gb = sum(p.numel() * p.element_size()
                    for p in llm.parameters()) / 1e9
    rng = np.random.default_rng(SEED + 12)
    plens = gemma2_prompt_lens(rng)
    check(plens.min() > cfg.sliding_window,
          f"prompts {plens} within the window {cfg.sliding_window}")
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in plens]
    attn_plain = {"ragged_attention": ra.ragged_attention_plain,
                  "ragged_decode_attention": ra.ragged_decode_attention_plain}
    out, first = {}, None
    models = {"none": llm}
    for run, weight_quant, kv_quant, counter in GEMMA2_RUNS:
        if weight_quant not in models:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models[weight_quant] = engine_mod.fuse_serving_weights(
                engine_mod.quantize_weights_int4(llm))
            torch.cuda.synchronize()
            phase("quantize-gemma2", seconds=f"{time.perf_counter() - t0:.2f}")
        model = models[weight_quant]
        ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=6200,
                            kv_chunk=1024, prefill_buckets=(6144,),
                            decode_steps=16, kv_quant=kv_quant,
                            weight_quant=weight_quant,
                            disable_radix_cache=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, cfg, ecfg, device=dev, seed=SEED)
        counters = [(ra.ragged_attention, counter),
                    (ra.ragged_decode_attention, counter),
                    (ra.ragged_attention, "launches_window"),
                    (ra.ragged_decode_attention, "launches_window"),
                    (qm.w4a8_matmul_tiled, "launches")] + plains
        reqs = [Request(rid=f"g{i}", input_ids=list(p),
                        max_new_tokens=GEMMA2_MAX_NEW, eos_ids=(),
                        logprobs=True)
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, GEMMA2_MAX_NEW)
        ext, dec, ext_w, dec_w, w4 = (counts[f"{f.__name__}.{a}"]
                                      for f, a in counters[:5])
        steps = engine._steps
        phase("serve-gemma2-" + run, card=repr(card),
              config=f"gemma-2-9b/L{L}/hd{cfg.head_dim}/window"
                     f"{cfg.sliding_window}-even-layers/caps"
                     f"{cfg.attn_logit_softcap:g},{cfg.final_logit_softcap:g}"
                     f"/weights-{weight_quant}/kv-{kv_quant}",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=GEMMA2_MAX_NEW, init_s=f"{init_s:.1f}",
              weight_gb=f"{weight_gb:.2f}",
              extend_s=f"{engine.t_extend_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps,
              tokens_per_s=f"{N_REQUESTS * GEMMA2_MAX_NEW / wall:.1f}",
              wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        # the cap is on in every layer, so every launch counts as windowed
        check(ext > 0 and dec > 0 and ext == ext_w and dec == dec_w
              and ext % L == 0 and dec == L * steps,
              f"{run}: ragged launches {counts}, steps {steps}")
        check((w4 == 4 * L * steps) if weight_quant == "int4" else w4 == 0,
              f"{run}: W4A8 launches {w4}, steps {steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        got = [(r.output_ids, [lp for lp in r.output_logprobs])
               for r in reqs]
        if run == "bf16":
            first = got
        elif run == "bf16-again":
            check(got == first, "two bf16 Gemma-2 runs differ")
            phase("serve-gemma2-repeat", bitwise_equal=True,
                  tokens=N_REQUESTS * GEMMA2_MAX_NEW)
        if run != "bf16-again":
            plain = dict(attn_plain)
            if weight_quant == "int4":
                plain["w4a8_matmul_tiled"] = qm.w4a8_matmul_tiled_plain
            logits_check(torch, engine_mod, engine.runner,
                         lambda r: model.embed_tokens[
                             torch.tensor(r.input_ids, device=dev)],
                         reqs, GEMMA2_LOGITS_TOL, "logits-gemma2-" + run,
                         plain, decode=True, decode_tol=GEMMA2_LOGITS_TOL,
                         reason=GEMMA2_LOGITS_REASON)
        out[run] = (ext, dec, w4)
        del engine
        gc.collect()
    del llm, models
    gc.collect()
    torch.cuda.empty_cache()
    return out


def qwen2_phase(torch, engine_mod, ra, qm, dev, card, plains):
    """Qwen2-7B (LlamaConfig.qwen2_7b, Qwen/Qwen2-7B-Instruct's config) at
    its widths and QWEN2_LAYERS layers, random bf16 weights and qkv
    biases from the seed: W8 weights + int8 KV, then W4 weights + int8
    KV, N_REQUESTS prompts of GEMMA2_PROMPT random ids, GEMMA2_MAX_NEW
    greedy tokens; launch counts and the logits of one extend wave and
    one decode step against the plain twins → {run: launch counts}."""
    import dataclasses as dc

    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    cfg = dc.replace(LlamaConfig.qwen2_7b(), num_hidden_layers=QWEN2_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    llm = build(LlamaModel, cfg, device=dev, dtype=torch.bfloat16,
                generator=gen)
    with torch.no_grad():
        for n, p in llm.named_parameters():
            if n.endswith(("q_bias", "k_bias", "v_bias")):
                p.normal_(0.0, 1.0, generator=gen)
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 13)
    plens = rng.integers(GEMMA2_PROMPT[0], GEMMA2_PROMPT[1] + 1,
                         size=N_REQUESTS)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in plens]
    kernel = {"int8": (qm.w8a8_matmul, qm.w8a8_matmul_plain, "w8a8_matmul"),
              "int4": (qm.w4a8_matmul_tiled, qm.w4a8_matmul_tiled_plain,
                       "w4a8_matmul_tiled")}
    out = {}
    for run, weight_quant, kv_quant in QWEN2_RUNS:
        quant = (engine_mod.quantize_weights_int8 if weight_quant == "int8"
                 else engine_mod.quantize_weights_int4)
        model = engine_mod.fuse_serving_weights(quant(llm))
        wk, wplain, wname = kernel[weight_quant]
        ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=6200,
                            kv_chunk=1024, prefill_buckets=(6144,),
                            decode_steps=16, kv_quant=kv_quant,
                            weight_quant=weight_quant,
                            disable_radix_cache=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, cfg, ecfg, device=dev, seed=SEED)
        counters = [(ra.ragged_attention, "launches_int8"),
                    (ra.ragged_decode_attention, "launches_int8"),
                    (wk, "launches")] + plains
        reqs = [Request(rid=f"q{i}", input_ids=list(p),
                        max_new_tokens=GEMMA2_MAX_NEW, eos_ids=())
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, GEMMA2_MAX_NEW)
        ext, dec, wl = (counts[f"{f.__name__}.{a}"] for f, a in counters[:3])
        steps = engine._steps
        phase("serve-qwen2-" + run, card=repr(card),
              config=f"qwen2-7b/L{L}/G{cfg.num_attention_heads // cfg.num_key_value_heads}"
                     f"/qkv-bias/theta{cfg.rope_theta:g}"
                     f"/weights-{weight_quant}/kv-{kv_quant}",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=GEMMA2_MAX_NEW, extend_s=f"{engine.t_extend_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps, wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        check(ext == L and dec == L * steps and wl > 0,
              f"{run}: launches {counts}, steps {steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        logits_check(torch, engine_mod, engine.runner,
                     lambda r: model.embed_tokens[
                         torch.tensor(r.input_ids, device=dev)],
                     reqs, QWEN2_LOGITS_TOL[run], "logits-qwen2-" + run,
                     {"ragged_attention": ra.ragged_attention_plain,
                      "ragged_decode_attention":
                          ra.ragged_decode_attention_plain, wname: wplain},
                     decode=True)
        out[run] = (ext, dec, wl)
        del engine, model
        gc.collect()
    del llm
    torch.cuda.empty_cache()
    return out


def stablelm_phase(torch, engine_mod, ra, dev, card, plains):
    """StableLM-3B-4E1T (STABLELM_3B through the port's converter, head_dim
    80) at STABLELM_LAYERS layers, random bf16 weights from the seed:
    N_REQUESTS prompts of STABLELM_PROMPT random ids, STABLELM_MAX_NEW
    greedy tokens, with bf16, int8 and packed int4 KV. Each run: the
    ragged kernels' launch counts (every layer a wave and a decode step,
    no window or cap, the twins 0), and the logits of one extend wave and
    one decode step against the same engine on the plain twins → {run:
    (extend launches, decode launches)}."""
    import dataclasses as dc

    from aurora_tpu_torch.models.convert import llama_config_from_hf
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaModel
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    cfg = dc.replace(llama_config_from_hf(STABLELM_3B),
                     num_hidden_layers=STABLELM_LAYERS)
    hd = cfg.hidden_size // cfg.num_attention_heads
    check(hd == 80 and ra.kernel_head_width(hd) == 96,
          f"stablelm head_dim {hd}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    llm = build(LlamaModel, cfg, device=dev, dtype=torch.bfloat16,
                generator=gen)
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 15)
    plens = rng.integers(STABLELM_PROMPT[0], STABLELM_PROMPT[1] + 1,
                         size=N_REQUESTS)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in plens]
    out = {}
    for run, kv_quant, counter in STABLELM_RUNS:
        ecfg = EngineConfig(max_batch=N_REQUESTS,
                            max_seq_len=2048 + STABLELM_MAX_NEW,
                            kv_chunk=256, prefill_buckets=(2048,),
                            decode_steps=16, kv_quant=kv_quant,
                            disable_radix_cache=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(llm, cfg, ecfg, device=dev, seed=SEED)
        counters = [(ra.ragged_attention, counter),
                    (ra.ragged_decode_attention, counter),
                    (ra.ragged_attention, "launches_window"),
                    (ra.ragged_decode_attention, "launches_window"),
                    (ra.ragged_attention, "launches_w96")] + plains
        reqs = [Request(rid=f"s{i}", input_ids=list(p),
                        max_new_tokens=STABLELM_MAX_NEW, eos_ids=())
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, STABLELM_MAX_NEW)
        ext, dec, ext_w, dec_w, w96 = (counts[f"{f.__name__}.{a}"]
                                       for f, a in counters[:5])
        steps = engine._steps
        phase("serve-stablelm-" + run, card=repr(card),
              config=f"stablelm-3b-4e1t/L{L}/hd{hd}/rotary"
                     f"{cfg.partial_rotary_factor:g}/{cfg.norm_type}"
                     f"/kv-{kv_quant}",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=STABLELM_MAX_NEW,
              extend_s=f"{engine.t_extend_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps, wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        check(ext == L and w96 == L and dec == L * steps and ext_w == 0
              and dec_w == 0, f"{run}: ragged launches {counts}, steps "
              f"{steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        logits_check(torch, engine_mod, engine.runner,
                     lambda r: llm.embed_tokens[
                         torch.tensor(r.input_ids, device=dev)],
                     reqs, STABLELM_LOGITS_TOL[run], "logits-stablelm-" + run,
                     {"ragged_attention": ra.ragged_attention_plain,
                      "ragged_decode_attention":
                          ra.ragged_decode_attention_plain},
                     decode=True)
        out[run] = (ext, dec)
        del engine
        gc.collect()
    del llm
    torch.cuda.empty_cache()
    return out


def phi3_hf_tree(torch, cfg, dev, gen):
    """Random bf16 weights of a Phi-3 checkpoint in its own key layout
    (the fused qkv_proj and gate_up_proj), drawn as models/init.py draws
    them: matrices N(0, 0.02^2), norm scales one."""
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, H, Hkv = cfg.head_dim, cfg.num_attention_heads, \
        cfg.num_key_value_heads

    def mat(*shape):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16).normal_(
            0.0, 0.02, generator=gen)

    def ones(n):
        return torch.ones(n, device=dev, dtype=torch.bfloat16)
    sd = {"model.embed_tokens.weight": mat(V, D),
          "model.norm.weight": ones(D), "lm_head.weight": mat(V, D)}
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}."
        sd[b + "self_attn.qkv_proj.weight"] = mat((H + 2 * Hkv) * hd, D)
        sd[b + "self_attn.o_proj.weight"] = mat(D, H * hd)
        sd[b + "mlp.gate_up_proj.weight"] = mat(2 * I, D)
        sd[b + "mlp.down_proj.weight"] = mat(D, I)
        sd[b + "input_layernorm.weight"] = ones(D)
        sd[b + "post_attention_layernorm.weight"] = ones(D)
    return sd


def phi3_phase(torch, engine_mod, ra, dev, card, plains):
    """Phi-3-mini-4k at full width and depth (PHI3_MINI through the
    port's converter: head_dim 96, MHA, window 2047 on every layer),
    random bf16 weights from the seed written as the checkpoint's fused
    tree and converted by `llama_params_from_hf`: N_REQUESTS prompts of
    PHI3_PROMPT random ids in one wave, PHI3_MAX_NEW greedy tokens, with
    bf16 KV (twice: the second run's tokens and logprobs must equal the
    first's bit for bit), int8 KV and packed int4 KV. Each run: the
    ragged kernels' launch counts (every layer a wave and a decode step,
    every launch windowed, every extend launch on the width-96 kernel and
    none on another width, the twins 0), and the logits of one extend
    wave and one decode step against the same engine on the plain twins
    → {run: (extend launches, decode launches)}."""
    from aurora_tpu_torch.models.convert import (llama_config_from_hf,
                                                 llama_params_from_hf)
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    cfg = llama_config_from_hf(PHI3_MINI)
    hd, L = cfg.head_dim, cfg.num_hidden_layers
    check(hd == 96 and ra.kernel_head_width(hd) == 96
          and cfg.num_key_value_heads == cfg.num_attention_heads
          and cfg.sliding_window == 2047, f"phi3 config {cfg}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = phi3_hf_tree(torch, cfg, dev, gen)
    llm = llama_params_from_hf(sd, cfg, dtype=torch.bfloat16, device=dev)
    del sd
    gc.collect()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size()
                    for p in llm.parameters()) / 1e9
    rng = np.random.default_rng(SEED + 16)
    plens = phi3_prompt_lens(rng)
    check(plens.min() > cfg.sliding_window,
          f"prompts {plens} within the window {cfg.sliding_window}")
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in plens]
    widths = [(ra.ragged_attention, f"launches_w{w}")
              for w in ra.KERNEL_WIDTHS]
    out, first = {}, None
    for run, kv_quant, counter in PHI3_RUNS:
        ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=PHI3_BUCKET,
                            kv_chunk=256, prefill_buckets=(PHI3_BUCKET,),
                            decode_steps=16, kv_quant=kv_quant,
                            disable_radix_cache=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(llm, cfg, ecfg, device=dev, seed=SEED)
        counters = [(ra.ragged_attention, counter),
                    (ra.ragged_decode_attention, counter),
                    (ra.ragged_attention, "launches_window"),
                    (ra.ragged_decode_attention, "launches_window"),
                    *widths] + plains
        reqs = [Request(rid=f"p{i}", input_ids=list(p),
                        max_new_tokens=PHI3_MAX_NEW, eos_ids=(),
                        logprobs=True)
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, PHI3_MAX_NEW)
        ext, dec, ext_w, dec_w = (counts[f"{f.__name__}.{a}"]
                                  for f, a in counters[:4])
        by_width = {a: counts[f"{f.__name__}.{a}"] for f, a in widths}
        steps = engine._steps
        phase("serve-phi3-mini-" + run, card=repr(card),
              config=f"phi-3-mini-4k/L{L}/hd{hd}/window"
                     f"{cfg.sliding_window}/kv-{kv_quant}",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=PHI3_MAX_NEW, init_s=f"{init_s:.1f}",
              weight_gb=f"{weight_gb:.2f}",
              extend_s=f"{engine.t_extend_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps, wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        # one wave: every layer once on the width-96 kernel, windowed
        check(ext == L and ext_w == L and dec == L * steps and dec_w == dec
              and by_width["launches_w96"] == L
              and sum(by_width.values()) == L,
              f"{run}: ragged launches {counts}, steps {steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        got = [(r.output_ids, list(r.output_logprobs)) for r in reqs]
        if run == "bf16":
            first = got
        elif run == "bf16-again":
            check(got == first, "two bf16 Phi-3-mini runs differ")
            phase("serve-phi3-mini-repeat", bitwise_equal=True,
                  tokens=N_REQUESTS * PHI3_MAX_NEW)
        if run != "bf16-again":
            logits_check(torch, engine_mod, engine.runner,
                         lambda r: llm.embed_tokens[
                             torch.tensor(r.input_ids, device=dev)],
                         reqs, PHI3_LOGITS_TOL, "logits-phi3-mini-" + run,
                         {"ragged_attention": ra.ragged_attention_plain,
                          "ragged_decode_attention":
                              ra.ragged_decode_attention_plain},
                         decode=True, decode_tol=PHI3_LOGITS_TOL,
                         reason=PHI3_LOGITS_REASON)
        out[run] = (ext, dec)
        del engine
        gc.collect()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def internvl_hf_tree(torch, cfg, dev, gen):
    """Random bf16 weights of an InternVLForConditionalGeneration
    checkpoint in its key names, drawn as models/init.py draws a model
    (matrices, embeddings and the CLS / position tables N(0, 0.02²), norm
    scales one, biases zero), with LayerScale at its init value, the
    tower's q/k/v biases N(0, 0.02²) and the decoder's N(0, 1), as the
    Qwen2 runs draw them, so that they act."""
    v, t = cfg.vision, cfg.text
    Dv, Iv, p = v.hidden_size, v.intermediate_size, v.patch_size
    D, I, V = t.hidden_size, t.intermediate_size, t.vocab_size
    H, Hkv, hd = t.num_attention_heads, t.num_key_value_heads, t.head_dim

    def mat(*shape, std=0.02):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16).normal_(
            0.0, std, generator=gen)

    def full(n, x):
        return torch.full((n,), x, device=dev, dtype=torch.bfloat16)

    e = "model.vision_tower.embeddings."
    sd = {e + "patch_embeddings.projection.weight": mat(Dv, 3, p, p),
          e + "patch_embeddings.projection.bias": full(Dv, 0.0),
          e + "cls_token": mat(1, 1, Dv),
          e + "position_embeddings": mat(1, v.num_patches + 1, Dv)}
    for i in range(v.num_hidden_layers):
        b = f"model.vision_tower.encoder.layer.{i}."
        for n in ("layernorm_before", "layernorm_after"):
            sd[b + n + ".weight"] = full(Dv, 1.0)
            sd[b + n + ".bias"] = full(Dv, 0.0)
        for n in "qkv":
            sd[b + f"attention.{n}_proj.weight"] = mat(Dv, Dv)
            sd[b + f"attention.{n}_proj.bias"] = mat(Dv)
        for n, shape in (("attention.projection_layer", (Dv, Dv)),
                         ("mlp.fc1", (Iv, Dv)), ("mlp.fc2", (Dv, Iv))):
            sd[b + n + ".weight"] = mat(*shape)
            sd[b + n + ".bias"] = full(shape[0], 0.0)
        for n in ("lambda_1", "lambda_2"):
            sd[b + n] = full(Dv, v.layer_scale_init_value)
    pj, Din = "model.multi_modal_projector.", cfg.projector_in
    sd.update({pj + "layer_norm.weight": full(Din, 1.0),
               pj + "layer_norm.bias": full(Din, 0.0),
               pj + "linear_1.weight": mat(D, Din),
               pj + "linear_1.bias": full(D, 0.0),
               pj + "linear_2.weight": mat(D, D),
               pj + "linear_2.bias": full(D, 0.0)})
    lm = "model.language_model."
    sd.update({lm + "embed_tokens.weight": mat(V, D),
               lm + "norm.weight": full(D, 1.0), "lm_head.weight": mat(V, D)})
    for i in range(t.num_hidden_layers):
        b = f"{lm}layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[b + n + ".weight"] = full(D, 1.0)
        for n, out in (("q", H * hd), ("k", Hkv * hd), ("v", Hkv * hd)):
            sd[b + f"self_attn.{n}_proj.weight"] = mat(out, D)
            sd[b + f"self_attn.{n}_proj.bias"] = mat(out, std=1.0)
        sd[b + "self_attn.o_proj.weight"] = mat(D, H * hd)
        for n, shape in (("gate", (I, D)), ("up", (I, D)), ("down", (D, I))):
            sd[b + f"mlp.{n}_proj.weight"] = mat(*shape)
    return sd


def visual_twin_err(torch, fn, modules, px, cfg, tape=None):
    """fn(model-like, px) on the card in bf16 against the same modules
    copied to fp32 on the same input (upcast), under TF32 off: → (max |Δ|
    / max |want|, the bf16 result). modules: {attribute: module}; tape: a
    RoutingTape whose pass on the bf16 modules the fp32 pass replays (the
    ToMe merges, whose rankings bf16 may order otherwise)."""
    import copy
    import types
    tape = tape or RoutingTape(())
    with torch.no_grad():
        with tape.patched(False):
            got = fn(types.SimpleNamespace(cfg=cfg, **modules), px)
        twin = {k: copy.deepcopy(m).float() for k, m in modules.items()}
        with tape.patched(True):
            want = fn(types.SimpleNamespace(cfg=cfg, **twin), px.float())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "visual features not finite")
    return ((got.float() - want).abs().max() / want.abs().max()).item(), got


def internvl_phase(torch, engine_mod, ra, dev, card, plains):
    """InternVL3-8B whole (INTERNVL3_8B: InternViT-300M, the pixel-shuffle
    projector, Qwen2.5-7B's decoder), random bf16 weights from the seed in
    the -hf key names, converted on the card by `internvl_params_from_hf`
    and served through `InternVLServing` and ServeEngine with the radix
    cache on: INTERNVL_PROMPTS (1 or 2 448 x 448 tiles and ~40 text ids
    each) in two waves of two, INTERNVL_MAX_NEW greedy tokens, bf16 KV
    twice (a fresh front end each time: tokens and logprobs bit for bit)
    and int8 KV. Each run: extend_kernel<128> once a layer a wave and no
    other width, the decode kernel once a layer a step, the twins 0, the
    repeated tile's request hits its prefix, and the logits of a wave and
    a decode step against the twins; InternViT + projector against their
    fp32 twin → {run: (extend launches, decode launches)}."""
    from aurora_tpu_torch.models.convert import llama_config_from_hf
    from aurora_tpu_torch.models.internvl import (InternVLConfig,
                                                  internvit_config_from_hf,
                                                  internvl_image_features,
                                                  internvl_params_from_hf)
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import (_PLACEHOLDER_BASE,
                                                   InternVLServing)
    cfg = InternVLConfig(
        vision=internvit_config_from_hf(INTERNVL3_8B["vision_config"]),
        text=llama_config_from_hf(INTERNVL3_8B["text_config"]),
        downsample_ratio=INTERNVL3_8B["downsample_ratio"],
        projector_hidden_act=INTERNVL3_8B["projector_hidden_act"])
    t = cfg.text
    L, hd, G = (t.num_hidden_layers, t.head_dim,
                t.num_attention_heads // t.num_key_value_heads)
    n_vis = cfg.n_visual_tokens
    check(hd == 128 and G == 7 and t.qkv_bias and n_vis == 256
          and cfg.projector_in == 4096, f"internvl config {cfg}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = internvl_hf_tree(torch, cfg, dev, gen)
    model = internvl_params_from_hf(sd, cfg, dtype=torch.bfloat16,
                                    device=dev)
    del sd
    gc.collect()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    rng = np.random.default_rng(SEED + 17)
    size = cfg.vision.image_size
    uniq = [rng.standard_normal((n, 3, size, size)).astype(np.float32)
            for n in (1, 2, 2)]
    # the third request repeats the first one's tile
    tiles = [uniq[0], uniq[1], uniq[0], uniq[2]]
    with torch.no_grad():       # warm InternViT (cuBLAS set-up) off the runs
        internvl_image_features(model, torch.zeros(
            (1, 3, size, size), device=dev, dtype=torch.bfloat16))
    prompts = [("<image>" * n) + "\n" + q for n, q in INTERNVL_PROMPTS]
    widths = [(ra.ragged_attention, f"launches_w{w}")
              for w in ra.KERNEL_WIDTHS]
    out, first = {}, None
    for run, kv_quant, counter in INTERNVL_RUNS:
        mm = InternVLServing(model, ByteTokenizer())
        embed_times = []

        def timed_embed_fn(req, mm=mm, embed_times=embed_times):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x = mm.embed_fn(req)
            torch.cuda.synchronize()
            embed_times.append(time.perf_counter() - t1)
            return x

        reqs = [mm.build_request(f"v{i}", p, px,
                                 max_new_tokens=INTERNVL_MAX_NEW,
                                 eos_ids=(), logprobs=True)
                for i, (p, px) in enumerate(zip(prompts, tiles))]
        for r, (n, _) in zip(reqs, INTERNVL_PROMPTS):
            n_ph = sum(x >= _PLACEHOLDER_BASE for x in r.input_ids)
            check(n_ph == n * n_vis, f"{r.rid}: {n_ph} visual tokens")
        plens = [len(r.input_ids) for r in reqs]
        ecfg = EngineConfig(max_batch=len(reqs), max_seq_len=INTERNVL_BUCKET,
                            kv_chunk=256, prefill_buckets=(INTERNVL_BUCKET,),
                            decode_steps=16, kv_quant=kv_quant)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(mm.llm_params, mm.llm_cfg, ecfg,
                             embed_fn=timed_embed_fn, device=dev, seed=SEED)
        counters = [(ra.ragged_attention, counter),
                    (ra.ragged_decode_attention, counter),
                    (ra.ragged_attention, "launches_window"),
                    *widths] + plains
        # two waves of two: the second finds the first's prompts cached
        wall, counts = serve(torch, engine, reqs[:2], counters,
                             INTERNVL_MAX_NEW)
        wall2, counts2 = serve(torch, engine, reqs[2:], counters,
                               INTERNVL_MAX_NEW)
        wall += wall2
        counts = {k: counts[k] + counts2[k] for k in counts}
        ext, dec, ext_win = (counts[f"{f.__name__}.{a}"]
                             for f, a in counters[:3])
        by_width = {a: counts[f"{f.__name__}.{a}"] for f, a in widths}
        steps = engine._steps
        hit = reqs[2].n_cached
        wave_s = (engine.t_extend_s - sum(embed_times)) / 2
        phase("serve-internvl-" + run, card=repr(card),
              config=f"internvl3-8b/vit-L{cfg.vision.num_hidden_layers}"
                     f"/text-L{L}/hd{hd}/G{G}/qkv-bias/kv-{kv_quant}",
              requests=len(reqs),
              tiles=",".join(str(n) for n, _ in INTERNVL_PROMPTS),
              prompt_tokens=",".join(str(n) for n in plens),
              new_tokens=INTERNVL_MAX_NEW, init_s=f"{init_s:.1f}",
              weight_gb=f"{weight_gb:.2f}",
              vit_proj_embed_s=",".join(f"{x:.4f}" for x in embed_times),
              extend_s_per_wave=f"{wave_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps, wall_s=f"{wall:.2f}",
              prefix_hit=f"{sum(r.n_cached for r in reqs)}/{sum(plens)}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        # two waves: every layer once a wave on the width-128 kernel
        check(ext == 2 * L and by_width["launches_w128"] == 2 * L
              and sum(by_width.values()) == 2 * L and ext_win == 0
              and dec == L * steps,
              f"{run}: ragged launches {counts}, steps {steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        check(hit >= 1 + n_vis and all(r.n_cached == 0 for r in reqs[:2]),
              f"{run}: prefix hits {[r.n_cached for r in reqs]}")
        got = [(r.output_ids, list(r.output_logprobs)) for r in reqs]
        if run == "bf16":
            first = got
        elif run == "bf16-again":
            check(got == first, "two bf16 InternVL3-8B runs differ")
            phase("serve-internvl-repeat", bitwise_equal=True,
                  tokens=len(reqs) * INTERNVL_MAX_NEW)
        if run != "bf16-again":
            logits_check(torch, engine_mod, engine.runner, mm.embed_fn,
                         reqs, INTERNVL_LOGITS_TOL, "logits-internvl-" + run,
                         {"ragged_attention": ra.ragged_attention_plain,
                          "ragged_decode_attention":
                              ra.ragged_decode_attention_plain},
                         decode=True)
        out[run] = (ext, dec)
        del engine, mm
        gc.collect()
    # InternViT + projector on two tiles (warm) against their fp32 twin
    px = torch.as_tensor(uniq[1], device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        internvl_image_features(model, px)
    torch.cuda.synchronize()
    tile_s = (time.perf_counter() - t0) / px.shape[0]
    err, feats = visual_twin_err(
        torch, internvl_image_features,
        {"vision": model.vision, "projector": model.projector}, px, cfg)
    phase("internvl-vision", card=repr(card), tiles=px.shape[0],
          vit_proj_s_per_tile=f"{tile_s:.4f}",
          features=json.dumps(list(feats.shape)).replace(" ", ""),
          rel_err=f"{err:.3e}", tol=VISUAL_REL_TOL)
    check(tuple(feats.shape) == (2, n_vis, t.hidden_size)
          and err <= VISUAL_REL_TOL, f"InternViT twin rel err {err}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def siglip_phase(torch, engine_mod, ra, dev, card, plains):
    """AuroraCap with a SigLIP tower: an xtuner directory written by this
    script (SIGLIP_SO400M's visual_encoder/ in SigLIP's names, fp16;
    Vicuna-7B-v1.5-16k's widths cut to SIGLIP_LLM_LAYERS layers, bf16;
    the projector fp32; weights drawn as models/init.py draws a model),
    read by `load_auroracap_dir` onto the card in bf16 and served through
    AuroraCapServing at kept ratio KEPT_RATIO: N_REQUESTS clips of
    N_FRAMES 384 x 384 frames, int8 KV, SIGLIP_MAX_NEW greedy tokens. The
    visual token count (no CLS) must equal each request's fused span, the
    extend kernel launch once a layer (width 128) and the decode kernel
    once a layer a step, the twins 0, and one clip's visual groups
    (SigLIP + ToMe + projector) hold to their fp32 twin under the bf16
    pass's merges → (extend launches, decode launches)."""
    import dataclasses as dc
    from aurora_tpu_torch.data.preprocess import clip_normalize_device
    from aurora_tpu_torch.models.aurora import (AuroraConfig, AuroraModel,
                                                encode_visual,
                                                num_visual_tokens)
    from aurora_tpu_torch.models.convert import load_auroracap_dir
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.models.vit import ViTConfig
    from aurora_tpu_torch.ops import tome as tome_mod
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import (_PLACEHOLDER_BASE,
                                                   AuroraCapServing)
    llm_cfg = dc.replace(LlamaConfig.vicuna_7b_v15_16k(),
                         num_hidden_layers=SIGLIP_LLM_LAYERS)
    vit_cfg = ViTConfig(**SIGLIP_SO400M)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "siglip")
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    try:
        t0 = time.perf_counter()
        _, nbytes = write_xtuner_dir(torch, root, llm_cfg, vit_cfg, g,
                                     model_init=True)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm, lcfg, vit, vcfg, pj, pcfg = load_auroracap_dir(
            root, llm_dtype=torch.bfloat16, vit_dtype=torch.bfloat16,
            device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(vcfg == vit_cfg and not vcfg.class_token, f"ViT config {vcfg}")
    names = set(vit.state_dict())
    check("patch_embed.bias" in names and "class_embedding" not in names
          and not any(n.startswith("pre_layernorm") for n in names),
          "the SigLIP tower's parameters")
    cfg = AuroraConfig(vit=vcfg, llm=lcfg, projector=pcfg)
    model = AuroraModel(cfg, device="meta", dtype=torch.bfloat16)
    model.visual_encoder, model.projector, model.llm = vit, pj, llm
    mm = AuroraCapServing(model, ByteTokenizer(), kept_ratio=KEPT_RATIO,
                          image_size=vcfg.image_size)
    n_vis = mm.n_visual_tokens()
    side = vcfg.image_size // vcfg.patch_size
    r = int(vcfg.image_size ** 2 / vcfg.patch_size ** 2 * (1 - KEPT_RATIO)
            / vcfg.num_hidden_layers)
    # no CLS: the patches less one merge step a layer but the last, less
    # the dropped token 0
    check(n_vis == side * side - r * (vcfg.num_hidden_layers - 1) - 1
          == num_visual_tokens(cfg, KEPT_RATIO), f"visual tokens {n_vis}")
    rng = np.random.default_rng(SEED + 18)
    size = vcfg.image_size
    clips = [rng.integers(0, 256, size=(N_FRAMES, size, size, 3),
                          dtype=np.uint8) for _ in range(N_REQUESTS + 1)]
    prompt = " ".join(["<image>"] * N_FRAMES) + \
        "\nDescribe the video in detail."
    reqs = [mm.build_request(f"s{i}", prompt, clips[i],
                             max_new_tokens=SIGLIP_MAX_NEW, eos_ids=())
            for i in range(N_REQUESTS)]
    for req in reqs:
        n_ph = sum(x >= _PLACEHOLDER_BASE for x in req.input_ids)
        check(n_ph == N_FRAMES * n_vis, f"{req.rid}: {n_ph} visual tokens")
    P = len(reqs[0].input_ids)
    mm._visual_groups(mm.build_request("warm", prompt, clips[-1]))
    vit_times = []

    def timed_embed_fn(req):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = mm.embed_fn(req)        # raises unless it spans the prompt
        torch.cuda.synchronize()
        vit_times.append(time.perf_counter() - t1)
        return x

    L = lcfg.num_hidden_layers
    ecfg = EngineConfig(max_batch=N_REQUESTS, kv_chunk=256,
                        prefill_buckets=(1536,), decode_steps=16,
                        disable_radix_cache=True, kv_quant="int8",
                        max_seq_len=P + SIGLIP_MAX_NEW)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(llm, lcfg, ecfg, embed_fn=timed_embed_fn,
                         device=dev, seed=SEED)
    counters = [(ra.ragged_attention, "launches_int8"),
                (ra.ragged_decode_attention, "launches_int8"),
                (ra.ragged_attention, "launches_w128")] + plains
    wall, counts = serve(torch, engine, reqs, counters, SIGLIP_MAX_NEW)
    ext, dec, w128 = (counts[f"{f.__name__}.{a}"] for f, a in counters[:3])
    steps = engine._steps
    phase("serve-siglip", card=repr(card),
          config=f"siglip-so400m-14-384/L{vcfg.num_hidden_layers}"
                 f"+vicuna-7b-widths/L{L}(cut from 32)/kv-int8",
          write_s=f"{write_s:.2f}", load_s=f"{load_s:.3f}", bytes=nbytes,
          requests=N_REQUESTS, frames=N_FRAMES, kept_ratio=KEPT_RATIO,
          visual_tokens_per_frame=n_vis, prompt_tokens=P,
          vit_proj_s_per_clip=f"{float(np.mean(vit_times)):.4f}",
          extend_s=f"{engine.t_extend_s - sum(vit_times):.4f}",
          decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
          decode_steps=steps, wall_s=f"{wall:.2f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          launches=json.dumps(counts).replace(" ", ""))
    check(ext == L and w128 == L and dec == L * steps,
          f"siglip: ragged launches {counts}, steps {steps}")
    check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
          f"plain twins ran: {counts}")
    del engine
    # one clip's visual groups against the fp32 twin, under the bf16
    # pass's ToMe merges; the served groups are the bf16 pass's bits
    px = clip_normalize_device(torch.as_tensor(clips[0], device=dev)).to(
        torch.bfloat16)[None]
    err, groups = visual_twin_err(
        torch, lambda m, x: encode_visual(m, x, KEPT_RATIO),
        {"visual_encoder": vit, "projector": pj}, px, cfg,
        RoutingTape([(tome_mod, "compute_merge_indices")]))
    served = mm._visual_groups(reqs[0])[0]
    phase("siglip-vision", card=repr(card),
          groups=json.dumps(list(groups.shape)).replace(" ", ""),
          rel_err=f"{err:.3e}", tol=VISUAL_REL_TOL,
          served_bitwise=bool(torch.equal(served, groups)))
    check(tuple(groups.shape) == (1, N_FRAMES, n_vis, lcfg.hidden_size)
          and err <= VISUAL_REL_TOL and torch.equal(served, groups),
          f"SigLIP twin rel err {err}")
    del model, mm, llm, vit, pj
    gc.collect()
    torch.cuda.empty_cache()
    return ext, dec


def dpo_phase(torch, fa, dev, card, counters, plains, gemma=False):
    """train/preference.py's `make_dpo_step` at Vicuna-7B widths and
    DPO_LAYERS layers, policy and reference (a copy of the policy's
    initial weights) on the card: DPO_PAIRS unmasked pairs of DPO_SEQ
    tokens, DPO_STEPS steps with the port's Optimizer (clip → AdamW),
    twice from the same weights; the losses repeat bit for bit, the
    flash kernels' forward and backward launch, the twins do not →
    (fwd, dkv, dq) launches of the first run. gemma: google/gemma-7b's
    widths instead (GEMMA7B: head_dim 256, the D 256 kernels), one layer,
    one pair, two steps ([train-dpo-gemma])."""
    import dataclasses as dc

    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.train.preference import make_dpo_step
    from aurora_tpu_torch.train.trainer import Optimizer, TrainConfig
    pairs, steps, name = DPO_PAIRS, DPO_STEPS, "train-dpo"
    cfg = dc.replace(LlamaConfig.vicuna_7b_v15_16k(),
                     num_hidden_layers=DPO_LAYERS)
    if gemma:
        pairs, steps, name = 1, 2, "train-dpo-gemma"
        cfg = LlamaConfig(num_hidden_layers=1, **GEMMA7B)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    policy = build(LlamaModel, cfg, device=dev, dtype=torch.bfloat16,
                   generator=gen)
    init = {k: v.clone() for k, v in policy.state_dict().items()}
    ref = build(LlamaModel, cfg, device=dev, dtype=torch.bfloat16,
                generator=gen)
    ref.load_state_dict(init)
    ref.requires_grad_(False)
    rng = np.random.default_rng(SEED + 14)
    batch = {}
    for side in ("chosen", "rejected"):
        ids = rng.integers(3, cfg.vocab_size, size=(pairs, DPO_SEQ))
        labels = ids.copy()
        labels[:, :DPO_PROMPT] = -100
        batch[side + "_ids"] = torch.tensor(ids, device=dev)
        batch[side + "_labels"] = torch.tensor(labels, device=dev)
    # lr 1e-7: one AdamW step moves the log-probs of 1,536 scored tokens
    # enough that lr 1e-5 drove the loss to 4e-14 at the second step
    tcfg = TrainConfig(lr=1e-7, max_steps=10, warmup_ratio=0.0,
                       freeze_llm=False)
    runs = []
    for rep in range(2):
        policy.load_state_dict(init)
        opt = Optimizer(policy, tcfg)
        state = opt.init(policy)
        step = make_dpo_step(cfg, ref, opt, beta=0.1)
        torch.cuda.reset_peak_memory_stats()
        for obj, attr in counters + plains:
            setattr(obj, attr, 0)
        losses, times = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = step(policy, state, batch)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(np.isfinite(losses[-1]), f"dpo loss {losses[-1]}")
        counts = {f"{obj.__name__}.{attr}": getattr(obj, attr)
                  for obj, attr in counters + plains}
        runs.append((losses, counts))
        phase(name, card=repr(card), run=rep,
              config=("gemma-7b" if gemma else "vicuna-7b")
              + f"-widths/L{cfg.num_hidden_layers}/hd{cfg.head_dim}/"
                f"pairs{pairs}/seq{DPO_SEQ}/bf16/adamw/unmasked",
              step_ms=",".join(f"{t * 1e3:.1f}" for t in times),
              losses=",".join(repr(x) for x in losses),
              reward_acc=f"{m['reward_acc'].item():.3f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        fwd, dkv, dq = (counts[f"{obj.__name__}.{attr}"]
                        for obj, attr in counters)
        check(fwd > 0 and dkv > 0 and dq > 0,
              f"{name} flash launches {counts}")
        check(all(counts[f"{obj.__name__}.{attr}"] == 0
                  for obj, attr in plains), f"plain twins ran: {counts}")
    check(runs[0][0] == runs[1][0],
          f"{name} losses do not repeat: {runs[0][0]} / {runs[1][0]}")
    del policy, ref, init, batch
    gc.collect()
    torch.cuda.empty_cache()
    return tuple(runs[0][1][f"{obj.__name__}.{attr}"]
                 for obj, attr in counters)


def moe_kernel_phase(torch, engine_mod, moe, dev):
    """[kernels-moe]: the grouped-expert kernel (csrc/moe_grouped_mm.cu)
    at each family's gate/up shape (xs [N·k, D] x [E, D, F]), the rows
    routed by a random router (softmax top-k, sorted by expert), at
    MOE_TOKENS tokens, with bf16 and int8 experts: against its plain twin
    (every output within one bf16 rounding plus MOE_ABS_TOL of max
    |want|), graph and eager ms beside the twin's and torch._grouped_mm's
    on the same bf16 weights (int8 experts dequantized once, outside the
    timing; null where the call is refused), the bound from the bytes of
    the rows, the experts touched and the output, or 2·M·D·F operations,
    the plan the kernel took (`moe_plan`: decode at 4 tokens, extend at
    4 x 2048) and its share of the bound → {(family, experts, tokens):
    numbers}."""
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for fam, D, F, E, k in MOE_SHAPES:
        w16 = (torch.randn((E, D, F), generator=g, device=dev)
               * 0.02).to(torch.bfloat16)
        router = (torch.randn((D, E), generator=g, device=dev)
                  * 0.02).to(torch.bfloat16)
        q8 = engine_mod._w8_experts(moe.ExpertStack(w16))
        for experts, w, scale in (("bf16", w16, None),
                                  ("int8", q8.weight, q8.scale)):
            wl = w16 if scale is None else q8.dequantized(torch.bfloat16)
            for tokens in MOE_TOKENS:
                x = torch.randn((tokens, D), generator=g,
                                device=dev).to(torch.bfloat16)
                _, idx = moe.routing_weights(moe.dot_f32(x, router), k,
                                             "softmax_topk")
                order, offs = moe.sort_by_expert(idx, E)
                xs = x.index_select(0, order // k)
                M = xs.shape[0]

                def kernel():
                    return moe.moe_grouped_mm(xs, w, offs, scale,
                                              out_dtype=torch.bfloat16)

                def plain():
                    return moe.moe_grouped_mm_reference(
                        xs, w, offs, scale, out_dtype=torch.float32)

                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                check(bool((err <= 2.0 ** -8 * want.abs() + MOE_ABS_TOL
                            * want.abs().max()).all()),
                      f"moe_grouped_mm {fam} {experts} {tokens}: max err "
                      f"{err.max().item()}")
                lib_ms, lib_note = None, "ok"
                if hasattr(torch, "_grouped_mm"):
                    ends = offs[1:].contiguous()
                    for wb in (wl, wl.transpose(1, 2).contiguous()
                               .transpose(1, 2)):
                        try:
                            lib = torch._grouped_mm(xs, wb, offs=ends)
                            torch.cuda.synchronize()
                        except (RuntimeError, TypeError,
                                ValueError) as e:
                            lib_note = repr(str(e).splitlines()[0][:80])
                            continue
                        check(((lib.float() - want).abs().max()
                               <= 2e-2 * want.abs().max()).item(),
                              f"torch._grouped_mm {fam} disagrees")
                        lib_ms = graph_ms(lambda: torch._grouped_mm(
                            xs, wb, offs=ends))
                        lib_note = "ok"
                        break
                else:
                    lib_note = "absent"
                counts = (offs[1:] - offs[:-1]).tolist()
                touched = sum(c > 0 for c in counts)
                wbytes = touched * D * F * (1 if scale is not None else 2)
                if scale is not None:
                    wbytes += touched * F * 4
                nbytes = M * D * 2 + wbytes + M * F * 2 + (E + 1) * 4
                bound = least_ms(2.0 * M * D * F, nbytes)
                plan = moe.moe_plan(M, D, F, E, scale is not None, sms)
                r = dict(err=err.max().item(), ms=graph_ms(kernel),
                         eager_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                         library_ms=lib_ms, bound=bound, touched=touched,
                         rows=M, plan=plan.kind)
                r["pct_of_bound"] = 100.0 * bound[0] / r["ms"]
                out[(fam, experts, tokens)] = r
                phase("kernels-moe", family=fam, shape=f"{M}x{D}x{F}/E{E}",
                      experts=experts, tokens=tokens, plan=plan.kind,
                      grid="x".join(map(str, plan.grid)),
                      experts_touched=touched,
                      max_abs_err=f"{r['err']:.3e}",
                      graph_ms=f"{r['ms']:.4f}",
                      eager_ms=f"{r['eager_ms']:.4f}",
                      plain_ms=f"{r['plain_ms']:.3f}",
                      library_ms=("null" if lib_ms is None
                                  else f"{lib_ms:.4f}"),
                      library=lib_note, bound_ms=f"{bound[0]:.4f}",
                      bound_by=bound[1],
                      pct_of_bound=f"{r['pct_of_bound']:.1f}")
        del w16, q8, wl
        torch.cuda.empty_cache()
    return out


def moe_prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    plens = rng.integers(MOE_PROMPT[0], MOE_PROMPT[1] + 1, size=N_REQUESTS)
    return plens, [rng.integers(3, vocab, size=n).tolist() for n in plens]


def moe_llama(torch, engine_mod, cfg, weight_quant, dev, seed, fuse=True):
    """A MoE LlamaModel of cfg with random bf16 weights from `seed`
    (models/init.py's scheme), built a layer at a time and, for W8 / W4,
    quantized before the next (serve/engine.py build_quantized: the bf16
    model never exists whole); the streams fused unless fuse is False (a
    tensor-parallel engine cuts the model before it fuses)."""
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import (LlamaLayer, LlamaModel,
                                               default_extras, is_moe_layer)
    gen = torch.Generator(device=dev).manual_seed(seed)
    extras = default_extras(cfg)
    if weight_quant == "none":
        model = build(LlamaModel, cfg, device=dev, dtype=torch.bfloat16,
                      generator=gen)
    else:
        def layer(l):
            return build(lambda c, device, dtype: LlamaLayer(
                c, device=device, dtype=dtype, extras=extras,
                moe=is_moe_layer(c, l)), cfg, device=dev,
                dtype=torch.bfloat16, generator=gen)

        V, D = cfg.vocab_size, cfg.hidden_size
        top = {"embed_tokens": torch.randn((V, D), generator=gen,
                                           device=dev) * 0.02,
               "final_norm": torch.ones(D, device=dev),
               "lm_head.weight": torch.randn((V, D), generator=gen,
                                             device=dev) * 0.02}
        model = engine_mod.build_quantized(cfg, weight_quant, layer, top,
                                           dev, torch.bfloat16,
                                           extras=extras)
    return engine_mod.fuse_serving_weights(model) if fuse else model


def experts_touched(torch, engine_mod, moe, runner, n):
    """Distinct experts one decode step of n lanes routes to, per MoE
    layer → (mean, max): each lane's next token fed at its row's end."""
    seen = []
    real = moe.sort_by_expert

    def spy(idx, E):
        order, offs = real(idx, E)
        seen.append(offs)
        return order, offs

    dev = runner.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    pos = torch.full((n,), 8, dtype=torch.int32, device=dev)
    x = runner.model.embed_tokens[torch.full((n,), 7, device=dev)][:, None]
    with torch.no_grad(), mock.patch.object(moe, "sort_by_expert", spy):
        engine_mod._forward_rows(runner.model, runner.cfg, x, runner.rows,
                                 ids, pos, pos + 1, runner.layer_ids)
    counts = [int(((o[1:] - o[:-1]) > 0).sum()) for o in seen]
    return sum(counts) / max(len(counts), 1), max(counts, default=0)


def moe_serve_phase(torch, engine_mod, ra, qm, moe, dev, card, plains):
    """The sparse-MoE families through ServeEngine on the card:
    `[serve-mixtral-w8kv8]` (twice, bit for bit) and
    `[serve-mixtral-w4kv8]`, Mixtral-8x7B at full width and depth
    (MIXTRAL_8X7B) with random bf16 weights quantized a layer at a time,
    int8 experts through the grouped kernel, W8A8 or W4A8 attention
    projections, int8 KV; then `[serve-qwen3moe]`, Qwen3-30B-A3B's widths
    (E 128, k 8, q/k norms) at QWEN3MOE_LAYERS layers in bf16 with int8
    KV. N_REQUESTS prompts of MOE_PROMPT random ids in one wave,
    MOE_MAX_NEW greedy tokens. Each run: extend s, decode ms a step, peak
    GB, the launch counts (the ragged kernels every layer a wave and a
    step, the grouped kernel 3 a layer a wave and a step, the weight
    kernel > 0, the twins 0), the distinct experts one decode step
    touches, and the logits of a wave and a decode step against the
    engine on the plain twins → {run: launch counts}."""
    import dataclasses as dc

    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    runs = (("mixtral-w8kv8", MIXTRAL_8X7B, "int8", SEED + 21, 2),
            ("mixtral-w4kv8", MIXTRAL_8X7B, "int4", SEED + 21, 1),
            ("qwen3moe", dict(QWEN3_30B_A3B,
                              num_hidden_layers=QWEN3MOE_LAYERS),
             "none", SEED + 22, 1))
    weight_kernel = {"int8": (qm.w8a8_matmul, "w8a8_matmul",
                              qm.w8a8_matmul_plain),
                     "int4": (qm.w4a8_matmul_tiled, "w4a8_matmul_tiled",
                              qm.w4a8_matmul_tiled_plain),
                     "none": (None, None, None)}
    out = {}
    for run, fields, weight_quant, seed, repeats in runs:
        cfg = LlamaConfig(**fields)
        L = cfg.num_hidden_layers
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = moe_llama(torch, engine_mod, cfg, weight_quant, dev, seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weight_gb = sum(t.numel() * t.element_size() for t in
                        model.state_dict().values()) / 1e9
        expert_gb = sum(t.numel() * t.element_size() for n, t in
                        model.state_dict().items() if ".moe_" in n
                        and "router" not in n) / 1e9
        plens, prompts = moe_prompts(cfg.vocab_size, seed)
        wk, wname, wplain = weight_kernel[weight_quant]
        first = None
        for rep in range(repeats):
            ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=MOE_SEQ,
                                kv_chunk=256, prefill_buckets=(2048,),
                                decode_steps=16, kv_quant="int8",
                                weight_quant=weight_quant,
                                disable_radix_cache=True)
            torch.cuda.reset_peak_memory_stats()
            engine = ServeEngine(model, cfg, ecfg, device=dev, seed=SEED)
            counters = [(ra.ragged_attention, "launches_int8"),
                        (ra.ragged_decode_attention, "launches_int8"),
                        (moe.moe_grouped_mm, "launches"),
                        (moe.moe_grouped_mm, "launches_extend"),
                        (moe.moe_grouped_mm, "launches_decode")]
            if wk is not None:
                counters.append((wk, "launches"))
            counters += plains
            reqs = [Request(rid=f"m{i}", input_ids=list(p),
                            max_new_tokens=MOE_MAX_NEW, eos_ids=(),
                            logprobs=True)
                    for i, p in enumerate(prompts)]
            wall, counts = serve(torch, engine, reqs, counters, MOE_MAX_NEW)
            ext, dec, gmm, gext, gdec = (counts[f"{f.__name__}.{a}"]
                                         for f, a in counters[:5])
            wl = counts[f"{wk.__name__}.launches"] if wk is not None else 0
            steps = engine._steps
            name = run if rep == 0 else run + "-again"
            mean_t, max_t = experts_touched(torch, engine_mod, moe,
                                            engine.runner, N_REQUESTS)
            phase("serve-" + name, card=repr(card),
                  config=f"{run.split('-')[0]}/L{L}/D{cfg.hidden_size}"
                         f"/E{cfg.num_experts}/k{cfg.num_experts_per_tok}"
                         f"/F{cfg.intermediate_size}/weights-{weight_quant}"
                         f"/experts-{'bf16' if weight_quant == 'none' else 'int8'}"
                         f"/kv-int8",
                  requests=N_REQUESTS,
                  prompt_tokens=",".join(str(int(n)) for n in plens),
                  new_tokens=MOE_MAX_NEW, build_s=f"{build_s:.1f}",
                  weight_gb=f"{weight_gb:.2f}", expert_gb=f"{expert_gb:.2f}",
                  extend_s=f"{engine.t_extend_s:.4f}",
                  decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
                  decode_steps=steps,
                  experts_touched_per_layer_step=f"{mean_t:.2f}",
                  experts_touched_max=max_t,
                  tokens_per_s=f"{N_REQUESTS * MOE_MAX_NEW / wall:.1f}",
                  wall_s=f"{wall:.2f}",
                  peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                  launches=json.dumps(counts).replace(" ", ""))
            check(ext == L and dec == L * steps,
                  f"{name}: ragged launches {counts}, steps {steps}")
            check(gmm == 3 * L * (1 + steps),
                  f"{name}: grouped launches {gmm}, steps {steps}")
            # the wave on the extend plan, every decode step on the decode
            # plan
            check(gext == 3 * L and gdec == 3 * L * steps,
                  f"{name}: grouped plans {gext} / {gdec}, steps {steps}")
            check(wk is None or wl > 0, f"{name}: {wname} launches {wl}")
            check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
                  f"plain twins ran: {counts}")
            got = [(r.output_ids, list(r.output_logprobs)) for r in reqs]
            if rep == 0:
                first = got
                plain = {"ragged_attention": ra.ragged_attention_plain,
                         "ragged_decode_attention":
                             ra.ragged_decode_attention_plain,
                         "moe_grouped_mm": moe.moe_grouped_mm_reference}
                if wk is not None:
                    plain[wname] = wplain
                logits_check(torch, engine_mod, engine.runner,
                             lambda r: model.embed_tokens[
                                 torch.tensor(r.input_ids, device=dev)],
                             reqs, MOE_LOGITS_TOL[weight_quant],
                             "logits-" + run, plain, decode=True,
                             decode_tol=MOE_LOGITS_TOL[weight_quant],
                             reason=MOE_LOGITS_REASON,
                             replay=[(moe, "routing_weights")])
            else:
                check(got == first, f"two {run} runs differ")
                phase(f"serve-{run}-repeat", bitwise_equal=True,
                      tokens=N_REQUESTS * MOE_MAX_NEW)
            out[name] = (ext, dec, gmm, wl, gext, gdec)
            del engine
            gc.collect()
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mla_serve_phase(torch, engine_mod, ra, moe, dev, card, plains):
    """`[serve-deepseek-v2-lite]`: DeepSeek-V2-Lite at full width and depth
    (its config.json, YaRN included, through deepseek_v2_config_from_hf),
    random bf16 weights from the seed, through deepseek_serving_params
    and ServeEngine over latent rows with the radix cache on: N_REQUESTS
    prompts of MOE_PROMPT ids, MOE_MAX_NEW greedy tokens, twice on fresh
    engines (bit for bit); then on the second engine the same prompts
    plus 16 ids, which hit the cached prefixes. Launch counts (the
    grouped kernel 4 a MoE layer a wave and a step: gate, up and the
    down product's two parts; the ragged kernels none), extend s, decode
    ms a step, peak GB, the logits of a wave and a decode step against the
    engine on the plain twin, and one MoE layer's fp32 expert path on the
    kernel against the fp32 twin (`ds_moe_dense`) → launch counts."""
    from aurora_tpu_torch.models.deepseek_v2 import (
        deepseek_v2_config_from_hf, init_deepseek_v2)
    from aurora_tpu_torch.serve import mla
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    check(not torch.backends.cuda.matmul.allow_tf32,
          "MLA's fp32 einsums need TF32 off")
    d = deepseek_v2_config_from_hf(DEEPSEEK_V2_LITE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = mla.deepseek_serving_params(
        init_deepseek_v2(d, gen, dev, torch.bfloat16), d)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    L = cfg.num_hidden_layers
    n_moe = L - cfg.mla_first_k_dense
    weight_gb = sum(t.numel() * t.element_size()
                    for t in model.state_dict().values()) / 1e9
    plens, prompts = moe_prompts(cfg.vocab_size, SEED + 23)
    counters = [(ra.ragged_attention, "launches"),
                (ra.ragged_decode_attention, "launches"),
                (moe.moe_grouped_mm, "launches"),
                (moe.moe_grouped_mm, "launches_extend"),
                (moe.moe_grouped_mm, "launches_decode")] + plains
    first, out = None, {}
    for rep in range(2):
        ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=MOE_SEQ,
                            kv_chunk=256, prefill_buckets=(2048,),
                            decode_steps=16, num_slots=4 * MOE_SEQ + 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, cfg, ecfg, device=dev, seed=SEED)
        reqs = [Request(rid=f"d{i}", input_ids=list(p),
                        max_new_tokens=MOE_MAX_NEW, eos_ids=(),
                        logprobs=True)
                for i, p in enumerate(prompts)]
        wall, counts = serve(torch, engine, reqs, counters, MOE_MAX_NEW)
        ext, dec, gmm, gext, gdec = (counts[f"{f.__name__}.{a}"]
                                     for f, a in counters[:5])
        steps = engine._steps
        name = "serve-deepseek-v2-lite" + ("-again" if rep else "")
        phase(name, card=repr(card),
              config=f"deepseek-v2-lite/L{L}/dense{cfg.mla_first_k_dense}"
                     f"/E{cfg.num_experts}/k{cfg.num_experts_per_tok}"
                     f"/rank{cfg.mla_kv_lora_rank}"
                     f"/rope{cfg.mla_qk_rope_head_dim}/yarn"
                     f"{cfg.rope_attention_scaling:.4f}/bf16-latents",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=MOE_MAX_NEW, build_s=f"{build_s:.1f}",
              weight_gb=f"{weight_gb:.2f}",
              latent_bytes_per_token_layer=engine_mod.kv_bytes_per_token_layer(
                  cfg, "none", torch.bfloat16),
              extend_s=f"{engine.t_extend_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps, radix=engine.radix_impl,
              tokens_per_s=f"{N_REQUESTS * MOE_MAX_NEW / wall:.1f}",
              wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              launches=json.dumps(counts).replace(" ", ""))
        check(ext == 0 and dec == 0, f"MLA ran ragged kernels: {counts}")
        check(gmm == 4 * n_moe * (1 + steps),
              f"grouped launches {gmm}, steps {steps}")
        check(gext == 4 * n_moe and gdec == 4 * n_moe * steps,
              f"grouped plans {gext} / {gdec}, steps {steps}")
        check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
              f"plain twins ran: {counts}")
        got = [(r.output_ids, list(r.output_logprobs)) for r in reqs]
        if rep == 0:
            first = got
            out["deepseek"] = (gmm, gext, gdec)
            logits_check(torch, engine_mod, engine.runner,
                         lambda r: model.embed_tokens[
                             torch.tensor(r.input_ids, device=dev)],
                         reqs, MOE_LOGITS_TOL["none"],
                         "logits-deepseek-v2-lite",
                         {"moe_grouped_mm": moe.moe_grouped_mm_reference},
                         decode=True, decode_tol=MOE_LOGITS_TOL["none"],
                         reason=MOE_LOGITS_REASON,
                         replay=[(mla, "_routing")])
            del engine
            gc.collect()
            continue
        check(got == first, "two DeepSeek-V2-Lite runs differ")
        phase("serve-deepseek-v2-lite-repeat", bitwise_equal=True,
              tokens=N_REQUESTS * MOE_MAX_NEW)
        # a second wave over the cached prompts
        hits = [Request(rid=f"h{i}", input_ids=list(p) + list(range(
            5, 21)), max_new_tokens=16, eos_ids=())
            for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        wall2, counts2 = serve(torch, engine, hits, counters, 16)
        mem = engine.check_memory()
        phase("serve-deepseek-v2-lite-prefix",
              cached_tokens=",".join(str(r.n_cached) for r in hits),
              extend_s=f"{engine.t_extend_s:.4f}", wall_s=f"{wall2:.2f}",
              leaked=mem["leaked"])
        check(all(r.n_cached > 0 for r in hits),
              f"prefix hits {[r.n_cached for r in hits]}")
        check(mem["leaked"] == 0, f"leaked slots {mem}")
        out["deepseek-prefix"] = counts2["moe_grouped_mm.launches"]
        del engine
        gc.collect()
    # one MoE layer's fp32 expert path: the kernel's two-part down product
    # against the reference's fp32 twin
    lp = model.layers[cfg.mla_first_k_dense]
    x = (torch.randn((N_REQUESTS, 512, cfg.hidden_size), generator=gen,
                     device=dev)).to(torch.bfloat16)
    with torch.no_grad():
        got = mla.ds_moe_grouped(cfg, lp, x).float()
        want = mla.ds_moe_dense(cfg, lp, x).float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    phase("mla-moe-fp32", rows=N_REQUESTS * 512, rel_err=f"{rel:.3e}",
          tol=MLA_MOE_TOL)
    check(rel <= MLA_MOE_TOL, f"ds_moe grouped vs fp32 twin {rel}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_entries(kres, serve_counts, mla_counts):
    """The grouped kernel's entries of the kernels line, one per plan,
    family and expert type: the decode plan at 4 tokens, the extend plan
    at 4 x 2048 (ms, plain_ms, library_ms: graph, eager, graph); launches
    of that plan from that family's runs with those experts."""
    mixtral = [c for r, c in serve_counts.items() if r.startswith("mixtral")]
    launches = {("mixtral-8x7b", "int8"): (sum(c[4] for c in mixtral),
                                           sum(c[5] for c in mixtral)),
                ("qwen3-30b-a3b", "bf16"): serve_counts["qwen3moe"][4:6],
                ("deepseek-v2-lite", "bf16"): mla_counts["deepseek"][1:3]}
    out = []
    for fam, D, F, E, k in MOE_SHAPES:
        for experts in ("bf16", "int8"):
            for tokens in MOE_TOKENS:
                r = kres[(fam, experts, tokens)]
                n = launches.get((fam, experts), (0, 0))
                out.append({
                    "name": f"moe_grouped_mm[{r['plan']},{experts},{fam}]",
                    "route": "cuda",
                    "source": "aurora_tpu_torch/csrc/moe_grouped_mm.cu",
                    "replaces": "aurora_tpu/ops/moe.py:148",
                    "launches": n[r["plan"] == "decode"],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": r["library_ms"],
                    "eager_ms": r["eager_ms"], "rows": r["rows"],
                    "tokens": tokens, "experts_touched": r["touched"],
                    "pct_of_bound": r["pct_of_bound"],
                    "shape": f"D{D}/F{F}/E{E}/k{k}"})
    return out


class _Spy:
    """A kernel wrapper's stand-in that records the shapes of some of its
    arguments; every other attribute (its launch counters, its name) is
    the wrapper's own, so the counts it keeps still rise."""

    def __init__(self, fn, idx, seen):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_idx", idx)
        object.__setattr__(self, "_seen", seen)

    def __call__(self, *a, **k):
        self._seen.add(tuple(tuple(a[i].shape) for i in self._idx))
        return self._fn(*a, **k)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def shape_spy(targets):
    """Patch each (module, name, argument indexes) to record the shapes of
    those arguments at every call → (the patch context, {name: set of
    shape tuples})."""
    seen = {name: set() for _, name, _ in targets}
    stack = contextlib.ExitStack()
    for mod, name, idx in targets:
        stack.enter_context(mock.patch.object(
            mod, name, _Spy(getattr(mod, name), idx, seen[name])))
    return stack, seen


def wave_logits(torch, runner, embed, reqs):
    """One extend wave's logits [n, V] of `reqs` (each request's prompt
    embeds `embed(r)` in a lane of the smallest bucket that holds them
    all), written into rows 0..n-1."""
    plens = [len(r.input_ids) for r in reqs]
    T = min(b for b in runner.ecfg.prefill_buckets if b >= max(plens))
    embeds = torch.zeros((len(reqs), T, runner.cfg.hidden_size),
                         dtype=runner.ecfg.kv_dtype, device=runner.device)
    for i, r in enumerate(reqs):
        embeds[i, :plens[i]] = embed(r)
    n = len(reqs)
    return runner.extend(embeds, np.arange(n, dtype=np.int32),
                         np.zeros(n, np.int32), np.asarray(plens, np.int32))


def shapes_field(seen):
    return json.dumps({k: sorted(v) for k, v in seen.items()}).replace(
        " ", "")


def forced_decode(torch, engine_mod, runner, reqs, tokens, steps):
    """`steps` decode forwards of every lane after `wave_logits` filled
    its rows (lane i holds reqs[i]'s prompt), lane i fed tokens[i][j] at
    step j, so that two runs of a comparison read the same tokens →
    logits [steps, n, V] in fp32."""
    dev = runner.device
    ids = torch.arange(len(reqs), dtype=torch.int32, device=dev)
    pos = torch.tensor([len(r.input_ids) for r in reqs], dtype=torch.int32,
                       device=dev)
    out = []
    with torch.no_grad():
        for j in range(steps):
            tok = torch.tensor([t[j] for t in tokens], device=dev)
            h = engine_mod._forward_rows(
                runner.model, runner.cfg,
                runner.model.embed_tokens[tok][:, None], runner.rows, ids,
                pos, pos + 1, runner.layer_ids,
                kv_maxq=runner.ecfg.kv_maxq, tp=runner.tp)
            out.append(engine_mod._lm_head(runner.model, h).float())
            pos = pos + 1
    return torch.stack(out)


def step_rel(got, want):
    """The worst step's max |got - want| over max |want| ([steps, n, V])."""
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def dropped_shard(when):
    """TPGroup.all_reduce with the last shard's partial zeroed in the sums
    where when(call index, parts) holds: a planted fault that a tp
    check's bound must see."""
    from aurora_tpu_torch.serve import tp as tp_mod
    real, calls = tp_mod.TPGroup.all_reduce, iter(range(1 << 62))

    def faulty(self, parts):
        if when(next(calls), parts):
            parts = [*parts[:-1], parts[-1].new_zeros(parts[-1].shape)]
        return real(self, parts)
    return mock.patch.object(tp_mod.TPGroup, "all_reduce", faulty)


def contract_held(flips, gap, lp):
    """The near-tie contract of tests/test_torch_engine_quant.py on what
    `near_tie(strict=False)` counted: every compared step's top-1 logprob
    within NEAR_TIE / 2, a flip only on a top-2 gap below NEAR_TIE."""
    return lp <= NEAR_TIE / 2 and (not flips or gap < NEAR_TIE)


def tp_runs(torch, engine_mod, ra, qm, mm, llm, llm_cfg, clips, prompt, P,
            dev, card, plains, failures):
    """[serve-tp2] / [serve-tp2-w8kv8]: AuroraCap-7B (the [serve] phases'
    weights) on EngineConfig(tp=2) with both shards on this card, bf16
    and W8 + int8 KV, against the tp 1 engine in the same call: 4 clips ×
    8 frames, TP_MAX_NEW greedy tokens with logprobs: a wave's logits
    against tp 1's and the kernels' against the twins at the [serve]
    phases' bounds, TP_FORCED_STEPS decode forwards fed tp 1's tokens
    against tp 1's (`forced_decode`) at LOGITS_DECODE_REL_TOL, which the
    same forwards with the second shard's partials dropped must exceed,
    the tokens' near-tie contract against tp 1's reported, launches a
    wave and a step twice tp 1's at the shards' shapes (half the heads,
    half the W8 rows or inputs). A broken bound is appended to
    `failures` (checked once every parallel phase has printed) → {run:
    launch counts}."""
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    L = llm_cfg.num_hidden_layers
    reqs_of = {}

    def requests(tag):
        return [mm.build_request(f"{tag}{i}", prompt, clips[i],
                                 max_new_tokens=TP_MAX_NEW, eos_ids=(),
                                 logprobs=True)
                for i in range(N_REQUESTS)]

    for r in requests("warm"):      # the ViT once: both runs fuse cached
        mm._visual_groups(r)        # visual groups
    runs = (("bf16", dict(), [(ra.ragged_attention, "launches"),
                              (ra.ragged_decode_attention, "launches")],
             LOGITS_REL_TOL, {"ragged_attention": ra.ragged_attention_plain}),
            ("w8kv8", dict(weight_quant="int8", kv_quant="int8"),
             [(ra.ragged_attention, "launches_int8"),
              (ra.ragged_decode_attention, "launches_int8"),
              (qm.w8a8_matmul, "launches")], LOGITS_W8_REL_TOL,
             {"ragged_attention": ra.ragged_attention_plain,
              "w8a8_matmul": qm.w8a8_matmul_plain}))
    out = {}
    for run, quant, counters, tol, plain in runs:
        res, logits, forced = {}, {}, {}
        for tp in (1, 2):
            ecfg = EngineConfig(max_batch=N_REQUESTS, kv_chunk=256,
                                prefill_buckets=(1536,), decode_steps=16,
                                disable_radix_cache=True,
                                max_seq_len=P + TP_MAX_NEW, tp=tp, **quant)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine = ServeEngine(llm, llm_cfg, ecfg, embed_fn=mm.embed_fn,
                                 device=dev, seed=SEED,
                                 devices=[dev] * tp)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            check(tp == 1 or len(engine.runner.group.models) == tp,
                  f"{run}: tp {tp} engine without its shards")
            reqs = requests(f"tp{tp}-")
            spy, seen = shape_spy(
                [(engine_mod, "ragged_attention", (0, 1)),
                 (engine_mod, "ragged_decode_attention", (0, 3)),
                 (engine_mod, "w8a8_matmul", (0, 2))])
            with spy:
                wall, counts = serve(torch, engine, reqs,
                                     counters + plains, TP_MAX_NEW)
            steps = engine._steps
            res[tp] = dict(
                done={r.rid.split("-", 1)[1]: r for r in reqs},
                counts=counts, steps=steps,
                extend_s=engine.t_extend_s,
                decode_ms=engine.t_decode_s / steps * 1e3)
            phase(f"serve-tp{tp}-{run}" if tp == 1 else
                  ("serve-tp2" if run == "bf16" else "serve-tp2-" + run),
                  card=repr(card), devices=f"[{dev}]x{tp}",
                  config=f"auroracap-7b/L{L}/weights-{quant.get('weight_quant', 'bf16')}"
                         f"/kv-{quant.get('kv_quant', 'bf16')}/tp{tp}",
                  requests=N_REQUESTS, prompt_tokens=P,
                  new_tokens=TP_MAX_NEW, init_s=f"{init_s:.2f}",
                  extend_s_per_wave=f"{engine.t_extend_s:.4f}",
                  decode_ms_per_step=f"{res[tp]['decode_ms']:.3f}",
                  decode_steps=steps, wall_s=f"{wall:.2f}",
                  peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                  launches=json.dumps(counts).replace(" ", ""),
                  shapes=shapes_field(seen))
            check(all(counts[f"{f.__name__}.{a}"] == 0 for f, a in plains),
                  f"{run} tp {tp}: plain twins ran: {counts}")
            ext, dec = (counts[f"{f.__name__}.{a}"] for f, a in counters[:2])
            check(ext == tp * L and dec == tp * L * steps,
                  f"{run} tp {tp}: ragged launches {ext} / {dec}, {steps} "
                  "steps")
            q_heads = {s[0][2] for s in seen["ragged_attention"]}
            kv_heads = {s[1][2] for s in seen["ragged_attention"]}
            check(q_heads == {llm_cfg.num_attention_heads // tp}
                  and kv_heads == {llm_cfg.num_key_value_heads // tp},
                  f"{run} tp {tp}: extend at heads {q_heads} / {kv_heads}")
            if quant:
                w8 = counts["w8a8_matmul.launches"]
                check(w8 == 4 * tp * L * steps,
                      f"{run} tp {tp}: {w8} W8A8 launches, {steps} steps")
                D, I = llm_cfg.hidden_size, llm_cfg.intermediate_size
                H, Hkv = (llm_cfg.num_attention_heads,
                          llm_cfg.num_key_value_heads)
                hd = llm_cfg.head_dim
                want = {((H + 2 * Hkv) * hd // tp, D), (D, H * hd // tp),
                        (2 * I // tp, D), (D, I // tp)}
                got = {s[1] for s in seen["w8a8_matmul"]}
                check(got == want, f"{run} tp {tp}: W8A8 weights {got}")
            logits[tp] = wave_logits(torch, engine.runner, mm.embed_fn,
                                     reqs)
            fed = [res[1]["done"][str(i)].output_ids
                   for i in range(N_REQUESTS)]
            forced[tp] = forced_decode(torch, engine_mod, engine.runner,
                                       reqs, fed, TP_FORCED_STEPS)
            if tp == 2:
                # the planted fault: the decode forwards without the
                # second shard's partials (both sums at T == 1); each
                # step rewrites the K/V its position held
                with dropped_shard(lambda i, parts: parts[0].shape[1] == 1):
                    planted = forced_decode(torch, engine_mod, engine.runner,
                                            reqs, fed, TP_FORCED_STEPS)
                logits_check(torch, engine_mod, engine.runner, mm.embed_fn,
                             reqs, tol, f"logits-tp2-{run}", plain)
            del engine
            gc.collect()
        flips, gap, lp = near_tie(res[2]["done"], res[1]["done"],
                                  strict=False)
        held = contract_held(flips, gap, lp)
        rel = ((logits[2] - logits[1]).abs().max()
               / logits[1].abs().max()).item()
        # tp 2 rounds where tp 1 does not (the shards' products, their
        # fp32 sum; with W8 each shard's own activation codes of o / down,
        # as the reference's shard_map body has them), and random bf16
        # layers amplify a single rounding: the same drift shows between
        # two engines that share all code at two batch shapes
        # ([serve-dp2]'s batch8_*). So the logits of a wave are held at
        # the [serve] phases' bound, and the tokens' near-tie contract is
        # reported
        agree = int((logits[2].argmax(-1) == logits[1].argmax(-1)).sum())
        dec_rel = step_rel(forced[2], forced[1])
        dec_planted = step_rel(planted, forced[1])
        dec_agree = int((forced[2].argmax(-1) == forced[1].argmax(-1)).sum())
        if rel > tol:
            failures.append(f"tp2 vs tp1 {run}: wave logits rel {rel}")
        if not dec_rel <= LOGITS_DECODE_REL_TOL < dec_planted:
            failures.append(f"tp2 vs tp1 {run}: forced decode rel {dec_rel}"
                            f", with a dropped shard {dec_planted} (bound "
                            f"{LOGITS_DECODE_REL_TOL})")
        phase(f"tp2-vs-tp1-{run}", card=repr(card),
              wave_logits_rel_err=f"{rel:.3e}", tol=tol,
              wave_argmax_agree=f"{agree}/{N_REQUESTS}",
              forced_decode_steps=TP_FORCED_STEPS,
              forced_decode_rel_err=f"{dec_rel:.3e}",
              forced_decode_tol=LOGITS_DECODE_REL_TOL,
              forced_decode_argmax_agree=f"{dec_agree}/"
                                         f"{TP_FORCED_STEPS * N_REQUESTS}",
              planted_dropped_shard_rel_err=f"{dec_planted:.3e}",
              token_contract_held=held, flips=flips,
              flip_gap=f"{gap:.3e}", worst_top1_logprob=f"{lp:.3e}",
              near_tie=NEAR_TIE,
              extend_s_tp1=f"{res[1]['extend_s']:.4f}",
              extend_s_tp2=f"{res[2]['extend_s']:.4f}",
              decode_ms_tp1=f"{res[1]['decode_ms']:.3f}",
              decode_ms_tp2=f"{res[2]['decode_ms']:.3f}")
        out[run] = res[2]["counts"]
    return out


def tp_mixtral_phase(torch, engine_mod, ra, qm, moe, dev, card, plains,
                     failures):
    """[serve-tp2-mixtral]: Mixtral-8x7B at full width, TP_MIXTRAL_LAYERS
    of its 32 layers, W8 + int8 KV (int8 experts through the grouped
    kernel at half the MLP width, N = F/2 = 7,168), tp 2 with both shards
    on this card against tp 1 on the same weights: N_REQUESTS prompts of
    MOE_PROMPT ids, MOE_MAX_NEW tokens; one wave's logits and
    TP_FORCED_STEPS fed decode forwards of tp 2 against tp 1's with tp
    1's routing replayed into both shards (a near-tie router would route
    the two apart; `RoutingTape`), the wave at TP_MIXTRAL_TOL, which the
    wave without the second shard's MLP partials must exceed, the
    decode at LOGITS_DECODE_REL_TOL; the tokens' matched prefix reported
    → launch counts. A broken bound is appended to `failures`."""
    from aurora_tpu_torch.models.llama import LlamaConfig
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    cfg = LlamaConfig(**dict(MIXTRAL_8X7B,
                             num_hidden_layers=TP_MIXTRAL_LAYERS))
    L, F_ = cfg.num_hidden_layers, cfg.intermediate_size
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = moe_llama(torch, engine_mod, cfg, "int8", dev, SEED + 21,
                      fuse=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plens, prompts = moe_prompts(cfg.vocab_size, SEED + 21)
    counters = [(ra.ragged_attention, "launches_int8"),
                (ra.ragged_decode_attention, "launches_int8"),
                (moe.moe_grouped_mm, "launches"),
                (qm.w8a8_matmul, "launches")] + plains
    res, runners = {}, {}
    for tp in (1, 2):
        ecfg = EngineConfig(max_batch=N_REQUESTS, max_seq_len=MOE_SEQ,
                            kv_chunk=256, prefill_buckets=(2048,),
                            decode_steps=16, kv_quant="int8",
                            weight_quant="int8", disable_radix_cache=True,
                            tp=tp)
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, cfg, ecfg, device=dev, seed=SEED,
                             devices=[dev] * tp)
        reqs = [Request(rid=f"m{i}", input_ids=list(p),
                        max_new_tokens=MOE_MAX_NEW, eos_ids=(),
                        logprobs=True) for i, p in enumerate(prompts)]
        spy, seen = shape_spy([(moe, "moe_grouped_mm", (0, 1))])
        with spy:
            wall, counts = serve(torch, engine, reqs, counters, MOE_MAX_NEW)
        steps = engine._steps
        ext, dec, gmm, w8 = (counts[f"{f.__name__}.{a}"]
                             for f, a in counters[:4])
        widths = sorted({s[1][2] for s in seen["moe_grouped_mm"]})
        phase("serve-tp2-mixtral" if tp == 2 else "serve-tp1-mixtral",
              card=repr(card), devices=f"[{dev}]x{tp}",
              config=f"mixtral-8x7b/L{L}/weights-int8/experts-int8/kv-int8"
                     f"/tp{tp}",
              requests=N_REQUESTS,
              prompt_tokens=",".join(str(int(n)) for n in plens),
              new_tokens=MOE_MAX_NEW, build_s=f"{build_s:.1f}",
              extend_s=f"{engine.t_extend_s:.4f}",
              decode_ms_per_step=f"{engine.t_decode_s / steps * 1e3:.3f}",
              decode_steps=steps, wall_s=f"{wall:.2f}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              grouped_n=widths, launches=json.dumps(counts).replace(" ", ""),
              shapes=shapes_field(seen))
        check(ext == tp * L and dec == tp * L * steps,
              f"mixtral tp {tp}: ragged launches {counts}")
        check(gmm == 3 * tp * L * (1 + steps),
              f"mixtral tp {tp}: grouped launches {gmm}, {steps} steps")
        check(w8 > 0 and all(counts[f"{f.__name__}.{a}"] == 0
                             for f, a in plains),
              f"mixtral tp {tp}: {counts}")
        check(widths == sorted({F_ // tp, cfg.hidden_size}),
              f"mixtral tp {tp}: grouped products of widths {widths}")
        res[tp] = {r.rid: r for r in reqs}
        runners[tp] = engine.runner
        del engine
    # one wave of both runners: tp 1 records its routing, both shards of
    # tp 2 replay it (each shard routes its own copy of the layer's input)
    reqs = list(res[1].values())

    def embed(r):
        return model.embed_tokens[torch.tensor(r.input_ids, device=dev)]

    fed = [res[1][r.rid].output_ids for r in reqs]

    def wave_and_decode(runner):
        return (wave_logits(torch, runner, embed, reqs),
                forced_decode(torch, engine_mod, runner, reqs, fed,
                              TP_FORCED_STEPS))

    tape = RoutingTape([(moe, "routing_weights")])
    with tape.patched(False):
        want, want_dec = wave_and_decode(runners[1])
    tape.tape = [t for t in tape.tape for _ in range(2)]
    with tape.patched(True):
        got, got_dec = wave_and_decode(runners[2])
    torch.cuda.synchronize()
    check(tape.at == len(tape.tape), f"routing replayed {tape.at} of "
                                     f"{len(tape.tape)}")
    # the planted fault: the wave without the second shard's MLP partial
    # (each layer's second sum)
    with tape.patched(True), dropped_shard(lambda i, parts: i % 2 == 1):
        planted = wave_logits(torch, runners[2], embed, reqs)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    rel_planted = ((planted - want).abs().max() / want.abs().max()).item()
    dec_rel = step_rel(got_dec, want_dec)
    match, dlp = matched_prefix(res[2], res[1])
    phase("tp2-vs-tp1-mixtral", card=repr(card), logits_rel_err=f"{rel:.3e}",
          tol=TP_MIXTRAL_TOL,
          argmax_agree=f"{int((got.argmax(-1) == want.argmax(-1)).sum())}"
                       f"/{N_REQUESTS}",
          planted_dropped_mlp_partial_rel_err=f"{rel_planted:.3e}",
          forced_decode_steps=TP_FORCED_STEPS,
          forced_decode_rel_err=f"{dec_rel:.3e}",
          forced_decode_tol=LOGITS_DECODE_REL_TOL,
          tokens_matched_prefix=f"{match:.3f}", prefix_dlogprob=f"{dlp:.3e}",
          reason=repr(MOE_LOGITS_REASON))
    check(bool(torch.isfinite(got).all()), "mixtral tp 2 logits not finite")
    if not rel <= TP_MIXTRAL_TOL < rel_planted:
        failures.append(f"mixtral tp2 vs tp1: wave logits rel {rel}, with "
                        f"a dropped MLP partial {rel_planted} (bound "
                        f"{TP_MIXTRAL_TOL})")
    if dec_rel > LOGITS_DECODE_REL_TOL:
        failures.append(f"mixtral tp2 vs tp1: forced decode rel {dec_rel}")
    del runners, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dp_phase(torch, mm, llm, llm_cfg, clips, prompt, P, dev, card,
             kernels, plains, failures):
    """[serve-dp2]: MultiReplicaController with two AuroraCap-7B bf16
    replicas on this card (one set of weights, two sets of KV rows and
    radix pools), DP_REQUESTS clips, shortest_queue then round_robin,
    TP_MAX_NEW tokens: every replica gets work, every request is
    answered, each replica's tokens and logprobs equal those of one
    engine serving the same requests in the same order (bit for bit),
    no slot leaks, flush_cache leaves 0. Beside them one engine of batch
    DP_REQUESTS serves all of them: its tokens/s, and how far its tokens
    drift from the replicas' (the same code at another batch shape)
    → {dispatch: launch counts}."""
    from aurora_tpu_torch.serve.controller import MultiReplicaController
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine

    def ecfg(batch):
        return EngineConfig(max_batch=batch, kv_chunk=256,
                            prefill_buckets=(1536,), decode_steps=16,
                            num_slots=DP_SLOTS, max_seq_len=P + TP_MAX_NEW)

    def requests(tag, which=range(DP_REQUESTS)):
        return [mm.build_request(f"{tag}{i}", prompt, clips[i],
                                 max_new_tokens=TP_MAX_NEW, eos_ids=(),
                                 logprobs=True)
                for i in which]

    def tokens(done):
        return {r.rid.split("-", 1)[1]: (r.output_ids, r.output_logprobs)
                for r in done}

    for r in requests("warm"):
        mm._visual_groups(r)
    one = ServeEngine(llm, llm_cfg, ecfg(DP_REQUESTS), embed_fn=mm.embed_fn,
                      device=dev, seed=SEED)
    reqs = requests("one-")
    one_wall, _ = serve(torch, one, reqs, kernels + plains, TP_MAX_NEW)
    batch8 = {r.rid.split("-", 1)[1]: r for r in reqs}
    del one
    gc.collect()
    alone = {}      # a replica's requests → one engine's answers to them
    out = {}
    for dispatch in ("shortest_queue", "round_robin"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctl = MultiReplicaController(llm, llm_cfg, ecfg(N_REQUESTS),
                                     devices=[dev, dev], dispatch=dispatch,
                                     embed_fn=mm.embed_fn, seed=SEED)
        check(all(e.runner.model is llm for e in ctl.engines),
              "replicas on one card must share the weights")
        reqs = requests(f"{dispatch}-")
        for r in reqs:
            ctl.add_request(r)
        groups = [tuple(int(r.rid.split("-", 1)[1]) for r in e.sched.waiting)
                  for e in ctl.engines]
        check(all(groups), f"{dispatch}: replicas got {groups}")
        for obj, attr in kernels + plains:
            setattr(obj, attr, 0)
        t0 = time.perf_counter()
        done = []
        while ctl.has_work():
            done.extend(ctl.step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {f"{o.__name__}.{a}": getattr(o, a)
                  for o, a in kernels + plains}
        check(len(done) == DP_REQUESTS and all(
            len(r.output_ids) == TP_MAX_NEW and r.error is None
            for r in done), f"{dispatch}: {len(done)} answered")
        mem = ctl.check_memory()
        flushed = ctl.flush_cache()
        del ctl
        gc.collect()
        got = tokens(done)
        for grp in groups:
            if grp not in alone:
                eng = ServeEngine(llm, llm_cfg, ecfg(N_REQUESTS),
                                  embed_fn=mm.embed_fn, device=dev,
                                  seed=SEED)
                ref = requests("alone-", grp)
                serve(torch, eng, ref, [], TP_MAX_NEW)
                alone[grp] = tokens(ref)
                del eng
            same = all(got[str(i)] == alone[grp][str(i)] for i in grp)
            if not same:
                failures.append(f"dp2 {dispatch}: replica of {grp} differs "
                                "from one engine on its requests")
        flips, gap, lp = near_tie({k: r for k, r in zip(
            (r.rid.split("-", 1)[1] for r in done), done)}, batch8,
            strict=False)
        phase("serve-dp2" + ("" if dispatch == "shortest_queue"
                             else "-round-robin"),
              card=repr(card), devices=f"[{dev}]x2", dispatch=dispatch,
              requests=DP_REQUESTS, per_replica=[len(g) for g in groups],
              replica_equals_one_engine=all(
                  got[str(i)] == alone[g][str(i)]
                  for g in groups for i in g),
              prompt_tokens=P, new_tokens=TP_MAX_NEW, wall_s=f"{wall:.2f}",
              tokens_per_s=f"{DP_REQUESTS * TP_MAX_NEW / wall:.1f}",
              batch8_tokens_per_s=f"{DP_REQUESTS * TP_MAX_NEW / one_wall:.1f}",
              batch8_flips=flips, batch8_worst_top1_logprob=f"{lp:.3e}",
              peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
              leaked=mem["leaked"], cached_after_flush=flushed,
              launches=json.dumps(counts).replace(" ", ""))
        check(mem["leaked"] == 0 and flushed == 0, f"{dispatch}: {mem}, "
                                                   f"{flushed} cached")
        check(all(counts[f"{o.__name__}.{a}"] > 0 for o, a in kernels)
              and all(counts[f"{o.__name__}.{a}"] == 0 for o, a in plains),
              f"{dispatch}: {counts}")
        out[dispatch] = counts
    return out


def export_phase(torch, model, dev, card):
    """[export]: the AuroraCap-7B weights at full width with EXPORT_LAYERS
    LLM layers (the first of the [serve] model's, shared), written by
    models/export.py in the xtuner and huggingface layouts in bf16 and
    loaded back by load_auroracap_dir / load_llava_hf_dir onto the card:
    every parameter bit for bit (Vicuna's 32,000 rows are a multiple of
    64: nothing is padded). GB written, write s, load s."""
    from aurora_tpu_torch.models import export
    from aurora_tpu_torch.models.aurora import AuroraModel
    from aurora_tpu_torch.models.convert import (load_auroracap_dir,
                                                 load_llava_hf_dir)
    from aurora_tpu_torch.models.llama import LlamaModel
    cfg = dataclasses.replace(model.cfg, llm=dataclasses.replace(
        model.cfg.llm, num_hidden_layers=EXPORT_LAYERS))
    sub = AuroraModel(cfg, device="meta")
    sub.visual_encoder, sub.projector = model.visual_encoder, model.projector
    sub.llm = LlamaModel(cfg.llm, device="meta")
    sub.llm.load_state_dict(
        {k: v for k, v in model.llm.state_dict().items()
         if not k.startswith("layers.") or int(k.split(".")[1])
         < EXPORT_LAYERS}, assign=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "export")
    loaders = {"xtuner": load_auroracap_dir, "huggingface": load_llava_hf_dir}
    for layout, load in loaders.items():
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = export.EXPORTERS[layout](sub, root, dtype=torch.bfloat16)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm, llm_cfg, vit, vit_cfg, pj, _ = load(
            root, llm_dtype=torch.bfloat16, vit_dtype=torch.bfloat16,
            device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n = bad = 0
        for got, want in ((llm, sub.llm), (vit, sub.visual_encoder),
                          (pj, sub.projector)):
            sd = got.state_dict()
            for k, t in want.state_dict().items():
                n += 1
                bad += not (sd[k].shape == t.shape
                            and torch.equal(sd[k], t.to(sd[k].dtype)))
        phase("export-" + layout if layout != "xtuner" else "export",
              card=repr(card), layout=layout,
              llm=f"vicuna-7b-widths/{EXPORT_LAYERS}-layers",
              vit="vit-h-14-378/32-layers", dtype="bf16",
              gb_written=f"{nbytes / 1e9:.3f}", write_s=f"{write_s:.2f}",
              load_s=f"{load_s:.2f}", tensors=n, mismatched=bad)
        check(llm_cfg == cfg.llm and vit_cfg == cfg.vit,
              f"{layout}: configs {llm_cfg} / {vit_cfg}")
        check(bad == 0, f"{layout}: {bad} of {n} tensors differ")
        del llm, vit, pj
        gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def serve_parallel_phases(torch, engine_mod, ra, qm, moe, model, mm, clips,
                          prompt, P, dev, card, plains):
    """[serve-tp2], [serve-tp2-w8kv8], [serve-tp2-mixtral], [serve-dp2]
    and [export]; the bounds and equalities checked once all have printed
    → {run: launch counts}."""
    llm, llm_cfg = model.llm, model.cfg.llm
    failures = []
    out = tp_runs(torch, engine_mod, ra, qm, mm, llm, llm_cfg, clips, prompt,
                  P, dev, card, plains, failures)
    out["mixtral"] = tp_mixtral_phase(torch, engine_mod, ra, qm, moe, dev,
                                      card, plains, failures)
    out["dp2"] = dp_phase(torch, mm, llm, llm_cfg, clips, prompt, P, dev,
                          card, [(ra.ragged_attention, "launches"),
                                 (ra.ragged_decode_attention, "launches")],
                          plains, failures)
    export_phase(torch, model, dev, card)
    # [serve-dp2] encoded later runs' clips: those runs time their ViT
    mm._cache.clear()
    check(not failures, "; ".join(failures))
    return out


def aurora_serving(torch, dev, n_runs):
    """The main path's AuroraCap-7B (AURORA_LAYERS LLM layers, random bf16
    weights from SEED) and its AuroraCapServing; N_REQUESTS clips for each
    of n_runs served configurations (the embed cache would skip the ViT on
    a repeated clip) and one more to warm the ViT; the prompt → (cfg,
    model, mm, clips, prompt, init s)."""
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    from aurora_tpu_torch.serve.multimodal import AuroraCapServing
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = AuroraConfig.auroracap_7b()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=AURORA_LAYERS))
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
    clips = [rng.integers(0, 256, size=(N_FRAMES, size, size, 3),
                          dtype=np.uint8)
             for _ in range(n_runs * N_REQUESTS + 1)]
    prompt = " ".join(["<image>"] * N_FRAMES) + \
        "\nDescribe the video in detail."
    return cfg, model, mm, clips, prompt, init_s


# ---------------------------------------------------------------------------
# Sequence parallelism and the training mesh: ranks as processes on cuda:0
# ---------------------------------------------------------------------------

def run_ranks(name, world, outdir, timeout=900):
    """Start `world` ranks of this script on rank phase `name` under a
    torchrun environment (every rank on this card: gloo), wait for them,
    and return each rank's JSON result; a rank that fails or hangs fails
    the phase (the others are killed)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-phase", name,
         outdir], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"[{name}] rank {r} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(outdir, f"{name}_rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def rank_main(name, outdir):
    """One rank of a multi-rank phase (`run_ranks` starts it)."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aurora_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(distributed.init_distributed(backend="gloo", device_type="cuda",
                                       log=lambda *_: None),
          "no process group")
    dev = distributed.rank_device("cuda")
    res = RANK_PHASES[name](torch, dev)
    res.update(rank=distributed.rank(),
               backend=torch.distributed.get_backend(), device=str(dev))
    with open(os.path.join(outdir, f"{name}_rank{res['rank']}.json"),
              "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _counters():
    from aurora_tpu_torch.ops.pallas import flash_attention as fa
    return [(fa.flash_attention, "launches_fwd"),
            (fa.flash_attention, "launches_dkv"),
            (fa.flash_attention, "launches_dq"),
            (fa.flash_attention_lse, "launches"),
            (fa.flash_attention_plain, "calls")]


def _zero(counters):
    for obj, attr in counters:
        setattr(obj, attr, 0)


def _read(counters):
    return {f"{obj.__name__}.{attr}": getattr(obj, attr)
            for obj, attr in counters}


def _order(case, sp):
    """The global positions a case's layout puts in sequence order."""
    c = SP_CASES[case]
    idx = np.arange(SP_T)
    if c.get("layout") == "stripe":
        return idx.reshape(SP_T // sp, sp).T.reshape(-1)
    if c.get("layout") == "zigzag":
        chunks = np.split(idx, 2 * sp)
        order = []
        for r in range(sp):
            order += [r, 2 * sp - 1 - r]
        return np.concatenate([chunks[i] for i in order])
    return idx


def sp_launch_rule(case, rank, sp=SP_RANKS):
    """Flash launches (forward = dK/dV = dQ) of one rank's forward and
    backward by the ring's case rules: a contiguous causal ring skips the
    later ranks' blocks; zigzag's diagonal takes two calls; Ulysses one
    flash call on its heads; the varlen ring one call a head chunk."""
    c = SP_CASES[case]
    if c["mode"] == "ulysses" or c.get("segments"):
        return 1
    if c["mode"] == "hybrid":
        return rank // SP_ULYSSES + 1
    if c.get("layout") == "zigzag":
        return 2 + (sp - 1)
    if c.get("layout") == "stripe":
        return sp
    return rank + 1


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def sp_attn_rank(torch, dev):
    """[sp-attn] on one rank: each case's out and dQ/dK/dV (this rank's
    block) against the one-process flash kernels on the whole sequence,
    the flash launches of the sp call alone, its ms; a planted fault (one
    K/V block of the ring zeroed) on the contiguous ring."""
    from unittest import mock as _mock
    from aurora_tpu_torch.ops.pallas import flash_attention as fa
    from aurora_tpu_torch.parallel import collectives, hybrid, ring, ulysses
    from aurora_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    mesh = create_mesh(MeshConfig(sp=SP_RANKS), "cuda")
    rank = mesh.axis("sp").index
    n = SP_T // SP_RANKS
    blk = slice(rank * n, (rank + 1) * n)
    counters = _counters()
    bf = dict(device=dev, dtype=torch.bfloat16)
    out = {"cases": {}}
    for i, (case, c) in enumerate(SP_CASES.items()):
        g = torch.Generator(device=dev).manual_seed(SEED + 40 + i)
        hkv = c.get("Hkv", SP_H)
        q = torch.randn((1, SP_T, SP_H, SP_D), generator=g, **bf)
        k = torch.randn((1, SP_T, hkv, SP_D), generator=g, **bf)
        v = torch.randn((1, SP_T, hkv, SP_D), generator=g, **bf)
        dout = torch.randn((1, SP_T, SP_H, SP_D), generator=g, **bf)
        seg = None
        if c.get("segments"):
            seg = torch.zeros((1, SP_T), dtype=torch.int32, device=dev)
            for j, a in enumerate(SP_SEGMENTS[1:-1]):
                seg[:, a:] = j + 1
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = fa.flash_attention(*leaves, causal=True, q_segment_ids=seg,
                                  kv_segment_ids=seg)
        wants = [want, *torch.autograd.grad(want, leaves, dout)]
        order = torch.as_tensor(_order(case, SP_RANKS), device=dev)
        local = [t.index_select(1, order)[:, blk] for t in (q, k, v, dout)]
        wants = [t.index_select(1, order)[:, blk] for t in wants]
        segl = None if seg is None else seg[:, blk].contiguous()

        def call(ql, kl, vl):
            if c["mode"] == "ulysses":
                return ulysses.ulysses_mha(ql, kl, vl, mesh, causal=True)
            if c["mode"] == "hybrid":
                return hybrid.hybrid_mha(ql, kl, vl, mesh,
                                         ulysses=SP_ULYSSES, causal=True)
            if segl is not None:
                return ring.ring_varlen_mha(ql, kl, vl, segl, mesh)
            return ring.ring_mha(ql, kl, vl, mesh, causal=True,
                                 layout=c.get("layout", "contiguous"))
        ls = [t.contiguous().requires_grad_() for t in local[:3]]
        torch.cuda.synchronize()
        _zero(counters)
        staged = collectives.host_staged
        t0 = time.perf_counter()
        got = call(*ls)
        got = [got, *torch.autograd.grad(got, ls, local[3])]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _read(counters)
        r = {name: _rel(a, b) for name, a, b in
             zip(("out", "dq", "dk", "dv"), got, wants)}
        r.update(ms=ms, launches=counts,
                 host_staged=collectives.host_staged - staged,
                 finite=all(bool(torch.isfinite(t).all()) for t in got))
        if case == "ring":
            # planted: the block of the rank one place back zeroed
            orig = ring.ring_pass

            def dropped(x, axis):
                blocks = orig(x, axis)
                return [torch.zeros_like(b) if j == 1 else b
                        for j, b in enumerate(blocks)]
            with _mock.patch.object(ring, "ring_pass", dropped), \
                    torch.no_grad():
                r["planted_out"] = _rel(call(*[t.detach() for t in ls]),
                                        wants[0])
        out["cases"][case] = r
        del q, k, v, dout, leaves, want, wants, local, ls, got
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _sp_batch(torch, cfg, dev, rows, seq, seed):
    ids = np.random.default_rng(seed).integers(
        10, min(30000, cfg.llm.vocab_size), size=(rows, seq))
    t = torch.from_numpy(ids).to(dev)
    return {"input_ids": t, "labels": t}


def one_process_step(torch, bs, dev, rows, seq, seed, steps=1):
    """The one-process steps on this card (train/bench_stage.py's model
    at TRAIN_SP_LAYERS layers) → [(loss, grad norm)] of each step."""
    from aurora_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)
    cfg = bs.aurora_config(layers=TRAIN_SP_LAYERS)
    model = bs.init_model(cfg, dev, SEED + 30)
    tcfg = bs.train_config()
    state = init_train_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    batch = _sp_batch(torch, cfg, dev, rows, seq, seed)
    res = []
    for _ in range(steps):
        state, m = step(state, batch)
        res.append((m["loss"].item(), m["grad_norm"].item()))
    del model, state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _mesh_step(torch, dev, mesh_kw, train_kw, rows, seq, seed, steps=1,
               planted=None, layers=TRAIN_SP_LAYERS):
    """One rank's steps on a mesh from the one-process step's model (at
    `layers` layers) and batch → dict of its metrics, launches, step ms,
    peak GB, shard bytes and, planted: the global loss of a forward with
    the fault before the steps ("ring" zeroes one K/V block of the ring,
    "tp" drops the second tp shard's partials), the grad norm of a
    forward and backward with it ("dp" skips the dp sum, "fsdp" the sum
    in the fsdp gather's transpose), or ("keep") the steps run with each
    layer's whole parameters kept to the step's end."""
    import hashlib
    from unittest import mock as _mock
    from aurora_tpu_torch.models.aurora import aurora_forward
    from aurora_tpu_torch.parallel import collectives, ring
    from aurora_tpu_torch.parallel.mesh import (FlatUnit, MeshConfig,
                                                ShardedModel, create_mesh,
                                                local_rows, seq_shard,
                                                shard_model)
    from aurora_tpu_torch.train import bench_stage as bs
    from aurora_tpu_torch.train import trainer
    cfg = bs.aurora_config(layers=layers)
    model = bs.init_model(cfg, dev, SEED + 30)
    tcfg = dataclasses.replace(bs.train_config(), **train_kw)
    mesh = create_mesh(MeshConfig(**mesh_kw), "cuda")
    trainer.apply_freeze(model, tcfg)
    full_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters() if p.requires_grad)
    plan = shard_model(model, mesh)
    state = trainer.init_train_state(plan, tcfg)
    step = trainer.make_train_step(cfg, tcfg, mesh=mesh)
    batch = local_rows(mesh, _sp_batch(torch, cfg, dev, rows, seq, seed))
    res = {"full_bytes": full_bytes,
           "shard_bytes": sum(t.numel() * t.element_size()
                              for t in plan.params()),
           "layer_shard_bytes": plan.layer_units[0].shard.numel()
           * plan.layer_units[0].shard.element_size(),
           "layer_full_bytes": plan.layer_units[0].numel
           * plan.layer_units[0].shard.element_size()}
    keep = contextlib.nullcontext()
    if planted == "keep":
        keep = _mock.patch.object(FlatUnit, "release", lambda self: None)
    elif planted in ("dp", "fsdp"):
        if planted == "dp":
            patch = _mock.patch.object(ShardedModel, "reduce_grads",
                                       lambda self, grads: grads)
        else:
            def no_sum(ctx, g):
                axis, dim, n = ctx.args
                return g.narrow(dim, axis.index * n, n), None, None
            patch = _mock.patch.object(collectives._AllGather, "backward",
                                       staticmethod(no_sum))
        with patch:
            _, _, grads = trainer.loss_and_grads(
                plan.model, batch, tcfg, plan.params(), mesh,
                trainer._build_sp_attn(tcfg, mesh), plan.tp,
                before=plan.gather_root)
            plan.release()
            res["planted_grad_norm"] = plan.grad_norm(
                plan.reduce_grads(grads)).item()
        del grads
    elif planted is not None:
        if planted == "ring":
            orig = ring.ring_pass

            def fault(x, axis):
                return [torch.zeros_like(b) if j == 1 else b
                        for j, b in enumerate(orig(x, axis))]
            patch = _mock.patch.object(ring, "ring_pass", fault)
        else:
            def fault(self, x):
                part = x if self.axis.index == 0 else torch.zeros_like(x)
                return collectives.reduce_sum(part, self.axis)
            patch = _mock.patch.object(collectives.TensorParallel, "reduce",
                                       fault)
        data = mesh.axis(("dp", "fsdp", "sp"))
        with patch, torch.no_grad():
            plan.gather_root()
            s_, n_ = aurora_forward(
                plan.model, batch["input_ids"], labels=batch["labels"],
                mode="loss_sum", remat=False,
                sp_attn=trainer._build_sp_attn(tcfg, mesh),
                seq_shard=seq_shard(mesh), tp=plan.tp)
            plan.release()
            n_all = collectives.all_reduce_(n_.clone(), data)
            res["planted_loss"] = (collectives.all_reduce_(
                s_.float().clone(), data) / n_all).item()
    counters = _counters()
    torch.cuda.reset_peak_memory_stats(dev)
    staged = collectives.host_staged
    res["steps"] = []
    with keep:
        for i in range(steps):
            torch.cuda.synchronize()
            _zero(counters)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, gnorm = m["loss"].item(), m["grad_norm"].item()
            torch.cuda.synchronize()
            res["steps"].append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                     loss=loss, grad_norm=gnorm,
                                     launches=_read(counters)))
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["host_staged"] = collectives.host_staged - staged
    digest = hashlib.sha256()
    for t in plan.params():
        digest.update(t.detach().view(torch.uint8).cpu().numpy().tobytes())
    res["checksum"] = digest.hexdigest()
    del plan, state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_sp_rank(torch, dev):
    """[train-sp] on one rank: each mesh of TRAIN_SP_MESHES, one step (a
    planted forward first)."""
    out = {}
    for name, (mesh_kw, train_kw) in TRAIN_SP_MESHES.items():
        out[name] = _mesh_step(torch, dev, mesh_kw, train_kw, 1,
                               TRAIN_SP_SEQ, SEED + 31,
                               planted="ring" if "ring" in name else "tp")
    return out


def train_dp_rank(torch, dev):
    """[train-dp2] and [train-fsdp2] on one rank, each rank its row: dp 2
    and fsdp 2 (TRAIN_DP_STEPS steps, a planted grad-norm fault first),
    and fsdp 2 at TRAIN_FSDP_DEEP layers (one step, and one with each
    layer's whole parameters kept)."""
    out = {name: _mesh_step(torch, dev, {name[:-1]: 2}, {}, 2,
                            TRAIN_DP_SEQ, SEED + 32, steps=TRAIN_DP_STEPS,
                            planted=name[:-1])
           for name in ("dp2", "fsdp2")}
    for name, planted in (("fsdp2-deep", None), ("fsdp2-deep-kept", "keep")):
        out[name] = _mesh_step(torch, dev, dict(fsdp=2), {}, 2,
                               TRAIN_DP_SEQ, SEED + 32, planted=planted,
                               layers=TRAIN_FSDP_DEEP)
    return out


RANK_PHASES = {"sp-attn": sp_attn_rank, "train-sp": train_sp_rank,
               "train-dp": train_dp_rank}


def lse_case(torch, fa, dev, g):
    """flash_attention_lse at one ring block (B 1, T 4096, H 32, D 128):
    causal, and causal at q_offset −1 (the stripe layout's later blocks,
    whose first row sees no key), against the fp32 twin (out, lse, dQ/dK/dV
    with a random dO and lse cotangent); its forward timed beside the twin
    and SDPA, with its bound."""
    import torch.nn.functional as F
    T = SP_T // SP_RANKS
    bf = dict(device=dev, dtype=torch.bfloat16)
    q, k, v, dout = (torch.randn((1, T, SP_H, SP_D), generator=g, **bf)
                     for _ in range(4))
    dlse = torch.randn((1, SP_H, T), generator=g, device=dev)
    res = {}
    for off in (0, -1):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = fa.flash_attention_lse(*leaves, causal=True, q_offset=off)
        grads = torch.autograd.grad((out, lse), leaves, (dout, dlse))
        fl = [t.float().requires_grad_() for t in (q, k, v)]
        w_out, w_lse = fa.flash_attention_plain(*fl, causal=True,
                                                q_offset=off)
        w_grads = torch.autograd.grad((w_out, w_lse), fl,
                                      (dout.float(), dlse))
        tag = "stripe" if off else "causal"
        res[f"{tag}_out_err"] = (out.float() - w_out).abs().max().item()
        live = w_lse > -1e30
        res[f"{tag}_lse_err"] = (lse - w_lse)[live].abs().max().item()
        for name, a, b in zip(("dq", "dk", "dv"), grads, w_grads):
            res[f"{tag}_{name}_rel"] = _rel(a, b)
        check(bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(t).all()) for t in grads),
            f"flash_attention_lse q_offset {off}: not finite")
        if off:
            check(bool((out[:, 0] == 0).all()) and bool(
                (lse[:, :, 0] <= -1e30).all()),
                "q_offset -1: the first row saw a key")
        del leaves, out, lse, grads, fl, w_out, w_lse, w_grads
        torch.cuda.empty_cache()
    check(max(res["causal_out_err"], res["stripe_out_err"]) <= FLASH_ABS_TOL
          and max(res["causal_lse_err"], res["stripe_lse_err"])
          <= FLASH_LSE_TOL
          and max(v_ for k_, v_ in res.items() if k_.endswith("_rel"))
          <= FLASH_GRAD_TOL, f"flash_attention_lse vs twin {res}")
    res["ms"] = cuda_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True),
                        reps=10)
    with torch.no_grad():
        fq = [t.float() for t in (q, k, v)]
        res["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            *fq, causal=True), reps=3)
        del fq
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=10)
    pairs = SP_H * T * (T + 1) // 2
    res["bound"] = least_ms(pairs * 4 * SP_D,
                            4 * q.numel() * 2 + SP_H * T * 4)
    torch.cuda.empty_cache()
    return res


def parallel_train_phases(torch, fa, bs, dev, card):
    """[sp-attn], [train-sp], [train-dp2], [train-fsdp2]: ranks as
    processes on this card over gloo (correctness, launches, peak memory
    a rank; NCCL, NVLink and distinct cards are not measured) → the
    flash launch counts for the kernels' JSON line."""
    import tempfile
    from aurora_tpu_torch.ops import cuda_build
    cuda_build.load_library()            # built once, before the ranks
    gc.collect()
    torch.cuda.empty_cache()             # the card's memory for the ranks
    g = torch.Generator(device=dev).manual_seed(SEED + 39)
    lse = lse_case(torch, fa, dev, g)
    phase("kernels", flash_lse=f"B1/T{SP_T // SP_RANKS}/H{SP_H}/D{SP_D}",
          **{k_: (f"{x:.4g}" if isinstance(x, float) else x)
             for k_, x in lse.items() if k_ != "bound"},
          bound_ms=f"{lse['bound'][0]:.4f}", bound_by=lse["bound"][1])
    found = {"lse": lse}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        # ---- [sp-attn] ------------------------------------------------------
        ranks = run_ranks("sp-attn", SP_RANKS, tmp)
        lse_launches = 0
        for case in SP_CASES:
            rs = [r["cases"][case] for r in ranks]
            errs = {n: max(r[n] for r in rs)
                    for n in ("out", "dq", "dk", "dv")}
            launches = [r["launches"] for r in rs]
            rule = [sp_launch_rule(case, r) for r in range(SP_RANKS)]
            via_lse = SP_CASES[case]["mode"] != "ulysses" and not \
                SP_CASES[case].get("segments")
            phase("sp-attn", case=case, card=repr(card),
                  shape=f"B1/T{SP_T}/H{SP_H}/Hkv"
                        f"{SP_CASES[case].get('Hkv', SP_H)}/D{SP_D}/bf16",
                  ranks=SP_RANKS, backend=ranks[0]["backend"],
                  host_staged=str(all(r["host_staged"] > 0
                                      for r in rs)).lower(),
                  **{f"{n}_rel": f"{e:.3e}" for n, e in errs.items()},
                  tol=f"{SP_OUT_TOL}/{SP_GRAD_TOL}",
                  planted_out_rel=(f"{max(r['planted_out'] for r in rs):.3e}"
                                   if "planted_out" in rs[0] else "-"),
                  ms_per_rank="/".join(f"{r['ms']:.1f}" for r in rs),
                  fwd_per_rank="/".join(
                      str(x["flash_attention.launches_fwd"])
                      for x in launches),
                  lse_per_rank="/".join(
                      str(x["flash_attention_lse.launches"])
                      for x in launches),
                  rule="/".join(map(str, rule)))
            check(all(r["finite"] for r in rs), f"[sp-attn] {case}: not finite")
            check(errs["out"] <= SP_OUT_TOL and max(
                errs[n] for n in ("dq", "dk", "dv")) <= SP_GRAD_TOL,
                f"[sp-attn] {case}: {errs}")
            if "planted_out" in rs[0]:
                check(max(r["planted_out"] for r in rs) > SP_OUT_TOL,
                      f"[sp-attn] {case}: the planted fault reads within "
                      "the bound")
            for r, x in enumerate(launches):
                want = {"flash_attention.launches_fwd": rule[r],
                        "flash_attention.launches_dkv": rule[r],
                        "flash_attention.launches_dq": rule[r],
                        "flash_attention_lse.launches":
                            rule[r] if via_lse else 0,
                        "flash_attention_plain.calls": 0}
                check(x == want, f"[sp-attn] {case} rank {r}: launches {x}, "
                                 f"the case rules give {want}")
            lse_launches += sum(x["flash_attention_lse.launches"]
                                for x in launches)
        found["sp_attn_lse"] = lse_launches
        phase("sp-attn", peak_gb_per_rank="/".join(
            f"{r['peak_gb']:.2f}" for r in ranks))

        # ---- [train-sp] -----------------------------------------------------
        (want_loss, want_gn), = one_process_step(torch, bs, dev, 1,
                                                 TRAIN_SP_SEQ, SEED + 31)
        ranks = run_ranks("train-sp", SP_RANKS, tmp)
        found["train_sp"] = {}
        for name in TRAIN_SP_MESHES:
            rs = [r[name] for r in ranks]
            st = [r["steps"][0] for r in rs]
            loss, gn = st[0]["loss"], st[0]["grad_norm"]
            rel_loss = abs(loss - want_loss) / abs(want_loss)
            rel_gn = abs(gn - want_gn) / want_gn
            planted = abs(rs[0]["planted_loss"] - want_loss) / abs(want_loss)
            sums = {k_: sum(s["launches"][k_] for s in st)
                    for k_ in st[0]["launches"]}
            found["train_sp"][name] = sums
            phase("train-sp", mesh=name, card=repr(card),
                  config=f"vicuna-7b-widths/L{TRAIN_SP_LAYERS}/seq"
                         f"{TRAIN_SP_SEQ}/b1/bf16/adamw/remat-full",
                  backend=ranks[0]["backend"],
                  loss=f"{loss:.6f}", loss_one_process=f"{want_loss:.6f}",
                  rel_loss=f"{rel_loss:.3e}", grad_norm=f"{gn:.6f}",
                  grad_norm_one_process=f"{want_gn:.6f}",
                  rel_grad_norm=f"{rel_gn:.3e}",
                  tol=f"{TRAIN_SP_LOSS_TOL}/{TRAIN_SP_GNORM_TOL}",
                  planted_rel_loss=f"{planted:.3e}",
                  step_ms_per_rank="/".join(f"{s['ms']:.1f}" for s in st),
                  peak_gb_per_rank="/".join(f"{r['peak_gb']:.2f}"
                                            for r in rs),
                  lse_per_rank="/".join(
                      str(s["launches"]["flash_attention_lse.launches"])
                      for s in st),
                  fwd_per_rank="/".join(
                      str(s["launches"]["flash_attention.launches_fwd"])
                      for s in st),
                  host_staged=str(all(r["host_staged"] > 0
                                      for r in rs)).lower())
            check(all(s["loss"] == loss and s["grad_norm"] == gn
                      for s in st), f"[train-sp] {name}: ranks disagree")
            check(rel_loss <= TRAIN_SP_LOSS_TOL
                  and rel_gn <= TRAIN_SP_GNORM_TOL,
                  f"[train-sp] {name}: {rel_loss} / {rel_gn}")
            check(planted > TRAIN_SP_LOSS_TOL, f"[train-sp] {name}: the "
                  f"planted fault reads {planted}, within the bound")
            check(sums["flash_attention_plain.calls"] == 0,
                  f"[train-sp] {name}: a plain twin ran")
            L = TRAIN_SP_LAYERS
            for r, s in enumerate(st):
                # full remat: each layer's attention runs twice forward
                ring_calls = (r + 1) if "ring" in name else 1
                want = {"flash_attention.launches_fwd": 2 * L * ring_calls,
                        "flash_attention.launches_dkv": L * ring_calls,
                        "flash_attention.launches_dq": L * ring_calls,
                        "flash_attention_lse.launches":
                            2 * L * ring_calls if "ring" in name else 0,
                        "flash_attention_plain.calls": 0}
                check(s["launches"] == want,
                      f"[train-sp] {name} rank {r}: {s['launches']} != "
                      f"{want}")

        # ---- [train-dp2] / [train-fsdp2] ------------------------------------
        want = one_process_step(torch, bs, dev, 2, TRAIN_DP_SEQ, SEED + 32,
                                steps=TRAIN_DP_STEPS)
        ranks = run_ranks("train-dp", 2, tmp)
        for name in ("dp2", "fsdp2"):
            rs = [r[name] for r in ranks]
            st = rs[0]["steps"]
            rel = [(abs(s["loss"] - w[0]) / abs(w[0]),
                    abs(s["grad_norm"] - w[1]) / w[1])
                   for s, w in zip(st, want)]
            planted = abs(rs[0]["planted_grad_norm"] - want[0][1]) / want[0][1]
            half = [r["shard_bytes"] / r["full_bytes"] for r in rs]
            phase(f"train-{name}", card=repr(card),
                  config=f"vicuna-7b-widths/L{TRAIN_SP_LAYERS}/seq"
                         f"{TRAIN_DP_SEQ}/b2/bf16/adamw/remat-full",
                  steps=len(st),
                  loss="/".join(f"{s['loss']:.6f}" for s in st),
                  loss_one_process="/".join(f"{w[0]:.6f}" for w in want),
                  grad_norm="/".join(f"{s['grad_norm']:.6f}" for s in st),
                  grad_norm_one_process="/".join(f"{w[1]:.6f}"
                                                 for w in want),
                  rel_loss="/".join(f"{x[0]:.3e}" for x in rel),
                  rel_grad_norm="/".join(f"{x[1]:.3e}" for x in rel),
                  tol=f"{TRAIN_SP_LOSS_TOL}/{TRAIN_SP_GNORM_TOL}",
                  planted_rel_grad_norm=f"{planted:.3e}",
                  params_equal=str(rs[0]["checksum"] ==
                                   rs[1]["checksum"]).lower(),
                  shard_share="/".join(f"{h:.4f}" for h in half),
                  step_ms_per_rank="/".join(
                      f"{r['steps'][-1]['ms']:.1f}" for r in rs),
                  peak_gb_per_rank="/".join(f"{r['peak_gb']:.2f}"
                                            for r in rs))
            check(len(st) == len(want) and all(
                a <= TRAIN_SP_LOSS_TOL and b <= TRAIN_SP_GNORM_TOL
                for a, b in rel), f"[train-{name}] {rel} against the "
                f"one-process steps {want}")
            check(planted > TRAIN_SP_GNORM_TOL, f"[train-{name}] the "
                  f"planted fault reads {planted}, within the bound")
            check(all(a["loss"] == b["loss"]
                      and a["grad_norm"] == b["grad_norm"] for a, b in
                      zip(rs[0]["steps"], rs[1]["steps"])),
                  f"[train-{name}] the ranks' metrics differ")
            check(all(s["launches"]["flash_attention.launches_fwd"] > 0
                      for r in rs for s in r["steps"]),
                  f"[train-{name}] no flash launch")
            if name == "dp2":
                check(rs[0]["checksum"] == rs[1]["checksum"],
                      "[train-dp2] the ranks' parameters differ")
            else:
                check(all(0.5 <= h <= 0.5001 for h in half),
                      f"[train-fsdp2] shard shares {half}")
        # fsdp's memory a layer: ZeRO-3 holds one layer's whole
        # parameters at a time
        deep = TRAIN_FSDP_DEEP - TRAIN_SP_LAYERS
        for r, rank in enumerate(ranks):
            zero3 = 4 * rank["fsdp2-deep"]["layer_shard_bytes"] / 1e9
            whole = rank["fsdp2-deep"]["layer_full_bytes"] / 1e9
            bound = zero3 + whole / 2
            per_layer, kept = ((rank[n]["peak_gb"] - rank["fsdp2"]["peak_gb"])
                               / deep for n in ("fsdp2-deep",
                                                "fsdp2-deep-kept"))
            phase("train-fsdp2", rank=r, card=repr(card),
                  memory=f"L{TRAIN_SP_LAYERS}-vs-L{TRAIN_FSDP_DEEP}",
                  peak_gb=f"{rank['fsdp2']['peak_gb']:.3f}/"
                          f"{rank['fsdp2-deep']['peak_gb']:.3f}",
                  gb_per_layer=f"{per_layer:.4f}",
                  zero3_gb_per_layer=f"{zero3:.4f}",
                  whole_layer_gb=f"{whole:.4f}", bound_gb=f"{bound:.4f}",
                  planted_kept_gb_per_layer=f"{kept:.4f}",
                  loss_deep=f"{rank['fsdp2-deep']['steps'][0]['loss']:.6f}")
            check(per_layer <= bound, f"[train-fsdp2] rank {r}: "
                  f"{per_layer} GB a layer, above {bound}")
            check(kept > bound, f"[train-fsdp2] rank {r}: the planted "
                  f"fault reads {kept} GB a layer, within {bound}")
        found["train_dp"] = {n: sum(s["launches"][
            "flash_attention.launches_fwd"] for r in ranks
            for s in r[n]["steps"]) for n in ("dp2", "fsdp2")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return found


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-phase"]:
        return rank_main(argv[1], argv[2])
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port's main paths "
                                 "on one NVIDIA GPU (module docstring)")
    ap.add_argument("--only", action="append",
                    choices=["train-cli", "kernels", "serve-gemma2",
                             "serve-phi3", "train-dpo", "serve-moe",
                             "serve-internvl", "serve-siglip",
                             "serve-parallel", "train-parallel"],
                    help="run these phases alone, in the script's order "
                         "(train-cli: [infer-load] and the four train-cli "
                         "phases; kernels: [build] and every [kernels] "
                         "case; serve-gemma2: the Gemma-2-9B, Qwen2-7B "
                         "and StableLM-3B runs; serve-phi3: the "
                         "Phi-3-mini runs; train-dpo: both DPO "
                         "phases; serve-moe: "
                         "[kernels-moe] and the Mixtral, Qwen3-MoE and "
                         "DeepSeek-V2-Lite runs; serve-internvl: the "
                         "InternVL3-8B runs; serve-siglip: AuroraCap with "
                         "a SigLIP tower; serve-parallel: the tp 2, dp 2 "
                         "and export phases; train-parallel: [sp-attn], "
                         "[train-sp], [train-dp2], [train-fsdp2]); no "
                         "kernel JSON line, no final line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aurora_tpu_torch.ops import cuda_build
    from aurora_tpu_torch.ops import moe
    from aurora_tpu_torch.ops.pallas import flash_attention as fa
    from aurora_tpu_torch.ops.pallas import quant_matmul as qm
    from aurora_tpu_torch.ops.pallas import ragged_attention as ra
    from aurora_tpu_torch.serve import engine as engine_mod
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import _PLACEHOLDER_BASE
    from aurora_tpu_torch.train import bench_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(card, flush=True)

    flash_counters = [(fa.flash_attention, "launches_fwd"),
                      (fa.flash_attention, "launches_dkv"),
                      (fa.flash_attention, "launches_dq")]
    # every plain twin: none may run on a path that launches kernels
    all_plains = [(ra.ragged_attention_plain, "calls"),
                  (ra.ragged_decode_attention_plain, "calls"),
                  (qm.w4a8_matmul_tiled_plain, "calls"),
                  (qm.w8a8_matmul_plain, "calls"),
                  (qm.w4a8_matmul_plain, "calls"),
                  (qm.w4a16_matmul_plain, "calls"),
                  (qm.fused_mlp_w4_plain, "calls"),
                  (moe.moe_grouped_mm_reference, "calls"),
                  (fa.flash_attention_plain, "calls")]
    only = set(args.only or ())
    if "train-cli" in only:
        root = infer_load_phase(torch, dev, card)
        try:
            train_cli_phases(torch, root, dev, card, flash_counters,
                             all_plains)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if only - {"train-cli"}:
        plains = all_plains[:-1]
        if "kernels" in only:
            cuda_build.load_library()
            family_kernel_phase(torch, ra, fa, dev)
        if "serve-gemma2" in only:
            gemma2_phase(torch, engine_mod, ra, qm, dev, card, plains)
            qwen2_phase(torch, engine_mod, ra, qm, dev, card, plains)
            stablelm_phase(torch, engine_mod, ra, dev, card, plains)
        if "serve-phi3" in only:
            phi3_phase(torch, engine_mod, ra, dev, card, plains)
        if only & {"serve-internvl", "serve-siglip"}:
            cuda_build.load_library()   # the build stays out of the waves
        if "serve-internvl" in only:
            internvl_phase(torch, engine_mod, ra, dev, card, plains)
        if "serve-siglip" in only:
            siglip_phase(torch, engine_mod, ra, dev, card, plains)
        if "train-dpo" in only:
            dpo_phase(torch, fa, dev, card, flash_counters, all_plains)
            dpo_phase(torch, fa, dev, card, flash_counters, all_plains,
                      gemma=True)
        if "serve-parallel" in only:
            cuda_build.load_library()
            _, model, mm, clips, prompt, _ = aurora_serving(torch, dev, 2)
            P = len(mm.build_request("p", prompt, clips[0]).input_ids)
            serve_parallel_phases(torch, engine_mod, ra, qm, moe, model, mm,
                                  clips, prompt, P, dev, card, all_plains[:7])
            del model, mm
            gc.collect()
            torch.cuda.empty_cache()
        if "train-parallel" in only:
            parallel_train_phases(torch, fa, bench_stage, dev, card)
        if "serve-moe" in only:
            cuda_build.load_library()
            moe_kernel_phase(torch, engine_mod, moe, dev)
            moe_serve_phase(torch, engine_mod, ra, qm, moe, dev, card,
                            plains)
            mla_serve_phase(torch, engine_mod, ra, moe, dev, card, plains)
    if only:
        return 0

    t0 = time.perf_counter()
    cuda_build.load_library()
    attrs = {n: cuda_build.kernel_attrs(n)
             for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                       *(f"ragged_extend_{m}" for m in KV_MODES),
                       *(f"ragged_decode_{m}_g{g}" for m in KV_MODES
                         for g in (1, 4)),
                       *(f"flash_{k}_d{w}" for w in (256, 512)
                         for k in ("fwd", "bwd_dkv", "bwd_dq")),
                       *(f"ragged_extend_{m}_hd{h}" for m in KV_MODES
                         for h in (64, 96, 256)),
                       *(f"ragged_decode_{m}_g{g}_hd{h}" for m in KV_MODES
                         for g, h in ((1, 64), (1, 96), (2, 256),
                                      (8, 128))),
                       *(f"{k}_b{b}" for k in ("w8a8", "w4a16", "w4a8",
                                                "w4a8_flat", "fused_mlp")
                         for b in (8, 64)),
                       *(f"moe_grouped_mm_{p}" for p in (
                           "extend_bf16", "extend_int8", "decode_bf16_t8",
                           "decode_bf16_t16", "decode_int8_t8",
                           "decode_int8_t16")))}
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          nvcc_seconds=f"{cuda_build.build_seconds:.1f}",
          library=cuda_build.library_path().name,
          **{n: "regs={regs}/local={local_bytes}/smem={smem}".format(**a)
             for n, a in attrs.items()})
    # the D 512 flash kernels hold their accumulators in registers whole
    check(all(attrs[f"flash_{k}_d512"]["local_bytes"] == 0
              for k in ("fwd", "bwd_dkv", "bwd_dq")),
          "a D 512 flash kernel spills to local memory")

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    kres = {(mode, hkv): attention_case(torch, ra, dev, g, hkv, mode)
            for mode in ("bf16", "int8", "int4") for hkv in (32, 8)}
    # int8 rows on the int4 grid, from a generator of their own (the
    # later phases' inputs stay)
    gq = torch.Generator(device=dev).manual_seed(SEED + 10)
    for hkv in (32, 8):
        kres[("int4grid", hkv)] = attention_case(torch, ra, dev, gq, hkv,
                                                 "int4grid")
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
    # the zoo's head widths and groups, and flash at D 256 and 512
    fam_res, flash_wide = family_kernel_phase(torch, ra, fa, dev)
    # the grouped-expert kernel at the MoE families' expert shapes
    moe_res = moe_kernel_phase(torch, engine_mod, moe, dev)
    # the flash launches at kernel width 512, over every run of the main
    # path from here to [train-dpo-gemma] (the phases above compared the
    # kernels with their twins; those launches do not count)
    d512_counters = [(fa.flash_attention, f"launches_{k_}_d512")
                     for k_ in ("fwd", "dkv", "dq")]
    for obj, attr in d512_counters:
        setattr(obj, attr, 0)

    # ---- checkpoint loading from an xtuner-format directory --------------
    torch.cuda.empty_cache()
    root = infer_load_phase(torch, dev, card)
    try:
        eval_launches = eval_phase(
            torch, ra, root, dev, card,
            [(ra.ragged_attention_plain, "calls"),
             (ra.ragged_decode_attention_plain, "calls")])
        # ---- the training CLI over the same directory ---------------------
        train_cli_launches = train_cli_phases(torch, root, dev, card,
                                              flash_counters, all_plains)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ---- main path at full width, bf16 ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    runs = ("bf16", "w8kv8", "w4kv8", "w4kv4", "w4kv8-fused", "w4kv8-flat")
    cfg, model, mm, clips, prompt, init_s = aurora_serving(torch, dev,
                                                           len(runs))
    n_vis = mm.n_visual_tokens()

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

    # ---- serving across devices on one card (tp 2, dp 2), export ---------
    serve_parallel_phases(torch, engine_mod, ra, qm, moe, model, mm, clips,
                          prompt, P, dev, card, plains)
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

    # ---- the int4-grid KV rows and the A8 prefill on the same W4 weights ---
    torch.cuda.reset_peak_memory_stats()
    surface = engine_surface_phase(torch, engine_mod, qm, mm, llm_w4, cfg.llm,
                                   dev, card, kernels["w4kv8"], plains)

    # ---- from video files, at the reference engine's defaults --------------
    torch.cuda.reset_peak_memory_stats()
    prefix_phase(torch, engine_mod, mm, llm_w4, cfg.llm, dev, card,
                 kernels["w4kv8"], plains)

    # ---- the in-process Runtime at the engine's defaults, stop strings ----
    rt_prompts, rt_first = runtime_phase(torch, llm_w4, cfg.llm, dev, card,
                                         kernels["w4kv8"], plains)

    # ---- the HTTP server over the same engine configuration ---------------
    http_phase(torch, llm_w4, cfg.llm, mm, dev, card, kernels["w4kv8"],
               plains, rt_prompts, rt_first)
    http_update_phase(torch, dev, card, plains)

    # ---- chunked prefill of ~4.9k-token videos beside running decodes ----
    chunked_phase(torch, ra, mm, llm_w4, cfg.llm, dev, card,
                  kernels["w4kv8"], plains)

    # ---- regex and choice constraints, jump-forward -----------------------
    constrained_phase(torch, ra, llm_w4, cfg.llm, dev, card,
                      kernels["w4kv8"], plains)

    # ---- Mistral-7B: the sliding window on the serving path -------------
    del llm_w4, model, mm
    gc.collect()
    torch.cuda.empty_cache()
    mistral = mistral_phase(torch, engine_mod, ra, dev, card, plains)

    # ---- the dense zoo: Gemma-2-9B at full width, Qwen2-7B ---------------
    gemma2 = gemma2_phase(torch, engine_mod, ra, qm, dev, card, plains)
    qwen2 = qwen2_phase(torch, engine_mod, ra, qm, dev, card, plains)
    stablelm = stablelm_phase(torch, engine_mod, ra, dev, card, plains)
    phi3 = phi3_phase(torch, engine_mod, ra, dev, card, plains)

    # ---- the vision zoo: InternVL3-8B whole, AuroraCap with SigLIP -------
    internvl = internvl_phase(torch, engine_mod, ra, dev, card, plains)
    siglip = siglip_phase(torch, engine_mod, ra, dev, card, plains)

    # ---- the MoE and MLA families: Mixtral-8x7B, Qwen3-MoE, V2-Lite ------
    moe_runs = moe_serve_phase(torch, engine_mod, ra, qm, moe, dev, card,
                               plains)
    mla_runs = mla_serve_phase(torch, engine_mod, ra, moe, dev, card, plains)

    # ---- training at 7B widths (bench.py's training stage) --------------
    launches_fwd, launches_dkv, launches_dq = train_phase(
        torch, bench_stage, dev, card, flash_counters,
        plains + [(fa.flash_attention_plain, "calls")])
    torch.cuda.empty_cache()
    train_parity(torch, bench_stage, fa, dev)

    # ---- DPO through the flash kernels: D 128 and D 256 -------------------
    dpo = dpo_phase(torch, fa, dev, card, flash_counters, plains + [
        (fa.flash_attention_plain, "calls")])
    dpo256 = dpo_phase(torch, fa, dev, card, flash_counters, plains + [
        (fa.flash_attention_plain, "calls")], gemma=True)
    launches512 = tuple(getattr(obj, attr) for obj, attr in d512_counters)
    phase("flash-d512", launches=json.dumps(dict(zip(
        ("fwd", "bwd_dkv", "bwd_dq"), launches512))).replace(" ", ""),
          runs="eval..train-dpo-gemma")

    # ---- sequence parallelism and the training mesh: ranks on this card ---
    par = parallel_train_phases(torch, fa, bench_stage, dev, card)

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

    def attn_entry(name, source, replaces, launches, mode, kind, **extra):
        r = kres[(mode, 32)][kind]   # the Vicuna shape: Hq = Hkv = 32
        err = max(kres[(mode, h)][kind]["err"] for h in (32, 8))
        return entry(name, source, replaces, launches, err, r["ms"],
                     r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                     r["library_ms"], **extra)

    def window_entry(name, source, replaces, launches, mode, kind):
        r = mres[mode][kind]        # Mistral-7B's shapes, window 4096
        return entry(f"{name}[{mode},window]", source, replaces, launches,
                     r["err"], r["ms"], r["plain_ms"],
                     (r["bound_ms"], r["bound_by"]), r["library_ms"])

    def flash_err(*names):
        return max(res[n] for res in flash_res for n in names)

    kernels = [
        # launches_eval: [eval]'s (generate_batch and the judge server)
        attn_entry("ragged_attention[bf16]", "ragged_extend.cu",
                   "ragged_attention.py:287", launches["bf16"][0], "bf16",
                   "extend", launches_eval=eval_launches[0]),
        attn_entry("ragged_decode_attention[bf16]", "ragged_decode.cu",
                   "ragged_attention.py:645", launches["bf16"][1], "bf16",
                   "decode", launches_eval=eval_launches[1]),
        attn_entry("ragged_attention[int8]", "ragged_extend.cu",
                   "ragged_attention.py:287", launches["w4kv8"][0], "int8",
                   "extend", launches_serve_a8_prefill=surface[
                       "serve-a8-prefill"][0]),
        attn_entry("ragged_decode_attention[int8]", "ragged_decode.cu",
                   "ragged_attention.py:645", launches["w4kv8"][1], "int8",
                   "decode", launches_serve_a8_prefill=surface[
                       "serve-a8-prefill"][1]),
        # int8 rows at the int4 grid (kv_maxq 7); launches from
        # [serve-kv4grid]
        attn_entry("ragged_attention[int4grid]", "ragged_extend.cu",
                   "ragged_attention.py:287",
                   surface["serve-kv4grid"][0], "int4grid", "extend"),
        attn_entry("ragged_decode_attention[int4grid]", "ragged_decode.cu",
                   "ragged_attention.py:645",
                   surface["serve-kv4grid"][1], "int4grid", "decode"),
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
                     w4res[64],
                     launches_serve_kv4grid=surface["serve-kv4grid"][2],
                     launches_serve_a8_prefill=surface[
                         "serve-a8-prefill"][2]),
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
        # launches_train_cli: over the four [train-cli*] runs (masked
        # batches: 0, as in the reference)
        entry("flash_attention_fwd", "flash_attention.cu",
              "flash_attention.py:121", launches_fwd,
              flash_err("out_err"), flash_t["fwd_ms"],
              flash_t["plain_fwd_ms"], flash_t["fwd_bound"],
              flash_t["library_fwd_ms"], launches_train_cli=
              train_cli_launches["flash_attention.launches_fwd"]),
        entry("flash_attention_bwd_dkv", "flash_attention.cu",
              "flash_attention.py:176", launches_dkv,
              flash_err("dk_err", "dv_err"), flash_t["dkv_ms"],
              flash_t["plain_bwd_ms"], flash_t["dkv_bound"],
              flash_t["library_bwd_ms"], launches_train_cli=
              train_cli_launches["flash_attention.launches_dkv"]),
        entry("flash_attention_bwd_dq", "flash_attention.cu",
              "flash_attention.py:237", launches_dq, flash_err("dq_err"),
              flash_t["dq_ms"], flash_t["plain_bwd_ms"],
              flash_t["dq_bound"], flash_t["library_bwd_ms"],
              launches_train_cli=train_cli_launches[
                  "flash_attention.launches_dq"]),
    ]
    # the Qwen2-7B runs (head_dim 128, G 7) launch the int8 kernels, and
    # so do the MoE runs (Mixtral G 4, Qwen3-MoE G 8)
    for e in kernels:
        if e["name"] in ("ragged_attention[int8]",
                         "ragged_decode_attention[int8]"):
            i = int(e["name"].startswith("ragged_decode"))
            e["launches_serve_qwen2"] = qwen2["w8kv8"][i] + qwen2["w4kv8"][i]
            for run, c in moe_runs.items():
                e[f"launches_serve_{run.replace('-', '_')}"] = c[i]
    # the StableLM-3B runs (head_dim 80, padded to the kernels' 96) and
    # the Phi-3-mini runs (head_dim 96; both bf16 runs)
    for e in kernels:
        for mode, run in (("bf16", "bf16"), ("int8", "kv8"), ("int4", "kv4")):
            if e["name"] in (f"ragged_attention[{mode}]",
                             f"ragged_decode_attention[{mode}]"):
                i = int(e["name"].startswith("ragged_decode"))
                e["launches_serve_stablelm"] = stablelm[run][i]
                e["launches_serve_phi3_mini"] = phi3[run][i] + (
                    phi3["bf16-again"][i] if run == "bf16" else 0)
        # InternVL3-8B (hd 128, G 7: bf16 KV twice, int8 KV) and AuroraCap
        # with a SigLIP tower (int8 KV)
        for mode, runs in (("bf16", ("bf16", "bf16-again")),
                           ("int8", ("kv8",))):
            if e["name"] in (f"ragged_attention[{mode}]",
                             f"ragged_decode_attention[{mode}]"):
                i = int(e["name"].startswith("ragged_decode"))
                e["launches_serve_internvl"] = sum(internvl[r][i]
                                                   for r in runs)
                if mode == "int8":
                    e["launches_serve_siglip"] = siglip[i]
        if e["name"] == "w8a8_matmul":
            e["launches_serve_mixtral_w8kv8"] = moe_runs["mixtral-w8kv8"][3]
        if e["name"] == "w4a8_matmul_tiled":
            e["launches_serve_mixtral_w4kv8"] = moe_runs["mixtral-w4kv8"][3]
    kernels += moe_entries(moe_res, moe_runs, mla_runs)
    # the zoo's head widths and groups (FAMILY_SHAPES, 4 layers of rows);
    # launches: the kernel's in that KV mode over the Gemma-2-9B run
    # (head_dim 256, G 2: the first family's shape; the others are held
    # to their twins in [kernels] only)
    gemma_run = {"bf16": "bf16", "int8": "kv8", "int4": "kv4"}
    for fam, hd, Hq, hkv in FAMILY_SHAPES:
        for mode in KV_MODES:
            for i, (name, source, line, step) in enumerate((
                    ("ragged_attention", "ragged_extend.cu", "287",
                     "extend"),
                    ("ragged_decode_attention", "ragged_decode.cu", "645",
                     "decode"))):
                r = fam_res[(fam, mode)][step]
                kernels.append(entry(
                    f"{name}[{mode},{fam}]", source,
                    "ragged_attention.py:" + line,
                    gemma2[gemma_run[mode]][i], r["err"], r["ms"],
                    r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                    r["library_ms"], head_dim=hd, q_heads=Hq, kv_heads=hkv,
                    kernel=extend_kernel_name(hd) if step == "extend"
                    else "decode_kernel"))
    # extend_d256_kernel at Gemma-2-9B's served extend, with the even
    # layers' window and cap and with neither; launches: the Gemma-2 run's
    # in that KV mode
    for mode in KV_MODES:
        for opts in GEMMA2_SERVED_OPTIONS:
            tag = served_tag(opts)
            r = fam_res[("gemma2-9b-served", mode, tag)]["extend"]
            kernels.append(entry(
                f"ragged_attention[{mode},gemma2-9b,served,{tag}]",
                "ragged_extend.cu", "ragged_attention.py:287",
                gemma2[gemma_run[mode]][0], r["err"], r["ms"],
                r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                r["library_ms"], head_dim=256, q_heads=16, kv_heads=8,
                kernel="extend_d256_kernel"))
    # extend_kernel at its width 96 at Phi-3-mini's served extend (window
    # 2047) and StableLM-3B's (hd 80); launches: that model's run in that
    # KV mode (Phi-3: both bf16 runs)
    served_runs = {"phi3-mini-served": phi3, "stablelm-3b-served": stablelm}
    for fam, hkv, case in SERVED_CASES:
        c = case()
        for mode in KV_MODES:
            r = fam_res[(fam, mode)]["extend"]
            runs = served_runs[fam]
            n = runs[gemma_run[mode]][0] + (
                runs["bf16-again"][0] if mode == "bf16" and
                "bf16-again" in runs else 0)
            kernels.append(entry(
                f"ragged_attention[{mode},{fam.replace('-served', '')},"
                f"served]", "ragged_extend.cu", "ragged_attention.py:287",
                n, r["err"], r["ms"], r["plain_ms"],
                (r["bound_ms"], r["bound_by"]), r["library_ms"],
                head_dim=c["hd"], q_heads=c["Hq"], kv_heads=hkv,
                window=c.get("window", 0),
                kernel=extend_kernel_name(c["hd"])))
    # flash at D 256 (google/gemma-7b: B 2, T 2048, H 16); launches from
    # [train-dpo-gemma], whose attention runs them; [train-dpo]'s (D 128)
    # beside the D 128 entries above. D 512 (FLASH_D512; its errors also
    # over the D 384 case, padded to 512): the launcher's width-512
    # counters over the whole main path (no model of the zoo has such a
    # head)
    for width, launches_w in (("d256", dpo256), ("d512", launches512)):
        t_w, res_w = flash_wide[width]
        for k_, src_line, ms, bound, plain_k, lib_k, errs, n in (
                ("fwd", "121", "fwd_ms", "fwd_bound", "plain_fwd_ms",
                 "library_fwd_ms", ("out_err",), launches_w[0]),
                ("bwd_dkv", "176", "dkv_ms", "dkv_bound", "plain_bwd_ms",
                 "library_bwd_ms", ("dk_err", "dv_err"), launches_w[1]),
                ("bwd_dq", "237", "dq_ms", "dq_bound", "plain_bwd_ms",
                 "library_bwd_ms", ("dq_err",), launches_w[2])):
            kernels.append(entry(
                f"flash_attention_{k_}[{width}]", "flash_attention.cu",
                "flash_attention.py:" + src_line, n,
                max(res[e] for res in res_w for e in errs), t_w[ms],
                t_w[plain_k], t_w[bound], t_w[lib_k],
                library_backend=t_w["library_backend"]))
    for e in kernels:
        if e["name"].startswith("flash_attention_") and "[" not in e["name"]:
            i = ("fwd", "bwd_dkv", "bwd_dq").index(
                e["name"][len("flash_attention_"):])
            e["launches_train_dpo"] = dpo[i]
            # over every rank of both [train-sp] meshes, and [train-dp2] /
            # [train-fsdp2]'s forwards
            e["launches_train_sp"] = sum(
                c["flash_attention.launches_" + ("fwd", "dkv", "dq")[i]]
                for c in par["train_sp"].values())
            if i == 0:
                e["launches_train_dp"] = sum(par["train_dp"].values())
    # flash_attention_lse: the same kernels at one ring block (B 1, T 4096,
    # H 32, D 128, causal; errors also at q_offset -1); launches: its
    # forwards over every rank of [train-sp] (the sp 4 ring), and in
    # [sp-attn]'s ring and hybrid cases
    lse = par["lse"]
    kernels.append(entry(
        "flash_attention_lse", "flash_attention.cu", "flash_attention.py:463",
        sum(c["flash_attention_lse.launches"]
            for c in par["train_sp"].values()),
        max(lse["causal_out_err"], lse["stripe_out_err"]), lse["ms"],
        lse["plain_ms"], lse["bound"], lse["library_ms"],
        launches_sp_attn=par["sp_attn_lse"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
