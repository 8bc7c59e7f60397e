#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

AuroraCap-7B caption serving at full published widths with random bf16
weights (seeded): uint8 frames → CLIP normalize → ViT-H/14 with ToMe →
projector → fusion → one batched extend → 256-token greedy decode via
`aurora_tpu_torch.serve.engine.ServeEngine` with bf16 KV. Phases, one
line each; any failure raises and exits non-zero:

1. device   — requires CUDA; prints the card's name and power limit
2. build    — compiles the CUDA kernels from aurora_tpu_torch/csrc
3. kernels  — each kernel vs its plain PyTorch twin at the slice's shapes
              (bf16 in, fp32 reference; decode row writes exact)
4. serve    — 4 requests of 8 frames each to 256 tokens; the kernels'
              launch counts must rise and the plain twins' stay 0
5. logits   — one extend wave's logits through the kernels vs through the
              plain twins, on the same engine state
6. the kernels' JSON line, then {"ok": true, "device": {...}} last.

float32 references run with TF32 disabled for matmuls and cuDNN
convolutions, so they are true fp32.
"""

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
LOGITS_REL_TOL = 5e-2     # max |Δlogits| / max |logits| after 32 bf16 layers


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


class ByteTokenizer:
    """Stand-in tokenizer (no tokenizer files exist): BOS 1, then one id
    per UTF-8 byte, offset past the special ids."""

    def encode(self, text, add_special_tokens=True):
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([1] + ids) if add_special_tokens else ids


def kernel_phase(torch, ra, dev):
    """Each kernel vs its plain twin at the serving shapes (L = 32,
    S = 1792, hd = 128, bf16 KV), including GQA, permuted rows, a query
    offset > 0 and a padded / inactive lane."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    L, B, S, hd, T = 32, 4, 1792, 128, 1536
    results = {}
    for hkv in (32, 8):
        bf = dict(device=dev, dtype=torch.bfloat16)
        k = torch.randn((L, B, hkv, S, hd), generator=g, **bf)
        v = torch.randn((L, B, hkv, S, hd), generator=g, **bf)
        i32 = dict(device=dev, dtype=torch.int32)
        layer = torch.tensor([17], **i32)
        rows = torch.tensor([2, 0, 3, 1], **i32)

        q = torch.randn((B, T, 32, hd), generator=g, **bf)
        offs = torch.tensor([0, 256, 0, 0], **i32)
        lens = torch.tensor([1392, 256 + 1400, 1536, 0], **i32)
        got = ra.ragged_attention(q, k, v, lens, offs, rows, layer=layer)
        want = ra.ragged_attention_plain(q.float(), k, v, lens, offs, rows,
                                         layer=17)
        torch.cuda.synchronize()
        err_e = (got.float() - want).abs().max().item()
        rel_e = lane_rel_err(got, want, (0, 1, 2))
        check(bool(torch.isfinite(got).all()), "extend output not finite")
        check(bool((got[3] == 0).all()), "padded extend lane not zero")
        check(err_e <= EXTEND_ABS_TOL, f"extend hkv={hkv} err {err_e}")
        check(rel_e <= EXTEND_REL_TOL, f"extend hkv={hkv} rel err {rel_e}")
        ms_e = cuda_ms(lambda: ra.ragged_attention(q, k, v, lens, offs,
                                                   rows, layer=layer))
        ms_ep = cuda_ms(lambda: ra.ragged_attention_plain(
            q, k, v, lens, offs, rows, layer=17), reps=3)
        del q, got, want

        qd = torch.randn((B, 1, 32, hd), generator=g, **bf)
        kn = torch.randn((B, hkv, hd), generator=g, **bf)
        vn = torch.randn((B, hkv, hd), generator=g, **bf)
        dlens = torch.tensor([1648, 700, 0, 1], **i32)
        kp, vp = k.clone(), v.clone()
        out, _, _ = ra.ragged_decode_attention(qd, kn, vn, k, v, dlens, rows,
                                               layer=layer)
        want, _, _ = ra.ragged_decode_attention_plain(
            qd.float(), kn, vn, kp, vp, dlens, rows, layer=17)
        torch.cuda.synchronize()
        check(torch.equal(k, kp) and torch.equal(v, vp),
              "decode row writes differ from the plain twin")
        err_d = (out.float() - want).abs().max().item()
        rel_d = lane_rel_err(out, want, (0, 1, 3))
        check(bool((out[2] == 0).all()), "inactive decode lane not zero")
        check(err_d <= DECODE_ABS_TOL, f"decode hkv={hkv} err {err_d}")
        check(rel_d <= DECODE_REL_TOL, f"decode hkv={hkv} rel err {rel_d}")
        ms_d = cuda_ms(lambda: ra.ragged_decode_attention(
            qd, kn, vn, k, v, dlens, rows, layer=layer), reps=20)
        ms_dp = cuda_ms(lambda: ra.ragged_decode_attention_plain(
            qd, kn, vn, kp, vp, dlens, rows, layer=17), reps=20)
        phase("kernels", hkv=hkv, extend_err=f"{err_e:.3e}",
              extend_rel=f"{rel_e:.3e}", extend_ms=f"{ms_e:.3f}",
              extend_plain_ms=f"{ms_ep:.3f}", decode_err=f"{err_d:.3e}",
              decode_rel=f"{rel_d:.3e}", decode_ms=f"{ms_d:.4f}",
              decode_plain_ms=f"{ms_dp:.4f}",
              tol=f"extend:{EXTEND_ABS_TOL}/{EXTEND_REL_TOL},"
                  f"decode:{DECODE_ABS_TOL}/{DECODE_REL_TOL}")
        results[hkv] = (err_e, ms_e, ms_ep, err_d, ms_d, ms_dp)
        del k, v, kp, vp
        torch.cuda.empty_cache()
    return results


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    from aurora_tpu_torch.ops import cuda_build
    from aurora_tpu_torch.ops.pallas import ragged_attention as ra
    from aurora_tpu_torch.serve import engine as engine_mod
    from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
    from aurora_tpu_torch.serve.multimodal import (_PLACEHOLDER_BASE,
                                                   AuroraCapServing)
    from aurora_tpu_torch.serve.scheduler import FinishReason

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
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          nvcc_seconds=f"{cuda_build.build_seconds:.1f}",
          library=cuda_build.library_path().name)

    kres = kernel_phase(torch, ra, dev)

    # ---- main path at full width ------------------------------------------
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
    clips = [rng.integers(0, 256, size=(N_FRAMES, size, size, 3),
                          dtype=np.uint8) for _ in range(N_REQUESTS + 1)]
    prompt = " ".join(["<image>"] * N_FRAMES) + \
        "\nDescribe the video in detail."
    reqs = [mm.build_request(f"clip{i}", prompt, clips[i],
                             max_new_tokens=MAX_NEW, eos_ids=())
            for i in range(N_REQUESTS)]
    P = len(reqs[0].input_ids)
    for r in reqs:
        n_ph = sum(t >= _PLACEHOLDER_BASE for t in r.input_ids)
        check(n_ph == N_FRAMES * 171, f"{r.rid}: {n_ph} visual tokens")
    # warm the ViT (cuDNN/cuBLAS set-up) on a clip the run does not use
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

    ecfg = EngineConfig(max_batch=N_REQUESTS, kv_chunk=256,
                        prefill_buckets=(1536,), decode_steps=16,
                        disable_radix_cache=True, max_seq_len=P + MAX_NEW)
    engine = ServeEngine(model.llm, cfg.llm, ecfg, embed_fn=timed_embed_fn,
                         device=dev, seed=SEED)
    for fn in (ra.ragged_attention, ra.ragged_decode_attention):
        fn.launches = 0
    for fn in (ra.ragged_attention_plain, ra.ragged_decode_attention_plain):
        fn.calls = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.add_request(r)
    done = {}
    while engine.has_work():
        for r in engine.step():
            done[r.rid] = r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ragged_attention": ra.ragged_attention.launches,
                "ragged_decode_attention": ra.ragged_decode_attention.launches}
    plain_calls = (ra.ragged_attention_plain.calls,
                   ra.ragged_decode_attention_plain.calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == N_REQUESTS, f"{len(done)} requests finished")
    V = cfg.llm.vocab_size
    for r in done.values():
        check(r.finished == FinishReason.LENGTH and r.error is None,
              f"{r.rid}: finished={r.finished} error={r.error}")
        check(len(r.output_ids) == MAX_NEW,
              f"{r.rid}: {len(r.output_ids)} tokens")
        check(all(0 <= t < V for t in r.output_ids), f"{r.rid}: bad ids")
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(plain_calls == (0, 0), f"plain twins ran: {plain_calls}")
    vit_s = float(np.mean(vit_times))
    gen_tokens = sum(len(r.output_ids) for r in done.values())
    llm_extend_s = engine.t_extend_s - sum(vit_times)
    decode_ms = engine.t_decode_s / max(engine._steps, 1) * 1e3
    phase("serve", card=repr(card), requests=len(done), prompt_tokens=P,
          visual_tokens=N_FRAMES * n_vis, init_s=f"{init_s:.1f}",
          vit_proj_s_per_clip=f"{vit_s:.4f}",
          extend_s=f"{llm_extend_s:.4f}",
          decode_ms_per_step=f"{decode_ms:.3f}",
          decode_steps=engine._steps,
          tokens_per_s=f"{gen_tokens / wall:.1f}",
          wall_s=f"{wall:.2f}", peak_gb=f"{peak_gb:.2f}",
          launches=json.dumps(launches).replace(" ", ""))

    # ---- extend logits: kernels vs plain twins, same engine state ---------
    runner = engine.runner
    T = ecfg.prefill_buckets[0]
    embeds = torch.zeros((N_REQUESTS, T, cfg.llm.hidden_size),
                         dtype=torch.bfloat16, device=dev)
    for i, r in enumerate(reqs):
        embeds[i, :P] = mm.embed_fn(r)
    row_ids = np.arange(N_REQUESTS, dtype=np.int32)
    offs = np.zeros(N_REQUESTS, np.int32)
    lens = np.full(N_REQUESTS, P, np.int32)
    logits_k = runner.extend(embeds, row_ids, offs, lens)
    # the plain twin stands in for the kernel in this call only
    with mock.patch.object(engine_mod, "ragged_attention",
                           ra.ragged_attention_plain):
        logits_p = runner.extend(embeds, row_ids, offs, lens)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "extend logits not finite")
    check(tuple(logits_k.shape) == (N_REQUESTS, V), "extend logits shape")
    rel = ((logits_k - logits_p).abs().max()
           / logits_p.abs().max()).item()
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    phase("logits", rel_err=f"{rel:.3e}", tol=LOGITS_REL_TOL,
          argmax_agree=f"{agree}/{N_REQUESTS}")
    check(rel <= LOGITS_REL_TOL, f"extend logits rel err {rel}")

    r32 = kres[32]     # the Vicuna shape: Hq = Hkv = 32
    kernels = [
        {"name": "ragged_attention", "route": "cuda",
         "source": "aurora_tpu_torch/csrc/ragged_extend.cu",
         "replaces": "aurora_tpu/ops/pallas/ragged_attention.py:287",
         "launches": launches["ragged_attention"],
         "max_abs_err": max(kres[h][0] for h in kres),
         "ms": r32[1], "plain_ms": r32[2]},
        {"name": "ragged_decode_attention", "route": "cuda",
         "source": "aurora_tpu_torch/csrc/ragged_decode.cu",
         "replaces": "aurora_tpu/ops/pallas/ragged_attention.py:645",
         "launches": launches["ragged_decode_attention"],
         "max_abs_err": max(kres[h][3] for h in kres),
         "ms": r32[4], "plain_ms": r32[5]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
