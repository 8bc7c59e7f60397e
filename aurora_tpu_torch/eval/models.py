"""Model adapters for the evaluator (aurora_tpu/eval/models.py) on the
port: the only eval module that is ported rather than copied.

Parity: the lmms-eval AuroraCap adapter
(src/lmms-eval/lmms_eval/models/auroracap.py:50-529) — xtuner-dir load,
video frame sampling, vicuna prompt building, generate; loglikelihood
over answer continuations.

Frames are decoded on the host (`read_video`) and resized, cropped and
normalized on the model's device (`clip_resize_crop_device`,
`clip_normalize_device`: within 2/255 of the reference's PIL pipeline),
since the GPU host has no PIL. `generate_batch` serves every doc through
`ServeEngine` and `AuroraCapServing` with the reference's own
EngineConfig; `generate_until` runs `cli.infer.caption` (dense KV cache)
or, for text-only docs, `generate`.
"""

from __future__ import annotations

import numpy as np
import torch

from aurora_tpu_torch.cli.infer import caption, load_model
from aurora_tpu_torch.data.preprocess import (clip_normalize_device,
                                              clip_resize_crop_device)
from aurora_tpu_torch.data.video import read_video
from aurora_tpu_torch.models.llama import llama_apply


class AuroraCapEval:
    """generate_until / loglikelihood over an xtuner-format checkpoint,
    on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, pretrained: str, *, token_merge_ratio: float = 0.8,
                 num_frames: int = 8, image_size: int = 378,
                 max_new_tokens: int = 1024, dtype=torch.bfloat16,
                 device="cuda"):
        self.model, self.cfg, self.tokenizer = load_model(pretrained, dtype,
                                                          device)
        self.device = torch.device(device)
        self.token_merge_ratio = token_merge_ratio
        self.num_frames = num_frames
        self.image_size = image_size
        self.max_new_tokens = max_new_tokens

    def _crops_all(self, visuals) -> torch.Tensor:
        """doc_to_visual's list → [F, size, size, 3] uint8-valued float32
        frames on the device. One visual: a video path or a pre-decoded
        [F, H, W, 3] frame array (image tasks like MMBench hand arrays
        straight through). N visuals (multi-image benchmarks such as
        muirbench / mirb): each image becomes ONE frame of AuroraCap's
        multi-frame input — dropping all but visuals[0] would answer
        comparison questions from the first image alone."""
        size = self.image_size
        if len(visuals) == 1:
            v = visuals[0]
            raw = v if isinstance(v, np.ndarray) else read_video(
                v, self.num_frames)
            return clip_resize_crop_device(
                torch.as_tensor(np.asarray(raw), device=self.device), size,
                size)
        # images of different sizes: resized one at a time
        return torch.cat([clip_resize_crop_device(torch.as_tensor(
            np.asarray(v if isinstance(v, np.ndarray)
                       else read_video(v, 1))[:1], device=self.device),
            size, size) for v in visuals])

    def _frames_all(self, visuals) -> torch.Tensor:
        """→ [F, 3, size, size] normalized float32 frames on the device."""
        return clip_normalize_device(self._crops_all(visuals))

    @staticmethod
    def _trim_stops(text: str, gk) -> str:
        for s in gk.get("stop", ()) or ():
            i = text.find(s)
            if i >= 0:
                text = text[:i]
        return text

    def generate_until(self, doc, task) -> str:
        prompt = task.doc_to_text(doc)
        gk = task.cfg.generation_kwargs
        visuals = task.doc_to_visual(doc) if task.doc_to_visual else None
        if not visuals:  # text-only tasks (gsm8k/ifeval/mmlu free-form)
            return self._trim_stops(self._generate_text(prompt, gk), gk)
        px = self._frames_all(visuals)
        return self._trim_stops(caption(
            self.model, self.cfg, self.tokenizer, pixel_values=px,
            prompt=prompt,
            token_kept_ratio=self.token_merge_ratio,
            temperature=float(gk.get("temperature", 0.0)),
            top_p=float(gk.get("top_p", 1.0)),
            max_new_tokens=int(gk.get("max_new_tokens",
                                      self.max_new_tokens)),
            image_size=self.image_size), gk)

    def _generate_text(self, prompt: str, gk) -> str:
        """Plain-text decode (no visual stream, no template wrapping —
        text benchmarks carry their own few-shot formatting)."""
        from aurora_tpu_torch.generate.engine import decode_tokens, generate
        from aurora_tpu_torch.generate.sampler import SamplingParams
        ids = self.tokenizer.encode(prompt)
        llm = self.model.llm
        embeds = llm.embed_tokens[torch.as_tensor(
            [ids], device=llm.embed_tokens.device)]
        eos = tuple({self.tokenizer.eos_token_id} - {None}) or (2,)
        res = generate(
            llm, self.cfg.llm, embeds,
            torch.ones((1, len(ids)), dtype=torch.bool,
                       device=embeds.device),
            max_new_tokens=int(gk.get("max_new_tokens",
                                      self.max_new_tokens)),
            sampling=SamplingParams(
                temperature=float(gk.get("temperature", 0.0)),
                top_p=float(gk.get("top_p", 1.0))),
            eos_ids=eos,
            generator=torch.Generator(device=embeds.device).manual_seed(0))
        return decode_tokens(self.tokenizer, res, eos_ids=eos)[0]

    def generate_batch(self, docs, task) -> list:
        """ALL docs through the serve engine's continuous batching (the
        reference parallelizes with accelerate DP, auroracap.py:118-142;
        here one card batches instead)."""
        from aurora_tpu_torch.data.text import build_video_prompt
        from aurora_tpu_torch.generate.sampler import SamplingParams
        from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
        from aurora_tpu_torch.serve.multimodal import AuroraCapServing
        from aurora_tpu_torch.serve.scheduler import Request
        from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE

        gk = task.cfg.generation_kwargs
        max_new = int(gk.get("max_new_tokens", self.max_new_tokens))
        stops = tuple(gk.get("stop", ()) or ())
        sampling = SamplingParams(
            temperature=float(gk.get("temperature", 0.0)),
            top_p=float(gk.get("top_p", 1.0)))
        eos = tuple({self.tokenizer.eos_token_id} - {None}) or (2,)

        mm = None
        reqs = []
        for i, doc in enumerate(docs):
            visuals = (task.doc_to_visual(doc) if task.doc_to_visual
                       else None)
            if not visuals:  # text-only docs: plain token requests
                reqs.append(Request(
                    rid=f"doc{i}",
                    input_ids=self.tokenizer.encode(task.doc_to_text(doc)),
                    sampling=sampling, max_new_tokens=max_new,
                    eos_ids=eos, stop_strs=stops))
                continue
            if mm is None:
                mm = AuroraCapServing(self.model, self.tokenizer,
                                      kept_ratio=self.token_merge_ratio,
                                      image_size=self.image_size)
            # uint8 crops: the request hashes them, the engine's embed_fn
            # normalizes them on the device
            px = self._crops_all(visuals).to(torch.uint8).cpu().numpy()
            prompt_text = build_video_prompt(task.doc_to_text(doc),
                                             px.shape[0],
                                             PROMPT_TEMPLATE.vicuna)
            reqs.append(mm.build_request(
                f"doc{i}", prompt_text, px, sampling=sampling,
                max_new_tokens=max_new, eos_ids=eos, stop_strs=stops))
        prompt_max = max(len(r.input_ids) for r in reqs)
        ecfg = EngineConfig(
            max_batch=min(8, len(reqs)),
            max_seq_len=prompt_max + max_new,
            num_slots=max(1024, prompt_max * 2),
            prefill_buckets=(-(-prompt_max // 128) * 128,),
            kv_chunk=512, kv_dtype=self.model.llm.embed_tokens.dtype)
        engine = ServeEngine(self.model.llm, self.cfg.llm, ecfg,
                             embed_fn=mm.embed_fn if mm else None,
                             device=self.device, tokenizer=self.tokenizer)
        for r in reqs:
            engine.add_request(r)
        done = {}
        while engine.has_work():
            for r in engine.step():
                done[r.rid] = r
        failed = [i for i in range(len(docs))
                  if done[f"doc{i}"].error is not None
                  or not done[f"doc{i}"].output_ids]
        if failed:
            # a silently empty prediction would quietly depress the
            # aggregate metric — fail loudly with the engine's reason
            msgs = [f"doc{i}: {done[f'doc{i}'].error}" for i in failed[:3]]
            raise RuntimeError(
                f"{len(failed)} eval requests failed in the engine: "
                + "; ".join(msgs))
        return [self._trim_stops(
            self.tokenizer.decode(done[f"doc{i}"].output_ids,
                                  skip_special_tokens=True), gk)
                for i in range(len(docs))]

    @torch.no_grad()
    def loglikelihood(self, context_ids, continuation_ids,
                      pixel_values=None) -> float:
        """Σ log p(continuation | context) (auroracap.py:232-297).

        MULTIMODAL scoring: when pixel_values [F, C, H, W] (normalized; an
        array or a tensor) is given, context_ids may contain
        IMAGE_TOKEN_INDEX (-200) markers — one per frame. The ViT+ToMe
        encoder runs at token_merge_ratio, visual embeddings are spliced
        over the markers, and the continuation is scored over the fused
        sequence, in fp32 over the log-softmax."""
        cont = list(continuation_ids)
        llm = self.model.llm
        dev = llm.embed_tokens.device
        ids = torch.as_tensor([list(context_ids) + cont], device=dev)
        if pixel_values is None:
            logits = llama_apply(llm, self.cfg.llm, input_ids=ids)
        else:
            from aurora_tpu_torch.models.aurora import (encode_visual,
                                                        fuse_multimodal)
            px = torch.as_tensor(pixel_values, device=dev).to(
                llm.embed_tokens.dtype)[None]
            groups = [encode_visual(self.model, px, self.token_merge_ratio)]
            fused = fuse_multimodal(llm.embed_tokens, ids, groups)
            logits = llama_apply(llm, self.cfg.llm,
                                 inputs_embeds=fused["inputs_embeds"])
        # the continuation is always the TAIL of the (fused) sequence
        lp = torch.log_softmax(logits[0].float(), -1)
        n = len(cont)
        tok_lp = lp[-n - 1:-1].gather(
            1, torch.as_tensor(cont, device=dev)[:, None])[:, 0]
        return float(tok_lp.sum())

    def loglikelihood_choices(self, doc, task) -> list:
        """Σ log p(choice | video+question) for every task choice — the
        lmms-eval multiple_choice/mc_ppl request type
        (auroracap.py:232-297 loglikelihood flow). Returns a list of
        floats aligned with task.doc_to_choice(doc)."""
        from aurora_tpu_torch.data.text import (build_video_prompt,
                                                encode_with_image_tokens)
        from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE
        choices = task.doc_to_choice(doc)
        visuals = (task.doc_to_visual(doc) if task.doc_to_visual
                   else None)
        px = self._frames_all(visuals) if visuals else None
        prompt = task.doc_to_text(doc)
        if px is not None:
            prompt = build_video_prompt(prompt, px.shape[0],
                                        PROMPT_TEMPLATE.vicuna)
            ctx = encode_with_image_tokens(prompt, self.tokenizer)
        else:
            ctx = self.tokenizer.encode(prompt)
        out = []
        for choice in choices:
            cont = self.tokenizer.encode(str(choice),
                                         add_special_tokens=False)
            out.append(self.loglikelihood(ctx, cont, pixel_values=px))
        return out


class HTTPModelEval:
    """Adapter that evaluates a served model over the OpenAI API — lets
    the harness score any aurora_tpu_torch.cli.serve deployment.
    Multimodal docs go through the native /generate endpoint's
    `video_path` (the server loads frames itself — standard for local
    deployments that share a filesystem); silently evaluating an image
    task text-blind would produce plausible-but-meaningless scores."""

    def __init__(self, base_url: str, max_new_tokens: int = 1024):
        from aurora_tpu_torch.eval.judge import JudgeClient
        self.base_url = base_url.rstrip("/")
        self.max_new_tokens = max_new_tokens
        self._client = JudgeClient(base_url, max_tokens=max_new_tokens)

    def generate_until(self, doc, task) -> str:
        from aurora_tpu_torch.utils.http import chat_completion, post_json

        gk = task.cfg.generation_kwargs
        stops = list(gk.get("stop", ()) or ())
        visuals = task.doc_to_visual(doc) if task.doc_to_visual else None
        prompt = task.doc_to_text(doc)
        if not visuals:
            return chat_completion(
                self.base_url,
                [{"role": "user", "content": prompt}],
                temperature=float(gk.get("temperature", 0.0)),
                max_tokens=int(gk.get("max_new_tokens",
                                      self.max_new_tokens)),
                stop=stops)
        if len(visuals) != 1 or not isinstance(visuals[0], str):
            raise ValueError(
                f"task {task.cfg.name!r}: HTTP-served models accept one "
                "server-visible visual path per doc (got "
                f"{len(visuals)} of {type(visuals[0]).__name__}) — run "
                "multi-image/array tasks with --model auroracap")
        body = {"text": prompt, "video_path": visuals[0],
                "max_new_tokens": int(gk.get("max_new_tokens",
                                             self.max_new_tokens)),
                "temperature": float(gk.get("temperature", 0.0))}
        if stops:
            body["stop"] = stops
        out = post_json(self.base_url + "/generate", body)
        if "error" in out:
            raise RuntimeError(f"/generate failed: {out['error']}")
        return out["text"]
