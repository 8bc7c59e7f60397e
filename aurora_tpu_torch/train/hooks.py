"""Training-time observability hooks (aurora_tpu/train/hooks.py).

  * dataset_info — decode and log the first samples, so the prompt
    template and the image-token layout can be read before steps are
    spent;
  * EvaluateChatHook — generate from fixed prompts every N steps to watch
    the model come alive, through the port's cli/infer.caption (with
    frames) or generate/engine.generate (text).

Plain callables: the training loop calls them directly.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from aurora_tpu_torch.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


def dataset_info(dataset, tokenizer, n: int = 2,
                 log=print) -> List[str]:
    """Decode the first n samples (image markers rendered as <image>)."""
    out = []
    for i in range(min(n, len(dataset))):
        d = dataset[i]
        ids = [t for t in d["input_ids"]]
        text = "".join(
            "<image>" if t == IMAGE_TOKEN_INDEX
            else tokenizer.decode([t]) for t in ids)
        n_loss = sum(1 for t in d["labels"] if t != IGNORE_INDEX)
        msg = (f"[dataset sample {i}] len={len(ids)} loss_tokens={n_loss} "
               f"text={text[:400]!r}")
        log(msg)
        out.append(msg)
    return out


class EvaluateChatHook:
    """Generate from fixed prompts every `every_n_steps` steps."""

    def __init__(self, tokenizer, acfg, *, prompts: List[str],
                 pixel_values=None,
                 kept_ratio: float = 1.0, max_new_tokens: int = 32,
                 every_n_steps: int = 500, image_size: int = 378,
                 log=print):
        self.tokenizer = tokenizer
        self.acfg = acfg
        self.prompts = prompts
        self.pixel_values = pixel_values  # [F, C, H, W] or None
        self.kept_ratio = kept_ratio
        self.max_new_tokens = max_new_tokens
        self.every = every_n_steps
        self.image_size = image_size
        self.log = log

    def maybe_run(self, step: int, params) -> Optional[List[str]]:
        if step % self.every != 0:
            return None
        return self.run(params, step)

    @torch.no_grad()
    def run(self, params, step: int = -1) -> List[str]:
        """params: the AuroraModel being trained."""
        from aurora_tpu_torch.cli.infer import caption
        from aurora_tpu_torch.generate.engine import decode_tokens, generate
        from aurora_tpu_torch.generate.sampler import SamplingParams

        emb = params.llm.embed_tokens
        outs = []
        for prompt in self.prompts:
            if self.pixel_values is not None:
                text = caption(params, self.acfg, self.tokenizer,
                               pixel_values=self.pixel_values,
                               prompt=prompt,
                               token_kept_ratio=self.kept_ratio,
                               max_new_tokens=self.max_new_tokens,
                               image_size=self.image_size)
            else:
                ids = torch.tensor([self.tokenizer.encode(prompt)],
                                   device=emb.device)
                eos = tuple({self.tokenizer.eos_token_id} - {None}) or (2,)
                res = generate(params.llm, self.acfg.llm, emb[ids],
                               torch.ones_like(ids, dtype=torch.bool),
                               max_new_tokens=self.max_new_tokens,
                               sampling=SamplingParams(), eos_ids=eos)
                text = decode_tokens(self.tokenizer, res, eos_ids=eos)[0]
            self.log(f"[eval-chat step={step}] {prompt!r} -> {text!r}")
            outs.append(text)
        return outs
