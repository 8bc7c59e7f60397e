"""In-process serving runtime, no HTTP (aurora_tpu/serve/runtime.py).

The offline and batch entry of the reference's benchmark and judge
scripts (sglang's `Runtime`, srt/server.py:501-640): submit N prompts to
a `ServeEngine`, step it until every request is done, and return the
texts in input order; continuous batching, the prefix cache and stop
strings included. Constrained decoding (`regex=`) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from aurora_tpu_torch.data.text import auto_tokenizer
from aurora_tpu_torch.generate.sampler import SamplingParams
from aurora_tpu_torch.models.convert import (_read_config,
                                             llama_config_from_hf,
                                             llama_params_from_hf,
                                             load_torch_state_dict)
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.scheduler import Request


class Runtime:
    """Synchronous in-process generation over the serving engine.

    model_path: a HF llama directory, loaded on the card unless `device`
    says otherwise (models/convert.py), with its tokenizer through
    transformers."""

    def __init__(self, model=None, cfg=None, tokenizer=None, *,
                 model_path: Optional[str] = None,
                 engine_config: Optional[EngineConfig] = None,
                 dtype=None, embed_fn=None, device=None):
        if model_path is not None:
            cfg = llama_config_from_hf(_read_config(model_path))
            model = llama_params_from_hf(load_torch_state_dict(model_path),
                                         cfg, dtype or torch.bfloat16,
                                         device)
            tokenizer = auto_tokenizer(model_path)
        if model is None or cfg is None:
            raise ValueError("Runtime needs a model and its config, or "
                             "model_path")
        self.tokenizer = tokenizer
        self.engine = ServeEngine(model, cfg, engine_config or EngineConfig(),
                                  embed_fn=embed_fn, tokenizer=tokenizer)

    def generate(self, prompts: Union[str, Sequence[str], None] = None,
                 *, input_ids: Optional[Sequence[Sequence[int]]] = None,
                 max_new_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None,
                 stop: Sequence[str] = (),
                 regex: Optional[str] = None,
                 max_steps: int = 100000
                 ) -> Union[Dict[str, Any], List[Dict[str, Any]]]:
        """Batch generation → [{"text", "output_ids", "finish_reason"}]
        in input order (a single-string prompt returns one dict). A text
        that a stop string ended is cut just before the stop."""
        if regex is not None:
            raise NotImplementedError("constrained decoding (regex=) is not "
                                      "ported yet")
        single = isinstance(prompts, str)
        if prompts is not None:
            if single:
                prompts = [prompts]
            if self.tokenizer is None:
                raise ValueError("text prompts need a tokenizer")
            input_ids = [self.tokenizer.encode(p) for p in prompts]
        if input_ids is None:
            raise ValueError("pass prompts or input_ids")
        sampling = sampling or SamplingParams()
        eos = (tuple({self.tokenizer.eos_token_id} - {None})
               if self.tokenizer is not None else ()) or (2,)
        for i, ids in enumerate(input_ids):
            self.engine.add_request(Request(
                rid=f"rt{i}", input_ids=[int(t) for t in ids],
                sampling=sampling, max_new_tokens=max_new_tokens,
                eos_ids=eos, stop_strs=tuple(stop)))
        done: Dict[str, Request] = {}
        for _ in range(max_steps):
            for r in self.engine.step():
                done[r.rid] = r
            if not self.engine.has_work():
                break
        missing = [f"rt{i}" for i in range(len(input_ids))
                   if f"rt{i}" not in done]
        if missing:
            raise RuntimeError(
                f"max_steps={max_steps} exhausted with "
                f"{len(missing)} unfinished requests: {missing[:5]}")
        out = []
        for i in range(len(input_ids)):
            r = done[f"rt{i}"]
            text = None
            if self.tokenizer is not None:
                text = self.tokenizer.decode(r.output_ids,
                                             skip_special_tokens=True)
                if r.stop_trim and r.stop_trim in text:
                    text = text[:text.find(r.stop_trim)]
            out.append({"text": text, "output_ids": list(r.output_ids),
                        "finish_reason": (r.finished.value
                                          if r.finished else None)})
        return out[0] if single else out

    def flush_cache(self) -> int:
        return self.engine.flush_cache()

    def shutdown(self) -> None:
        """Nothing to stop (no processes): kept for the reference's API."""
