"""Per-request sampling configuration (aurora_tpu/generate/sampler.py).

Only the dataclass is ported; the serving engine applies the full
sampler surface on the device (serve/engine.py `_sample_core`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 → greedy
    top_k: int = 0                    # 0 → disabled
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0   # HF/CTRL style, prompt+output
    frequency_penalty: float = 0.0    # OpenAI style, output histogram
    presence_penalty: float = 0.0     # OpenAI style, output presence
    min_new_tokens: int = 0           # suppress eos below this length

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0
