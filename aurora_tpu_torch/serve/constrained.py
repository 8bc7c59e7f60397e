"""Constrained decoding: choice tries with per-step token masks (a copy
of aurora_tpu/serve/constrained.py, which the port may not import).

Constrains the output to one of a finite set of token sequences (yes/no,
multiple choice, labels; sglang's `select` and the OpenAI server's
`choices_constraint`): a trie walked on the host while the device takes a
[V] bool mask a step. The engine writes every token through its decode
step (a choice has no `forced_run`, so jump-forward skips it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np


class ChoiceConstraint:
    """Constrain generation to one of `choices` (token-id sequences)."""

    def __init__(self, choices_token_ids: Sequence[Sequence[int]]):
        assert choices_token_ids, "need at least one choice"
        self.choices = [list(c) for c in choices_token_ids]
        self.pos = 0
        self.alive: Set[int] = set(range(len(self.choices)))

    @classmethod
    def from_strings(cls, tokenizer, choices: Sequence[str]):
        return cls([tokenizer.encode(c, add_special_tokens=False)
                    for c in choices])

    def allowed_tokens(self) -> List[int]:
        out = []
        for i in self.alive:
            c = self.choices[i]
            if self.pos < len(c):
                out.append(c[self.pos])
        return sorted(set(out))

    def advance(self, token: int) -> None:
        self.alive = {i for i in self.alive
                      if self.pos < len(self.choices[i])
                      and self.choices[i][self.pos] == token}
        self.pos += 1

    @property
    def finished(self) -> bool:
        """Done when some alive choice is fully consumed and no longer one
        continues past it."""
        if not self.alive:
            return True
        return all(len(self.choices[i]) <= self.pos for i in self.alive)

    def mask(self, vocab_size: int) -> np.ndarray:
        m = np.zeros((vocab_size,), bool)
        allowed = self.allowed_tokens()
        if allowed:
            m[allowed] = True
        else:
            m[:] = True  # exhausted → unconstrained (engine finishes us)
        return m
