"""Regex → FSM constrained decoding with jump-forward (a copy of
aurora_tpu/serve/fsm.py, which the port may not import; numpy only).

The stack of sglang's constrained decode (fsm_cache.py, jump_forward.py),
built without the `outlines` library:

  1. A small regex engine: pattern → Thompson NFA → subset-construction
     DFA. Syntax: literals, escapes (\\d \\w \\s \\n \\t \\r and escaped
     metacharacters), '.', character classes `[a-z0-9_]` (ranges,
     negation), groups `(...)`, alternation `|`, quantifiers `* + ?` and
     bounded `{m}`/`{m,n}`/`{m,}`.
  2. The DFA's alphabet is the set of characters in the tokenizer's
     vocabulary (plus the pattern's literals): only token strings are
     ever walked.
  3. A token table: for every DFA state one vectorized walk advances
     every vocabulary token at once → `allowed[state] : bool[V]` and
     `next_state[state] : int[V]`, cached per (pattern, tokenizer).

Jump-forward: `forced_run()` advances through stretches where exactly one
token is allowed; the engine writes them through one extend call instead
of a decode step each (ServeEngine._maybe_jump).

The engine-facing interface is ChoiceConstraint's: `allowed_tokens()`,
`advance(tok)`, `finished`, `mask(vocab_size)`. Unlike the reference, the
token-table cache takes a lock: the HTTP server builds constraints in its
worker threads.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

# Patterns arrive on the UNAUTHENTICATED /generate endpoint, so both the
# DFA state count and the dense token-table bytes (states × vocab × 5B)
# are hard-bounded — an adversarial regex must map to a 400, not a
# multi-GB allocation + O(states × Lmax) vectorized build.
MAX_DFA_STATES = int(os.environ.get("AURORA_FSM_MAX_STATES", "512"))
MAX_TABLE_BYTES = int(os.environ.get("AURORA_FSM_MAX_TABLE_BYTES",
                                     str(128 << 20)))

# ---------------------------------------------------------------------------
# Regex parsing → NFA (Thompson construction)
# ---------------------------------------------------------------------------

_METACHARS = set("\\^$.|?*+()[]{}")
_ESCAPE_CLASSES = {
    "d": set("0123456789"),
    "w": set("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": set(" \t\n\r\f\v"),
    "n": set("\n"), "t": set("\t"), "r": set("\r"),
}


@dataclasses.dataclass(frozen=True)
class _Pred:
    """Character predicate: a set of chars, possibly negated."""
    chars: FrozenSet[str]
    negated: bool = False

    def matches(self, c: str) -> bool:
        return (c not in self.chars) if self.negated else (c in self.chars)


@dataclasses.dataclass(frozen=True)
class _ClassPred:
    r"""Character class [...] as a union of atoms (sets and negated
    sets, e.g. [\d\D]); `negated` inverts the whole class ([^...])."""
    atoms: tuple              # of _Pred
    negated: bool = False

    def matches(self, c: str) -> bool:
        hit = any(a.matches(c) for a in self.atoms)
        return (not hit) if self.negated else hit


class _Nfa:
    def __init__(self):
        self.eps: List[List[int]] = []          # state → eps targets
        self.edges: List[List[Tuple[_Pred, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


class _Parser:
    """Recursive-descent regex parser producing an NFA fragment
    (start, end) with Thompson construction."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _Nfa()

    def parse(self) -> Tuple[int, int]:
        s, e = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return s, e

    # alt := concat ('|' concat)*
    def _alt(self):
        frags = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.state(), self.nfa.state()
        for fs, fe in frags:
            self.nfa.eps[s].append(fs)
            self.nfa.eps[fe].append(e)
        return s, e

    # concat := quantified*
    def _concat(self):
        s = e = self.nfa.state()
        while self._peek() not in ("", "|", ")"):
            fs, fe = self._quantified()
            self.nfa.eps[e].append(fs)
            e = fe
        return s, e

    # quantified := atom ('*' | '+' | '?' | '{m}' | '{m,n}' | '{m,}')?
    def _quantified(self):
        start_i = self.i
        frag = self._atom()
        c = self._peek()
        if c == "*":
            self.i += 1
            return self._star(frag)
        if c == "+":
            self.i += 1
            ss, se = self._star(self._copy_atom(start_i))
            self.nfa.eps[frag[1]].append(ss)
            return frag[0], se
        if c == "?":
            self.i += 1
            s, e = self.nfa.state(), self.nfa.state()
            self.nfa.eps[s] += [frag[0], e]
            self.nfa.eps[frag[1]].append(e)
            return s, e
        if c == "{":
            m, n = self._parse_braces()
            return self._repeat(start_i, frag, m, n)
        return frag

    def _star(self, frag):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s] += [frag[0], e]
        self.nfa.eps[frag[1]] += [frag[0], e]
        return s, e

    def _copy_atom(self, start_i: int):
        """Re-parse the atom at start_i to get a fresh fragment copy."""
        save = self.i
        self.i = start_i
        frag = self._atom()
        self.i = save
        return frag

    MAX_REPEAT = 256  # bounds NFA expansion (user-facing patterns)

    def _parse_braces(self) -> Tuple[int, Optional[int]]:
        assert self.p[self.i] == "{"
        j = self.p.find("}", self.i)
        if j < 0:
            raise ValueError("unterminated {m,n} quantifier")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        try:
            if "," in body:
                lo, hi = body.split(",", 1)
                m, n = int(lo), (int(hi) if hi.strip() else None)
            else:
                m = n = int(body)
        except ValueError:
            raise ValueError(f"malformed quantifier {{{body}}}") from None
        if m < 0 or (n is not None and (n < m or n > self.MAX_REPEAT)) \
                or m > self.MAX_REPEAT:
            raise ValueError(
                f"quantifier bounds out of range (max {self.MAX_REPEAT})")
        return m, n

    def _repeat(self, start_i, first, m, n):
        if n == 0:  # x{0}: epsilon — the atom is unreachable
            s = self.nfa.state()
            return s, s
        s = self.nfa.state()
        e = s
        frags = [first]
        total = m if n is None else n
        for _ in range(max(total, m) - 1):
            frags.append(self._copy_atom(start_i))
        cur = s
        exits = []
        for idx, (fs, fe) in enumerate(frags):
            if idx >= m:
                exits.append(cur)
            self.nfa.eps[cur].append(fs)
            cur = fe
        end = self.nfa.state()
        self.nfa.eps[cur].append(end)
        for x in exits:
            self.nfa.eps[x].append(end)
        if n is None:  # {m,}: loop the final copy
            fs, fe = frags[-1]
            self.nfa.eps[fe].append(fs)
        return s, end

    # atom := group | class | '.' | escape | literal
    def _atom(self):
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i:self.i + 2] == "?:":  # non-capturing
                self.i += 2
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError("unbalanced group")
            self.i += 1
            return frag
        if c == "[":
            return self._edge(self._char_class())
        if c == ".":
            self.i += 1
            # re default: '.' matches anything EXCEPT newline
            return self._edge(_Pred(frozenset("\n"), negated=True))
        if c == "\\":
            self.i += 1
            return self._edge(self._escape())
        if c in ("", "|", ")", "*", "+", "?", "{"):
            raise ValueError(f"unexpected {c!r} at {self.i}")
        self.i += 1
        return self._edge(_Pred(frozenset(c)))

    def _escape(self) -> _Pred:
        if self.i >= len(self.p):
            raise ValueError("dangling escape at end of pattern")
        c = self.p[self.i]
        self.i += 1
        if c in _ESCAPE_CLASSES:
            return _Pred(frozenset(_ESCAPE_CLASSES[c]))
        if c.isupper() and c.lower() in _ESCAPE_CLASSES:
            # \D \W \S — negated classes
            return _Pred(frozenset(_ESCAPE_CLASSES[c.lower()]),
                         negated=True)
        return _Pred(frozenset(c))  # escaped metachar / literal

    def _char_class(self):
        assert self.p[self.i] == "["
        self.i += 1
        if self.i >= len(self.p):
            raise ValueError("unterminated character class")
        negated = self.p[self.i] == "^"
        if negated:
            self.i += 1
        chars = set()
        atoms = []
        while True:
            if self.i >= len(self.p):
                raise ValueError("unterminated character class")
            if self.p[self.i] == "]":
                break
            c = self.p[self.i]
            if c == "\\":
                self.i += 1
                pred = self._escape()
                if pred.negated:
                    atoms.append(pred)   # e.g. [\D]
                else:
                    chars |= pred.chars
                continue
            if (self.p[self.i + 1:self.i + 2] == "-"
                    and self.p[self.i + 2:self.i + 3] not in ("]", "")):
                lo, hi = c, self.p[self.i + 2]
                chars |= {chr(x) for x in range(ord(lo), ord(hi) + 1)}
                self.i += 3
                continue
            chars.add(c)
            self.i += 1
        self.i += 1
        if not atoms:
            return _Pred(frozenset(chars), negated=negated)
        atoms.insert(0, _Pred(frozenset(chars)))
        return _ClassPred(atoms=tuple(atoms), negated=negated)

    def _edge(self, pred: _Pred):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.edges[s].append((pred, e))
        return s, e

    def _peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""


# ---------------------------------------------------------------------------
# NFA → DFA over a finite alphabet
# ---------------------------------------------------------------------------

class RegexDFA:
    """Deterministic automaton over an explicit alphabet.

    trans: [n_states, n_alphabet] int32, dead state included (self-loop).
    State 0 is the start; `dead` marks the sink."""

    def __init__(self, pattern: str, alphabet: Sequence[str]):
        parser = _Parser(pattern)
        start, end = parser.parse()
        nfa = parser.nfa
        self.alphabet = list(alphabet)
        self.char_idx: Dict[str, int] = {c: i for i, c
                                         in enumerate(self.alphabet)}

        def closure(states: FrozenSet[int]) -> FrozenSet[int]:
            out = set(states)
            stack = list(states)
            while stack:
                s = stack.pop()
                for t in nfa.eps[s]:
                    if t not in out:
                        out.add(t)
                        stack.append(t)
            return frozenset(out)

        start_set = closure(frozenset([start]))
        ids: Dict[FrozenSet[int], int] = {start_set: 0}
        MAX_STATES = MAX_DFA_STATES  # user-facing patterns: bound
        todo = [start_set]
        rows: List[List[int]] = []
        accepts: List[bool] = []
        A = len(self.alphabet)
        while todo:
            cur = todo.pop()
            i = ids[cur]
            while len(rows) <= i:
                rows.append([0] * A)
                accepts.append(False)
            accepts[i] = end in cur
            # group outgoing edges once, then evaluate per alphabet char
            edges = [(p, t) for s in cur for (p, t) in nfa.edges[s]]
            row = rows[i]
            for a, ch in enumerate(self.alphabet):
                nxt = frozenset(t for (p, t) in edges if p.matches(ch))
                if not nxt:
                    row[a] = -1
                    continue
                nxt = closure(nxt)
                if nxt not in ids:
                    if len(ids) >= MAX_STATES:
                        raise ValueError(
                            "regex too complex (DFA state bound)")
                    ids[nxt] = len(ids)
                    todo.append(nxt)
                row[a] = ids[nxt]
        n = len(rows)
        self.dead = n
        trans = np.full((n + 1, A), self.dead, np.int32)
        for i, row in enumerate(rows):
            for a, t in enumerate(row):
                trans[i, a] = self.dead if t < 0 else t
        self.trans = trans
        self.accepts = np.asarray(accepts + [False], bool)

    def walk(self, state: int, text: str) -> int:
        for ch in text:
            a = self.char_idx.get(ch)
            if a is None:
                return self.dead
            state = int(self.trans[state, a])
        return state


# ---------------------------------------------------------------------------
# Token-level FSM (vectorized table build) + cache
# ---------------------------------------------------------------------------

def _byte_decoder():
    """Inverse of the GPT-2 bytes_to_unicode table (byte-level BPE
    tokenizers — Llama-3/Qwen/GPT-2 — print bytes as these chars)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_DECODER = _byte_decoder()
_SP_BYTE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def _surface(token: str) -> str:
    """Token → the character string it contributes to decoded text.
    Handles sentencepiece ('▁' space, '<0xNN>' byte fallback) and
    byte-level BPE (GPT-2 byte-unicode chars)."""
    m = _SP_BYTE.match(token)
    if m:  # sentencepiece byte fallback: raw byte via latin-1
        return bytes([int(m.group(1), 16)]).decode("latin-1")
    if token and all(c in _BYTE_DECODER for c in token):
        raw = bytes(_BYTE_DECODER[c] for c in token)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw.decode("latin-1")
    return token.replace("▁", " ")


def token_strings(tokenizer, vocab_size: int) -> List[str]:
    """Decoded surface string per token id (sentencepiece + byte-level
    BPE conventions via _surface)."""
    out = []
    convert = getattr(tokenizer, "convert_ids_to_tokens", None)
    for i in range(vocab_size):
        try:
            t = convert(i) if convert is not None else tokenizer.decode([i])
        except Exception:
            t = None
        out.append(_surface(t) if t else "")
    return out


class TokenFSM:
    """DFA lifted to the token vocabulary.

    allowed[s]    : bool[V] — tokens whose surface string keeps the DFA
                    alive from state s
    next_state[s] : int[V]  — resulting state per token
    """

    def __init__(self, pattern: str, tokenizer, vocab_size: int,
                 special_ids: Sequence[int] = ()):
        toks = token_strings(tokenizer, vocab_size)
        alphabet = sorted({c for t in toks for c in t}
                          | {c for c in pattern if c not in _METACHARS})
        self.dfa = RegexDFA(pattern, alphabet)
        V = vocab_size
        Lmax = max((len(t) for t in toks), default=1) or 1
        chars = np.full((V, Lmax), -1, np.int32)
        for i, t in enumerate(toks):
            for j, ch in enumerate(t):
                chars[i, j] = self.dfa.char_idx[ch]
        lengths = np.asarray([len(t) for t in toks], np.int32)
        empty = lengths == 0
        n = self.dfa.trans.shape[0]
        if n * V * 5 > MAX_TABLE_BYTES:  # int32 next_state + bool allowed
            raise ValueError(
                f"regex too complex: token table would need {n} states × "
                f"{V} vocab ≈ {n * V * 5 >> 20}MB (cap "
                f"{MAX_TABLE_BYTES >> 20}MB)")
        self.next_state = np.zeros((n, V), np.int32)
        self.allowed = np.zeros((n, V), bool)
        for s in range(n):
            cur = np.full((V,), s, np.int32)
            for j in range(Lmax):
                live = chars[:, j] >= 0
                idx = np.where(live, chars[:, j], 0)
                cur = np.where(live, self.dfa.trans[cur, idx], cur)
            self.next_state[s] = cur
            # empty-string tokens and specials never advance a match
            self.allowed[s] = (cur != self.dfa.dead) & ~empty
        for sid in special_ids:
            if 0 <= sid < V:
                self.allowed[:, sid] = False
        self.n_allowed = self.allowed.sum(axis=1)


_FSM_CACHE: Dict[tuple, TokenFSM] = {}
_FSM_CACHE_MAX = 64
_FSM_LOCK = threading.Lock()


def get_token_fsm(pattern: str, tokenizer, vocab_size: int,
                  special_ids: Sequence[int] = ()) -> TokenFSM:
    """The cached TokenFSM of pattern + tokenizer identity + the banned
    special ids (another ban list must not reuse a table), the oldest
    entry evicted past _FSM_CACHE_MAX. Thread-safe: the table is built
    outside the lock, so two threads asking for one new pattern may both
    build it, and the first one stored is kept."""
    key = (pattern, id(tokenizer),
           getattr(tokenizer, "name_or_path", ""), vocab_size,
           tuple(sorted(special_ids)))
    with _FSM_LOCK:
        fsm = _FSM_CACHE.get(key)
    if fsm is not None:
        return fsm
    fsm = TokenFSM(pattern, tokenizer, vocab_size, special_ids)
    with _FSM_LOCK:
        if key in _FSM_CACHE:
            return _FSM_CACHE[key]
        if len(_FSM_CACHE) >= _FSM_CACHE_MAX:
            _FSM_CACHE.pop(next(iter(_FSM_CACHE)))
        _FSM_CACHE[key] = fsm
    return fsm


class RegexConstraint:
    """Engine-facing regex constraint (ChoiceConstraint interface +
    forced_run for jump-forward)."""

    def __init__(self, pattern: str, tokenizer, vocab_size: int,
                 eos_ids: Sequence[int] = (2,)):
        special = [i for i in getattr(tokenizer, "all_special_ids", [])
                   if i not in eos_ids]
        self.fsm = get_token_fsm(pattern, tokenizer, vocab_size, special)
        self.eos_ids = [e for e in eos_ids if 0 <= e < vocab_size]
        self.state = 0
        self.finished = False

    def mask(self, vocab_size: int) -> np.ndarray:
        m = self.fsm.allowed[self.state].copy()
        if self.fsm.dfa.accepts[self.state]:
            m[self.eos_ids] = True
        if not m.any():
            m[self.eos_ids] = True  # dead end: force termination
        return m

    def allowed_tokens(self) -> List[int]:
        return np.nonzero(self.mask(self.fsm.allowed.shape[1]))[0].tolist()

    def advance(self, token: int) -> None:
        if token in self.eos_ids:
            self.finished = True
            return
        self.state = int(self.fsm.next_state[self.state, token])
        if self.state == self.fsm.dfa.dead:
            self.finished = True

    def forced_run(self, budget: int) -> List[int]:
        """Jump-forward: advance while EXACTLY one token is permitted (and
        eos is not an alternative). Returns the forced tokens, already
        applied to the constraint state."""
        out: List[int] = []
        while len(out) < budget and not self.finished:
            s = self.state
            if self.fsm.dfa.accepts[s]:  # eos is an alternative
                break
            if int(self.fsm.n_allowed[s]) != 1:
                break
            tok = int(np.argmax(self.fsm.allowed[s]))
            self.advance(tok)
            out.append(tok)  # allowed tokens never hit the dead state
        return out
