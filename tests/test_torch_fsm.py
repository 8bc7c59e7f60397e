"""The port's regex FSM and choice trie (aurora_tpu_torch/serve/fsm.py,
serve/constrained.py) against the JAX package's copies, which they
reproduce: the DFA tables of the reference's patterns (tests/test_fsm.py),
the token tables over a tokenizer's vocabulary, forced runs, the token
surfaces, the trie, and the bounds on user patterns. No model runs."""

import re
import threading

import numpy as np
import pytest

from aurora_tpu.serve import constrained as jconstrained
from aurora_tpu.serve import fsm as jfsm
from aurora_tpu_torch.serve import constrained as tconstrained
from aurora_tpu_torch.serve import fsm as tfsm

from utils import make_tiny_tokenizer

# tests/test_fsm.py's patterns, its alphabets and its accepted and
# rejected strings
DFA_CASES = [
    (r"abc", "abcdefghijklmnopqrstuvwxyz0123456789.-xyz", ["abc"],
     ["ab", "abcd"]),
    (r"a*b+", "abcdefghijklmnopqrstuvwxyz0123456789.-xyz",
     ["b", "aab", "abbb"], ["a", ""]),
    (r"(ab|cd){1,2}", "abcdefghijklmnopqrstuvwxyz0123456789.-xyz",
     ["ab", "abcd", "cdcd"], ["abcdab", "a"]),
    (r"[^x]+", "abcdefghijklmnopqrstuvwxyz0123456789.-xyz", ["abc", "yz"],
     ["ax", ""]),
    (r"\d+\.\d+", "abcdefghijklmnopqrstuvwxyz0123456789.-xyz",
     ["3.14", "10.0"], ["3.", ".5", "3"]),
    (r"-?\d{1,3}", "abcdefghijklmnopqrstuvwxyz0123456789.-xyz",
     ["7", "-42", "123"], ["1234", "-", ""]),
    (r"\D+", "abcxy 12345\n\t", ["abc", "x y"], ["a1", "5"]),
    (r"\S+", "abcxy 12345\n\t", ["abc"], ["a b", " "]),
    (r"[\D]+", "abcxy 12345\n\t", ["ab"], ["a1"]),
    (r"[\d\s]+", "abcxy 12345\n\t", ["1 2", "34"], ["a1"]),
    (r"a{0}b", "abcxy 12345\n\t", ["b"], ["ab"]),
    (r"ab{0,2}c", "abcxy 12345\n\t", ["ac", "abc", "abbc"], ["abbbc"]),
    (r".+", "ab\n", ["ab"], ["a\nb"]),
    # the VDC judge's answer (aurora_tpu/eval/judge.py)
    (r"\{'pred': '(yes|no)', 'score': [0-5]\}",
     "{}'predscoryn:, 0123456789",
     ["{'pred': 'yes', 'score': 4}", "{'pred': 'no', 'score': 0}"],
     ["{'pred': 'maybe', 'score': 4}", "{'pred': 'yes', 'score': 7}"]),
]
TOKEN_PATTERNS = [r"[0-9]+", r'\{"age": [0-9]{1,3}\}', r"abc(x|y)",
                  r"\{'pred': '(yes|no)', 'score': [0-5]\}", r"xy+"]


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    return make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))


@pytest.mark.parametrize("pattern,alphabet,accept,reject", DFA_CASES)
def test_regex_dfa_tables_equal_jax(pattern, alphabet, accept, reject):
    alphabet = sorted(set(alphabet))
    got, want = tfsm.RegexDFA(pattern, alphabet), jfsm.RegexDFA(pattern,
                                                                alphabet)
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.accepts, want.accepts)
    assert got.dead == want.dead and got.char_idx == want.char_idx
    for text in accept:
        assert got.accepts[got.walk(0, text)] and re.fullmatch(pattern, text)
    for text in reject:
        assert not got.accepts[got.walk(0, text)]
        assert not re.fullmatch(pattern, text)


@pytest.mark.parametrize("bad", ["[abc", "a{2", "a{5,2}", "a{99999}",
                                 "(a|b", "a\\", "*a"])
def test_malformed_patterns_raise_value_error(bad):
    """Both raise ValueError (the HTTP server's 400) on a malformed or
    over-long pattern."""
    for mod in (tfsm, jfsm):
        with pytest.raises(ValueError):
            mod.RegexDFA(bad, list("ab"))


def test_dfa_state_bound(monkeypatch):
    """A pattern past the DFA state bound raises ValueError in both."""
    pattern = "(a|b)*a(a|b){12}"        # 2^13 states as a DFA
    for mod in (tfsm, jfsm):
        with pytest.raises(ValueError, match="too complex"):
            mod.RegexDFA(pattern, list("ab"))


@pytest.mark.parametrize("pattern", TOKEN_PATTERNS)
def test_token_fsm_tables_equal_jax(tok, pattern):
    V = tok.vocab_size
    got = tfsm.TokenFSM(pattern, tok, V, special_ids=(0, 1))
    want = jfsm.TokenFSM(pattern, tok, V, special_ids=(0, 1))
    np.testing.assert_array_equal(got.allowed, want.allowed)
    np.testing.assert_array_equal(got.next_state, want.next_state)
    np.testing.assert_array_equal(got.n_allowed, want.n_allowed)
    assert got.allowed[0].any()
    assert not got.allowed[:, [0, 1]].any()


def test_token_strings_and_surfaces_equal_jax(tok):
    assert tfsm.token_strings(tok, tok.vocab_size) == \
        jfsm.token_strings(tok, tok.vocab_size)
    for t in ("Ġhello", "ĉ", "Ċ", "<0x0A>", "▁word", "abc", "<0xZZ>", ""):
        assert tfsm._surface(t) == jfsm._surface(t), t


@pytest.mark.parametrize("pattern", TOKEN_PATTERNS)
def test_constraint_walk_and_forced_runs_equal_jax(tok, pattern):
    """The same walk on both: at each state the masks are equal; the
    forced run is taken where there is one, else the lowest allowed token
    is advanced; both finish at the same point."""
    V = tok.vocab_size
    got = tfsm.RegexConstraint(pattern, tok, V, eos_ids=(2,))
    want = jfsm.RegexConstraint(pattern, tok, V, eos_ids=(2,))
    for _ in range(40):
        np.testing.assert_array_equal(got.mask(V), want.mask(V))
        assert got.allowed_tokens() == want.allowed_tokens()
        forced = got.forced_run(8)
        assert forced == want.forced_run(8)
        if not forced and not got.finished:
            tok_id = got.allowed_tokens()[0]
            got.advance(tok_id)
            want.advance(tok_id)
        assert (got.state, got.finished) == (want.state, want.finished)
        if got.finished:
            break
    assert got.finished


def test_token_fsm_cache_is_shared_across_threads(tok):
    """get_token_fsm from 8 threads at once: one table per key, the one
    stored first; another ban list is another table."""
    tfsm._FSM_CACHE.clear()
    out, start = [], threading.Barrier(8)

    def build():
        start.wait()
        out.append(tfsm.get_token_fsm(r"[a-f]{2,4}z", tok, tok.vocab_size))

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 8 and all(f is out[0] for f in out)
    assert tfsm.get_token_fsm(r"[a-f]{2,4}z", tok, tok.vocab_size) is out[0]
    other = tfsm.get_token_fsm(r"[a-f]{2,4}z", tok, tok.vocab_size,
                               special_ids=(1,))
    assert other is not out[0]
    assert tfsm.get_token_fsm(r"[a-f]{2,4}z", tok, tok.vocab_size,
                              special_ids=(1,)) is other


@pytest.mark.parametrize("choices,walk", [
    ([[1, 2, 3], [1, 5]], [1, 5]),
    ([[7, 8, 9], [7, 20], [50]], [7, 8, 9]),
    ([[4], [4, 6]], [4, 6]),
    ([[3, 3], [9]], [9]),
])
def test_choice_trie_equals_jax(choices, walk):
    got = tconstrained.ChoiceConstraint(choices)
    want = jconstrained.ChoiceConstraint(choices)
    for t in walk:
        assert got.allowed_tokens() == want.allowed_tokens()
        np.testing.assert_array_equal(got.mask(64), want.mask(64))
        assert got.finished == want.finished
        got.advance(t)
        want.advance(t)
    assert got.finished and want.finished
    np.testing.assert_array_equal(got.mask(64), want.mask(64))


def test_choice_from_strings_equals_jax(tok):
    choices = ["yes", "no", "camera"]
    got = tconstrained.ChoiceConstraint.from_strings(tok, choices)
    want = jconstrained.ChoiceConstraint.from_strings(tok, choices)
    assert got.choices == want.choices
