"""A small prompt-program language: the sglang frontend surface (a copy
of aurora_tpu/lang.py, which the port may not import).

The `sglang.lang` primitives the reference's pipelines use (sglang's
lang/api.py: @function, system / user / assistant / gen / select;
interpreter.py's run loop; the RuntimeEndpoint backend); the VDCScore
judge programs (lmms_eval/tasks/vdc/utils.py:201-258) are written in it.

A program is a Python function over a State; the primitives append chat
messages, and `gen(name, ...)` calls the backend (any OpenAI-chat server,
serve/api.py among them) and keeps the answer as `state[name]`. gen takes
temperature, max_tokens and stop, `choices` (the server's
`choices_constraint`, serve/constrained.py) and `regex` (serve/fsm.py);
`select` picks one of its choices by constrained decoding.
`function.run_batch` runs many instances from a thread pool, so that the
server's continuous batching turns their requests into shared decode
steps; `state.fork(n)` clones the context for parallel branches;
`function.trace()` records the ops against a mock backend and
`function.compile()` freezes them into a static op graph.

Against the port's server:

    srv = ServerThread(ServingLoop(engine, tokenizer)).start()
    set_default_backend(RuntimeEndpoint(srv.url))
    states = judge.run_batch([{"caption": c} for c in captions])
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

_default_backend = None
_backend_lock = threading.Lock()


class RuntimeEndpoint:
    """OpenAI-chat backend (lang/backend RuntimeEndpoint parity).
    `model`/`api_key` make it work against real OpenAI-compatible
    servers that require them (ours ignores both)."""

    def __init__(self, base_url: str, timeout: float = 600.0,
                 model: str = "default",
                 api_key: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.model = model
        self.api_key = api_key

    def chat(self, messages: List[Dict[str, str]], *, max_tokens: int,
             temperature: float, stop: Sequence[str] = (),
             choices: Optional[Sequence[str]] = None,
             regex: Optional[str] = None) -> str:
        from aurora_tpu_torch.utils.http import chat_completion
        extra: Dict[str, Any] = {}
        if choices:
            extra["choices_constraint"] = list(choices)
        if regex:
            extra["regex"] = regex
        return chat_completion(
            self.base_url, messages, model=self.model,
            max_tokens=max_tokens, temperature=temperature, stop=stop,
            extra=extra or None, api_key=self.api_key,
            timeout=self.timeout)


class OpenAI(RuntimeEndpoint):
    """OpenAI backend (lang/backend/openai.py parity): the hosted chat
    API is OpenAI-protocol, so this is RuntimeEndpoint pinned at
    api.openai.com with a required model + api key. choices/regex are
    rejected — a hosted endpoint cannot run our FSM-constrained decode
    (the reference emulates select via logit_bias on COMPLETION models
    only, openai.py:352-372; its chat path has the same limitation)."""

    def __init__(self, model_name: str, api_key: Optional[str] = None,
                 base_url: str = "https://api.openai.com",
                 timeout: float = 600.0):
        import os
        super().__init__(base_url, timeout=timeout, model=model_name,
                         api_key=api_key or os.environ.get(
                             "OPENAI_API_KEY"))

    def chat(self, messages, *, max_tokens, temperature, stop=(),
             choices=None, regex=None) -> str:
        if choices or regex:
            raise ValueError(
                "OpenAI chat backend does not support choices/regex "
                "constrained decode; use RuntimeEndpoint (our server)")
        return super().chat(messages, max_tokens=max_tokens,
                            temperature=temperature, stop=stop)


class Anthropic:
    """Anthropic messages-API backend (lang/backend/anthropic.py:16-77
    parity). Raw HTTP instead of the anthropic SDK (not installed in
    this environment): POST /v1/messages with x-api-key +
    anthropic-version headers; a leading system message moves to the
    top-level `system` field exactly as the reference does
    (anthropic.py:39-43). No choices/regex (same as the reference)."""

    def __init__(self, model_name: str, api_key: Optional[str] = None,
                 base_url: str = "https://api.anthropic.com",
                 timeout: float = 600.0):
        import os
        self.model = model_name
        self.api_key = api_key or os.environ.get("ANTHROPIC_API_KEY")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def chat(self, messages: List[Dict[str, str]], *, max_tokens: int,
             temperature: float, stop: Sequence[str] = (),
             choices=None, regex=None) -> str:
        if choices or regex:
            raise ValueError(
                "Anthropic backend does not support choices/regex")
        msgs = list(messages)
        system = ""
        if msgs and msgs[0]["role"] == "system":
            system = msgs.pop(0)["content"]
        payload: Dict[str, Any] = {
            "model": self.model, "messages": msgs,
            "max_tokens": max_tokens, "temperature": temperature}
        if system:
            payload["system"] = system
        if stop:
            payload["stop_sequences"] = list(stop)
        import json
        import urllib.request
        req = urllib.request.Request(
            self.base_url + "/v1/messages",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "x-api-key": self.api_key or "",
                     "anthropic-version": "2023-06-01"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            body = json.loads(r.read())
        return body["content"][0]["text"]


class LiteLLM(RuntimeEndpoint):
    """LiteLLM backend (lang/backend/litellm.py parity). The reference
    calls the litellm SDK in proxy-less mode; this environment has no
    litellm, so the adapter targets a LiteLLM PROXY server — which
    speaks the OpenAI chat protocol verbatim with the provider routed
    by the model string ("anthropic/<model>", "gpt-4o", ...)."""

    def __init__(self, model_name: str,
                 base_url: str = "http://localhost:4000",
                 api_key: Optional[str] = None, timeout: float = 600.0):
        super().__init__(base_url, timeout=timeout, model=model_name,
                         api_key=api_key)


class VertexAI:
    """VertexAI backend stub (lang/backend/vertexai.py parity shape).
    The reference requires the `vertexai` SDK and raises the ImportError
    at construction when absent (vertexai.py:20-24); this environment
    has no SDK and no egress, so the constructor raises the same way.
    The request mapping (system instruction + contents with
    user/model roles) is documented in docs/SERVE.md."""

    def __init__(self, model_name: str, **kwargs):
        raise ImportError(
            "VertexAI backend requires the google-cloud vertexai SDK, "
            "which is not available in this environment (reference "
            "behavior: lang/backend/vertexai.py raises at init too)")


def set_default_backend(backend) -> None:
    global _default_backend
    with _backend_lock:
        _default_backend = backend


class State:
    """Accumulated messages + captured generations."""

    def __init__(self, backend):
        self.backend = backend
        self.messages: List[Dict[str, str]] = []
        self.captured: Dict[str, str] = {}

    def __iadd__(self, piece):
        piece.apply(self)
        return self

    def __getitem__(self, name: str) -> str:
        return self.captured[name]

    def fork(self, n: int) -> List["State"]:
        """n independent continuations of the current context
        (lang fork parity). Children share nothing after the split;
        run their branches concurrently via run_states_parallel."""
        import copy
        out = []
        for _ in range(n):
            child = State(self.backend)
            child.messages = copy.deepcopy(self.messages)
            child.captured = dict(self.captured)
            out.append(child)
        return out


class _Message:
    def __init__(self, role: str, content: str):
        self.role = role
        self.content = content

    def apply(self, state: State) -> None:
        state.messages.append({"role": self.role, "content": self.content})


class _Gen:
    def __init__(self, name: str, max_tokens: int = 128,
                 temperature: float = 0.0, stop: Sequence[str] = (),
                 choices: Optional[Sequence[str]] = None,
                 regex: Optional[str] = None):
        self.name = name
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.stop = stop
        self.choices = choices
        self.regex = regex

    def apply(self, state: State) -> None:
        text = state.backend.chat(
            state.messages, max_tokens=self.max_tokens,
            temperature=self.temperature, stop=self.stop,
            choices=self.choices, regex=self.regex)
        state.captured[self.name] = text
        state.messages.append({"role": "assistant", "content": text})


class _Assistant:
    """assistant(gen(...)) — runs the gen in the assistant slot."""

    def __init__(self, gen: _Gen):
        self.gen = gen

    def apply(self, state: State) -> None:
        self.gen.apply(state)


def system(content: str) -> _Message:
    return _Message("system", content)


def user(content: str) -> _Message:
    return _Message("user", content)


def assistant(gen_or_text) -> Any:
    if isinstance(gen_or_text, _Gen):
        return _Assistant(gen_or_text)
    return _Message("assistant", gen_or_text)


def gen(name: str, max_tokens: int = 128, temperature: float = 0.0,
        stop: Sequence[str] = (), choices=None, regex=None) -> _Gen:
    return _Gen(name, max_tokens, temperature, stop, choices, regex)


def select(name: str, choices: Sequence[str]) -> _Gen:
    """Pick one of `choices` via constrained decode (lang select parity)."""
    return _Gen(name, max_tokens=max(len(c) for c in choices) + 8,
                temperature=0.0, choices=choices)


def run_states_parallel(states: List[State], branch: Callable,
                        num_threads: int = 8) -> List[State]:
    """Apply `branch(state)` to every forked state concurrently — the
    server's continuous batching merges the requests into shared decode
    steps."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(branch, states))
    return states


class _TraceBackend:
    """Mock backend that records gen ops (lang/tracer.py parity)."""

    def __init__(self):
        self.ops: List[Dict[str, Any]] = []

    def chat(self, messages, *, max_tokens, temperature, stop=(),
             choices=None, regex=None):
        self.ops.append({"op": "gen", "n_messages": len(messages),
                         "max_tokens": max_tokens,
                         "temperature": temperature,
                         "choices": list(choices) if choices else None,
                         "regex": regex})
        return f"<gen_{len(self.ops) - 1}>"


class _Placeholder(str):
    """Lazy argument used during compilation tracing: stringifies to a
    stable marker so f-strings/concats in user code leave substitution
    points in the recorded message template (the role sglang's
    SglArgument plays, lang/compiler.py tracing)."""

    def __new__(cls, name: str):
        return super().__new__(cls, "{__" + name + "__}")


class _RecordingState(State):
    """Trace-time State: records every applied piece instead of (for
    messages) or in addition to (for gens) executing it."""

    def __init__(self):
        super().__init__(_TraceBackend())
        self.program: List[Any] = []

    def __iadd__(self, piece):
        if isinstance(piece, _Assistant):
            piece = piece.gen
        if isinstance(piece, _Message):
            self.program.append(("msg", piece.role, piece.content))
        elif isinstance(piece, _Gen):
            self.program.append(("gen", piece))
            # placeholder capture so later prompt text referencing
            # state[name] stays a substitution point
            self.captured[piece.name] = "{__gen_" + piece.name + "__}"
        else:
            piece.apply(self)
        return self


class CompiledFunction:
    """Static op-graph form of a program (lang/compiler.py parity):
    the Python body runs ONCE at compile time against placeholder
    arguments; each .run() replays the recorded message/gen sequence
    with argument substitution — no user Python on the hot path, and
    run_batch dispatches instances concurrently so the server batches
    their decode steps."""

    def __init__(self, program: List[Any], arg_names: Sequence[str]):
        self.program = program
        self.arg_names = list(arg_names)

    def graph(self) -> List[Dict[str, Any]]:
        """Inspectable op list: roles/templates and gen dependencies
        (a gen depends on every earlier op in the chat chain)."""
        out = []
        for op in self.program:
            if op[0] == "msg":
                out.append({"op": "msg", "role": op[1], "template": op[2]})
            else:
                g = op[1]
                out.append({"op": "gen", "name": g.name,
                            "depends_on": len(out)})
        return out

    def _subst(self, text: str, kwargs: Dict[str, Any],
               captured: Dict[str, str]) -> str:
        for k, v in kwargs.items():
            text = text.replace("{__" + k + "__}", str(v))
        for k, v in captured.items():
            text = text.replace("{__gen_" + k + "__}", v)
        return text

    def run(self, backend=None, **kwargs) -> State:
        backend = backend or _default_backend
        assert backend is not None, \
            "call set_default_backend(RuntimeEndpoint(...)) first"
        state = State(backend)
        for op in self.program:
            if op[0] == "msg":
                state += _Message(op[1], self._subst(op[2], kwargs,
                                                     state.captured))
            else:
                op[1].apply(state)
        return state

    def run_batch(self, batch_kwargs: Sequence[Dict[str, Any]],
                  backend=None, num_threads: int = 8) -> List[State]:
        from concurrent.futures import ThreadPoolExecutor
        backend = backend or _default_backend
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            futs = [pool.submit(self.run, backend=backend, **kw)
                    for kw in batch_kwargs]
            return [f.result() for f in futs]


class function:  # noqa: N801 — decorator name matches the reference API
    """@function — wraps a program; .run(**kwargs) executes it."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def run(self, backend=None, **kwargs) -> State:
        backend = backend or _default_backend
        assert backend is not None, \
            "call set_default_backend(RuntimeEndpoint(...)) first"
        state = State(backend)
        self.fn(state, **kwargs)
        return state

    def run_batch(self, batch_kwargs: Sequence[Dict[str, Any]],
                  backend=None, num_threads: int = 8) -> List[State]:
        """Run many program instances concurrently (sglang run_batch /
        threaded-interpreter parity): the server's continuous batching
        turns the concurrent requests into shared decode steps."""
        from concurrent.futures import ThreadPoolExecutor
        backend = backend or _default_backend
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            futs = [pool.submit(self.run, backend=backend, **kw)
                    for kw in batch_kwargs]
            return [f.result() for f in futs]

    def trace(self, **kwargs) -> List[Dict[str, Any]]:
        """Execute against a recording mock backend → op list
        (lang/tracer.py parity; gen results are placeholders)."""
        tb = _TraceBackend()
        state = State(tb)
        self.fn(state, **kwargs)
        return tb.ops

    def compile(self, arg_names: Sequence[str] = ()) -> CompiledFunction:
        """Trace the body once with placeholder arguments into a static
        op graph (lang/compiler.py parity). Limitation shared with the
        reference compiler: control flow that branches on an argument's
        VALUE is frozen at its traced path — such programs should use
        .run/.run_batch (the interpreter) instead."""
        rec = _RecordingState()
        self.fn(rec, **{a: _Placeholder(a) for a in arg_names})
        return CompiledFunction(rec.program, arg_names)

    def __call__(self, state: State, **kwargs):
        return self.fn(state, **kwargs)
