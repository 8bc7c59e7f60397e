"""The port's prompt-program language (aurora_tpu_torch/lang.py) on the
reference's own cases (tests/test_lang.py): the VDC judge program shape,
multi-turn state, gen's options forwarded, trace, fork, run_batch,
compile and the provider backends, against a live OpenAI-chat endpoint
that echoes what it was sent. tests/test_torch_serve_api.py runs a judge
program over the port's HTTP server against the JAX one."""

import asyncio
import threading

import pytest

from aurora_tpu_torch.lang import (RuntimeEndpoint, assistant, function,
                                   gen, set_default_backend, system, user)

aiohttp = pytest.importorskip("aiohttp")


class EchoServer:
    """Chat endpoint that answers with a digest of what it was sent."""

    def __init__(self):
        self.port = None
        self.requests = []
        self._started = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()
        self._started.wait(10)

    def _run(self):
        from aiohttp import web

        async def chat(request):
            body = await request.json()
            self.requests.append(body)
            n_msgs = len(body["messages"])
            last = body["messages"][-1]["content"]
            return web.json_response({"choices": [{"message": {
                "content": f"reply{n_msgs}:{last[:10]}"}}]})

        async def start():
            app = web.Application()
            app.router.add_post("/v1/chat/completions", chat)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.port = runner.addresses[0][1]
            self._started.set()
            while True:
                await asyncio.sleep(3600)

        asyncio.run(start())


@pytest.fixture(scope="module")
def echo():
    return EchoServer()


def test_reference_style_program(echo):
    """The VDCScore judge program shape (vdc/utils.py:201-217) ported
    1:1 to our API."""

    @function
    def gener_pred_response(s, pred_cap, q):
        s += system("You answer questions from descriptions.")
        s += user(f"description: {pred_cap}, question: {q}")
        s += assistant(gen("answer_1", max_tokens=64))

    set_default_backend(RuntimeEndpoint(f"http://127.0.0.1:{echo.port}"))
    state = gener_pred_response.run(pred_cap="a cat video", q="what?")
    assert state["answer_1"].startswith("reply2:")
    sent = echo.requests[-1]
    assert sent["messages"][0]["role"] == "system"
    assert "a cat video" in sent["messages"][1]["content"]
    assert sent["temperature"] == 0.0


def test_multi_turn_state(echo):
    @function
    def dialog(s):
        s += user("first")
        s += assistant(gen("a", max_tokens=8))
        s += user("second")
        s += assistant(gen("b", max_tokens=8))

    state = dialog.run(RuntimeEndpoint(f"http://127.0.0.1:{echo.port}"))
    # second gen sees 3 prior messages (user, assistant, user)
    assert state["a"].startswith("reply1:")
    assert state["b"].startswith("reply3:")


def test_gen_kwargs_forwarded(echo):
    @function
    def prog(s):
        s += user("pick")
        s += assistant(gen("c", max_tokens=4, temperature=0.7,
                           stop=["\n"], choices=["yes", "no"]))

    prog.run(RuntimeEndpoint(f"http://127.0.0.1:{echo.port}"))
    sent = echo.requests[-1]
    assert sent["max_tokens"] == 4
    assert sent["temperature"] == 0.7
    assert sent["stop"] == ["\n"]
    assert sent["choices_constraint"] == ["yes", "no"]


def test_function_trace_records_ops():
    from aurora_tpu_torch.lang import function, gen, select, system, user

    @function
    def prog(s, q):
        s += system("judge")
        s += user(q)
        s += gen("ans", max_tokens=32)
        s += user("score it")
        s += select("score", ["yes", "no"])

    ops = prog.trace(q="what?")
    assert len(ops) == 2
    assert ops[0]["max_tokens"] == 32 and ops[0]["choices"] is None
    assert ops[1]["choices"] == ["yes", "no"]


def test_state_fork_independent():
    from aurora_tpu_torch.lang import State, user

    class Echo:
        def chat(self, messages, **kw):
            return f"echo{len(messages)}"

    s = State(Echo())
    s += user("root")
    kids = s.fork(2)
    kids[0] += user("a")
    kids[1] += user("b")
    assert len(s.messages) == 1
    assert kids[0].messages[1]["content"] == "a"
    assert kids[1].messages[1]["content"] == "b"


def test_run_batch_concurrent(echo):
    """run_batch drives concurrent program instances (threaded-
    interpreter parity); each state captures its own generation."""
    from aurora_tpu_torch.lang import RuntimeEndpoint, function, gen, user

    @function
    def prog(s, q):
        s += user(q)
        s += gen("out", max_tokens=4)

    backend = RuntimeEndpoint(f"http://127.0.0.1:{echo.port}")
    states = prog.run_batch([{"q": f"question {i}"} for i in range(5)],
                            backend=backend, num_threads=4)
    assert len(states) == 5
    assert all(isinstance(st["out"], str) and st["out"] for st in states)
    assert all(st.messages[0]["content"] == f"question {i}"
               for i, st in enumerate(states))


def test_compile_static_graph(echo):
    """function.compile traces the body once into a static op graph
    (sglang lang/compiler.py parity): argument substitution + gen-result
    references replay without re-running user Python."""
    from aurora_tpu_torch.lang import (RuntimeEndpoint, function, gen,
                                       system, user)

    calls = {"n": 0}

    @function
    def prog(s, topic, style):
        calls["n"] += 1
        s += system(f"You write {style} text.")
        s += user(f"Write about {topic}.")
        s += gen("draft", max_tokens=8)
        s += user(f"Improve this {style} draft: {s['draft']}")
        s += gen("final", max_tokens=8)

    cf = prog.compile(arg_names=["topic", "style"])
    assert calls["n"] == 1  # body ran exactly once, at compile time
    g = cf.graph()
    assert [op["op"] for op in g] == ["msg", "msg", "gen", "msg", "gen"]
    assert "{__topic__}" in g[1]["template"]
    assert "{__gen_draft__}" in g[3]["template"]

    backend = RuntimeEndpoint(f"http://127.0.0.1:{echo.port}")
    st = cf.run(backend=backend, topic="tpus", style="terse")
    assert calls["n"] == 1  # replay did NOT re-run the Python body
    assert st.messages[0]["content"] == "You write terse text."
    assert st.messages[1]["content"] == "Write about tpus."
    # the second prompt embeds the ACTUAL first generation
    assert st["draft"] in st.messages[3]["content"]
    assert "{__" not in st.messages[3]["content"]
    assert st["final"]

    # batched replay: per-instance substitution survives concurrency
    states = cf.run_batch(
        [{"topic": f"t{i}", "style": "dry"} for i in range(4)],
        backend=backend, num_threads=4)
    assert all(s.messages[1]["content"] == f"Write about t{i}."
               for i, s in enumerate(states))


def test_provider_backends(echo, monkeypatch):
    """Thin provider adapters (lang/backend/{openai,anthropic,litellm,
    vertexai}.py parity): OpenAI/LiteLLM speak the OpenAI chat protocol
    (verified against the live echo endpoint); Anthropic maps to the
    messages API (system extraction, x-api-key + anthropic-version
    headers, stop_sequences) — verified via a captured urllib request;
    VertexAI raises at init without its SDK, like the reference."""
    import json

    from aurora_tpu_torch.lang import Anthropic, LiteLLM, OpenAI, VertexAI

    base = f"http://127.0.0.1:{echo.port}"
    oa = OpenAI("gpt-4o-mini", api_key="sk-test", base_url=base)
    out = oa.chat([{"role": "user", "content": "hello"}],
                  max_tokens=16, temperature=0.5)
    assert out.startswith("reply1:")
    sent = echo.requests[-1]
    assert sent["model"] == "gpt-4o-mini" and sent["temperature"] == 0.5
    with pytest.raises(ValueError):
        oa.chat([{"role": "user", "content": "x"}], max_tokens=4,
                temperature=0.0, choices=["a", "b"])

    ll = LiteLLM("anthropic/some-model", base_url=base)
    assert ll.chat([{"role": "user", "content": "hi"}],
                   max_tokens=8, temperature=0.0).startswith("reply1:")
    assert echo.requests[-1]["model"] == "anthropic/some-model"

    captured = {}

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps(
                {"content": [{"text": "the model says hi"}]}).encode()

    def fake_urlopen(req, timeout=None):
        captured["url"] = req.full_url
        captured["headers"] = dict(req.header_items())
        captured["payload"] = json.loads(req.data)
        return _Resp()

    import urllib.request
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    ant = Anthropic("some-messages-model", api_key="ak-test")
    out = ant.chat([{"role": "system", "content": "be terse"},
                    {"role": "user", "content": "hello"}],
                   max_tokens=32, temperature=0.0, stop=["\n\n"])
    assert out == "the model says hi"
    assert captured["url"].endswith("/v1/messages")
    hdr = {k.lower(): v for k, v in captured["headers"].items()}
    assert hdr["x-api-key"] == "ak-test"
    assert hdr["anthropic-version"] == "2023-06-01"
    p = captured["payload"]
    assert p["system"] == "be terse"           # extracted, not in messages
    assert [m["role"] for m in p["messages"]] == ["user"]
    assert p["stop_sequences"] == ["\n\n"]
    with pytest.raises(ValueError):
        ant.chat([{"role": "user", "content": "x"}], max_tokens=4,
                 temperature=0.0, regex="[0-9]+")

    with pytest.raises(ImportError):
        VertexAI("gemini-1.5-pro")
