"""The port's HTTP server (aurora_tpu_torch/serve/api.py) against the JAX
package's (aurora_tpu/serve/api.py), fp32 on the CPU.

One module-scoped pair of servers on one tiny model
(`LlamaConfig.tiny(vocab_size=512)`, the byte-level tokenizer of
tests/utils.py, max_batch 4, max_seq_len 256, 1024 pool slots, buckets
(32, 192), both radix caches on their Python trees): the JAX server is
aiohttp's TestServer, the port's its `ServerThread` on the standard
library; each listens on 127.0.0.1 from a thread of its own, and one
stdlib client asks both the same things. Tolerances: greedy tokens,
texts and status codes equal; completion logprobs within 1e-4; embeddings
within rtol 1e-5 / atol 1e-5; /v1/classify within 1e-5 of JAX's logits
and 5e-4 of HF's (tests/test_serve_api.py's bound); 8 concurrent clients
equal or within the near-tie rule of tests/test_torch_engine_quant.py
(their waves may batch differently). Constrained decoding (`regex`,
`choices_constraint`) on /generate, completions and chat, a prompt past
the largest bucket (chunked prefill), 400 for a bad pattern, and a
lang.py judge program (the port's lang over the port's server against
the reference's lang over the JAX server): equal answers. Then the port
alone: StreamDetok (tests/test_serve_api.py's two cases); the engine
surface the server calls (auto_engine_config, update_weights in every
weight layout, a failed admission). tests/test_torch_import.py starts the
server with aiohttp blocked.
"""

import asyncio
import json
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import http.client
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models.export import _write, llama_config_dict, \
    llama_state_dict
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve.api import ServingLoop as JServingLoop
from aurora_tpu.serve.api import build_app as jbuild_app
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu_torch import bridge
from aurora_tpu_torch.serve.api import ServerThread, ServingLoop, StreamDetok
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine

from test_torch_engine_quant import assert_near_tie_parity
from utils import make_tiny_tokenizer

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestServer  # noqa: E402

ENGINE = dict(max_batch=4, max_seq_len=256, num_slots=1024,
              prefill_buckets=(32, 192))
LOGPROB_TOL = 1e-4
EMBED_TOL = 1e-5
HF_TOL = 5e-4


# ---------------------------------------------------------------------------
# servers and a client
# ---------------------------------------------------------------------------

class JaxServer:
    """The JAX package's app on aiohttp's TestServer, in a thread."""

    def __init__(self, engine, tok):
        self.engine, self.tok = engine, tok
        self.loop_ = None
        self.port = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._main, daemon=True)

    def _main(self):
        async def run():
            self.loop_ = JServingLoop(self.engine, self.tok)
            await self.loop_.start()
            server = TestServer(jbuild_app(self.loop_, "tiny"),
                                host="127.0.0.1")
            await server.start_server()
            self._aloop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            self.port = server.port
            self._ready.set()
            try:
                await self._stop.wait()
            finally:
                await server.close()
                self.loop_._task.cancel()

        asyncio.run(run())

    def start(self):
        self._thread.start()
        assert self._ready.wait(120), "the JAX server did not start"
        return self

    def stop(self):
        self._aloop.call_soon_threadsafe(self._stop.set)
        self._thread.join(60)


class Pair:
    """The JAX and the port's servers on one model."""

    def __init__(self, tree, jcfg, jecfg, model, tcfg, tecfg, tok):
        # committed device arrays, as the JAX engine's update_weights puts
        # them (so that a swap does not recompile its steps)
        self.jengine = JServeEngine(jax.device_put(tree, jax.devices()[0]),
                                    jcfg, jecfg, tokenizer=tok)
        self.tengine = ServeEngine(model, tcfg, tecfg, tokenizer=tok)
        self.jax = JaxServer(self.jengine, tok).start()
        self.port = ServerThread(ServingLoop(self.tengine, tok),
                                 "tiny").start()
        self.ports = (self.jax.port, self.port.port)

    def stop(self):
        self.jax.stop()
        self.port.stop()


def call(port, method, path, body=None, *, raw=None, headers=None,
         timeout=120):
    """One request → (status, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        hdrs = dict(headers or {})
        data = raw
        if raw is None and body is not None:
            data = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, data, hdrs)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def post(port, path, body, **kw):
    status, data = call(port, "POST", path, body, **kw)
    return status, json.loads(data)


def get(port, path):
    status, data = call(port, "GET", path)
    return status, json.loads(data)


def both(pair, fn):
    """fn(port) on the JAX server, then on the port's → (jax, port)."""
    return tuple(fn(p) for p in pair.ports)


def events(data: bytes):
    """SSE payloads of a streamed answer, the final [DONE] checked."""
    lines = [ln[6:] for ln in data.decode().splitlines()
             if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]", lines
    return [json.loads(e) for e in lines[:-1]]


def stream_text(data: bytes) -> str:
    out = ""
    for e in events(data):
        if "choices" in e:
            c = e["choices"][0]
            out += c["delta"]["content"] if "delta" in c else c["text"]
        else:
            out += e["text"]
    return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tok = make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))
    jcfg = JLlamaConfig.tiny(vocab_size=512)
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(3), jcfg,
                                            dtype=jnp.float32))
    tcfg = bridge.llama_config_from(jcfg)
    return SimpleNamespace(tok=tok, jcfg=jcfg, tree=tree, tcfg=tcfg,
                           tmp=tmp_path_factory.mktemp("weights"),
                           trees={3: tree})


def _pair(tiny, tree, quant="none", tcfg=None, jcfg=None):
    model = bridge.llama_from_params(tree, tcfg or tiny.tcfg, device="cpu",
                                     dtype=torch.float32)
    return Pair(tree, jcfg or tiny.jcfg,
                JEngineConfig(kv_dtype=jnp.float32, weight_quant=quant,
                              **ENGINE),
                model, tcfg or tiny.tcfg,
                EngineConfig(kv_dtype=torch.float32, weight_quant=quant,
                             **ENGINE), tiny.tok)


@pytest.fixture(scope="module")
def servers(tiny):
    mp = pytest.MonkeyPatch()
    mp.setenv("AURORA_NATIVE_RADIX", "0")
    pair = _pair(tiny, tiny.tree)
    yield pair
    pair.stop()
    mp.undo()


# ---------------------------------------------------------------------------
# parity with the JAX server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["text", "input_ids"])
def test_generate_matches_jax(servers, tiny, field):
    """Greedy /generate from text and from ids: text, output_ids and
    meta_info equal."""
    body = {"max_new_tokens": 6, "temperature": 0.0}
    body[field] = ("hello world" if field == "text"
                   else tiny.tok.encode("hello world"))
    (js, jb), (ts, tb) = both(servers, lambda p: post(p, "/generate", body))
    assert js == ts == 200
    assert tb == jb
    assert tb["meta_info"]["completion_tokens"] == len(tb["output_ids"])


def test_completions_logprobs_match_jax(servers):
    """/v1/completions with logprobs: text, tokens and usage equal, each
    token's logprob and its top-5 within 1e-4."""
    body = {"prompt": "hello world", "max_tokens": 5, "logprobs": 5}
    (_, jb), (_, tb) = both(servers,
                            lambda p: post(p, "/v1/completions", body))
    assert tb["object"] == "text_completion"
    jc, tc = jb["choices"][0], tb["choices"][0]
    assert (tc["text"], tc["finish_reason"]) == (jc["text"],
                                                 jc["finish_reason"])
    assert tb["usage"] == jb["usage"]
    jl, tl = jc["logprobs"], tc["logprobs"]
    assert tl["tokens"] == jl["tokens"]
    np.testing.assert_allclose(tl["token_logprobs"], jl["token_logprobs"],
                               atol=LOGPROB_TOL, rtol=0)
    for jt, tt in zip(jl["top_logprobs"], tl["top_logprobs"]):
        assert tt.keys() == jt.keys()
        np.testing.assert_allclose([tt[k] for k in jt], list(jt.values()),
                                   atol=LOGPROB_TOL, rtol=0)


def test_chat_matches_jax(servers):
    """/v1/chat/completions over a multi-round conversation (no system
    message: the vicuna system prompt alone passes the largest bucket,
    and the port's engine has no chunked prefill)."""
    body = {"messages": [{"role": "user", "content": "first"},
                         {"role": "assistant", "content": "answer"},
                         {"role": "user", "content": "second"}],
            "max_tokens": 5}
    (js, jb), (ts, tb) = both(servers,
                              lambda p: post(p, "/v1/chat/completions",
                                             body))
    assert js == ts == 200
    assert tb["choices"][0]["message"] == jb["choices"][0]["message"]
    assert tb["choices"][0]["message"]["role"] == "assistant"
    assert tb["usage"] == jb["usage"]


@pytest.mark.parametrize("path", ["/generate", "/v1/completions",
                                  "/v1/chat/completions"])
def test_stream_matches_jax_and_plain(servers, path):
    """A streamed answer: chunks of the same object as JAX's (how many
    depends on how steps and the handler interleave: a handler that runs
    late sends several tokens in one chunk), and its joined deltas equal
    between the packages and equal to the text of the same request sent
    without streaming."""
    body = {"max_new_tokens": 7, "max_tokens": 7, "temperature": 0.0}
    if path == "/v1/chat/completions":
        body["messages"] = [{"role": "user", "content": "stream me"}]
    else:
        body["text" if path == "/generate" else "prompt"] = "stream me"
    streamed = both(servers, lambda p: call(p, "POST", path,
                                            {**body, "stream": True}))
    assert all(s == 200 for s, _ in streamed)
    jtext, ttext = (stream_text(d) for _, d in streamed)
    assert ttext == jtext
    jev, tev = (events(d) for _, d in streamed)
    assert {e.get("object") for e in tev} == {e.get("object") for e in jev}
    assert tev and jev
    _, plain = post(servers.ports[1], path, body)
    if path == "/generate":
        want = plain["text"]
    elif path == "/v1/completions":
        want = plain["choices"][0]["text"]
    else:
        want = plain["choices"][0]["message"]["content"]
    assert ttext == want


@pytest.mark.parametrize("stream", [False, True])
def test_stop_strings_match_jax(servers, stream):
    """A stop string from inside the greedy text: both packages cut the
    text just before it, streamed or not."""
    body = {"text": "hello world", "max_new_tokens": 12,
            "temperature": 0.0}
    _, full = post(servers.ports[1], "/generate", body)
    words = full["text"].split()
    stop = words[len(words) // 2]    # not the last token: that one
    want = full["text"][:full["text"].find(stop)]   # finishes on length
    req = {**body, "stop": [stop], "stream": stream}
    got = both(servers, lambda p: call(p, "POST", "/generate", req))
    assert all(s == 200 for s, _ in got)
    texts = [stream_text(d) if stream else json.loads(d)["text"]
             for _, d in got]
    assert texts == [want, want]


def test_prompt_plus_max_tokens_over_seq_len_is_400(servers):
    body = {"text": "x" * 500, "max_new_tokens": 500}
    (js, jb), (ts, tb) = both(servers, lambda p: call(p, "POST",
                                                      "/generate", body))
    assert js == ts == 400
    assert b"max_seq_len 256" in tb


def test_sampling_surface_accepted(servers):
    """The full sampling surface is honoured, min_new_tokens included (the
    port's server; the packages draw from generators of their own, so no
    tokens are compared, and tests/test_serve_api.py holds the JAX one)."""
    body = {"text": "sample with everything", "max_new_tokens": 6,
            "temperature": 0.8, "top_k": 3, "top_p": 0.9, "min_p": 0.05,
            "frequency_penalty": 0.2, "presence_penalty": 0.1,
            "repetition_penalty": 1.1, "min_new_tokens": 2}
    status, b = post(servers.ports[1], "/generate", body)
    assert status == 200 and len(b["output_ids"]) >= 2


def test_concurrent_clients_match_jax(servers):
    """8 clients at once on 4 rows: each rid's tokens equal JAX's, or
    differ only after a near tie."""
    def run(port):
        def one(i):
            return post(port, "/generate", {
                "text": f"request number {i}", "max_new_tokens": 6,
                "temperature": 0.0, "logprobs": True, "rid": f"c{i}"})[1]
        with ThreadPoolExecutor(8) as pool:
            out = list(pool.map(one, range(8)))
        return {f"c{i}": SimpleNamespace(
            output_ids=o["output_ids"],
            output_top_logprobs=o["meta_info"]["output_top_logprobs"])
            for i, o in enumerate(out)}

    want, got = both(servers, run)
    assert_near_tie_parity(got, want)


def test_embeddings_match_jax(servers):
    """/v1/embeddings: the last token's final-norm hidden state."""
    body = {"input": ["hello world", "something else entirely"]}
    (js, jb), (ts, tb) = both(servers,
                              lambda p: post(p, "/v1/embeddings", body))
    assert js == ts == 200
    assert tb["usage"] == jb["usage"] and len(tb["data"]) == 2
    for jd, td in zip(jb["data"], tb["data"]):
        assert td["index"] == jd["index"]
        assert len(td["embedding"]) == 64
        np.testing.assert_allclose(td["embedding"], jd["embedding"],
                                   rtol=EMBED_TOL, atol=EMBED_TOL)


def test_offline_endpoints_answer_400_on_w8(tiny):
    """A W8 deployment: /v1/embeddings answers 400 with JAX's message;
    /v1/classify 400 (no classification head) in both."""
    mp = pytest.MonkeyPatch()
    mp.setenv("AURORA_NATIVE_RADIX", "0")
    pair = _pair(tiny, tiny.tree, quant="int8")
    try:
        for path in ("/v1/embeddings", "/v1/classify"):
            (js, jb), (ts, tb) = both(pair, lambda p: post(
                p, path, {"input": "hello"}))
            assert js == ts == 400
            assert tb == jb
    finally:
        pair.stop()
        mp.undo()


def test_classify_matches_jax_and_hf(servers, tiny):
    """/v1/classify on a tiny LlamaForSequenceClassification: the score
    head over the last prompt token, held to JAX's server and to HF's
    logits; a deployment without a head answers 400 in both."""
    import transformers

    from aurora_tpu.models.convert import (llama_config_from_hf as
                                           j_config_from_hf,
                                           llama_params_from_hf as
                                           j_params_from_hf,
                                           state_dict_from_torch_module)
    from aurora_tpu_torch.models.convert import (llama_config_from_hf,
                                                 llama_params_from_hf)
    torch.manual_seed(81)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, num_labels=3, pad_token_id=0,
        max_position_embeddings=512, attn_implementation="eager",
        tie_word_embeddings=False)
    hf = transformers.LlamaForSequenceClassification(hf_cfg).eval()
    jcfg = j_config_from_hf(hf_cfg.to_dict())
    tree = j_params_from_hf(state_dict_from_torch_module(hf), jcfg,
                            dtype=jnp.float32)
    tcfg = llama_config_from_hf(hf_cfg.to_dict())
    model = llama_params_from_hf(hf.state_dict(), tcfg, torch.float32,
                                 "cpu")
    assert model.score.weight.shape == (3, 64)
    assert torch.equal(model.lm_head.weight, model.embed_tokens)
    bridged = bridge.llama_from_params(jax.device_get(tree), tcfg,
                                       device="cpu", dtype=torch.float32)
    assert torch.equal(bridged.score.weight, model.score.weight)
    mp = pytest.MonkeyPatch()
    mp.setenv("AURORA_NATIVE_RADIX", "0")
    pair = Pair(tree, jcfg, JEngineConfig(kv_dtype=jnp.float32, **ENGINE),
                model, tcfg, EngineConfig(kv_dtype=torch.float32, **ENGINE),
                tiny.tok)
    try:
        (js, jb), (ts, tb) = both(pair, lambda p: post(
            p, "/v1/classify", {"input": ["hello", "a longer input"]}))
    finally:
        pair.stop()
        mp.undo()
    assert js == ts == 200
    for i, text in enumerate(["hello", "a longer input"]):
        got = tb["data"][i]["logits"]
        np.testing.assert_allclose(got, jb["data"][i]["logits"],
                                   rtol=EMBED_TOL, atol=EMBED_TOL)
        with torch.no_grad():
            want = hf(torch.tensor([tiny.tok.encode(text)])).logits[0]
        np.testing.assert_allclose(got, want.numpy(), rtol=HF_TOL,
                                   atol=HF_TOL)
    statuses = both(servers, lambda p: post(p, "/v1/classify",
                                            {"input": "hello"})[0])
    assert statuses == (400, 400)


def test_update_weights_matches_jax(servers, tiny):
    """/update_weights: the swap (tokens equal to JAX's after its swap,
    every live tensor at its address), the rollback on a missing directory
    (400, tokens kept), /flush_cache, then the swap back."""
    if 99 not in tiny.trees:
        tiny.trees[99] = jax.device_get(init_llama_params(
            jax.random.PRNGKey(99), tiny.jcfg, dtype=jnp.float32))
    other = tiny.trees[99]
    dirs = {}
    for name, tree in (("other", other), ("orig", tiny.tree)):
        dirs[name] = str(tiny.tmp / name)
        _write(llama_state_dict(tree, tiny.jcfg),
               llama_config_dict(tiny.jcfg), dirs[name])
    q = {"text": "the weather is", "max_new_tokens": 6}

    def gen():
        out = both(servers, lambda p: post(p, "/generate", q)[1])
        assert out[0]["output_ids"] == out[1]["output_ids"]
        return out[1]["output_ids"]

    def update(model_dir):
        return both(servers, lambda p: post(p, "/update_weights",
                                            {"model_dir": model_dir}))

    live = servers.tengine.runner.model.state_dict()
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    r1 = gen()
    for status, b in update(dirs["other"]):
        assert status == 200 and b["success"], b
    r2 = gen()
    assert r2 != r1
    assert {k: t.data_ptr() for k, t in
            servers.tengine.runner.model.state_dict().items()} == ptrs
    for status, b in update(str(tiny.tmp / "missing")):
        assert status == 400 and b["success"] is False
    assert gen() == r2
    for status, b in both(servers, lambda p: post(p, "/flush_cache", {})):
        assert status == 200 and b["flushed"]
    for status, b in update(dirs["orig"]):
        assert status == 200 and b["success"], b
    assert gen() == r1


@pytest.mark.parametrize("upload", ["multipart", "raw"])
def test_files_and_batches_match_jax(servers, upload):
    """/v1/files (a multipart upload or a raw body) and /v1/batches: the
    output records equal JAX's apart from their ids."""
    lines = "\n".join(json.dumps({
        "custom_id": f"c{i}", "method": "POST",
        "url": "/v1/chat/completions",
        "body": {"messages": [{"role": "user", "content": f"question {i}"}],
                 "max_tokens": 4}}) for i in range(3)).encode()
    if upload == "multipart":
        b = "auroraboundary"
        raw = (f'--{b}\r\nContent-Disposition: form-data; name="file"; '
               f'filename="in.jsonl"\r\nContent-Type: application/jsonl'
               f'\r\n\r\n').encode() + lines + f"\r\n--{b}--\r\n".encode()
        kw = dict(raw=raw, headers={
            "Content-Type": f"multipart/form-data; boundary={b}"})
        path = "/v1/files"
    else:
        kw = dict(raw=lines)
        path = "/v1/files?filename=in.jsonl"

    def run(port):
        status, fobj = call(port, "POST", path, **kw)
        fobj = json.loads(fobj)
        assert status == 200 and fobj["object"] == "file"
        assert (fobj["bytes"], fobj["filename"]) == (len(lines), "in.jsonl")
        _, batch = post(port, "/v1/batches", {"input_file_id": fobj["id"]})
        assert batch["status"] == "in_progress"
        for _ in range(600):
            _, batch = get(port, f"/v1/batches/{batch['id']}")
            if batch["status"] != "in_progress":
                break
            time.sleep(0.05)
        assert batch["status"] == "completed", batch
        assert batch["request_counts"] == {"total": 3, "completed": 3,
                                           "failed": 0}
        status, data = call(port, "GET",
                            f"/v1/files/{batch['output_file_id']}/content")
        assert status == 200
        out = [json.loads(ln) for ln in data.decode().splitlines() if ln]
        for o in out:
            o.pop("id")
        return sorted(out, key=lambda o: o["custom_id"])

    want, got = both(servers, run)
    assert got == want
    assert all(o["response"]["status_code"] == 200 for o in got)


def test_abort_request_matches_jax(servers):
    """/abort_request: an unknown rid answers false; a request aborted in
    mid-decode finishes with 'abort'."""
    def run(port):
        assert post(port, "/abort_request", {"rid": "nope"}) == \
            (200, {"aborted": False})
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(post, port, "/generate", {
                "text": "a long one", "max_new_tokens": 200,
                "temperature": 0.0, "rid": "long"})
            for _ in range(2000):
                if get(port, "/decode_stats")[1]["running"]:
                    break
                time.sleep(0.005)
            aborted = post(port, "/abort_request", {"rid": "long"})[1]
            status, body = fut.result(timeout=120)
        assert aborted == {"aborted": True} and status == 200
        return body["meta_info"]["finish_reason"], \
            len(body["output_ids"]) < 200

    assert both(servers, run) == (("abort", True), ("abort", True))


def test_ops_endpoints_match_jax(servers):
    """/decode_stats' keys; /get_model_info's memory equal to JAX's
    check_memory after the same request; /health and /v1/models."""
    def run(port):
        assert post(port, "/flush_cache", {})[0] == 200
        post(port, "/generate", {"text": "memory check",
                                 "max_new_tokens": 3})
        _, stats = get(port, "/decode_stats")
        _, info = get(port, "/get_model_info")
        return (sorted(stats), stats["running"], stats["queued"],
                info, get(port, "/health"), get(port, "/v1/models")[1]
                ["data"][0]["id"])

    want, got = both(servers, run)
    assert got == want
    assert got[0] == ["decode_s", "extend_s", "gen_tokens_per_s", "queued",
                      "running", "slot_usage"]
    assert got[3]["memory"]["leaked"] == 0 and got[3]["memory"]["cached"]


def test_failed_step_fails_only_the_running_batch(servers):
    """A step made to raise once with 4 requests running and 2 queued: the
    4 answer 500, the 2 complete, in both packages."""
    def arm(engine):
        real, failed = engine.step, []

        def step():
            if not failed:
                sched = engine.sched
                if len(sched.running) + len(sched.waiting) < 6:
                    time.sleep(0.002)        # wait for all 6 to arrive
                    return []
                if sched.running:
                    failed.extend(r.rid for r in sched.running)
                    raise RuntimeError("injected step failure")
            return real()

        engine.step = step
        return failed

    def run(pair_port, engine):
        failed = arm(engine)
        try:
            with ThreadPoolExecutor(6) as pool:
                res = list(pool.map(lambda i: post(pair_port, "/generate", {
                    "text": f"fail test {i}", "max_new_tokens": 8,
                    "temperature": 0.0, "rid": f"f{i}"}), range(6)))
        finally:
            del engine.step
        return sorted(failed), {f"f{i}": s for i, (s, _) in enumerate(res)}

    for port, engine in zip(servers.ports, (servers.jengine,
                                             servers.tengine)):
        failed, statuses = run(port, engine)
        assert len(failed) == 4
        assert {r for r, s in statuses.items() if s == 500} == set(failed)
        assert sum(s == 200 for s in statuses.values()) == 2
        assert engine.check_memory()["leaked"] == 0


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _surfaces(tok, ids):
    """The tiny WordLevel tokenizer joins its tokens with spaces: the text
    of ids is their surfaces joined."""
    return "".join(tok.decode([t], skip_special_tokens=True) for t in ids)


@pytest.mark.parametrize("body", [{"regex": "[ab]+"},
                                  {"choices_constraint": ["a", "b"]}])
def test_constrained_decoding_answers_501(servers, tiny, body):
    """Named for the 501 the port answered before constrained decoding was
    ported: /generate with a regex or choices now answers 200, the JAX
    server's tokens and text, inside the constraint."""
    req = {"text": "x", "max_new_tokens": 2, "temperature": 0.0, **body}
    (js, jb), (ts, tb) = both(servers, lambda p: post(p, "/generate", req))
    assert js == ts == 200
    assert tb == jb
    text = _surfaces(tiny.tok, tb["output_ids"])
    if "regex" in body:
        assert re.fullmatch("[ab]+", text), text
    else:
        assert text in ("a", "b") and tb["meta_info"]["finish_reason"] \
            == "stop"


@pytest.mark.parametrize("stream", [False, True])
def test_prompt_past_largest_bucket_answers_501(servers, stream):
    """Named for the 501 the port answered before chunked prefill was
    ported: a 200-token prompt, past the largest bucket (192), is
    prefilled in two chunks and answered with the JAX server's text,
    streamed or not."""
    req = {"text": "y" * 200, "max_new_tokens": 4, "temperature": 0.0,
           "stream": stream}
    (js, jb), (ts, tb) = both(servers, lambda p: call(p, "POST", "/generate",
                                                      req, timeout=60))
    assert js == ts == 200
    if stream:
        assert stream_text(tb) == stream_text(jb)
    else:
        assert json.loads(tb) == json.loads(jb)
        assert json.loads(tb)["meta_info"]["prompt_tokens"] == 200
    assert get(servers.ports[1], "/health")[0] == 200
    assert servers.tengine.check_memory()["leaked"] == 0


JUDGE = r"\{'pred': '(yes|no)', 'score': [0-5]\}"


@pytest.mark.parametrize("path", ["/v1/completions", "/v1/chat/completions"])
@pytest.mark.parametrize("constraint", [
    {"regex": JUDGE}, {"choices_constraint": ["camera", "background",
                                              "main object"]}])
def test_openai_constrained_matches_jax(servers, tiny, path, constraint):
    body = {"max_tokens": 40, "temperature": 0.0, **constraint}
    if path == "/v1/completions":
        body["prompt"] = "Is the caption right?"
    else:
        body["messages"] = [{"role": "user",
                             "content": "Is the caption right?"}]
    (js, jb), (ts, tb) = both(servers, lambda p: post(p, path, body))
    assert js == ts == 200
    jc, tc = jb["choices"][0], tb["choices"][0]
    assert tc == jc and tb["usage"] == jb["usage"]
    text = tc["text"] if "text" in tc else tc["message"]["content"]
    words = text.replace(" ", "")   # the tokenizer's joining spaces
    if "regex" in constraint:
        assert re.fullmatch(JUDGE, words.replace("'pred':'", "'pred': '")
                            .replace("','score':", "', 'score': ")), text
    else:
        assert words in ("camera", "background", "mainobject"), text
    assert tc["finish_reason"] == "stop"


@pytest.mark.parametrize("pattern", ["[ab", "a{99999}", "(a|b"])
def test_bad_pattern_answers_400(servers, pattern):
    got = both(servers, lambda p: post(p, "/generate", {
        "text": "x", "max_new_tokens": 4, "regex": pattern}))
    assert [s for s, _ in got] == [400, 400]
    assert "invalid constraint" in got[1][1]["error"]
    assert get(servers.ports[1], "/health")[0] == 200


def test_lang_judge_program_matches_jax(servers, tiny):
    """A VDC judge program (an answer under the judge's regex, then a
    yes/no select) in the port's lang.py over the port's server and in
    the reference's lang.py over the JAX server, run_batch of 4: the same
    captured answers, each inside its constraint."""
    from aurora_tpu import lang as jlang
    from aurora_tpu_torch import lang as tlang

    def judge(lang):
        @lang.function
        def program(s, caption):
            s += lang.user(f"caption: {caption}. Right?")
            s += lang.assistant(lang.gen("verdict", max_tokens=40,
                                         regex=JUDGE))
            s += lang.user("Sure?")
            s += lang.assistant(lang.select("sure", ["yes", "no"]))
        return program

    batch = [{"caption": c} for c in ("a cat", "two dogs", "rain", "a car")]
    out = []
    for lang, port in ((jlang, servers.ports[0]), (tlang, servers.ports[1])):
        states = judge(lang).run_batch(
            batch, backend=lang.RuntimeEndpoint(f"http://127.0.0.1:{port}"),
            num_threads=4)
        out.append([(st["verdict"], st["sure"]) for st in states])
    assert out[1] == out[0]
    for verdict, sure in out[1]:
        assert sure.replace(" ", "") in ("yes", "no")
        assert verdict.replace(" ", "").startswith("{'pred':'")


@pytest.mark.parametrize("case", ["unknown", "method", "gui", "bad_json",
                                  "missing_field"])
def test_transport_status_codes(servers, case):
    port = servers.ports[1]
    if case == "unknown":
        assert call(port, "GET", "/nope")[0] == 404
    elif case == "method":
        assert call(port, "GET", "/generate")[0] == 405
    elif case == "gui":
        status, data = call(port, "GET", "/")
        assert status == 200 and b"/generate" in data
    elif case == "bad_json":
        assert call(port, "POST", "/generate", raw=b"{not json",
                    headers={"Content-Type": "application/json"})[0] == 400
    else:
        status, b = post(port, "/generate", {"max_new_tokens": 2})
        assert status == 400 and "text" in b["error"]


def test_stream_detok_incremental(tiny):
    """StreamDetok emits exactly the full-decode text, incrementally,
    with bounded decode windows and stop trimming (as
    tests/test_serve_api.py's case)."""
    tok = tiny.tok
    ids = tok.encode("hello world this is streaming",
                     add_special_tokens=False)
    sd = StreamDetok(tok)
    out = "".join(sd.push(ids[:i + 1]) for i in range(len(ids)))
    out += sd.push(ids)
    assert out == tok.decode(ids, skip_special_tokens=True)
    assert sd.prefix >= len(ids) - 8
    text = tok.decode(ids, skip_special_tokens=True)
    stop = text.split()[2]
    sd2 = StreamDetok(tok, stop=stop)
    out2 = "".join(sd2.push(ids[:i + 1]) for i in range(len(ids)))
    assert out2 == text[:text.find(stop)]
    assert sd2.done
    assert sd2.push(ids) == ""


def test_stream_detok_rewrite_and_final_flush(tiny):
    """StreamDetok survives output_ids rewrites without garbling or
    duplicating, and final=True flushes a held-back tail (as
    tests/test_serve_api.py's case)."""
    tok = tiny.tok
    ids_a = tok.encode("hello world this is streaming",
                       add_special_tokens=False)
    sd = StreamDetok(tok)
    out = sd.push(ids_a[:3])
    rewritten = list(ids_a[:2]) + list(
        tok.encode(tok.decode(ids_a[2:], skip_special_tokens=True),
                   add_special_tokens=False))
    for i in range(2, len(rewritten) + 1):
        out += sd.push(rewritten[:i])
    out += sd.push(rewritten, final=True)
    assert out == tok.decode(rewritten, skip_special_tokens=True)
    sd2 = StreamDetok(tok)
    ids_b = tok.encode("abc", add_special_tokens=False)
    partial = "".join(sd2.push(ids_b[:i + 1]) for i in range(len(ids_b)))
    assert partial + sd2.push(ids_b, final=True) == tok.decode(
        ids_b, skip_special_tokens=True)


# ---------------------------------------------------------------------------
# the engine surface the server calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill", ["max_batch", "num_slots", "both"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_auto_engine_config_matches_jax(tiny, fill, kv_quant):
    """auto_engine_config's doubling rule over the port's row_buffer_bytes
    gives the JAX package's max_batch and num_slots for the same budget;
    free_hbm_bytes is None on the CPU."""
    from aurora_tpu.serve.engine import auto_engine_config as j_auto
    from aurora_tpu_torch.serve.engine import (auto_engine_config,
                                               free_hbm_bytes)
    zero = {"max_batch": 0} if fill == "max_batch" else \
        {"num_slots": 0} if fill == "num_slots" else \
        {"max_batch": 0, "num_slots": 0}
    kw = dict(max_seq_len=2048, kv_quant=kv_quant, **zero)
    for budget in (3 * 2 ** 20, 5 * 10 ** 8):
        want = j_auto(tiny.jcfg, JEngineConfig(kv_dtype=jnp.bfloat16, **kw),
                      budget_bytes=budget)
        got = auto_engine_config(tiny.tcfg, EngineConfig(**kw),
                                 budget_bytes=budget)
        assert (got.max_batch, got.num_slots) == (want.max_batch,
                                                  want.num_slots)
    assert free_hbm_bytes("cpu") is None


def _greedy(engine, prompts, n=8):
    from aurora_tpu_torch.serve.scheduler import Request
    for i, ids in enumerate(prompts):
        engine.add_request(Request(rid=f"u{i}", input_ids=ids,
                                   max_new_tokens=n, eos_ids=()))
    done = {}
    while engine.has_work():
        done.update((r.rid, r.output_ids) for r in engine.step())
    return [done[f"u{i}"] for i in range(len(prompts))]


@pytest.mark.parametrize("layout", ["dense", "w8", "w4-stripes", "w4-flat",
                                    "w4-fused-mlp"])
def test_update_weights_reaches_the_live_layout(tiny, monkeypatch, layout):
    """update_weights with a dense model: every live tensor keeps its
    address, and the tokens after the swap equal those of an engine built
    fresh from the new weights, in every weight layout (the quantization,
    the fused streams, w4_decode_layout, the int8 LM head); a model of
    another shape is refused with nothing changed; so is any swap while a
    request runs."""
    from aurora_tpu_torch.serve.engine import BUSY
    monkeypatch.setenv("AURORA_NATIVE_RADIX", "0")
    quant = {"dense": {}, "w8": dict(weight_quant="int8", kv_quant="int8"),
             "w4-stripes": dict(weight_quant="int4", kv_quant="int8"),
             "w4-flat": dict(weight_quant="int4", w4_tiled=False),
             "w4-fused-mlp": dict(weight_quant="int4", w4_fused_mlp=True)}
    ecfg = EngineConfig(kv_dtype=torch.float32, **quant[layout], **ENGINE)

    def dense(seed):
        if seed not in tiny.trees:
            tiny.trees[seed] = jax.device_get(init_llama_params(
                jax.random.PRNGKey(seed), tiny.jcfg, dtype=jnp.float32))
        return bridge.llama_from_params(tiny.trees[seed], tiny.tcfg,
                                        device="cpu", dtype=torch.float32)

    prompts = [tiny.tok.encode("update me"), tiny.tok.encode("and me too")]
    engine = ServeEngine(dense(3), tiny.tcfg, ecfg)
    before = _greedy(engine, prompts)
    live = engine.runner.model.state_dict()
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    snapshot = {k: t.clone() for k, t in live.items()}

    other = dense(99)
    import dataclasses
    wide = dataclasses.replace(tiny.tcfg, intermediate_size=192)
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaModel
    misfit = build(LlamaModel, wide, device="cpu", dtype=torch.float32,
                   generator=torch.Generator().manual_seed(1))
    ok, msg = engine.update_weights(misfit)
    assert not ok and msg
    assert all(torch.equal(t, snapshot[k]) for k, t in live.items())
    assert _greedy(engine, prompts) == before

    from aurora_tpu_torch.serve.scheduler import Request
    engine.add_request(Request(rid="busy", input_ids=prompts[0],
                               max_new_tokens=4))
    engine.step()
    assert engine.update_weights(other) == (False, BUSY)
    while engine.has_work():
        engine.step()

    ok, msg = engine.update_weights(other)
    assert ok, msg
    assert {k: t.data_ptr() for k, t in
            engine.runner.model.state_dict().items()} == ptrs
    assert engine.check_memory()["cached"] == 0
    after = _greedy(engine, prompts)
    fresh = _greedy(ServeEngine(dense(99), tiny.tcfg, ecfg), prompts)
    assert after == fresh and after != before


def test_failed_admission_answers_500_not_a_hang(servers, monkeypatch):
    """A wave whose extend raises: the step raises with the wave parked in
    sched.aborted, which has_work counts, so the next step returns it and
    its client gets 500 instead of waiting for another request."""
    engine = servers.tengine
    real = engine.runner.extend

    def extend(*a, **k):
        monkeypatch.setattr(engine.runner, "extend", real)
        raise RuntimeError("injected extend failure")

    monkeypatch.setattr(engine.runner, "extend", extend)
    status, b = post(servers.ports[1], "/generate",
                     {"text": "admission fails", "max_new_tokens": 3},
                     timeout=30)
    assert status == 500 and "injected extend failure" in b["error"]
    assert engine.check_memory()["leaked"] == 0
    assert post(servers.ports[1], "/generate",
                {"text": "admission works", "max_new_tokens": 3})[0] == 200
