"""HTTP serving front end (aurora_tpu/serve/api.py): /generate and the
OpenAI-compatible endpoints over `ServeEngine`, on the standard library.

One asyncio event loop holds the connections and a `ServingLoop`, which
steps the engine in a worker thread (`asyncio.to_thread`) and hands each
request's progress to its handler through an asyncio.Queue. Engine
mutations that handlers ask for (add, abort, flush, update_weights) are
staged and applied only between steps, since a step mutates the
scheduler's lists in its thread. Each step runs under
`torch.inference_mode()` and with the engine's device as the thread's
current CUDA device (both are thread-local; the kernel launchers read the
current stream).

Routes, the reference's `build_app` (api.py:777-796):
  POST /generate                  native API: text, input_ids, or a video
                                  (video_path or frames_b64) with --aurora
  POST /v1/completions            OpenAI completions (+ SSE streaming)
  POST /v1/chat/completions       OpenAI chat (+ SSE streaming)
  GET  /health, /get_model_info, /v1/models, /decode_stats
  POST /abort_request, /flush_cache
  POST /update_weights            live reload from a HF directory
  POST /v1/embeddings, /v1/classify   offline forward (dense weights only)
  POST /v1/files, GET /v1/files/{fid}/content
  POST /v1/batches, GET /v1/batches/{bid}
  GET  /                          a one-page web UI driving /generate

Transport. The reference is built on aiohttp, which the GPU host does not
have (and nothing may be installed there), so the port serves HTTP/1.1 on
`asyncio.start_server` itself: the request line, the query string,
headers and a Content-Length body (an `Expect: 100-continue` is
answered); path parameters; JSON answers with Content-Length and
keep-alive; SSE streams with `Transfer-Encoding: chunked`; multipart
uploads parsed by `email.parser.BytesParser`. Status codes: 400 for bad
input (a malformed or over-complex `regex` among it), 404 for an unknown
route, 405 for a wrong method, 409 when /update_weights cannot drain the
running batch, 500 for an engine error, 501 for what the port has not
ported.

Constrained decoding: `regex` (serve/fsm.py RegexConstraint, with
jump-forward) or `choices_constraint` (serve/constrained.py
ChoiceConstraint) on /generate, /v1/completions and /v1/chat/completions,
as the reference takes them (api.py:257-270). A regex's token table walks
the whole vocabulary, so such a request is built in the worker threads
that also read videos, not on the event loop. Prompts up to max_seq_len
are answered: the engine prefills those past its largest bucket in
chunks, beside the running decode.

Where the port differs from the reference:
- A video request's frames are resized and center-cropped on the device
  (`clip_resize_crop_device`, rounded to uint8 levels) before
  `build_request`, where the reference runs PIL's geometry on the host
  (api.py:409, :425): the two agree within 2 levels (tests/test_data.py),
  and the GPU host has no PIL.
- /v1/embeddings and /v1/classify answer 501 on a tensor-parallel
  deployment (`EngineConfig(tp > 1)`): its shards hold parts of each
  layer, and the offline forward runs one whole model.
- A request that the engine refuses at admission answers with the
  engine's reason (400 for a ValueError, 500 otherwise); the reference's
  engine refuses none.
- /v1/embeddings and /v1/classify run one `llama_apply(...,
  return_hidden=True)` under `torch.inference_mode` in a worker thread in
  place of the reference's jitted `_embed_fwd`.
- /update_weights retries only while the engine is busy; any other
  refusal answers at once.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import email.parser
import email.policy
import http
import json
import logging
import os
import re
import shutil
import tempfile
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aurora_tpu_torch.data.preprocess import clip_resize_crop_device
from aurora_tpu_torch.data.text import build_video_prompt
from aurora_tpu_torch.data.video import read_video
from aurora_tpu_torch.generate.sampler import SamplingParams
from aurora_tpu_torch.models.convert import (llama_params_from_hf,
                                             load_torch_state_dict)
from aurora_tpu_torch.models.llama import llama_apply
from aurora_tpu_torch.serve.constrained import ChoiceConstraint
from aurora_tpu_torch.serve.engine import (BUSY, EngineConfig, ServeEngine,
                                           device_scope, weight_quant_of)
from aurora_tpu_torch.serve.fsm import RegexConstraint
from aurora_tpu_torch.serve.scheduler import Request
from aurora_tpu_torch.utils.templates import (PROMPT_TEMPLATE,
                                              render_conversation)

log = logging.getLogger(__name__)

_MAX_BODY = 1 << 30          # bytes of one request body
_MAX_HEADERS = 100


# ---------------------------------------------------------------------------
# Engine bridge
# ---------------------------------------------------------------------------

class ServingLoop:
    """Bridges the asyncio front end and the synchronous engine."""

    def __init__(self, engine: ServeEngine, tokenizer, mm=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.mm = mm  # AuroraCapServing for multimodal deployments
        self.device = engine.runner.device
        self._events: Dict[str, asyncio.Queue] = {}
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        # (callable, future or None) staged by handlers, applied by
        # _drain_ops between steps only
        self._ops = collections.deque()

    async def start(self) -> None:
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._run())

    def _drain_ops(self) -> None:
        """Apply staged engine mutations — called ONLY between steps."""
        while self._ops:
            fn, fut = self._ops.popleft()
            try:
                res = fn()
                if fut is not None and not fut.cancelled():
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 - delivered to the caller
                if fut is not None and not fut.cancelled():
                    fut.set_exception(e)
                else:
                    log.exception("staged engine operation failed")

    async def call(self, fn):
        """Run an engine-mutating callable between steps, await result."""
        fut = asyncio.get_running_loop().create_future()
        self._ops.append((fn, fut))
        if self._wake is not None:
            self._wake.set()
        return await fut

    def _step(self):
        with torch.inference_mode(), device_scope(self.device):
            return self.engine.step()

    async def _run(self) -> None:
        while True:
            self._drain_ops()
            if not self.engine.has_work():
                # park until submit() or call() wakes us (no idle polling)
                self._wake.clear()
                if self._ops:  # staged between drain and clear
                    continue
                await self._wake.wait()
                continue
            try:
                stepped = await asyncio.to_thread(self._step)
            except Exception as e:  # noqa: BLE001 - the loop must go on
                # per-request failures are isolated inside the engine; a
                # step that raises makes the running batch suspect: fail
                # it, and keep the waiting queue
                log.exception("engine step failed")
                for req in self.engine.fail_running():
                    q = self._events.pop(req.rid, None)
                    if q is not None:
                        q.put_nowait(("error", e))
                continue
            for req in stepped:
                q = self._events.pop(req.rid, None)
                if q is not None:
                    if req.error is not None:
                        q.put_nowait(("error", RuntimeError(req.error)))
                    else:
                        q.put_nowait(("done", req))
            # streaming: push partials for running requests
            for req in self.engine.sched.running:
                q = self._events.get(req.rid)
                if q is not None and req.stream:
                    q.put_nowait(("delta", req))

    async def submit(self, req: Request) -> asyncio.Queue:
        """Stage req's admission; its progress arrives on the returned
        queue: ("delta", req) after each step while it streams, ("done",
        req), ("error", exc) when its step failed, or ("rejected", exc)
        when the engine refused it at admission."""
        q: asyncio.Queue = asyncio.Queue()
        self._events[req.rid] = q

        def add():
            try:
                self.engine.add_request(req)
            except Exception as e:  # noqa: BLE001 - the handler answers
                self._events.pop(req.rid, None)
                q.put_nowait(("rejected", e))

        self._ops.append((add, None))
        if self._wake is not None:
            self._wake.set()
        return q

    def detok(self, ids, req=None) -> str:
        text = self.tokenizer.decode([int(t) for t in ids],
                                     skip_special_tokens=True)
        stop = getattr(req, "stop_trim", None) if req is not None else None
        if stop:
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
        return text


class StreamDetok:
    """Incremental detokenization for one streamed request.

    The HF/sglang incremental-decode algorithm (sglang
    srt/managers/tokenizer_manager.py decode_status: prefix_offset /
    read_offset): each delta decodes only the tokens since the last
    emitted boundary instead of the whole output — O(n) over a stream —
    and holds back text while the tail is an incomplete UTF-8 sequence
    ('\\ufffd'). Stop-string trimming matches ServingLoop.detok."""

    def __init__(self, tokenizer, stop=None):
        self.tok = tokenizer
        # one stop string or a tuple of them (Request.stop_strs)
        self.stops = ((stop,) if isinstance(stop, str)
                      else tuple(stop or ()))
        self.prefix = 0      # decode-window start (last clean boundary)
        self.read = 0        # tokens already rendered into `acc`
        self.window = []     # ids[prefix:read] snapshot (rewrite detect)
        self.acc = ""        # full decoded text so far
        self.sent = 0        # chars already returned to the client
        self.done = False    # stop string reached

    def push(self, ids, final: bool = False) -> str:
        """ids: full output_ids so far → newly-stable text delta.
        final=True (the stream's done event) flushes text held back
        behind an incomplete-UTF-8 boundary instead of dropping it."""
        if self.done:
            return ""
        ids = [int(t) for t in ids]
        if ids[self.prefix:self.read] != self.window:
            # output_ids were REWRITTEN, not appended — jump-forward
            # retokenization healing rewinds the list to the canonical
            # tokenization of the same text (engine._maybe_jump). The
            # incremental window is meaningless now: resync from a full
            # decode. Already-sent chars stay monotonic (`sent` never
            # rewinds), so clients see no duplication.
            self.acc = self.tok.decode(ids, skip_special_tokens=True)
            self.read = len(ids)
            self.prefix = max(0, self.read - 4)
        else:
            last = self.tok.decode(ids[self.prefix:self.read],
                                   skip_special_tokens=True)
            new = self.tok.decode(ids[self.prefix:],
                                  skip_special_tokens=True)
            if len(new) > len(last) and (final
                                         or not new.endswith("�")):
                self.acc += new[len(last):]
                self.prefix = self.read
                self.read = len(ids)
        self.window = ids[self.prefix:self.read]
        text = self.acc
        hits = [text.find(s) for s in self.stops if text.find(s) >= 0]
        if hits:
            text = text[:min(hits)]
            self.done = True
        delta = text[self.sent:]
        self.sent = max(self.sent, len(text))
        return delta


def _sampling_from(body: Dict[str, Any]) -> SamplingParams:
    temp = float(body.get("temperature", 0.0))
    if not body.get("do_sample", True):
        temp = 0.0
    return SamplingParams(
        temperature=temp,
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        min_new_tokens=int(body.get("min_new_tokens", 0)))


def _logprobs_payload(loop_, req, chat: bool = False):
    """OpenAI-format logprobs block for a finished request."""
    if not req.logprobs:
        return None
    toks = [loop_.tokenizer.decode([t]) for t in req.output_ids]
    if chat:
        content = []
        for t, lp, top in zip(toks, req.output_logprobs,
                              req.output_top_logprobs):
            content.append({
                "token": t, "logprob": lp,
                "top_logprobs": [
                    {"token": loop_.tokenizer.decode([i]), "logprob": v}
                    for i, v in top]})
        return {"content": content}
    return {"tokens": toks,
            "token_logprobs": req.output_logprobs,
            "top_logprobs": [
                {loop_.tokenizer.decode([i]): v for i, v in top}
                for top in req.output_top_logprobs]}


# ---------------------------------------------------------------------------
# Transport: HTTP/1.1 on asyncio streams
# ---------------------------------------------------------------------------

class HTTPError(Exception):
    """An answer other than 200, raised by a handler."""

    def __init__(self, status: int, payload: Dict[str, Any]):
        super().__init__(payload)
        self.status = status
        self.payload = payload


def _error(status: int, message: str) -> HTTPError:
    return HTTPError(status, {"error": message})


class HTTPRequest:
    """One parsed request: method, path (percent-decoded), query (last
    value of each name), headers (lower-case names), body bytes, and the
    route's path parameters in match_info."""

    def __init__(self, method, path, query, headers, body, writer):
        self.method, self.path, self.query = method, path, query
        self.headers, self.body, self.writer = headers, body, writer
        self.match_info: Dict[str, str] = {}

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip()

    def json(self) -> Dict[str, Any]:
        try:
            body = json.loads(self.body or b"{}")
        except ValueError as e:
            raise _error(400, f"invalid JSON body: {e}") from e
        if not isinstance(body, dict):
            raise _error(400, "the JSON body must be an object")
        return body


class Response:
    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = "application/json"):
        self.body, self.status, self.content_type = body, status, \
            content_type


def json_response(obj, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status)


def _head(status: int, headers: List[Tuple[str, str]]) -> bytes:
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A 200 server-sent-event stream written as it is produced, chunked."""

    def __init__(self, request: HTTPRequest):
        self.writer = request.writer
        self.finished = False

    async def prepare(self) -> None:
        self.writer.write(_head(200, [
            ("Content-Type", "text/event-stream"),
            ("Cache-Control", "no-cache"),
            ("Transfer-Encoding", "chunked")]))
        await self.writer.drain()

    async def write(self, data: bytes) -> None:
        self.writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self.writer.drain()

    async def write_eof(self) -> None:
        self.writer.write(b"0\r\n\r\n")
        await self.writer.drain()
        self.finished = True


Handler = Callable[[HTTPRequest], Awaitable[Any]]


class App:
    """The route table and the connection handler; `close` ends what the
    handlers started."""

    def __init__(self, loop_: ServingLoop):
        self.loop_ = loop_
        self.routes: List[Tuple[str, "re.Pattern", Handler]] = []
        self.on_close: List[Callable[[], Any]] = []
        self._writers = set()

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        rx = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)",
                                     pattern) + "$")
        self.routes.append((method, rx, handler))

    def _route(self, req: HTTPRequest) -> Handler:
        allowed = []
        for method, rx, handler in self.routes:
            m = rx.match(req.path)
            if m is None:
                continue
            if method == req.method:
                req.match_info = m.groupdict()
                return handler
            allowed.append(method)
        if allowed:
            raise _error(405, f"{req.method} {req.path}: allowed "
                              f"{', '.join(allowed)}")
        raise _error(404, f"no route {req.path}")

    async def _read(self, reader, writer) -> Optional[HTTPRequest]:
        """The next request on the connection, None at its end."""
        line = await reader.readline()
        if not line.strip():
            return None
        try:
            method, target, version = line.decode("latin-1").split()
        except ValueError:
            raise _error(400, "malformed request line") from None
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS + 1):
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        else:
            raise _error(400, "too many headers")
        headers[":version"] = version
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _error(501, "chunked request bodies are not supported; "
                              "send a Content-Length")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise _error(400, "bad Content-Length") from None
        if not 0 <= n <= _MAX_BODY:
            raise _error(400, f"a body of {n} bytes")
        if n and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        body = await reader.readexactly(n) if n else b""
        url = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(url.query,
                                            keep_blank_values=True))
        return HTTPRequest(method.upper(), urllib.parse.unquote(url.path),
                           query, headers, body, writer)

    async def _answer(self, req: HTTPRequest):
        try:
            return await self._route(req)(req)
        except HTTPError as e:
            return json_response(e.payload, e.status)
        except (ValueError, TypeError, KeyError) as e:
            # malformed fields of the request body
            what = f"missing field {e}" if isinstance(e, KeyError) else str(e)
            return json_response({"error": what}, 400)
        except Exception as e:  # noqa: BLE001 - a server keeps serving
            log.exception("%s %s failed", req.method, req.path)
            return json_response({"error": str(e)}, 500)

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        """Serve one connection: requests in turn while it is kept alive."""
        self._writers.add(writer)
        try:
            while True:
                try:
                    req = await self._read(reader, writer)
                except HTTPError as e:
                    resp, req = json_response(e.payload, e.status), None
                else:
                    if req is None:
                        break
                    resp = await self._answer(req)
                if isinstance(resp, StreamResponse):
                    if not resp.finished:
                        break
                    continue
                conn = req.headers.get("connection", "").lower() \
                    if req is not None else "close"
                keep = req is not None and (
                    "keep-alive" in conn if req.headers[":version"] ==
                    "HTTP/1.0" else conn != "close")
                writer.write(_head(resp.status, [
                    ("Content-Type", resp.content_type),
                    ("Content-Length", str(len(resp.body))),
                    ("Connection", "keep-alive" if keep else "close")])
                    + resp.body)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError):
            pass  # the client went away or sent an oversized line
        finally:
            self._writers.discard(writer)
            writer.close()

    async def close(self) -> None:
        for writer in list(self._writers):
            writer.close()
        for fn in self.on_close:
            res = fn()
            if asyncio.iscoroutine(res):
                await res


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

_GUI_HTML = """<!doctype html><html><head><title>aurora_tpu_torch</title>
<style>body{font-family:sans-serif;max-width:760px;margin:2em auto}
textarea,input{width:100%;margin:4px 0;box-sizing:border-box}
#out{white-space:pre-wrap;border:1px solid #ccc;padding:1em;min-height:6em}
label{font-size:.9em;color:#444}</style></head><body>
<h2>aurora_tpu_torch — video captioning</h2>
<label>Prompt</label>
<textarea id="prompt" rows="3">Describe the video in detail.</textarea>
<label>Server-side video path (optional — empty for text-only)</label>
<input id="video" placeholder="/path/to/video.mp4">
<label>num frames / kept ratio / max new tokens</label>
<input id="frames" value="8"> <input id="ratio" value="0.8">
<input id="maxnew" value="256">
<button onclick="go()">Generate</button>
<h3>Output</h3><div id="out"></div>
<script>
async function go(){
  const v = document.getElementById('video').value.trim();
  const body = {text: document.getElementById('prompt').value,
                max_new_tokens: +document.getElementById('maxnew').value};
  if (v) { body.video_path = v;
           body.num_frames = +document.getElementById('frames').value;
           body.token_kept_ratio = +document.getElementById('ratio').value; }
  document.getElementById('out').textContent = '…generating';
  const r = await fetch('/generate', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify(body)});
  const j = await r.json();
  document.getElementById('out').textContent = j.text || JSON.stringify(j);
}
</script></body></html>"""


def _refusal(e: Exception) -> HTTPError:
    """The answer to a request that the engine would not admit."""
    if isinstance(e, NotImplementedError):
        return _error(501, str(e))
    if isinstance(e, ValueError):
        return _error(400, str(e))
    return _error(500, str(e))


def _multipart_file(content_type: str, body: bytes):
    """The `file` field of a multipart/form-data body → (filename or None,
    bytes), (None, b"") when there is none."""
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n"
        + body)
    if not msg.is_multipart():
        raise _error(400, "a multipart body without its boundary")
    for part in msg.iter_parts():
        if part.get_param("name", header="content-disposition") == "file":
            return part.get_filename(), part.get_payload(decode=True) or b""
    return None, b""


def _offline_fwd_unavailable(model) -> Optional[str]:
    """Why the offline llama_apply forward (embeddings, classify) cannot
    run on this deployment's weights, or None: it runs dense layers only,
    and dotting packed int4 or int8 matrices would return garbage."""
    if weight_quant_of(model) != "none":
        return ("are unavailable on weight-quantized deployments (start "
                "without --weight-quant)")
    return None


def _last_hidden(model, cfg, ids: List[int]) -> torch.Tensor:
    """The final-norm hidden state of the last prompt token, fp32 [D] (the
    e5-mistral convention of the reference's embedding path); the prompt
    is padded to a power-of-two bucket of at least 16 and masked."""
    n = len(ids)
    bucket = max(16, 1 << (n - 1).bit_length())
    dev = model.embed_tokens.device
    pad = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    pad[0, :n] = torch.as_tensor(ids, dtype=torch.int64)
    mask = torch.zeros((1, bucket), dtype=torch.bool, device=dev)
    mask[0, :n] = True
    hidden = llama_apply(model, cfg, input_ids=pad, attention_mask=mask,
                         return_hidden=True)
    last = (mask.sum(dim=1) - 1).clamp_min(0)
    return hidden[torch.arange(1, device=dev), last][0].float()


def build_app(loop_: ServingLoop, model_name: str = "auroracap") -> App:
    app = App(loop_)
    eos_default = tuple(
        {loop_.tokenizer.eos_token_id} - {None}) or (2,)
    # multimodal host work (video decode, the device resize-crop and the
    # ViT prewarm) and constraint builds run here, off the event loop
    mm_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="aurora-mm")
    app.on_close.append(lambda: mm_pool.shutdown(wait=False,
                                                 cancel_futures=True))
    tasks = set()   # background batch jobs (the loop holds tasks weakly)

    def make_request(prompt_ids, body, stream=False) -> Request:
        ecfg = loop_.engine.ecfg
        max_new = int(body.get("max_new_tokens", body.get("max_tokens",
                                                          128)))
        if len(prompt_ids) + max_new > ecfg.max_seq_len:
            raise _error(400, "prompt+max_tokens exceeds max_seq_len "
                              f"{ecfg.max_seq_len}")
        stop = body.get("stop") or ()
        if isinstance(stop, str):
            stop = (stop,)
        constraint = None
        try:
            if body.get("choices_constraint"):
                constraint = ChoiceConstraint.from_strings(
                    loop_.tokenizer, body["choices_constraint"])
            elif body.get("regex"):
                constraint = RegexConstraint(
                    body["regex"], loop_.tokenizer,
                    loop_.engine.cfg.vocab_size, eos_ids=eos_default)
        except (ValueError, IndexError) as e:
            raise _error(400, f"invalid constraint: {e}") from None
        return Request(
            constraint=constraint,
            rid=body.get("rid", uuid.uuid4().hex),
            input_ids=[int(t) for t in prompt_ids],
            sampling=_sampling_from(body),
            max_new_tokens=max_new,
            logprobs=bool(body.get("logprobs")),
            eos_ids=eos_default, stop_strs=tuple(stop), stream=stream)

    async def new_request(prompt_ids, body, stream=False) -> Request:
        """make_request, in a worker thread when the body asks for a
        constraint (a regex's token table walks the whole vocabulary)."""
        if body.get("choices_constraint") or body.get("regex"):
            return await asyncio.get_running_loop().run_in_executor(
                mm_pool, make_request, prompt_ids, body, stream)
        return make_request(prompt_ids, body, stream)

    async def run_request(req: Request):
        q = await loop_.submit(req)
        while True:
            kind, r = await q.get()
            if kind == "rejected":
                raise _refusal(r)
            if kind == "error":
                raise _error(500, str(r))
            if kind == "done":
                return r

    def _multimodal_request(body):
        """AuroraCap video captioning request (launch_server_auroracap
        parity): the video read on the host, resized and cropped on the
        device, the prompt built from the reference template; placeholder
        ids keep the radix cache hot; the ViT encode starts here."""
        mm = loop_.mm
        dev = mm.model.llm.embed_tokens.device
        if "video_path" in body:
            raw = read_video(body["video_path"],
                             int(body.get("num_frames", 8)))
        else:
            shape = body["frame_shape"]
            raw = np.stack([np.frombuffer(base64.b64decode(b),
                                          np.uint8).reshape(shape)
                            for b in body["frames_b64"]])
        size = int(body.get("image_size", mm.image_size))
        with torch.inference_mode(), device_scope(dev):
            px = clip_resize_crop_device(torch.as_tensor(raw, device=dev),
                                         size, size)
            px = px.to(torch.uint8).cpu().numpy()
            prompt_text = build_video_prompt(
                body.get("text", "Describe the video in detail."),
                px.shape[0], PROMPT_TEMPLATE.vicuna)
            kept = body.get("token_kept_ratio")
            req = mm.build_request(
                body.get("rid", uuid.uuid4().hex), prompt_text, px,
                kept_ratio=float(kept) if kept is not None else None,
                sampling=_sampling_from(body),
                max_new_tokens=int(body.get("max_new_tokens", 1024)),
                eos_ids=eos_default, stream=bool(body.get("stream")))
            # placeholder expansion (frames x visual tokens) can blow past
            # the row width: the guard make_request applies
            ecfg = loop_.engine.ecfg
            if len(req.input_ids) + req.max_new_tokens > ecfg.max_seq_len:
                raise _error(400, f"expanded prompt ({len(req.input_ids)}) "
                                  f"+ max_new_tokens ({req.max_new_tokens}) "
                                  f"exceeds max_seq_len {ecfg.max_seq_len}")
            # decode-ahead: the extend's embed_fn then hits the cache
            mm.prewarm(req)
        return req

    async def h_generate(request):
        body = request.json()
        if loop_.mm is not None and ("video_path" in body
                                     or "frames_b64" in body):
            req = await asyncio.get_running_loop().run_in_executor(
                mm_pool, _multimodal_request, body)
        elif "input_ids" in body:
            req = await new_request(body["input_ids"], body,
                                    stream=bool(body.get("stream")))
        else:
            ids = loop_.tokenizer.encode(body["text"])
            req = await new_request(ids, body,
                                    stream=bool(body.get("stream")))
        if not req.stream:
            done = await run_request(req)
            meta = {"finish_reason": done.finished.value,
                    "prompt_tokens": len(done.input_ids),
                    "completion_tokens": len(done.output_ids)}
            if done.logprobs:
                meta["output_token_logprobs"] = done.output_logprobs
                meta["output_top_logprobs"] = done.output_top_logprobs
            return json_response({
                "text": loop_.detok(done.output_ids, done),
                "output_ids": done.output_ids,
                "meta_info": meta})
        return await _stream_response(request, req, openai=None)

    async def _stream_response(request, req, openai):
        q = await loop_.submit(req)
        kind, r = await q.get()
        if kind == "rejected":      # before any byte is sent: a status
            raise _refusal(r)
        resp = StreamResponse(request)
        # the request's stop strings: the engine sets stop_trim only when
        # it finishes the request
        detok = StreamDetok(loop_.tokenizer, req.stop_strs)
        try:
            await resp.prepare()
            while True:
                if kind == "error":
                    await resp.write(f"data: {json.dumps({'error': str(r)})}"
                                     "\n\n".encode())
                    break
                delta = detok.push(r.output_ids, final=(kind == "done"))
                if delta or kind == "done":
                    if openai == "chat":
                        payload = {"id": req.rid,
                                   "object": "chat.completion.chunk",
                                   "choices": [{"index": 0, "delta":
                                                {"content": delta}}]}
                    elif openai == "completions":
                        payload = {"id": req.rid,
                                   "object": "text_completion",
                                   "choices": [{"index": 0, "text": delta}]}
                    else:
                        payload = {"text": delta, "rid": req.rid}
                    await resp.write(f"data: {json.dumps(payload)}\n\n"
                                     .encode())
                if kind == "done":
                    break
                kind, r = await q.get()
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
        except ConnectionError:
            # the client left: stop generating for it
            loop_._ops.append((lambda: loop_.engine.abort(req.rid), None))
            loop_._wake.set()
        return resp

    async def h_completions(request):
        body = request.json()
        ids = loop_.tokenizer.encode(body.get("prompt", ""))
        req = await new_request(ids, body, stream=bool(body.get("stream")))
        if req.stream:
            return await _stream_response(request, req, "completions")
        done = await run_request(req)
        return json_response({
            "id": req.rid, "object": "text_completion",
            "created": int(time.time()), "model": model_name,
            "choices": [{"index": 0,
                         "text": loop_.detok(done.output_ids, done),
                         "logprobs": _logprobs_payload(loop_, done),
                         "finish_reason": done.finished.value}],
            "usage": {"prompt_tokens": len(done.input_ids),
                      "completion_tokens": len(done.output_ids),
                      "total_tokens": done.seq_len}})

    async def h_chat(request):
        body = request.json()
        tpl = getattr(PROMPT_TEMPLATE, body.get("chat_template", "vicuna"),
                      PROMPT_TEMPLATE.vicuna)
        prompt = render_conversation(tpl, body.get("messages", []))
        ids = loop_.tokenizer.encode(prompt)
        req = await new_request(ids, body, stream=bool(body.get("stream")))
        if req.stream:
            return await _stream_response(request, req, "chat")
        done = await run_request(req)
        return json_response({
            "id": req.rid, "object": "chat.completion",
            "created": int(time.time()), "model": model_name,
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content":
                                     loop_.detok(done.output_ids, done)},
                         "logprobs": _logprobs_payload(loop_, done,
                                                       chat=True),
                         "finish_reason": done.finished.value}],
            "usage": {"prompt_tokens": len(done.input_ids),
                      "completion_tokens": len(done.output_ids),
                      "total_tokens": done.seq_len}})

    # -- OpenAI files + batches (openai_api/adapter.py parity) -------------
    files_dir = os.environ.get("AURORA_FILES_DIR")
    if not files_dir:
        files_dir = tempfile.mkdtemp(prefix="aurora_files_")
        app.on_close.append(lambda: shutil.rmtree(files_dir,
                                                  ignore_errors=True))
    batches: Dict[str, Dict[str, Any]] = {}

    def _file_path(fid):
        if not re.fullmatch(r"file-[0-9a-f]+", fid):
            raise _error(404, "file not found")
        return os.path.join(files_dir, fid)

    async def h_file_upload(request):
        """POST /v1/files — multipart (`file` field) or raw body with
        ?filename=. Returns an OpenAI file object."""
        fid = "file-" + uuid.uuid4().hex[:24]
        name = request.query.get("filename", "upload.jsonl")
        if request.content_type.startswith("multipart/"):
            fname, data = _multipart_file(request.headers["content-type"],
                                          request.body)
            name = fname or name
        else:
            data = request.body
        with open(_file_path(fid), "wb") as f:
            f.write(data)
        return json_response({
            "id": fid, "object": "file", "bytes": len(data),
            "created_at": int(time.time()), "filename": name,
            "purpose": request.query.get("purpose", "batch")})

    async def h_file_content(request):
        path = _file_path(request.match_info["fid"])
        if not os.path.exists(path):
            return json_response({"error": "file not found"}, 404)
        with open(path, "rb") as f:
            return Response(f.read(), content_type="application/octet-stream")

    async def _run_batch_job(bid: str):
        """Process a batch file of /v1/chat/completions-style requests
        CONCURRENTLY through the engine's continuous batching."""
        job = batches[bid]
        try:
            with open(_file_path(job["input_file_id"])) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]

            async def one(rec):
                body = rec.get("body", {})
                msgs = body.get("messages")
                if msgs:
                    prompt = render_conversation(PROMPT_TEMPLATE.vicuna,
                                                 msgs)
                else:
                    prompt = body.get("prompt", "")
                ids = loop_.tokenizer.encode(prompt)
                req = await new_request(ids, body)
                done = await run_request(req)
                return {"id": "batch_req_" + uuid.uuid4().hex[:16],
                        "custom_id": rec.get("custom_id"),
                        "response": {"status_code": 200, "body": {
                            "choices": [{"index": 0, "message": {
                                "role": "assistant",
                                "content": loop_.detok(done.output_ids,
                                                       done)}}]}},
                        "error": None}

            results = await asyncio.gather(
                *[one(rec) for rec in lines], return_exceptions=True)
            out_id = "file-" + uuid.uuid4().hex[:24]
            ok = fail = 0
            with open(_file_path(out_id), "w") as f:
                for rec, res in zip(lines, results):
                    if isinstance(res, BaseException):
                        fail += 1
                        msg = (res.payload.get("error", str(res))
                               if isinstance(res, HTTPError) else str(res))
                        res = {"custom_id": rec.get("custom_id"),
                               "response": None,
                               "error": {"message": msg}}
                    else:
                        ok += 1
                    f.write(json.dumps(res) + "\n")
            job.update(status="completed", output_file_id=out_id,
                       request_counts={"total": len(lines),
                                       "completed": ok, "failed": fail},
                       completed_at=int(time.time()))
        except Exception as e:  # noqa: BLE001 - reported on the job
            job.update(status="failed", errors={"message": str(e)})

    async def h_batch_create(request):
        body = request.json()
        bid = "batch_" + uuid.uuid4().hex[:24]
        batches[bid] = {
            "id": bid, "object": "batch", "status": "in_progress",
            "input_file_id": body["input_file_id"],
            "endpoint": body.get("endpoint", "/v1/chat/completions"),
            "created_at": int(time.time()), "output_file_id": None}
        task = asyncio.get_running_loop().create_task(_run_batch_job(bid))
        tasks.add(task)
        task.add_done_callback(tasks.discard)
        return json_response(batches[bid])

    async def h_batch_get(request):
        bid = request.match_info["bid"]
        if bid not in batches:
            return json_response({"error": "batch not found"}, 404)
        return json_response(batches[bid])

    def cancel_tasks():
        for task in list(tasks):
            task.cancel()

    app.on_close.append(cancel_tasks)

    async def h_gui(request):
        """Minimal built-in web UI (gradio_gui.py:98-129 parity)."""
        return Response(_GUI_HTML.encode(), content_type="text/html")

    async def h_health(request):
        return json_response({"status": "ok"})

    async def h_model_info(request):
        return json_response({"model": model_name,
                              "memory": loop_.engine.check_memory()})

    async def h_models(request):
        # OpenAI SDK compatibility: clients list models before first use
        return json_response({
            "object": "list",
            "data": [{"id": model_name, "object": "model",
                      "created": 0, "owned_by": "aurora_tpu_torch"}]})

    async def h_decode_stats(request):
        # print_decode_stats parity (tp_worker.py:285-300) as an ops
        # endpoint: running/queued, slot usage, decode tokens/s
        return json_response(loop_.engine.decode_stats())

    async def h_abort(request):
        body = request.json()
        # staged: abort mutates scheduler lists the step thread may hold
        ok = await loop_.call(
            lambda: loop_.engine.abort(body.get("rid", "")))
        return json_response({"aborted": ok})

    def _offline(what, need_score=False):
        """The engine's model if the offline forward can run on it."""
        if loop_.engine.ecfg.tp > 1:
            raise _error(501, f"{what} are unavailable on tensor-parallel "
                              "deployments (the offline forward runs one "
                              "whole model)")
        model = loop_.engine.runner.model
        if need_score and not hasattr(model, "score"):
            raise _error(400, "this checkpoint has no classification head "
                              "(expected LlamaForSequenceClassification "
                              "score.weight)")
        err = _offline_fwd_unavailable(model)
        if err:
            raise _error(400, what + " " + err)
        return model

    def _inputs(body):
        inputs = body.get("input", [])
        return [inputs] if isinstance(inputs, str) else list(inputs)

    def _forward(fn):
        """Run fn in a worker thread, without autograd, on the device."""
        def run():
            with torch.inference_mode(), device_scope(loop_.device):
                return fn()
        return asyncio.to_thread(run)

    async def h_embeddings(request):
        """OpenAI /v1/embeddings (srt embedding-request parity): last
        hidden state of the final prompt token, length-bucketed."""
        body = request.json()
        inputs = _inputs(body)
        model = _offline("embeddings")
        data, n_tokens = [], 0
        for i, text in enumerate(inputs):
            ids = loop_.tokenizer.encode(text)
            n_tokens += len(ids)
            emb = await _forward(lambda: _last_hidden(
                model, loop_.engine.cfg, ids).cpu())
            data.append({"object": "embedding", "index": i,
                         "embedding": [float(x) for x in emb]})
        return json_response({"object": "list", "data": data,
                              "model": model_name,
                              "usage": {"prompt_tokens": n_tokens}})

    async def h_classify(request):
        """Sequence classification / reward scoring over the engine's
        weights (sglang srt/models/llama_classification.py parity): class
        logits = the score head over the LAST prompt token's hidden state.
        Body: {"input": str | [str, ...]}."""
        body = request.json()
        inputs = _inputs(body)
        model = _offline("classification logits", need_score=True)
        data = []
        for i, text in enumerate(inputs):
            ids = loop_.tokenizer.encode(text)
            logits = await _forward(lambda: F.linear(
                _last_hidden(model, loop_.engine.cfg, ids),
                model.score.weight.float()).cpu())
            data.append({"object": "classification", "index": i,
                         "logits": [float(x) for x in logits]})
        return json_response({"object": "list", "data": data,
                              "model": model_name})

    async def h_flush_cache(request):
        # staged: eviction mutates the radix tree the step thread reads
        remaining = await loop_.call(loop_.engine.flush_cache)
        return json_response({"flushed": True, "cached_tokens": remaining})

    async def h_update_weights(request):
        """Live weight reload with rollback (sglang /update_weights,
        model_runner.py:230-316). Body: {"model_dir": "<HF llama dir>",
        "drain_timeout": seconds (10)}. Waits for the running batch to
        drain, then swaps in place."""
        body = request.json()
        eng = loop_.engine

        def load():
            with torch.no_grad(), device_scope(loop_.device):
                sd = load_torch_state_dict(body["model_dir"])
                return llama_params_from_hf(
                    sd, eng.cfg, dtype=eng.runner.model.embed_tokens.dtype,
                    device=loop_.device)

        try:
            new = await asyncio.to_thread(load)
        except Exception as e:  # noqa: BLE001 - any load failure is a 400
            return json_response(
                {"success": False, "message": f"load failed: {e}"}, 400)

        def update():
            with torch.no_grad(), device_scope(loop_.device):
                return eng.update_weights(new)

        deadline = time.monotonic() + float(body.get("drain_timeout", 10))
        while True:
            ok, msg = await loop_.call(update)
            if ok or msg != BUSY or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.05)
        return json_response({"success": ok, "message": msg},
                             200 if ok else 409)

    app.add("POST", "/generate", h_generate)
    app.add("POST", "/v1/completions", h_completions)
    app.add("POST", "/v1/chat/completions", h_chat)
    app.add("GET", "/health", h_health)
    app.add("GET", "/get_model_info", h_model_info)
    app.add("GET", "/v1/models", h_models)
    app.add("GET", "/decode_stats", h_decode_stats)
    app.add("POST", "/abort_request", h_abort)
    app.add("POST", "/flush_cache", h_flush_cache)
    app.add("POST", "/update_weights", h_update_weights)
    app.add("POST", "/v1/embeddings", h_embeddings)
    app.add("POST", "/v1/classify", h_classify)
    app.add("POST", "/v1/files", h_file_upload)
    app.add("GET", "/v1/files/{fid}/content", h_file_content)
    app.add("POST", "/v1/batches", h_batch_create)
    app.add("GET", "/v1/batches/{bid}", h_batch_get)
    app.add("GET", "/", h_gui)
    return app


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

async def serve(app: App, host: str, port: int, *,
                started: Optional[Callable[[int], None]] = None,
                stop: Optional[asyncio.Event] = None) -> None:
    """Start the serving loop and listen on (host, port); `started` gets
    the bound port; serve until `stop` is set (forever without one), then
    close the connections and what the app started."""
    await app.loop_.start()
    server = await asyncio.start_server(app.handle, host, port)
    try:
        if started is not None:
            started(server.sockets[0].getsockname()[1])
        if stop is None:
            await server.serve_forever()
        else:
            await stop.wait()
    finally:
        server.close()
        app.loop_._task.cancel()
        await app.close()


class ServerThread:
    """build_app's server on an event loop of its own in a daemon thread:
    start() returns once it listens (port 0 takes a free one), `url` is
    its address, stop() ends it and joins the thread."""

    def __init__(self, loop_: ServingLoop, model_name: str = "auroracap",
                 host: str = "127.0.0.1", port: int = 0):
        self.loop_, self.model_name = loop_, model_name
        self.host, self.port = host, port
        self._ready = threading.Event()
        self._aloop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name="aurora-http")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _main(self) -> None:
        async def run():
            self._aloop = asyncio.get_running_loop()
            self._stop = asyncio.Event()

            def started(port):
                self.port = port
                self._ready.set()

            await serve(build_app(self.loop_, self.model_name), self.host,
                        self.port, started=started, stop=self._stop)

        try:
            asyncio.run(run())
        except BaseException as e:  # noqa: BLE001 - re-raised in start()
            self._error = e
        finally:
            self._ready.set()

    def start(self, timeout: float = 60.0) -> "ServerThread":
        self._thread.start()
        if not self._ready.wait(timeout) or self._error is not None:
            raise RuntimeError(f"the server did not start: {self._error}")
        return self

    def stop(self, timeout: float = 60.0) -> None:
        if self._aloop is not None and self._thread.is_alive():
            self._aloop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the server thread did not stop")

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def build_engine(model, cfg, ecfg: EngineConfig, *, devices=None, dp=1,
                 dispatch="shortest_queue", embed_fn=None, tokenizer=None):
    """launch_server's engine: one ServeEngine on `model`'s device, its
    shards on `devices` with ecfg.tp > 1; with dp > 1 a
    MultiReplicaController (serve/controller.py) of replicas over
    `devices`, requests dispatched by `dispatch` (round_robin or
    shortest_queue). devices default to the first dp × tp cards for a
    model on the card, the CPU dp × tp times for one there (serve/tp.py
    `visible_devices`). At tp > 1 each engine holds only the shards it
    cut, so `model` (which may live on the host) is not referenced once
    this returns."""
    from aurora_tpu_torch.serve.tp import visible_devices
    if devices is None and (dp > 1 or ecfg.tp > 1):
        devices = visible_devices(model.embed_tokens.device, dp * ecfg.tp)
    if dp > 1:
        from aurora_tpu_torch.serve.controller import MultiReplicaController
        engine = MultiReplicaController(
            model, cfg, ecfg, devices=devices, dispatch=dispatch,
            embed_fn=embed_fn, tokenizer=tokenizer)
        print(f"[serve] {len(engine.engines)} replicas ({dispatch})",
              flush=True)
        return engine
    return ServeEngine(model, cfg, ecfg, embed_fn=embed_fn,
                       tokenizer=tokenizer, devices=devices)


def serve_engine(engine, tokenizer, *, host="0.0.0.0", port=30000,
                 model_name="auroracap", mm=None):
    """Blocking HTTP server over a built engine or controller."""
    loop_ = ServingLoop(engine, tokenizer, mm=mm)

    def started(bound):
        print(f"[serve] listening on http://{host}:{bound}", flush=True)

    asyncio.run(serve(build_app(loop_, model_name), host, port,
                      started=started))


def launch_server(model, cfg, tokenizer, *, host="0.0.0.0", port=30000,
                  engine_cfg: Optional[EngineConfig] = None,
                  model_name="auroracap", mm=None, dp=1,
                  dispatch="shortest_queue"):
    """Blocking server entry (launch_server parity, srt/server.py:282):
    `build_engine` (one ServeEngine, tp shards with engine_cfg.tp > 1,
    dp replicas with dp > 1), then `serve_engine`; this frame drops
    `model` in between, so that at tp > 1 only the caller's reference
    keeps it. Pass mm=AuroraCapServing(...) for multimodal deployments.
    tokenizer: any object with encode, decode and eos_token_id (a
    checkpoint's through transformers in cli/serve.py)."""
    engine = build_engine(model, cfg, engine_cfg or EngineConfig(), dp=dp,
                          dispatch=dispatch,
                          embed_fn=mm.embed_fn if mm else None,
                          tokenizer=tokenizer)
    del model
    serve_engine(engine, tokenizer, host=host, port=port,
                 model_name=model_name, mm=mm)
