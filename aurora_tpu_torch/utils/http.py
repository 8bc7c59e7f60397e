"""The stdlib OpenAI-chat and JSON POST client (a copy of
aurora_tpu/utils/http.py, which the port may not import): one urllib
request/parse sequence for every client of an HTTP server, ours
(serve/api.py) or another OpenAI-compatible one.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, List, Optional, Sequence


def chat_completion(base_url: str, messages: List[Dict[str, str]], *,
                    model: str = "default", max_tokens: int = 128,
                    temperature: float = 0.0,
                    stop: Sequence[str] = (),
                    extra: Optional[Dict[str, Any]] = None,
                    api_key: Optional[str] = None,
                    timeout: float = 600.0) -> str:
    """POST /v1/chat/completions → assistant message content.

    `model` is always sent: our own server ignores it, but real OpenAI /
    vLLM / sglang endpoints reject payloads without it.
    """
    payload: Dict[str, Any] = {"model": model, "messages": messages,
                               "max_tokens": max_tokens,
                               "temperature": temperature}
    if stop:
        payload["stop"] = list(stop)
    if extra:
        payload.update(extra)
    headers = {"Content-Type": "application/json"}
    if api_key:
        headers["Authorization"] = f"Bearer {api_key}"
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/chat/completions",
        data=json.dumps(payload).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
    return body["choices"][0]["message"]["content"]


def post_json(url: str, body: Dict[str, Any], *,
              timeout: float = 600.0) -> Dict[str, Any]:
    """POST arbitrary JSON → parsed JSON response (single urllib POST
    implementation for non-chat endpoints like /generate)."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())
