"""HTTP serving load generator (aurora_tpu/cli/bench_serving.py, sglang's
bench_serving.py): fire concurrent /generate requests at a running server
and report request and token throughput and latency percentiles, as one
JSON line.

    python -m aurora_tpu_torch bench-serving --url http://localhost:30000 \
        --num-requests 64 --concurrency 8 --prompt-len 128 --max-tokens 64

The reference's client is aiohttp's; this one is the standard library's:
`concurrency` threads, each sending its requests in turn over
http.client. A request that fails to connect, or answers other than 200,
counts against `ok` and adds no tokens.
"""

from __future__ import annotations

import argparse
import http.client
import json
import random
import string
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Tuple


def _one(url: str, prompt: str, max_tokens: int,
         timeout: float) -> Tuple[float, int, int]:
    """One greedy /generate → (seconds, completion tokens, HTTP status or 0
    when the connection failed)."""
    u = urllib.parse.urlsplit(url)
    body = json.dumps({"text": prompt, "max_new_tokens": max_tokens,
                       "temperature": 0.0})
    conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                      timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", u.path.rstrip("/") + "/generate", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        status = r.status
    except OSError:
        return time.perf_counter() - t0, 0, 0
    finally:
        conn.close()
    dt = time.perf_counter() - t0
    n = json.loads(data)["meta_info"]["completion_tokens"] \
        if status == 200 else 0
    return dt, n, status


def run(url: str, num_requests: int = 64, concurrency: int = 8,
        prompt_len: int = 128, max_tokens: int = 64,
        timeout: float = 600.0) -> Dict[str, Any]:
    """The load: num_requests random lowercase prompts of prompt_len
    characters (seeded), at most `concurrency` in flight → the report."""
    rng = random.Random(0)
    prompts = ["".join(rng.choices(string.ascii_lowercase + " ",
                                   k=prompt_len))
               for _ in range(num_requests)]
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        t0 = time.perf_counter()
        results = list(pool.map(
            lambda p: _one(url, p, max_tokens, timeout), prompts))
        wall = time.perf_counter() - t0
    lat = sorted(dt for dt, _, _ in results)
    toks = sum(n for _, n, _ in results)

    def pct(p):
        return lat[min(int(len(lat) * p), len(lat) - 1)]

    return {"num_requests": num_requests,
            "ok": sum(1 for _, _, s in results if s == 200),
            "concurrency": concurrency,
            "wall_s": round(wall, 2),
            "requests_per_s": round(num_requests / wall, 2),
            "output_tokens_per_s": round(toks / wall, 1),
            "latency_s": {"p50": round(pct(0.5), 3),
                          "p90": round(pct(0.9), 3),
                          "p99": round(pct(0.99), 3)}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--url", default="http://localhost:30000")
    p.add_argument("--num-requests", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128,
                   help="characters of random prompt text")
    p.add_argument("--max-tokens", type=int, default=64)
    args = p.parse_args(argv)
    print(json.dumps(run(args.url, args.num_requests, args.concurrency,
                         args.prompt_len, args.max_tokens)))


if __name__ == "__main__":
    main()
