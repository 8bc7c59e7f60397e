"""Multi-replica serving: data-parallel engines over several devices
(aurora_tpu/serve/controller.py).

Each replica is a ServeEngine whose weights and KV rows live on its own
device (or, with `ecfg.tp > 1`, on its own group of tp devices). One host
thread steps the replicas in turn; CUDA launches are asynchronous, so
replica i's step is issued while replica j's runs on its card. Dispatch
policies are the reference's: round_robin and shortest_queue.

A replica on the device that already holds the weights shares them (the
reference's `jax.device_put` is a no-op there, as `Module.to` is here),
so two replicas on one card cost one set of weights and two sets of KV
rows; a replica on another device gets its own copy, made tensor by
tensor on that device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aurora_tpu_torch.serve.engine import (EngineConfig, ServeEngine,
                                           device_scope)
from aurora_tpu_torch.serve.scheduler import Request


def model_on(model: nn.Module, device) -> nn.Module:
    """`model` itself where every tensor already lives on `device`, else a
    copy of it there (each parameter and buffer copied once, straight to
    `device`; the source is left as it is)."""
    device = torch.device(device)
    tensors = list(model.parameters()) + list(model.buffers())
    if all(t.device == device for t in tensors):
        return model
    memo: Dict[int, Any] = {}
    for p in model.parameters():
        memo[id(p)] = nn.Parameter(p.detach().to(device),
                                   requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = b.to(device)
    return copy.deepcopy(model, memo)


class MultiReplicaController:
    """N data-parallel ServeEngine replicas; each replica spans
    `ecfg.tp` devices (tp=1: one engine a device). devices: the devices
    in order, which may repeat (default: every visible card, or the
    model's device once); len(devices) // tp replicas are built."""

    def __init__(self, model: LlamaModel, cfg: LlamaConfig,
                 ecfg: EngineConfig = EngineConfig(), *,
                 devices: Optional[List[Any]] = None,
                 dispatch: str = "shortest_queue",
                 embed_fn=None, tokenizer=None, seed: int = 0):
        if dispatch not in ("round_robin", "shortest_queue"):
            raise ValueError(f"dispatch={dispatch!r}: round_robin or "
                             "shortest_queue")
        src = model.embed_tokens.device
        if not devices:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if src.type == "cuda" else [src])
        devices = [torch.device(d) for d in devices]
        tp = ecfg.tp
        if len(devices) < tp:
            raise ValueError(f"tp={tp} needs {tp} devices per replica, "
                             f"have {len(devices)}")
        self.dispatch = dispatch
        self.engines: List[ServeEngine] = []
        for at in range(0, len(devices) - tp + 1, tp):
            grp = devices[at:at + tp]
            if tp == 1:
                self.engines.append(ServeEngine(
                    model_on(model, grp[0]), cfg, ecfg, embed_fn=embed_fn,
                    device=grp[0], seed=seed, tokenizer=tokenizer))
            else:   # the engine cuts the model onto its own group
                self.engines.append(ServeEngine(
                    model, cfg, ecfg, embed_fn=embed_fn, seed=seed,
                    tokenizer=tokenizer, devices=grp))
        self._rr = 0
        self._where: Dict[str, int] = {}

    # -- dispatch (the reference's round_robin / shortest_queue) ----------

    def _pick(self) -> int:
        if self.dispatch == "round_robin":
            i = self._rr
            self._rr = (self._rr + 1) % len(self.engines)
            return i
        loads = [len(e.sched.waiting) + len(e.sched.running)
                 for e in self.engines]
        return min(range(len(loads)), key=loads.__getitem__)

    def add_request(self, req: Request) -> None:
        i = self._pick()
        self._where[req.rid] = i
        self.engines[i].add_request(req)

    def abort(self, rid: str) -> bool:
        i = self._where.pop(rid, None)
        if i is not None:
            return self.engines[i].abort(rid)
        return any(e.abort(rid) for e in self.engines)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def step(self) -> List[Request]:
        """One controller iteration: one step of every busy replica."""
        done: List[Request] = []
        for e in self.engines:
            if e.has_work():
                with device_scope(e.runner.device):
                    done.extend(e.step())
        for req in done:
            self._where.pop(req.rid, None)
        return done

    def fail_running(self) -> List[Request]:
        out: List[Request] = []
        for e in self.engines:
            out.extend(e.fail_running())
        for req in out:
            self._where.pop(req.rid, None)
        return out

    def flush_cache(self) -> int:
        return sum(e.flush_cache() for e in self.engines)

    def update_weights(self, model: LlamaModel):
        """Swap the weights of every replica, atomically across the fleet:
        refused while any replica has requests in flight; every replica
        stages and checks the new weights first, and only when all accept
        are they copied in, so a refusal by any replica leaves every
        replica as it was (the reference rolls back the replicas it has
        already changed; here none has been). A deployment never serves
        two models behind one dispatcher."""
        busy = [i for i, e in enumerate(self.engines) if e.sched.running]
        if busy:
            return False, f"replicas {busy} have requests in flight"
        staged = []
        for i, e in enumerate(self.engines):
            ok, msg, pairs = e.stage_weights(model)
            if not ok:
                return False, f"replica {i}: {msg} (rolled back)"
            staged.append(pairs)
        for e, pairs in zip(self.engines, staged):
            e.commit_weights(pairs)
        return True, "weights updated on all replicas"

    def decode_stats(self) -> Dict[str, float]:
        stats = [e.decode_stats() for e in self.engines]
        return {"running": sum(s["running"] for s in stats),
                "queued": sum(s["queued"] for s in stats),
                "slot_usage": round(sum(s["slot_usage"]
                                        for s in stats) / len(stats), 4),
                "gen_tokens_per_s": round(sum(s["gen_tokens_per_s"]
                                              for s in stats), 1)}

    def check_memory(self) -> Dict[str, int]:
        mems = [e.check_memory() for e in self.engines]
        return {k: sum(m[k] for m in mems) for k in mems[0]}

    @property
    def sched(self):
        """The API layer's view: every replica's running requests."""
        class _Agg:
            def __init__(self, engines):
                self.engines = engines

            @property
            def running(self):
                out = []
                for e in self.engines:
                    out.extend(e.sched.running)
                return out
        return _Agg(self.engines)

    @property
    def runner(self):
        """The first replica's device runner (the API's device and offline
        model)."""
        return self.engines[0].runner

    @property
    def ecfg(self) -> EngineConfig:
        return self.engines[0].ecfg

    @property
    def cfg(self) -> LlamaConfig:
        return self.engines[0].cfg
