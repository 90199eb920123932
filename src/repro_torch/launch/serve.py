"""Batched serving: the continuous-batching decode loop (PyTorch port of
``repro/launch/serve.py``).

Requests arrive with a prompt and take a free slot of the running batch;
all slots decode in lock-step against one KV cache.  Prompts are fed one
token per round (chunked prefill inside the lock-step loop), so every
prompt token passes through the model.  As in the reference, one global
``pos`` is shared by all slots: a request that takes over a slot attends
to the previous occupant's cache entries at earlier positions, and its
RoPE positions are global (ROADMAP C notes this quirk of the reference).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import configs
from ..core.oracles.chain import resolve_device
from ..models import common, registry


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    # prompt tokens scheduled into the slot so far (chunked prefill
    # cursor); generation starts once the whole prompt is consumed.
    fed: int = 0


class Server:
    """Fixed-slot lock-step decoding on ``device`` (CUDA by default);
    ``params`` must live there."""

    def __init__(self, cfg, params: dict, slots: int = 4, max_seq: int = 256,
                 device=None):
        self.device = resolve_device(device)
        where = params["embedding"].device
        if where.type != self.device.type:
            raise ValueError(f"Server: parameters on {where}, device "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.max_seq = max_seq
        self.cache = registry.init_cache(cfg, slots, max_seq, where)
        self.pos = 0
        self.active: List[Optional[Request]] = [None] * slots
        self.tokens = np.zeros((slots, 1), np.int64)
        self.rounds = 0

    def _step(self) -> np.ndarray:
        tokens = torch.from_numpy(self.tokens).to(
            self.params["embedding"].device)
        logits, self.cache = registry.decode_step(
            self.params, self.cfg, self.cache, tokens, self.pos)
        return torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()

    def add(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.active[s] is None:
                self.active[s] = req
                # Schedule the first prompt token now; decode_round feeds
                # the rest one per round.
                self.tokens[s, 0] = int(req.prompt[0])
                req.fed = 1
                return True
        return False

    def decode_round(self) -> List[Request]:
        """One lock-step decode over all slots; returns the requests
        that finished this round (their slots free immediately)."""
        if self.pos >= self.max_seq:
            raise RuntimeError(f"Server: the cache holds {self.max_seq} "
                               "positions, all used")
        nxt = self._step()
        self.pos += 1
        self.rounds += 1
        finished: List[Request] = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if req.fed < len(req.prompt):
                # Still prefilling: schedule the next prompt token and
                # discard the logits.
                self.tokens[s, 0] = int(req.prompt[req.fed])
                req.fed += 1
                continue
            req.out.append(int(nxt[s]))
            self.tokens[s, 0] = int(nxt[s])
            if len(req.out) >= req.max_new:
                req.done = True
                finished.append(req)
                self.active[s] = None
        return finished

    def serve(self, pending: List[Request]) -> List[Request]:
        """Admit and decode until every request is answered; returns them
        in completion order."""
        pending = list(pending)
        completed: List[Request] = []
        while pending or any(self.active):
            while pending and self.add(pending[0]):
                pending.pop(0)
            completed += self.decode_round()
        return completed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.reduced_config(args.arch)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, dev)
    server = Server(cfg, params, slots=args.slots, device=dev)
    rng = np.random.RandomState(0)
    pending = [Request(i, rng.randint(0, cfg.vocab_size, size=4),
                       args.max_new) for i in range(args.requests)]
    t0 = time.time()
    completed = server.serve(pending)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in completed)
    assert len(completed) == args.requests, \
        f"served {len(completed)} of {args.requests} requests"
    print(f"served {len(completed)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {dev}")


if __name__ == "__main__":
    main()
