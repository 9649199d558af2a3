"""Request batcher with mux slots (counterpart of
``repro.serve.batcher``).

Fill-drain serving packs requests into the N_mux x B instance grid of
``MuxBatcher``: under light load the spare slots hold duplicates of live
requests, and their logit streams are averaged — the paper's ensembling
mode (§5.4) as a load-adaptive serving policy.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field

import torch


@dataclass
class Request:
    """One generation request plus its wall-clock lifecycle stamps
    (``time.time()``): ``t_submit`` entered the queue (kept across
    preemption), ``t_admit`` placed into the grid, ``t_first`` first
    generated token on the host (TTFT = t_first - t_submit), ``t_done``
    retired (TPOT = (t_done - t_first) / (len(output) - 1)).

    Width-lane serving (``serve.router``): ``slo`` is the declared SLO
    class (latency | balanced | throughput | None, balanced), ``lane`` the
    lane the router chose, ``routed_step`` the engine step at which the
    request entered that lane's queue (a lane's replay point)."""
    uid: int
    prompt: object                  # token list / array
    max_new: int = 16
    done: bool = False
    output: list = field(default_factory=list)
    sampling: object = None         # serve.sampling.SamplingParams | None
    t_submit: float = None
    t_admit: float = None
    t_first: float = None
    t_done: float = None
    slo: str = None
    lane: int = None
    routed_step: int = None


@dataclass
class MuxBatcher:
    n_mux: int
    backbone_batch: int
    queue: collections.deque = field(default_factory=collections.deque)
    _uid: itertools.count = field(default_factory=itertools.count)

    @property
    def capacity(self) -> int:
        return self.n_mux * self.backbone_batch

    def submit(self, prompt, max_new: int = 16) -> Request:
        r = Request(uid=next(self._uid), prompt=prompt, max_new=max_new)
        self.queue.append(r)
        return r

    def next_batch(self):
        """Up to ``capacity`` queued requests, spare slots filled round-robin
        with duplicates.  Returns (requests_in_slot, slot_owner), lists of
        length capacity: slot_owner[i] indexes the batch's unique requests,
        and a request owning k slots gets its k logit streams averaged.
        An empty queue gives (None, None)."""
        if not self.queue:
            return None, None
        live = []
        while self.queue and len(live) < self.capacity:
            live.append(self.queue.popleft())
        owners = list(range(len(live)))
        for i in range(self.capacity - len(live)):
            owners.append(i % len(live))
        return [live[o] for o in owners], owners

    @staticmethod
    def combine_logits(logits, owners, n_unique):
        """Average the logit streams of duplicated requests: logits
        (capacity, ...) -> (n_unique, ...)."""
        dev = logits.device
        idx = torch.as_tensor(owners, device=dev)
        acc = torch.zeros((n_unique,) + logits.shape[1:], dtype=logits.dtype,
                          device=dev).index_add_(0, idx, logits)
        cnt = torch.zeros(n_unique, dtype=logits.dtype, device=dev)
        cnt.index_add_(0, idx, torch.ones(len(owners), dtype=logits.dtype,
                                          device=dev))
        return acc / cnt.reshape((n_unique,) + (1,) * (logits.ndim - 1))
