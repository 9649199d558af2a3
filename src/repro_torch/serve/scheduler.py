"""Continuous batching policy (host-side copy of ``repro.serve.scheduler``).

``ContinuousScheduler`` keeps an N_mux × B grid of stream slots: slot
(i, j) is mux stream i of backbone row j.  Paged admission is row-level:
queued requests are grouped into entirely empty rows only, so a joining
group is prefilled once into freshly allocated blocks and occupied rows
are never re-prefilled.  Ring admission (``admit``) fills any free slot
and reports the rows that changed: the ring arm then re-prefills the
whole grid.  The scheduler emits typed plans — ``AdmitPlan``,
``PrefillChunkPlan``, ``DecodePlan``, ``FreePlan`` — that
``serve.runtime.ServeRuntime`` executes; allocation failures come back
through ``cancel_admit`` and ``preempt_row``.  Every plan carries the
scheduler's ``lane`` (width-lane serving: one scheduler, runtime and pool
per lane, so no plan crosses lanes).  Disaggregated serving moves a
finished-prefill row whole into a decode lane: ``plan_handoff`` emits a
``HandoffPlan``, ``retire_handoff`` detaches the row's slots on the
source and ``admit_handoff`` installs them on the destination, which
never prefills the row again.

Logical data shards (``n_shards``): row j belongs to shard ``j //
(B // n_shards)``, as the pool's segments; paged admission visits rows
round-robin across shards, can pass over shards whose pool is full
(``skip_shards``) and never places a group on a shard in
``dead_shards`` (fenced by ``ServeRuntime.kill_shard``).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.telemetry import NULL_TELEMETRY


@dataclass
class StreamSlot:
    request: object = None        # serve.batcher.Request | None
    pos: int = 0                  # next decode position
    prompt_len: int = 0


@dataclass(frozen=True)
class AdmitPlan:
    """A newly formed mux group, already placed in row ``row``'s slots.
    The runtime either allocates blocks for ``total`` tokens and starts
    chunked prefill of ``tokens`` (N_mux, total), or rolls the plan back
    with ``cancel_admit``."""
    row: int
    placed: tuple                 # ((slot, request), ...)
    tokens: np.ndarray            # (N_mux, total) padded current sequences
    total: int
    shard: int = 0                # owning data shard (row -> shard map)
    lane: int = 0                 # owning serving lane


@dataclass(frozen=True)
class PrefillChunkPlan:
    """Advance row ``row``'s prefill by ``length`` tokens from ``start``;
    ``last`` marks the chunk that completes the prompt (its logits give
    the row's first generated tokens)."""
    row: int
    start: int
    length: int
    last: bool
    lane: int = 0


@dataclass(frozen=True)
class DecodePlan:
    """Rows that decode one token this step: active, not mid-prefill."""
    rows: tuple
    lane: int = 0


@dataclass(frozen=True)
class HandoffPlan:
    """Move a finished-prefill mux group, whole, from its prefill lane
    (``lane``, row ``row``) into a decode lane (``dst_lane``, row
    ``dst_row``).  Mux combine is nonlinear through the backbone, so a
    row's muxed KV belongs to the exact streams that prefilled it: a
    handoff relocates the row (same width) and never splits or re-mixes
    it.  ``tokens`` KV tokens migrate with the row; ``uids`` are the
    streams riding it."""
    row: int
    dst_row: int
    lane: int = 0
    dst_lane: int = 0
    tokens: int = 0
    uids: tuple = ()


@dataclass(frozen=True)
class FreePlan:
    """A drained row whose blocks the runtime returns to the pool."""
    row: int
    lane: int = 0


@dataclass
class ContinuousScheduler:
    n_mux: int
    backbone_batch: int
    max_len: int
    n_shards: int = 1             # logical data shards (contiguous rows)
    lane: int = 0                 # serving lane: tags plans and telemetry
    telemetry: object = None
    queue: collections.deque = field(default_factory=collections.deque)
    slots: list = field(init=False)
    steps: int = field(default=0, init=False)    # ring grid decode steps
    completed: list = field(default_factory=list, init=False)
    # row -> [filled, total] for rows mid-way through chunked prefill
    prefill_progress: dict = field(default_factory=dict, init=False)
    # shards fenced by ServeRuntime.kill_shard: admission never places a
    # group on their rows (unlike a step's transient ``skip_shards``)
    dead_shards: set = field(default_factory=set, init=False)

    def __post_init__(self):
        if self.n_shards < 1 or self.backbone_batch % self.n_shards:
            raise ValueError(
                f"backbone_batch {self.backbone_batch} not divisible by "
                f"n_shards {self.n_shards}")
        if self.telemetry is None:
            self.telemetry = NULL_TELEMETRY
        self.slots = [[StreamSlot() for _ in range(self.n_mux)]
                      for _ in range(self.backbone_batch)]

    def shard_of(self, j: int) -> int:
        return j // (self.backbone_batch // self.n_shards)

    def _admission_order(self):
        """Paged admission's row visit order: plain on one shard, else
        round-robin over the shards (row r of shard 0, of shard 1, ...),
        spreading load over every shard's pool."""
        if self.n_shards == 1:
            return range(self.backbone_batch)
        rps = self.backbone_batch // self.n_shards
        return [s * rps + r for r in range(rps)
                for s in range(self.n_shards)]

    def submit(self, request):
        if getattr(request, "t_submit", None) is None:
            request.t_submit = time.time()
        self.queue.append(request)

    @property
    def n_active(self):
        return sum(1 for row in self.slots for s in row
                   if s.request is not None)

    def _stamp_admit(self, r):
        r.t_admit = now = time.time()
        if self.telemetry.enabled and r.t_submit is not None:
            self.telemetry.observe("queue_wait_s", now - r.t_submit,
                                   lane=self.lane)

    def admit(self):
        """Place queued requests into free slots, row by row.  Returns the
        rows whose composition changed (they need a re-prefill)."""
        dirty = set()
        for j in range(self.backbone_batch):
            for i in range(self.n_mux):
                if not self.queue:
                    return sorted(dirty)
                if self.slots[j][i].request is None:
                    r = self.queue.popleft()
                    self.slots[j][i] = StreamSlot(
                        request=r, pos=len(r.prompt),
                        prompt_len=len(r.prompt))
                    self._stamp_admit(r)
                    dirty.add(j)
        return sorted(dirty)

    def admit_paged(self, skip_shards=()):
        """Group queued requests (up to N per row) into empty rows, passing
        over the shards in ``skip_shards`` and the dead ones.  Returns
        [(row, [(slot, request), ...]), ...]."""
        placements = []
        for j in self._admission_order():
            if not self.queue:
                break
            if (self.shard_of(j) in skip_shards
                    or self.shard_of(j) in self.dead_shards
                    or self.row_active(j)):
                continue
            placed = []
            for i in range(self.n_mux):
                if not self.queue:
                    break
                r = self.queue.popleft()
                self.slots[j][i] = StreamSlot(request=r,
                                              prompt_len=len(r.prompt))
                self._stamp_admit(r)
                placed.append((i, r))
            # every stream's position in the muxed row is the row's padded
            # length, keeping max_len retirement in step with the row's
            # physical length
            l_pad = max(len(r.prompt) + len(r.output) for _, r in placed)
            for i, _ in placed:
                self.slots[j][i].pos = l_pad
            placements.append((j, placed))
        return placements

    def plan_admissions(self, pad_id: int = 0, skip_shards=()):
        """One AdmitPlan per newly formed group; registers the row for
        chunked prefill.  skip_shards: as ``admit_paged``'s (the runtime
        re-plans a rolled-back group onto sibling shards)."""
        plans = []
        for j, placed in self.admit_paged(skip_shards):
            tokens = self.row_prompts(j, pad_id)
            self.prefill_progress[j] = [0, tokens.shape[1]]
            plans.append(AdmitPlan(row=j, placed=tuple(placed),
                                   tokens=tokens, total=tokens.shape[1],
                                   shard=self.shard_of(j), lane=self.lane))
        return plans

    def cancel_admit(self, plan: AdmitPlan):
        """Roll an admission back: un-place the group and put its requests
        back at the head of the queue."""
        del self.prefill_progress[plan.row]
        for i, r in reversed(plan.placed):
            self.slots[plan.row][i] = StreamSlot()
            self.queue.appendleft(r)

    def plan_chunks(self, chunk: int | None):
        """One PrefillChunkPlan per mid-prefill row: its next ``chunk``
        tokens (all remaining tokens when ``chunk`` is None — blocking
        prefill)."""
        plans = []
        for j, (filled, total) in self.prefill_progress.items():
            n = total - filled if chunk is None else min(chunk,
                                                        total - filled)
            plans.append(PrefillChunkPlan(row=j, start=filled, length=n,
                                          last=filled + n >= total,
                                          lane=self.lane))
        return plans

    def chunk_done(self, row: int, n: int) -> bool:
        """Advance a row's prefill; True when the prompt is complete."""
        st = self.prefill_progress[row]
        st[0] += n
        if st[0] >= st[1]:
            del self.prefill_progress[row]
            return True
        return False

    def plan_decode(self):
        return DecodePlan(rows=tuple(
            j for j in range(self.backbone_batch)
            if j not in self.prefill_progress and self.row_active(j)),
            lane=self.lane)

    def plan_frees(self):
        return [FreePlan(row=j, lane=self.lane)
                for j in range(self.backbone_batch)
                if j not in self.prefill_progress and not self.row_active(j)]

    # -- handoff (disaggregated serving) ----------------------------------
    def plan_handoff(self, j: int, dst_lane: int, dst_row: int,
                     tokens: int) -> HandoffPlan:
        """A HandoffPlan for row ``j``, which must be live with its
        prefill complete; ``tokens`` is its KV length (pool knowledge)."""
        if j in self.prefill_progress:
            raise ValueError(f"row {j} is mid-prefill — not handoff-ready")
        if not self.row_active(j):
            raise ValueError(f"row {j} has no live streams")
        uids = tuple(s.request.uid for s in self.slots[j]
                     if s.request is not None)
        return HandoffPlan(row=j, dst_row=dst_row, lane=self.lane,
                           dst_lane=dst_lane, tokens=tokens, uids=uids)

    def retire_handoff(self, plan: HandoffPlan) -> list:
        """Source side: detach row ``plan.row``'s slots without requeueing
        or retiring their streams, and return them for
        ``admit_handoff``."""
        slots = self.slots[plan.row]
        self.slots[plan.row] = [StreamSlot() for _ in range(self.n_mux)]
        return slots

    def admit_handoff(self, plan: HandoffPlan, slots: list):
        """Destination side: install a migrated row's slots at
        ``plan.dst_row``.  The row joins the decode grid directly: no
        ``prefill_progress`` entry is made, so no chunk is ever planned
        for it (zero re-prefill by construction)."""
        if any(s.request is not None for s in self.slots[plan.dst_row]):
            raise ValueError(f"row {plan.dst_row} is occupied")
        if plan.dst_row in self.prefill_progress:
            raise ValueError(f"row {plan.dst_row} is mid-prefill")
        if len(slots) != self.n_mux:
            raise ValueError(
                f"handoff carries {len(slots)} slots into an N={self.n_mux} "
                "lane — handoffs must preserve the mux width")
        self.slots[plan.dst_row] = slots
        for s in slots:
            if s.request is not None:
                s.request.lane = self.lane
        if self.telemetry.enabled:
            self.telemetry.inc("handoff_streams",
                               sum(s.request is not None for s in slots),
                               lane=self.lane)

    def preempt_row(self, j: int):
        """Requeue row j's live requests at the head of the queue (prompt +
        generated-so-far is re-prefilled on re-admission)."""
        self.prefill_progress.pop(j, None)
        for i in reversed(range(self.n_mux)):
            s = self.slots[j][i]
            if s.request is not None:
                self.queue.appendleft(s.request)
            self.slots[j][i] = StreamSlot()

    def row_active(self, j: int) -> bool:
        return any(s.request is not None for s in self.slots[j])

    def row_prompts(self, j: int, pad_id: int = 0):
        """Row j's N current token sequences, right-padded to one length."""
        seqs = [list(s.request.prompt) + s.request.output if s.request
                else [pad_id] for s in self.slots[j]]
        arr = np.full((self.n_mux, max(map(len, seqs))), pad_id, np.int32)
        for i, t in enumerate(seqs):
            arr[i, :len(t)] = t
        return arr

    def _record_slot(self, j: int, i: int, token, now: float) -> int:
        s = self.slots[j][i]
        if s.request is None:
            return 0
        r = s.request
        r.output.append(int(token))
        tele = self.telemetry
        if r.t_first is None:
            r.t_first = now
            if tele.enabled and r.t_submit is not None:
                tele.observe("ttft_s", now - r.t_submit, lane=self.lane)
        s.pos += 1
        if len(r.output) < r.max_new and s.pos < self.max_len:
            return 0
        r.done = True
        r.t_done = now
        self.completed.append(r)
        self.slots[j][i] = StreamSlot()
        if tele.enabled:
            tele.inc("requests_completed", lane=self.lane)
            if len(r.output) > 1 and now > r.t_first:
                tele.observe("tpot_s",
                             (now - r.t_first) / (len(r.output) - 1),
                             lane=self.lane)
        return 1

    def record_tokens(self, tokens, now: float | None = None):
        """tokens (N_mux * B,): the next token of every stream, mux-major
        (stream i of row j at i * B + j), on the host.  Retires finished
        requests; returns the number retired."""
        if now is None:
            now = time.time()
        retired = sum(self._record_slot(j, i, tokens[i * self.backbone_batch
                                                     + j], now)
                      for i in range(self.n_mux)
                      for j in range(self.backbone_batch))
        if self.telemetry.enabled:
            self.telemetry.inc("tokens_generated", self.n_active + retired,
                               lane=self.lane)
        self.steps += 1
        return retired

    def record_row_tokens(self, j: int, tokens, now: float | None = None):
        """tokens (N_mux,): the next token of each stream of row j, on the
        host.  Retires finished requests; returns the number retired."""
        if now is None:
            now = time.time()
        before = sum(1 for s in self.slots[j] if s.request is not None)
        retired = sum(self._record_slot(j, i, tokens[i], now)
                      for i in range(self.n_mux))
        if self.telemetry.enabled:
            self.telemetry.inc("tokens_generated", before, lane=self.lane)
        return retired

    def utilization(self) -> float:
        """Occupied fraction of the N_mux × B slot grid (a mid-prefill
        row's streams count from admission on)."""
        return self.n_active / (self.n_mux * self.backbone_batch)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for admission (submitted, not yet placed)."""
        return len(self.queue)
