"""Fault tolerance and resize for the serve stack (counterpart of
``repro.serve.recovery``, DESIGN.md §fault tolerance).

``RecoverySupervisor`` is policy-free glue over mechanisms that live in
the runtime, router and pool layers; it adds the accounting the serve
loop reports (``stats``, the reference's dict key for key):

  * **kill-a-shard replay** — ``ServeRuntime.kill_shard`` fences a lost
    logical shard and replays its streams onto the survivors from their
    host token logs; the supervisor tracks each replayed request until
    its first post-kill token (``recovery_latency_s``), counts the
    re-prefill tokens and records a ``runtime.elastic`` shrink plan.
  * **straggler fencing** — per-(lane, shard) ``StragglerDetector``s on
    the step times the serve loop feeds; a shard flagged alone is fenced
    through the same kill path before it fails outright.
  * **live lane resize** — ``LaneRouter.drain_lane`` / ``add_lane`` /
    ``pop_drained``.
  * **hot snapshot / restore** — ``snapshot_state`` captures a runtime's
    whole serving state: the paged cache as the checkpoint tree and the
    host state as JSON metadata; ``restore_into`` rebuilds a fresh
    runtime from it, live rows resuming decode with no re-prefill.  On a
    serve mesh the snapshot holds the whole cache (``ServeRuntime.
    whole_cache``, gathered by every rank; rank 0 writes it), so it is
    the files one device writes, and a restore places each rank's part
    again (``ServeRuntime.place_cache``).

Snapshot format (``checkpoint.manager``'s layout; one format for both
packages, so each restores the other's)::

    tree     = {"cache": the paged cache in the reference's layout}
               periods/<p>/{bt,kp,vp,ppos[,ksc,vsc]} stacked over each
               pattern position's layers, leftover layers under tail
               (``interop.paged_cache_to_reference``)
    metadata = {"format": "mux-serve-v2",
                "config": {n_mux, rows, capacity, block_size, num_blocks,
                           n_shards, lane, chunk, kv_dtype, role},
                "pool": the pool's dump_state(),
                "queue": [request...], "slots": [[slot|null, ...]...],
                "prefill_progress": {row: [filled, total]},
                "dead_shards": [...], "sched_steps": int,
                "row_len": {...}, "row_tokens": {...},
                "next_tok": [[...]], "engine_steps": int,
                "pending_handoffs": [...]}

A snapshot restores only into an identically shaped runtime (the config
block must match).
"""
from __future__ import annotations

import time
from dataclasses import asdict

import numpy as np

from repro_torch import interop
from repro_torch.checkpoint.manager import AsyncCheckpointManager
from repro_torch.runtime.elastic import plan_serve_shrink
from repro_torch.runtime.fault_tolerance import StragglerDetector
from repro_torch.serve.batcher import Request
from repro_torch.serve.engine import init_cache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import StreamSlot
from repro_torch.serve.telemetry import NULL_TELEMETRY

SNAPSHOT_FORMAT = "mux-serve-v2"


def _dump_request(r) -> dict:
    return {"uid": int(r.uid),
            "prompt": [int(x) for x in r.prompt],
            "max_new": int(r.max_new),
            "output": [int(x) for x in r.output],
            "sampling": asdict(r.sampling) if r.sampling is not None
            else None,
            "t_submit": r.t_submit, "t_admit": r.t_admit,
            "t_first": r.t_first,
            "slo": r.slo, "lane": r.lane, "routed_step": r.routed_step}


def _load_request(d: dict) -> Request:
    return Request(uid=d["uid"], prompt=list(d["prompt"]),
                   max_new=d["max_new"], output=list(d["output"]),
                   sampling=(SamplingParams(**d["sampling"])
                             if d["sampling"] is not None else None),
                   t_submit=d["t_submit"], t_admit=d["t_admit"],
                   t_first=d["t_first"], slo=d["slo"], lane=d["lane"],
                   routed_step=d["routed_step"])


def _config_of(rt) -> dict:
    """What a snapshot must share with the runtime it restores into: the
    grid, the pool's geometry, the page storage (a payload read as
    another dtype would be garbage) and the lane's role."""
    return {"n_mux": rt.n_mux, "rows": rt.nrows,
            "capacity": rt.sc.capacity, "block_size": rt.sc.block_size,
            "num_blocks": rt.pool.num_blocks,
            "n_shards": rt.sc.n_shards, "lane": rt.lane,
            "chunk": rt.chunk, "kv_dtype": rt.sc.kv_dtype,
            "role": rt.role}


def snapshot_state(rt):
    """Capture a ``ServeRuntime``'s full serving state.  Returns ``(tree,
    metadata)`` for ``AsyncCheckpointManager.save`` (module docstring);
    the tree's stacked leaves are copies on the runtime's device."""
    sched = rt.sched
    slots = [[({"slot": i, "pos": s.pos, "prompt_len": s.prompt_len,
                "request": _dump_request(s.request)}
               if s.request is not None else None)
              for i, s in enumerate(row)] for row in sched.slots]
    meta = {
        "format": SNAPSHOT_FORMAT,
        "config": _config_of(rt),
        "pool": rt.pool.dump_state(),
        "queue": [_dump_request(r) for r in sched.queue],
        "slots": slots,
        "prefill_progress": {str(j): [int(f), int(t)]
                             for j, (f, t) in sched.prefill_progress.items()},
        "dead_shards": sorted(sched.dead_shards),
        "sched_steps": sched.steps,
        "row_len": {str(j): int(n) for j, n in rt.row_len.items()},
        "row_tokens": {str(j): np.asarray(a).tolist()
                       for j, a in rt.row_tokens.items()},
        "next_tok": rt.next_tok.tolist(),
        "engine_steps": rt.engine_steps,
        # a prefill lane's rows parked for a handoff: derivable from the
        # slots, recorded so a restore can check no handoff was torn
        "pending_handoffs": ([int(j) for j in rt.handoff_ready()]
                             if rt.role == "prefill" else []),
    }
    return {"cache": interop.paged_cache_to_reference(rt.whole_cache(),
                                                      rt.sc.cfg)}, meta


def restore_state(rt, cache_tree, meta):
    """Install a ``snapshot_state`` capture into ``rt``, a freshly built
    runtime of the same config.  Restored rows resume decode at their
    positions (no re-prefill); mid-prefill rows continue chunking where
    they stopped."""
    if meta.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"not a serve snapshot: format="
                         f"{meta.get('format')!r}")
    want, have = meta["config"], _config_of(rt)
    if want != have:
        raise ValueError(
            f"snapshot config {want} does not match runtime {have} — "
            "restore requires an identically shaped grid")
    if rt.mesh is None:
        interop.paged_cache_from_reference(cache_tree["cache"], rt.sc.cfg,
                                           rt.cache)
    else:        # the whole cache, then this rank's part of it
        whole = init_cache(rt.sc, rt.nb, device=rt.device)
        interop.paged_cache_from_reference(cache_tree["cache"], rt.sc.cfg,
                                           whole)
        rt.place_cache(whole)
    rt.pool.load_state(meta["pool"])
    sched = rt.sched
    sched.queue.clear()
    sched.queue.extend(_load_request(d) for d in meta["queue"])
    for j, row in enumerate(meta["slots"]):
        for i, s in enumerate(row):
            sched.slots[j][i] = (
                StreamSlot(request=_load_request(s["request"]),
                           pos=s["pos"], prompt_len=s["prompt_len"])
                if s is not None else StreamSlot())
    sched.prefill_progress.clear()
    sched.prefill_progress.update(
        {int(j): [f, t] for j, (f, t) in meta["prefill_progress"].items()})
    sched.dead_shards = set(int(s) for s in meta["dead_shards"])
    sched.steps = meta["sched_steps"]
    rt.row_len.clear()
    rt.row_len.update({int(j): n for j, n in meta["row_len"].items()})
    rt.row_tokens.clear()
    rt.row_tokens.update({int(j): np.asarray(a, np.int32)
                          for j, a in meta["row_tokens"].items()})
    rt.next_tok = np.asarray(meta["next_tok"], np.int32)
    rt.engine_steps = meta["engine_steps"]
    if rt.role == "prefill":
        want_pending = sorted(int(j) for j in
                              meta.get("pending_handoffs", []))
        have_pending = sorted(rt.handoff_ready())
        if want_pending != have_pending:
            raise ValueError(
                f"snapshot pending handoffs {want_pending} do not match "
                f"restored state {have_pending} — torn handoff")
    # the pool is the source of truth for the tables
    rt._install_tables()
    return rt


def restore_into(rt, ckpt, *, step: int | None = None):
    """Restore the latest (or ``step``'s) snapshot from ``ckpt`` (an
    ``AsyncCheckpointManager`` or a checkpoint directory) into the freshly
    built runtime ``rt``.  Returns ``(rt, step)``."""
    if isinstance(ckpt, str):
        ckpt = AsyncCheckpointManager(ckpt)
    whole = (rt.cache if rt.mesh is None else
             init_cache(rt.sc, rt.nb, device="meta"))
    target = {"cache": interop.paged_cache_to_reference(
        whole, rt.sc.cfg, meta=True)}
    tree, got_step, meta = ckpt.restore(target, step=step, device=rt.device)
    restore_state(rt, tree, meta)
    return rt, got_step


class RecoverySupervisor:
    """The serve loop's one place for failure and resize events: shard
    kills (replay accounting and shrink plans), straggler fencing, lane
    drains and adds, handoff accounting and hot snapshot / restore
    through an ``AsyncCheckpointManager`` (``ckpt_dir``, keeping
    ``keep_k`` steps).  telemetry: a ``serve.telemetry.Telemetry`` (None
    = disabled)."""

    def __init__(self, *, ckpt_dir: str | None = None, keep_k: int = 3,
                 telemetry=None):
        self.ckpt = (AsyncCheckpointManager(ckpt_dir, keep_k=keep_k)
                     if ckpt_dir else None)
        self.tele = telemetry if telemetry is not None else NULL_TELEMETRY
        # replayed requests waiting for their first post-kill token:
        # (request, len(output) at the kill, t_kill)
        self._pending: list = []
        self.shrink_plans: list = []
        self.stats = {"shards_killed": 0, "requests_replayed": 0,
                      "replay_prefill_tokens": 0,
                      "recovery_latency_s": [],
                      "lane_drains": 0, "lane_adds": 0,
                      "lanes_retired": 0, "snapshots": 0, "restarts": 0,
                      "restore_latency_s": [],
                      "handoffs": 0, "handoff_streams": 0,
                      "migrated_kv_bytes": 0,
                      "stragglers_fenced": 0, "global_slow_steps": 0}
        # (lane, shard) -> StragglerDetector, built once fencing is armed
        self._straggler_factory = None
        self._detectors: dict = {}

    # -- kill-a-shard ------------------------------------------------------
    def kill_shard(self, rt, shard: int):
        """Kill ``shard`` of runtime ``rt`` (``ServeRuntime.kill_shard``)
        and track every replayed request until its first post-kill token,
        which closes its ``recovery_latency_s`` (requeue wait, re-admission
        and re-prefill).  Records the shrink plan of the surviving grid.
        Returns the replayed requests."""
        t0 = time.perf_counter()
        replayed = rt.kill_shard(shard)
        self.stats["shards_killed"] += 1
        self.stats["requests_replayed"] += len(replayed)
        # every replayed token (prompt + generated so far) runs through
        # prefill again on a surviving shard
        self.stats["replay_prefill_tokens"] += sum(
            len(r.prompt) + len(r.output) for r in replayed)
        self._pending.extend((r, len(r.output), t0) for r in replayed)
        mesh = getattr(rt, "mesh", None)      # a runtime's serve mesh
        model_ax = mesh.shape.get("model", 1) if mesh is not None else 1
        alive = rt.sc.n_shards - len(rt.sched.dead_shards)
        self.shrink_plans.append(plan_serve_shrink(
            alive, model_parallel=model_ax, rows=rt.nrows))
        return replayed

    def note_step(self):
        """Called once per serve step: closes the recovery latency of each
        replayed request whose first post-kill token has arrived."""
        if not self._pending:
            return
        now = time.perf_counter()
        still = []
        for r, n0, t0 in self._pending:
            if len(r.output) > n0 or r.done:
                dt = now - t0
                self.stats["recovery_latency_s"].append(dt)
                if self.tele.enabled:
                    self.tele.observe("recovery_latency_s", dt,
                                      lane=r.lane or 0)
            else:
                still.append((r, n0, t0))
        self._pending = still

    def note_handoff(self, plan, nbytes: int):
        """Record one executed prefill-to-decode handoff: the
        ``HandoffPlan`` ``ServeRuntime.handoff_to`` returned and the page
        bytes it migrated."""
        self.stats["handoffs"] += 1
        self.stats["handoff_streams"] += len(plan.uids)
        self.stats["migrated_kv_bytes"] += nbytes

    # -- straggler fencing -------------------------------------------------
    def enable_straggler_fencing(self, **kw):
        """Arm per-(lane, shard) ``StragglerDetector``s (keyword args go
        to it) over the step times ``observe_shard_times`` is fed; a shard
        whose step time leaves its own baseline is fenced through
        ``kill_shard`` before it fails outright."""
        self._straggler_factory = lambda: StragglerDetector(**kw)

    @property
    def fencing_enabled(self) -> bool:
        return self._straggler_factory is not None

    def observe_shard_times(self, rt, times: dict):
        """Feed one serve step's per-shard step times (seconds, {shard:
        dt} over alive shards) of runtime ``rt`` and fence a straggler.
        Fencing fires only when exactly one shard flags: a step slow on
        every shard is a global stall (counted in ``global_slow_steps``),
        and the last alive shard is never fenced.  Returns the fenced
        shard or None."""
        if self._straggler_factory is None:
            return None
        flagged = []
        for shard, dt in sorted(times.items()):
            key = (rt.lane, shard)
            det = self._detectors.get(key)
            if det is None:
                det = self._detectors[key] = self._straggler_factory()
            if det.observe(rt.engine_steps, dt):
                flagged.append(shard)
        if not flagged:
            return None
        if len(flagged) > 1:
            self.stats["global_slow_steps"] += 1
            if self.tele.enabled:
                self.tele.instant("global_slow_step", lane=rt.lane,
                                  shards=len(flagged))
            return None
        shard = flagged[0]
        alive = rt.sc.n_shards - len(rt.sched.dead_shards)
        if shard in rt.sched.dead_shards or alive < 2:
            return None
        self.kill_shard(rt, shard)
        self.stats["stragglers_fenced"] += 1
        if self.tele.enabled:
            self.tele.inc("stragglers_fenced", lane=rt.lane, shard=shard)
            self.tele.instant("straggler_fenced", lane=rt.lane,
                              shard=shard, dt=times[shard])
        return shard

    # -- live lane resize --------------------------------------------------
    def drain_lane(self, router, lane: int, step: int | None = None) -> int:
        moved = router.drain_lane(lane, step=step)
        self.stats["lane_drains"] += 1
        return moved

    def add_lane(self, router, rt) -> int:
        idx = router.add_lane(rt)
        self.stats["lane_adds"] += 1
        return idx

    def pop_drained(self, router) -> list:
        removed = router.pop_drained()
        self.stats["lanes_retired"] += len(removed)
        return removed

    # -- hot snapshot / restore --------------------------------------------
    def snapshot(self, rt, step: int):
        """Snapshot ``rt``'s full serving state as step ``step``: the host
        capture is synchronous, the disk write runs in the checkpoint
        manager's background thread."""
        if self.ckpt is None:
            raise ValueError("RecoverySupervisor needs ckpt_dir for "
                             "snapshot/restore")
        tree, meta = snapshot_state(rt)
        if rt.mesh is None or not any(rt.mesh.coords.values()):
            self.ckpt.save(step, tree, metadata=meta)     # rank 0 writes
        self.stats["snapshots"] += 1
        if self.tele.enabled:
            self.tele.instant("snapshot", lane=rt.lane, step=step)

    def restore(self, rt, *, step: int | None = None):
        """Restore the latest (or ``step``'s) snapshot into the freshly
        built runtime ``rt``; records the restore latency (joining the
        write, reading the checkpoint and rebuilding the state).  Returns
        ``(rt, step)``."""
        if self.ckpt is None:
            raise ValueError("RecoverySupervisor needs ckpt_dir for "
                             "snapshot/restore")
        t0 = time.perf_counter()
        if rt.mesh is not None:       # rank 0's write lands before any read
            self.ckpt.wait()
            rt.mesh.barrier()
        rt, got_step = restore_into(rt, self.ckpt, step=step)
        dt = time.perf_counter() - t0
        self.stats["restarts"] += 1
        self.stats["restore_latency_s"].append(dt)
        if self.tele.enabled:
            self.tele.observe("restore_latency_s", dt, lane=rt.lane)
            self.tele.instant("restore", lane=rt.lane, step=got_step)
        return rt, got_step
