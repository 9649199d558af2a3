"""The serve stack's resize path (counterpart of the lane half of
``repro.serve.recovery``, DESIGN.md §fault tolerance).

``RecoverySupervisor`` is policy-free glue: live lane resize lives in
``serve.router.LaneRouter`` (``drain_lane`` / ``add_lane`` /
``pop_drained``) and the disaggregated handoff in
``serve.runtime.ServeRuntime.handoff_to``; the supervisor adds the
accounting the serve loop reports (``stats``, the reference's dict key
for key) and one place to hand resize events and handoffs to.

Kill-a-shard replay, the hot KV-pool snapshot / restore and straggler
fencing need logical shards and the checkpoint manager: they are ROADMAP
§1 item 11, and their methods raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

_LATER = ("shards, kill-shard replay, snapshots and straggler fencing are "
          "ROADMAP §1 item 11; the JAX package serves them")


class RecoverySupervisor:
    """Lane drains and adds and handoff accounting for the serve loop.

    ``stats`` holds every key of the reference's; the shard, snapshot and
    straggler keys stay 0 (or empty) until ROADMAP §1 item 11."""

    def __init__(self):
        self.stats = {"shards_killed": 0, "requests_replayed": 0,
                      "replay_prefill_tokens": 0,
                      "recovery_latency_s": [],
                      "lane_drains": 0, "lane_adds": 0,
                      "lanes_retired": 0, "snapshots": 0, "restarts": 0,
                      "restore_latency_s": [],
                      "handoffs": 0, "handoff_streams": 0,
                      "migrated_kv_bytes": 0,
                      "stragglers_fenced": 0, "global_slow_steps": 0}

    def kill_shard(self, rt, shard: int):
        raise NotImplementedError(f"kill_shard: {_LATER}")

    def enable_straggler_fencing(self, **kw):
        raise NotImplementedError(f"straggler fencing: {_LATER}")

    def snapshot(self, rt, step: int):
        raise NotImplementedError(f"snapshot: {_LATER}")

    def restore(self, rt, *, step: int | None = None):
        raise NotImplementedError(f"restore: {_LATER}")

    def note_step(self):
        """Called once per serve step.  It closes the recovery-latency
        observations of requests replayed after a shard kill; with no
        shards before ROADMAP §1 item 11 there are none to close."""

    def note_handoff(self, plan, nbytes: int):
        """Record one executed prefill-to-decode handoff: the
        ``HandoffPlan`` ``ServeRuntime.handoff_to`` returned and the page
        bytes it migrated."""
        self.stats["handoffs"] += 1
        self.stats["handoff_streams"] += len(plan.uids)
        self.stats["migrated_kv_bytes"] += nbytes

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
