"""SLO-aware routing across mux-width serving lanes (counterpart of
``repro.serve.router``, DESIGN.md §width lanes).

The mux width N trades quality for throughput.  Width-lane serving hosts
several ``serve.runtime.ServeRuntime`` lanes at different widths (an N=1
latency lane beside wider throughput lanes) and routes each request to a
lane from its declared SLO class and live lane load:

  * ``latency``     — narrowest lane first, spilling *wider* (a
                      **demotion**) only when the preferred lane saturates;
  * ``throughput``  — widest lane first, spilling *narrower* (a
                      **promotion**);
  * ``balanced``    — the middle width first, then outward, wider before
                      narrower.

A lane is *saturated* when its admission queue reaches ``spill_queue``
(default: its N_mux × rows slots) or its pool has no allocatable block.
When every eligible lane is saturated the least-pressured one takes the
request: nothing is dropped, and backpressure stays lane-local (each lane
owns its scheduler, runtime, pool and step signatures).

An optional global block ``budget`` is split into per-lane pool quotas
(soft caps below each pool's device ceiling); ``rebalance`` moves
**unused** quota from idle lanes to lanes with queued work, and device
shapes never change.  ``mode="goodput"`` stable-sorts the candidates on
each lane's published goodput (TTFT-SLO attainment × tok/s, from
``lane_stats``).  ``drain_lane`` / ``add_lane`` / ``pop_drained`` resize
the lane set under traffic; ``handoff_targets`` picks the decode lanes of
disaggregated serving.  Routing happens once, at submit time: a placed
stream never moves to another lane's grid, so each lane's streams equal a
fixed-width runtime fed the same sub-schedule.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.serve.kvpool import blocks_for
from repro_torch.serve.telemetry import MetricsRegistry, NULL_TELEMETRY

SLO_LATENCY = "latency"
SLO_BALANCED = "balanced"
SLO_THROUGHPUT = "throughput"
SLO_CLASSES = (SLO_LATENCY, SLO_BALANCED, SLO_THROUGHPUT)

# Default per-class TTFT targets (seconds) for goodput accounting —
# goodput = TTFT-SLO attainment × tokens/s (arXiv:2504.14489; MuxServe,
# arXiv:2404.02015).  Deployments override via ``LaneRouter(ttft_slo=...)``.
DEFAULT_TTFT_SLO = {SLO_LATENCY: 0.1, SLO_BALANCED: 0.5,
                    SLO_THROUGHPUT: 2.0}


def ttft_attainment(completed, targets=None):
    """Fraction of ``completed`` requests whose TTFT met their SLO
    class's target (requests without both stamps are skipped; missing /
    None SLO counts as balanced).  Returns (attainment, n_measured);
    attainment is 1.0 when nothing was measurable (vacuous)."""
    targets = targets if targets is not None else DEFAULT_TTFT_SLO
    met = n = 0
    for r in completed:
        if r.t_first is None or r.t_submit is None:
            continue
        n += 1
        limit = targets.get(getattr(r, "slo", None) or SLO_BALANCED)
        if limit is None or r.t_first - r.t_submit <= limit:
            met += 1
    return (met / n if n else 1.0), n


@dataclass(frozen=True)
class LaneSpec:
    """Static description of one serving lane.

    n_mux: the lane's mux width N (its own params and step signatures).
    rows:  backbone rows of the lane's N_mux × rows grid.
    chunk: prefill chunk size (None = blocking prefill) for this lane —
           latency lanes may want smaller chunks than throughput lanes.
    role:  disaggregated serving (DESIGN.md §disaggregated): "both"
           (default, interleaved prefill+decode), "prefill" (admissions
           and chunks only — finished rows hand off) or "decode"
           (decode only — rows arrive by KV-page migration).
    """
    n_mux: int
    rows: int
    chunk: int | None = 32
    role: str = "both"

    @property
    def slots(self) -> int:
        return self.n_mux * self.rows


@dataclass(frozen=True)
class LaneLoad:
    """One lane's live-load snapshot (``ServeRuntime.load()``): the three
    signals the router weighs — slot utilization, admission-queue depth
    and pool headroom — plus the mid-prefill row count for diagnostics."""
    lane: int
    n_mux: int
    slots: int                    # n_mux * rows
    active: int                   # live streams holding slots
    queue_depth: int              # requests waiting for admission
    headroom_blocks: int          # allocatable blocks (quota-capped)
    mid_prefill: int = 0          # rows mid-way through chunked prefill

    @property
    def utilization(self) -> float:
        return self.active / self.slots

    @property
    def pressure(self) -> float:
        """In-flight + waiting requests per stream slot; the router's
        tie-breaker when every eligible lane is saturated."""
        return (self.active + self.queue_depth) / self.slots


class LaneRouter:
    """Admit requests to width lanes by SLO class and live lane load.

    runtimes: one ``ServeRuntime`` per lane (any object exposing
    ``lane``, ``n_mux``, ``nrows``, ``sc``, ``pool`` and ``load()``
    works — unit tests pass fakes).  spill_queue: per-lane queued-request
    threshold beyond which the lane counts as saturated (default: the
    lane's slot count — one full grid waiting).  budget: optional global
    block budget partitioned into per-lane quotas (proportional to each
    lane's device ceiling); enables ``rebalance``.  telemetry: serve-wide
    ``serve.telemetry.Telemetry`` handle — the router's counters live in
    its ``MetricsRegistry`` (a private registry when no telemetry is
    passed) and rebalance/spill decisions emit trace instants.
    ttft_slo: per-SLO-class TTFT targets (seconds) for goodput
    accounting (``lane_stats``); defaults to ``DEFAULT_TTFT_SLO``.
    """

    def __init__(self, runtimes, *, spill_queue: int | None = None,
                 budget: int | None = None, telemetry=None,
                 ttft_slo: dict | None = None, mode: str = "load"):
        if not runtimes:
            raise ValueError("need at least one lane")
        if mode not in ("load", "goodput"):
            raise ValueError(f"mode must be load|goodput, got {mode!r}")
        # admission routes only to lanes that can PREFILL a new request
        # ('both'/'prefill' roles); decode-only lanes receive streams via
        # handoff (``handoff_targets``), never from the queue — so width
        # uniqueness, the per-width routing key, applies to routable
        # lanes only (a disaggregated pair shares one width by design)
        widths = [rt.n_mux for rt in runtimes
                  if getattr(rt, "role", "both") != "decode"]
        if not widths:
            raise ValueError("need at least one routable (non-decode) lane")
        if len(set(widths)) != len(widths):
            raise ValueError(f"duplicate routable lane widths {widths}")
        self.runtimes = list(runtimes)
        self.mode = mode
        # lane id -> latest published goodput signal (``lane_stats``);
        # goodput-mode routing stable-sorts candidates on it, so a
        # uniform/absent signal degenerates to plain load routing
        self._goodput: dict = {}
        self.spill_queue = spill_queue
        self.budget = budget
        # live lane resize (DESIGN.md §fault tolerance): lanes draining
        # toward removal (by lane id) and runtimes already removed —
        # retired runtimes are kept so compile-once and stats assertions
        # can still see them after the lane left the routing set
        self.draining: set = set()
        self.retired: list = []
        self.tele = telemetry if telemetry is not None else NULL_TELEMETRY
        # routing counters live on a MetricsRegistry (shared with the
        # serve-wide telemetry when enabled, private otherwise); the
        # ``counters`` property rebuilds the legacy dict view from it
        self.registry = (self.tele.registry if self.tele.enabled
                         else MetricsRegistry())
        self.ttft_slo = dict(ttft_slo if ttft_slo is not None
                             else DEFAULT_TTFT_SLO)
        # lane indices sorted narrow -> wide; SLO preference orders are
        # slices/reversals of this
        self._by_width = sorted(range(len(runtimes)),
                                key=lambda i: runtimes[i].n_mux)
        if budget is not None:
            self._init_quotas(budget)

    @property
    def counters(self) -> dict:
        """Backward-compatible view of the routing counters (they live
        on ``self.registry`` since the telemetry layer landed): the
        historical nested-dict shape consumed by ``stats['routing']``
        and the churn benchmark JSON."""
        reg = self.registry
        return {"routed": {slo: reg.value("router_routed", slo=slo)
                           for slo in SLO_CLASSES},
                "demotions": reg.value("router_demotions"),
                "promotions": reg.value("router_promotions"),
                "rebalanced_blocks": reg.value("router_rebalanced_blocks")}

    # -- pool partitioning -------------------------------------------------
    @staticmethod
    def _ceiling(rt) -> int:
        """Device-side allocatable blocks of a lane's pool: its
        ``ceiling`` (total minus the trash block), else the same from
        ``num_blocks`` for a pool without one (unit-test fakes)."""
        pool = rt.pool
        ceiling = getattr(pool, "ceiling", None)
        if ceiling is not None:
            return ceiling
        return pool.num_blocks - getattr(pool, "n_shards", 1)

    def _init_quotas(self, budget: int):
        """Partition the global budget into per-lane quotas proportional
        to each lane's device ceiling (every lane keeps at least one
        row's worth of blocks so no lane starves at t=0)."""
        ceil = [self._ceiling(rt) for rt in self.runtimes]
        if budget > sum(ceil):
            raise ValueError(
                f"budget {budget} exceeds total device capacity {sum(ceil)}")
        floors = [min(c, rt.sc.max_blocks_per_seq)
                  for c, rt in zip(ceil, self.runtimes)]
        if budget < sum(floors):
            raise ValueError(
                f"budget {budget} cannot fund one row per lane "
                f"(needs >= {sum(floors)})")
        quotas = list(floors)
        spare = budget - sum(floors)
        total_ceil = sum(ceil)
        for i, rt in enumerate(self.runtimes):
            extra = min(ceil[i] - quotas[i], spare * ceil[i] // total_ceil)
            quotas[i] += extra
        # distribute rounding remainder narrow-first within ceilings
        rem = budget - sum(quotas)
        for i in self._by_width:
            give = min(rem, ceil[i] - quotas[i])
            quotas[i] += give
            rem -= give
        for rt, q in zip(self.runtimes, quotas):
            rt.pool.set_quota(q)

    def _redistribute(self):
        """Re-split the global budget across the CURRENT lane set after
        an add or a drain-removal, flooring each lane at its live usage
        (like ``rebalance``, resize moves only unused quota — live
        blocks never strand below their lane's cap).  When the budget
        still covers one-row floors for every lane, each lane keeps at
        least ``max_blocks_per_seq``; mid-resize overcommit (usage
        alone exceeds what floors allow) degrades to usage-only floors
        and lanes regain reserve as rows drain.  No-op without a
        budget."""
        if self.budget is None or not self.runtimes:
            return
        ceil = [self._ceiling(rt) for rt in self.runtimes]
        used = [rt.pool.n_used_blocks for rt in self.runtimes]
        floors = [min(c, max(u, rt.sc.max_blocks_per_seq))
                  for c, u, rt in zip(ceil, used, self.runtimes)]
        if self.budget < sum(floors):
            floors = [min(c, u) for c, u in zip(ceil, used)]
        quotas = list(floors)
        spare = max(0, self.budget - sum(floors))
        total_ceil = sum(ceil) or 1
        for i in range(len(self.runtimes)):
            extra = min(ceil[i] - quotas[i], spare * ceil[i] // total_ceil)
            quotas[i] += extra
        rem = self.budget - sum(quotas)
        for i in self._by_width:
            give = min(rem, ceil[i] - quotas[i])
            if give > 0:
                quotas[i] += give
                rem -= give
        for rt, q in zip(self.runtimes, quotas):
            rt.pool.set_quota(q)

    # -- live lane resize (DESIGN.md §fault tolerance) ---------------------
    def _index_of(self, lane: int) -> int:
        for i, rt in enumerate(self.runtimes):
            if rt.lane == lane:
                return i
        raise ValueError(f"no lane with id {lane} "
                         f"(have {[rt.lane for rt in self.runtimes]})")

    def drain_lane(self, lane: int, step: int | None = None) -> int:
        """Start draining lane ``lane`` under traffic, dropping no
        stream: new arrivals stop routing to it and its QUEUED (not yet
        admitted) requests re-route across the remaining lanes; streams
        already placed keep decoding to completion where they are (mux
        combine is nonlinear — a placed stream cannot migrate,
        DESIGN.md §admission).  The caller keeps stepping the lane
        until ``pop_drained`` removes it and hands its quota back.
        ``step``: current engine step — re-routed requests are
        re-stamped (``routed_step``) so lane-parity replay stays exact.
        Returns the number of requests moved to other lanes."""
        idx = self._index_of(lane)
        if len(self.runtimes) - len(self.draining) <= 1:
            raise ValueError("cannot drain the last active lane")
        self.draining.add(lane)
        rt = self.runtimes[idx]
        pending = list(rt.sched.queue)
        rt.sched.queue.clear()
        moved = 0
        for r in pending:
            i = self.route(r)         # draining lanes excluded below
            if step is not None:
                r.routed_step = step
            self.runtimes[i].submit(r)
            moved += int(self.runtimes[i] is not rt)
        self.registry.inc("router_lane_drains")
        self.tele.instant("lane_drain", lane=lane, requeued=moved)
        return moved

    def add_lane(self, rt) -> int:
        """Add a freshly built runtime as a new lane under traffic.
        Its width must be unique across current lanes (draining ones
        included — two lanes at one width would make routing and the
        per-width compile-once contract ambiguous) and its lane id
        unused.  With a budget, quotas re-split across the grown lane
        set (floors at live usage).  Returns the new lane's index."""
        if getattr(rt, "role", "both") != "decode" and any(
                x.n_mux == rt.n_mux
                and getattr(x, "role", "both") != "decode"
                for x in self.runtimes):
            raise ValueError(f"duplicate lane width {rt.n_mux}")
        if any(x.lane == rt.lane for x in self.runtimes + self.retired):
            raise ValueError(f"lane id {rt.lane} already used")
        self.runtimes.append(rt)
        self._by_width = sorted(range(len(self.runtimes)),
                                key=lambda i: self.runtimes[i].n_mux)
        self._redistribute()
        self.registry.inc("router_lane_adds")
        self.tele.instant("lane_add", lane=rt.lane, n_mux=rt.n_mux)
        return len(self.runtimes) - 1

    def pop_drained(self) -> list:
        """Remove draining lanes whose last stream has retired.  Their
        runtimes move to ``self.retired`` (so end-of-run compile-once
        and stats checks still reach them) and, with a budget, the
        freed quota re-splits across the surviving lanes.  Call once
        per serve step, after stepping the lanes.  Returns the removed
        runtimes."""
        removed = []
        for lane in sorted(self.draining):
            idx = self._index_of(lane)
            rt = self.runtimes[idx]
            if rt.has_work():
                continue
            self.runtimes.pop(idx)
            self.draining.discard(lane)
            self.retired.append(rt)
            removed.append(rt)
            self.tele.instant("lane_removed", lane=lane)
        if removed:
            self._by_width = sorted(range(len(self.runtimes)),
                                    key=lambda i: self.runtimes[i].n_mux)
            self._redistribute()
        return removed

    def rebalance(self) -> int:
        """Move unused quota from idle lanes to lanes with queued work.

        A lane *donates* spare quota (free quota beyond one row's worth
        of reserve) only while its own queue is empty; a lane *takes*
        enough to fund its queued groups, capped by its device ceiling.
        Only UNUSED quota ever moves — live blocks stay where they are —
        and the global sum is conserved.  Returns blocks moved.  No-op
        without a budget."""
        if self.budget is None or len(self.runtimes) < 2:
            return 0
        loads = [rt.load() for rt in self.runtimes]
        surplus, demand = {}, {}
        for i, (rt, ld) in enumerate(zip(self.runtimes, loads)):
            quota = rt.pool.quota
            free_quota = max(0, quota - rt.pool.n_used_blocks)
            reserve = rt.sc.max_blocks_per_seq
            if ld.queue_depth == 0 and free_quota > reserve:
                surplus[i] = free_quota - reserve
            elif ld.queue_depth > 0:
                groups = -(-ld.queue_depth // rt.n_mux)
                want = groups * rt.sc.max_blocks_per_seq - free_quota
                want = min(want, self._ceiling(rt) - quota)
                if want > 0:
                    demand[i] = want
        moved = 0
        for i in sorted(demand, key=demand.get, reverse=True):
            for j in sorted(surplus, key=surplus.get, reverse=True):
                d = min(demand[i], surplus[j])
                if d <= 0:
                    continue
                self.runtimes[j].pool.set_quota(
                    self.runtimes[j].pool.quota - d)
                self.runtimes[i].pool.set_quota(
                    self.runtimes[i].pool.quota + d)
                surplus[j] -= d
                demand[i] -= d
                moved += d
                if demand[i] == 0:
                    break
        if moved:
            self.registry.inc("router_rebalanced_blocks", moved)
            self.tele.instant("rebalance", blocks=moved)
        return moved

    # -- routing policy ----------------------------------------------------
    def _routable(self) -> list:
        """Lane indices admission may route to (decode-only lanes are
        handoff destinations, not admission targets)."""
        return [i for i, rt in enumerate(self.runtimes)
                if getattr(rt, "role", "both") != "decode"]

    def _goodput_order(self, order: list) -> list:
        """Goodput mode: stable-sort candidate lanes by their latest
        published goodput signal, best first.  Stable + uniform-signal
        short-circuit means ties and cold starts fall back to exactly
        the load-order decision (the degenerate-to-load property the
        router tests pin down); lanes without a signal yet are scored
        at the observed max so new lanes still get explored."""
        scores = {i: self._goodput.get(self.runtimes[i].lane)
                  for i in order}
        known = [s for s in scores.values() if s is not None]
        if not known or max(known) <= min(known):
            return list(order)
        default = max(known)
        return sorted(order, key=lambda i: -(
            scores[i] if scores[i] is not None else default))

    def _pref_order(self, slo: str) -> list:
        routable = set(self._routable())
        bw = [i for i in self._by_width if i in routable]
        if slo == SLO_LATENCY:
            return list(bw)
        if slo == SLO_THROUGHPUT:
            return list(reversed(bw))
        # balanced: middle width first, then outward, wider before
        # narrower (ride the middle lane, spill toward throughput)
        mid = (len(bw) - 1) // 2
        return sorted(bw, key=lambda i: (abs(bw.index(i) - mid),
                                         -self.runtimes[i].n_mux))

    def _fits(self, i: int, need_tokens: int) -> bool:
        """Whether a request of ``need_tokens`` (prompt + budget) can
        EVER be served by lane i — capacity and per-sequence block cap.
        A request that fits no lane is a sizing error, not backpressure."""
        sc = self.runtimes[i].sc
        return (need_tokens <= sc.capacity and
                blocks_for(need_tokens, sc.block_size)
                <= sc.max_blocks_per_seq)

    def _saturated(self, i: int, ld: LaneLoad) -> bool:
        limit = (self.spill_queue if self.spill_queue is not None
                 else ld.slots)
        return ld.queue_depth >= limit or ld.headroom_blocks <= 0

    def route(self, request) -> int:
        """Pick a lane for ``request`` and record the verdict.

        Reads ``request.slo`` (``latency`` / ``balanced`` /
        ``throughput``; missing/None means balanced) and writes
        ``request.lane``.  Returns the lane index — the caller submits
        to that lane's runtime.  Routing is final (see module docstring).
        """
        slo = getattr(request, "slo", None) or SLO_BALANCED
        if slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo!r} "
                             f"(expected one of {SLO_CLASSES})")
        need = len(request.prompt) + request.max_new
        order = [i for i in self._pref_order(slo) if self._fits(i, need)]
        if not order:
            raise ValueError(
                f"request uid={getattr(request, 'uid', '?')} "
                f"({need} tokens) fits no lane")
        # draining lanes accept no new streams — unless no active lane
        # fits this request at all (requests are never dropped; the
        # overflow stream simply delays that lane's removal)
        active = [i for i in order
                  if self.runtimes[i].lane not in self.draining]
        if active:
            order = active
        else:
            self.registry.inc("router_drain_overflow")
        if self.mode == "goodput":
            order = self._goodput_order(order)
        loads = {i: self.runtimes[i].load() for i in order}
        chosen = next((i for i in order if not self._saturated(i, loads[i])),
                      None)
        if chosen is None:        # every eligible lane saturated: least
            chosen = min(order, key=lambda i: loads[i].pressure)
        self.registry.inc("router_routed", slo=slo)
        self.registry.inc("router_lane_routed",
                          lane=self.runtimes[chosen].lane)
        if chosen != order[0]:
            w0 = self.runtimes[order[0]].n_mux
            wc = self.runtimes[chosen].n_mux
            kind = "demotions" if wc > w0 else "promotions"
            self.registry.inc(f"router_{kind}")
            self.tele.instant("spill", lane=self.runtimes[chosen].lane,
                              kind=kind[:-1], slo=slo,
                              uid=getattr(request, "uid", None))
        request.slo = slo
        request.lane = self.runtimes[chosen].lane
        return chosen

    def loads(self) -> list:
        return [rt.load() for rt in self.runtimes]

    # -- handoff-target selection (DESIGN.md §disaggregated) ---------------
    def handoff_targets(self, n_mux: int) -> list:
        """Candidate lanes for a finished-prefill row of width
        ``n_mux``, best first: decode-capable ('decode'/'both' role),
        same width (a muxed row cannot change composition), and not
        draining (a draining lane finishes its placed streams but
        accepts no new ones — drain semantics are preserved across
        handoff).  Ordered by least pressure; goodput mode stable-sorts
        the published lane signal on top, exactly like admission.  The
        orchestrator tries candidates in order until one has a free row
        and pool headroom — an empty list parks the row in its prefill
        lane (backpressure, not an error)."""
        cands = [i for i, rt in enumerate(self.runtimes)
                 if getattr(rt, "role", "both") != "prefill"
                 and rt.n_mux == n_mux
                 and rt.lane not in self.draining]
        loads = {i: self.runtimes[i].load() for i in cands}
        cands.sort(key=lambda i: loads[i].pressure)
        if self.mode == "goodput":
            cands = self._goodput_order(cands)
        return cands

    # -- goodput accounting ------------------------------------------------
    def lane_stats(self, wall: float | None = None) -> list:
        """Per-lane goodput accounting: TTFT-SLO attainment × tokens/s —
        the signal goodput-driven scheduling routes on
        (arXiv:2504.14489).  ``wall``: elapsed serving wall time in
        seconds (tokens/s and goodput are None without it).  Reads each
        runtime's completed requests (lanes without stats — unit-test
        fakes — report zero traffic).  Also publishes the per-lane
        ``lane_goodput_tok_s`` / ``lane_ttft_slo_attainment`` gauges."""
        out = []
        for rt in self.runtimes:
            completed = getattr(rt, "stats", {}).get("completed", ())
            tokens = sum(len(r.output) for r in completed)
            attain, measured = ttft_attainment(completed, self.ttft_slo)
            tok_s = tokens / wall if wall else None
            goodput = attain * tok_s if tok_s is not None else None
            out.append({"lane": rt.lane, "n_mux": rt.n_mux,
                        "completed": len(completed), "tokens": tokens,
                        "ttft_measured": measured,
                        "slo_attainment": attain, "tok_s": tok_s,
                        "goodput_tok_s": goodput})
            # the routing signal goodput mode sorts on: goodput when
            # wall time is known, bare attainment otherwise
            self._goodput[rt.lane] = (goodput if goodput is not None
                                      else attain)
            self.registry.gauge("lane_ttft_slo_attainment", attain,
                                lane=rt.lane)
            if goodput is not None:
                self.registry.gauge("lane_goodput_tok_s", goodput,
                                    lane=rt.lane)
        return out
