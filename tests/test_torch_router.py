"""The port's width-lane router (``repro_torch.serve.router``) and the lane
half of its ``RecoverySupervisor`` against the reference on the CPU.

  * every case of ``tests/test_router.py``, run on the port (fake lanes for
    the policy, reduced qwen2-1.5b lanes at widths 1 and 2 end to end);
  * the lane-resize cases of ``tests/test_recovery.py`` (drain, add, the
    budget re-split) and the supervisor's counters;
  * a seeded differential: the same sequence of loads, requests,
    rebalances, goodput publications, drains and adds through both
    routers over fake lanes gives the same lane choices, quota splits,
    requeues and counters.
"""
import collections
from types import SimpleNamespace

import numpy as np
import pytest

import jax

from repro.models import TransformerLM as RefLM
from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.serve import kvpool as ref_kvpool
from repro.serve import router as ref_router
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.launch import serve as cli
from repro_torch.serve import kvpool as port_kvpool
from repro_torch.serve import router as port_router
from repro_torch.serve.batcher import Request
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.recovery import RecoverySupervisor
from repro_torch.serve.router import (DEFAULT_TTFT_SLO, SLO_BALANCED,
                                      SLO_CLASSES, SLO_LATENCY,
                                      SLO_THROUGHPUT, LaneRouter,
                                      ttft_attainment)
from repro_torch.serve.telemetry import Telemetry

import torch

torch.set_num_threads(2)


# --------------------------------------------------------------- fakes

class FakeLane:
    """Duck-typed ServeRuntime over one package's ``KVPool`` and
    ``LaneLoad``: a real queue plus the load / pool surface the router
    reads.  ``queue_depth`` / ``headroom`` override what the queue and
    the pool say."""

    def __init__(self, lane, n_mux, rows=2, *, capacity=32, block_size=4,
                 queue_depth=None, active=0, headroom=None,
                 pkg=(port_kvpool, port_router)):
        kvpool, router = pkg
        self._load_cls = router.LaneLoad
        self.lane, self.n_mux, self.nrows = lane, n_mux, rows
        mbs = kvpool.blocks_for(capacity, block_size)
        self.sc = SimpleNamespace(capacity=capacity, block_size=block_size,
                                  max_blocks_per_seq=mbs)
        self.pool = kvpool.KVPool(num_blocks=rows * mbs + 1,
                                  block_size=block_size,
                                  max_blocks_per_seq=mbs)
        self.sched = SimpleNamespace(queue=collections.deque())
        self.queue_depth = queue_depth
        self.active = active
        self.headroom = headroom

    def submit(self, r):
        self.sched.queue.append(r)

    def has_work(self):
        return bool(self.sched.queue) or self.active > 0

    def load(self):
        qd = (len(self.sched.queue) if self.queue_depth is None
              else self.queue_depth)
        return self._load_cls(
            lane=self.lane, n_mux=self.n_mux, slots=self.n_mux * self.nrows,
            active=self.active, queue_depth=qd,
            headroom_blocks=(self.pool.headroom if self.headroom is None
                             else self.headroom))


def mk_router(widths=(1, 4, 8), **kw):
    lanes = [FakeLane(i, w) for i, w in enumerate(widths)]
    return LaneRouter(lanes, **kw), lanes


def req(uid=0, plen=4, max_new=4, slo=None):
    return Request(uid=uid, prompt=list(range(1, plen + 1)),
                   max_new=max_new, slo=slo)


# ------------------------------------------------------ routing policy

def test_slo_preference_orders():
    router, _ = mk_router((1, 4, 8))
    assert router._pref_order(SLO_LATENCY) == [0, 1, 2]
    assert router._pref_order(SLO_THROUGHPUT) == [2, 1, 0]
    assert router._pref_order(SLO_BALANCED) == [1, 2, 0]


def test_idle_lanes_route_by_slo_class():
    router, _ = mk_router((1, 4, 8))
    assert router.route(req(0, slo=SLO_LATENCY)) == 0
    assert router.route(req(1, slo=SLO_THROUGHPUT)) == 2
    assert router.route(req(2, slo=SLO_BALANCED)) == 1
    r = req(3, slo=None)
    assert router.route(r) == 1
    assert r.slo == SLO_BALANCED and r.lane == 1
    assert router.counters["routed"] == {"latency": 1, "balanced": 2,
                                         "throughput": 1}
    assert router.counters["demotions"] == 0
    assert router.counters["promotions"] == 0


def test_unknown_slo_raises():
    router, _ = mk_router((1, 4))
    with pytest.raises(ValueError, match="unknown SLO"):
        router.route(req(0, slo="best-effort"))


def test_saturated_latency_lane_demotes_wider():
    router, lanes = mk_router((1, 4, 8))
    lanes[0].queue_depth = lanes[0].n_mux * lanes[0].nrows
    r = req(0, slo=SLO_LATENCY)
    assert router.route(r) == 1 and r.lane == 1
    assert router.counters["demotions"] == 1


def test_pool_exhausted_lane_spills():
    router, lanes = mk_router((1, 4))
    lanes[0].headroom = 0
    assert router.route(req(0, slo=SLO_LATENCY)) == 1
    assert router.counters["demotions"] == 1


def test_saturated_wide_lane_promotes_narrower():
    router, lanes = mk_router((1, 4, 8))
    lanes[2].queue_depth = lanes[2].n_mux * lanes[2].nrows
    r = req(0, slo=SLO_THROUGHPUT)
    assert router.route(r) == 1 and r.lane == 1
    assert router.counters["promotions"] == 1


def test_all_saturated_picks_least_pressure():
    router, lanes = mk_router((1, 4))
    lanes[0].queue_depth = 6
    lanes[1].queue_depth = 9
    assert router.route(req(0, slo=SLO_LATENCY)) == 1
    assert router.route(req(1, slo=SLO_THROUGHPUT)) == 1


def test_oversized_request_skips_small_lane():
    lanes = [FakeLane(0, 1, capacity=8), FakeLane(1, 4, capacity=64)]
    router = LaneRouter(lanes)
    assert router.route(req(0, plen=16, max_new=8, slo=SLO_LATENCY)) == 1
    with pytest.raises(ValueError, match="fits no lane"):
        router.route(req(1, plen=100, max_new=8))


def test_duplicate_widths_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        mk_router((2, 2))


# --------------------------------------------------- quota partitioning

def test_budget_partition_conserves_and_respects_ceilings():
    router, lanes = mk_router((1, 4, 8), budget=30)
    quotas = [ln.pool.quota for ln in lanes]
    ceilings = [ln.pool.num_blocks - 1 for ln in lanes]
    assert sum(quotas) == 30
    assert all(0 < q <= c for q, c in zip(quotas, ceilings))
    assert all(q >= ln.sc.max_blocks_per_seq
               for q, ln in zip(quotas, lanes))


def test_budget_bounds_validated():
    with pytest.raises(ValueError, match="exceeds total"):
        mk_router((1, 4), budget=10_000)
    with pytest.raises(ValueError, match="one row per lane"):
        mk_router((1, 4), budget=2)


def test_rebalance_moves_unused_quota_to_queued_lane():
    router, lanes = mk_router((1, 4), budget=24)
    before = [ln.pool.quota for ln in lanes]
    lanes[1].queue_depth = 8
    moved = router.rebalance()
    after = [ln.pool.quota for ln in lanes]
    assert moved > 0
    assert sum(after) == sum(before) == 24
    assert after[1] > before[1] and after[0] < before[0]
    assert after[0] >= lanes[0].sc.max_blocks_per_seq
    assert router.counters["rebalanced_blocks"] == moved


def test_rebalance_never_strands_live_blocks():
    router, lanes = mk_router((1, 4), budget=24)
    lanes[0].pool.allocate("row0", 8)
    lanes[1].queue_depth = 50
    router.rebalance()
    assert lanes[0].pool.quota >= (lanes[0].pool.n_used_blocks
                                   + lanes[0].sc.max_blocks_per_seq)
    assert lanes[1].pool.quota <= lanes[1].pool.num_blocks - 1
    assert sum(ln.pool.quota for ln in lanes) == 24


def test_rebalance_noop_without_budget():
    router, lanes = mk_router((1, 4))
    lanes[1].queue_depth = 4
    assert router.rebalance() == 0
    assert all(ln.pool.quota is None for ln in lanes)


# ------------------------------------------------- end-to-end lane runs

ROWS = 2


@pytest.fixture(scope="module")
def lane_model():
    """Reduced qwen2-1.5b at widths 1 and 2, the reference's init carried
    over (``interop``)."""
    cfg_r = ref_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    key = jax.random.PRNGKey(0)
    params = {w: interop.params_from_reference(
        jax.tree.map(np.asarray, RefLM.init(jax.random.fold_in(key, w),
                                            cfg_r, RefMux(n=w))),
        cfg, device="cpu") for w in (1, 2)}
    return cfg, params


def _base_sc(cfg):
    return ServeConfig(cfg=cfg, mux=MuxSpec(n=1), capacity=24,
                       dtype=torch.float32, cache_layout="paged",
                       block_size=4)


def _arrivals(cfg, n, slo, *, every=1, seed=0):
    rng = np.random.default_rng(seed)
    return [(i * every, rng.integers(4, cfg.vocab_size, size=(6,)), 3,
             None, slo) for i in range(n)]


def _run(params, sc, arrivals, **kw):
    return cli.run_continuous(params, sc, ROWS, arrivals, chunk=4,
                              device="cpu", **kw)


def test_all_latency_mix_degenerates_to_narrowest_lane(lane_model):
    cfg, params = lane_model
    stats = _run(params, _base_sc(cfg), _arrivals(cfg, 4, "latency",
                                                  every=3), lanes=(1, 2))
    assert len(stats["completed"]) == 4
    assert all(r.lane == 0 for r in stats["completed"])
    assert stats["routing"]["routed"]["latency"] == 4
    wide = stats["lanes"][1]
    assert not wide["completed"] and wide["trace_counts"] == {}
    assert wide["decode_steps"] == 0


def test_latency_burst_spills_into_wide_lane(lane_model):
    cfg, params = lane_model
    stats = _run(params, _base_sc(cfg), _arrivals(cfg, 6, "latency",
                                                  every=0), lanes=(1, 2))
    assert len(stats["completed"]) == 6
    assert stats["routing"]["demotions"] > 0
    by_lane = {ls["lane"]: {r.uid for r in ls["completed"]}
               for ls in stats["lanes"]}
    assert by_lane[1]
    for r in stats["completed"]:
        assert r.uid in by_lane[r.lane]
    for ls in stats["lanes"]:
        assert ls["trace_counts"].get("decode", 0) <= 1


def test_lane_backpressure_stays_lane_local(lane_model):
    cfg, params = lane_model
    sc = _base_sc(cfg)
    mbs = sc.max_blocks_per_seq
    arrivals = (_arrivals(cfg, 3, "latency", every=0)
                + _arrivals(cfg, 2, "throughput", every=0, seed=1))
    stats = _run(params, sc, arrivals, lanes=(1, 2),
                 pool_budget=2 * mbs + mbs, spill_queue=100)
    assert len(stats["completed"]) == 5
    for pool in stats["pools"]:
        assert pool.n_used_blocks == 0
        pool.check_invariants()
    assert stats["routing"]["routed"]["latency"] == 3
    assert stats["routing"]["routed"]["throughput"] == 2
    assert all(r.lane == 0 for r in stats["completed"]
               if r.slo == "latency")
    assert all(r.lane == 1 for r in stats["completed"]
               if r.slo == "throughput")


# ---------------------------------------------- goodput + telemetry view

def _done_req(uid, slo, ttft, tokens=4):
    r = req(uid, slo=slo)
    r.t_submit = 100.0
    r.t_first = 100.0 + ttft
    r.output = list(range(tokens))
    return r


def test_ttft_attainment_helper():
    done = [_done_req(0, SLO_LATENCY, 0.05), _done_req(1, SLO_LATENCY, 0.50),
            _done_req(2, SLO_THROUGHPUT, 1.00), _done_req(3, None, 0.40)]
    attain, n = ttft_attainment(done)
    assert n == 4 and attain == pytest.approx(3 / 4)
    pending = req(9, slo=SLO_LATENCY)
    attain, n = ttft_attainment(done + [pending])
    assert n == 4 and attain == pytest.approx(3 / 4)
    assert ttft_attainment([pending]) == (1.0, 0)
    attain, _ = ttft_attainment(done, {s: 10.0 for s in SLO_CLASSES})
    assert attain == 1.0
    assert DEFAULT_TTFT_SLO == ref_router.DEFAULT_TTFT_SLO


def test_counters_are_registry_view():
    tele = Telemetry()
    router, _ = mk_router((1, 4), telemetry=tele)
    assert router.registry is tele.registry
    router.route(req(0, slo=SLO_LATENCY))
    assert tele.registry.value("router_routed", slo="latency") == 1
    assert tele.registry.value("router_lane_routed", lane=0) == 1
    assert router.counters["routed"]["latency"] == 1
    tele.registry.inc("router_demotions")
    assert router.counters["demotions"] == 1
    router2, _ = mk_router((1, 4))
    router2.route(req(1, slo=SLO_BALANCED))
    assert router2.counters["routed"] == {"latency": 0, "balanced": 1,
                                          "throughput": 0}


def test_lane_stats_goodput_accounting():
    router, lanes = mk_router((1, 4))
    for ls in router.lane_stats():
        assert ls["completed"] == 0 and ls["tokens"] == 0
        assert ls["slo_attainment"] == 1.0
        assert ls["tok_s"] is None and ls["goodput_tok_s"] is None
    lanes[0].stats = {"completed": [_done_req(0, SLO_LATENCY, 0.05),
                                    _done_req(1, SLO_LATENCY, 0.50)]}
    lanes[1].stats = {"completed": [_done_req(2, SLO_THROUGHPUT, 1.0,
                                              tokens=8)]}
    stats = router.lane_stats(wall=2.0)
    assert stats[0]["slo_attainment"] == pytest.approx(0.5)
    assert stats[0]["tok_s"] == pytest.approx(8 / 2.0)
    assert stats[0]["goodput_tok_s"] == pytest.approx(0.5 * 4.0)
    assert stats[1]["slo_attainment"] == 1.0
    assert stats[1]["goodput_tok_s"] == pytest.approx(4.0)
    assert (router.registry.value("lane_ttft_slo_attainment", lane=0)
            == pytest.approx(0.5))
    assert (router.registry.value("lane_goodput_tok_s", lane=1)
            == pytest.approx(4.0))
    loose, _ = mk_router((1,), ttft_slo={s: 10.0 for s in SLO_CLASSES})
    loose.runtimes[0].stats = lanes[0].stats
    assert loose.lane_stats(wall=2.0)[0]["slo_attainment"] == 1.0


# ------------------------------------------- goodput-aware routing mode

def _skewed_stats(lanes):
    lanes[0].stats = {"completed": [_done_req(0, SLO_LATENCY, 5.0),
                                    _done_req(1, SLO_LATENCY, 5.0)]}
    lanes[1].stats = {"completed": [_done_req(2, SLO_LATENCY, 0.01,
                                              tokens=8)]}


def test_goodput_mode_beats_load_on_skewed_lanes():
    load_r, load_lanes = mk_router((1, 4))
    good_r, good_lanes = mk_router((1, 4), mode="goodput")
    for router, lanes in ((load_r, load_lanes), (good_r, good_lanes)):
        _skewed_stats(lanes)
        router.lane_stats(wall=2.0)
    assert load_r.route(req(0, slo=SLO_LATENCY)) == 0
    assert good_r.route(req(0, slo=SLO_LATENCY)) == 1
    assert good_r.counters["demotions"] == 0
    assert good_r.counters["promotions"] == 0


def test_goodput_mode_degenerates_to_load_when_uniform():
    router, lanes = mk_router((1, 4), mode="goodput")
    assert router.route(req(0, slo=SLO_LATENCY)) == 0
    for ln in lanes:
        ln.stats = {"completed": [_done_req(ln.lane, SLO_LATENCY, 0.01,
                                            tokens=4)]}
    router.lane_stats(wall=2.0)
    assert router.route(req(1, slo=SLO_LATENCY)) == 0
    assert router.counters["demotions"] == 0


def test_goodput_unscored_lane_explores_at_max():
    router, _ = mk_router((1, 4, 8), mode="goodput")
    router._goodput = {0: 0.5, 1: 4.0}
    assert router._goodput_order([0, 1, 2]) == [1, 2, 0]


def test_goodput_mode_validated():
    with pytest.raises(ValueError, match="mode"):
        mk_router((1, 4), mode="qps")


# ------------------------------------- handoff targets (disaggregated)

def mk_disagg_router(**kw):
    lanes = [FakeLane(0, 1), FakeLane(1, 1), FakeLane(2, 1), FakeLane(3, 2)]
    lanes[0].role = "prefill"
    for ln in lanes[1:]:
        ln.role = "decode"
    return LaneRouter(lanes, **kw), lanes


def test_handoff_targets_filter_role_width_and_order_by_pressure():
    router, lanes = mk_disagg_router()
    lanes[1].active = 2
    assert router.handoff_targets(1) == [2, 1]
    assert router.handoff_targets(2) == [3]
    assert router.handoff_targets(8) == []
    assert 0 not in router.handoff_targets(1)


def test_handoff_targets_respect_drain():
    router, lanes = mk_disagg_router()
    router.draining.add(lanes[2].lane)
    assert router.handoff_targets(1) == [1]
    router.draining.add(lanes[1].lane)
    assert router.handoff_targets(1) == []


def test_handoff_targets_goodput_order():
    router, lanes = mk_disagg_router(mode="goodput")
    router._goodput = {1: 0.5, 2: 4.0}
    assert router.handoff_targets(1) == [2, 1]
    router._goodput = {1: 4.0, 2: 0.5}
    assert router.handoff_targets(1) == [1, 2]
    router._goodput = {1: 1.0, 2: 1.0}
    lanes[1].active = 2
    assert router.handoff_targets(1) == [2, 1]


def test_decode_lanes_share_width_without_conflict():
    router, lanes = mk_disagg_router()
    for u, slo in enumerate((SLO_LATENCY, SLO_BALANCED, SLO_THROUGHPUT)):
        assert router.route(req(u, slo=slo)) == 0
    both = [FakeLane(0, 1), FakeLane(1, 1)]
    with pytest.raises(ValueError, match="duplicate"):
        LaneRouter(both)
    for ln in both:
        ln.role = "decode"
    with pytest.raises(ValueError, match="routable"):
        LaneRouter(both)


# -------------------------------------------------- live lane resize

CAPACITY, BLOCK = 20, 4


def _resize_lane(lane, n_mux):
    return FakeLane(lane, n_mux, capacity=CAPACITY, block_size=BLOCK)


def test_router_drain_requeues_and_retires():
    lanes = [_resize_lane(0, 1), _resize_lane(1, 4)]
    router = LaneRouter(lanes)
    for uid in range(3):
        r = Request(uid=uid, prompt=[1, 2], max_new=2, slo="throughput")
        lanes[router.route(r)].submit(r)
    assert len(lanes[1].sched.queue) == 3
    lanes[1].active = 1
    moved = router.drain_lane(1, step=5)
    assert moved == 3
    assert all(r.routed_step == 5 and r.lane == 0
               for r in lanes[0].sched.queue)
    r = Request(uid=9, prompt=[1], max_new=1, slo="throughput")
    assert router.route(r) == 0
    assert router.pop_drained() == []
    lanes[1].active = 0
    removed = router.pop_drained()
    assert removed == [lanes[1]] and router.retired == [lanes[1]]
    with pytest.raises(ValueError, match="last active lane"):
        router.drain_lane(0)


def test_router_add_lane_unique_width_and_id():
    lanes = [_resize_lane(0, 1), _resize_lane(1, 4)]
    router = LaneRouter(lanes)
    with pytest.raises(ValueError, match="duplicate lane width"):
        router.add_lane(_resize_lane(2, 4))
    with pytest.raises(ValueError, match="already used"):
        router.add_lane(_resize_lane(1, 8))
    idx = router.add_lane(_resize_lane(2, 8))
    assert router.runtimes[idx].lane == 2
    r = Request(uid=0, prompt=[1, 2], max_new=2, slo="throughput")
    assert router.route(r) == idx


def test_router_resize_resplits_budget():
    lanes = [_resize_lane(0, 1), _resize_lane(1, 4)]
    router = LaneRouter(lanes, budget=16)
    assert sum(rt.pool.quota for rt in lanes) == 16
    router.add_lane(_resize_lane(2, 8))
    quotas = [rt.pool.quota for rt in router.runtimes]
    assert sum(quotas) == 16 and all(q >= 5 for q in quotas)
    router.drain_lane(2)
    router.pop_drained()
    assert sum(rt.pool.quota for rt in router.runtimes) == 16


def test_supervisor_counts_resize_and_refuses_item_11():
    """The supervisor counts drains, adds and retirements, handoffs and
    shard kills under the reference's keys."""
    sup = RecoverySupervisor()
    ref_keys = set(ref_supervisor_stats())
    assert set(sup.stats) == ref_keys
    lanes = [_resize_lane(0, 1), _resize_lane(1, 4)]
    router = LaneRouter(lanes)
    sup.add_lane(router, _resize_lane(2, 8))
    sup.drain_lane(router, 2, step=3)
    assert sup.pop_drained(router) == [router.retired[0]]
    sup.note_handoff(SimpleNamespace(uids=(4, 5)), 1024)
    sup.note_step()
    assert {k: sup.stats[k] for k in ("lane_drains", "lane_adds",
                                      "lanes_retired", "handoffs",
                                      "handoff_streams",
                                      "migrated_kv_bytes")} == {
        "lane_drains": 1, "lane_adds": 1, "lanes_retired": 1,
        "handoffs": 1, "handoff_streams": 2, "migrated_kv_bytes": 1024}
    # the shard half: a kill is counted with its shrink plan, fencing
    # arms, snapshots need a checkpoint directory
    killed = SimpleNamespace(
        kill_shard=lambda shard: [SimpleNamespace(prompt=[1, 2], output=[3])],
        sc=SimpleNamespace(n_shards=2), nrows=2,
        sched=SimpleNamespace(dead_shards={1}))
    assert len(sup.kill_shard(killed, 1)) == 1
    assert (sup.stats["shards_killed"], sup.stats["requests_replayed"],
            sup.stats["replay_prefill_tokens"]) == (1, 1, 3)
    assert sup.shrink_plans[-1].mesh_shape == (1, 1)
    assert not sup.fencing_enabled
    sup.enable_straggler_fencing(warmup_steps=2)
    assert sup.fencing_enabled
    for call in (lambda: sup.snapshot(lanes[0], 1),
                 lambda: sup.restore(lanes[0])):
        with pytest.raises(ValueError, match="needs ckpt_dir"):
            call()


def ref_supervisor_stats():
    from repro.serve.recovery import RecoverySupervisor as Ref
    return Ref().stats


# ----------------------------------------------- seeded differential

REF = (ref_kvpool, ref_router)
PORT = (port_kvpool, port_router)


def _state(router):
    return ([(rt.lane, rt.pool.quota, rt.pool.n_used_blocks,
              len(rt.sched.queue)) for rt in router.runtimes],
            [rt.lane for rt in router.retired], sorted(router.draining),
            router.counters,
            {k: v for k, v in router.registry.snapshot().items()
             if k != "histograms"})


def _drive(pkg, seed):
    """One seeded sequence of router operations on one package's fakes;
    returns the trace of every return value and state."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 5))
    widths = [int(w) for w in rng.choice([1, 2, 4, 8, 16], n,
                                         replace=False)]
    rows = [int(r) for r in rng.integers(1, 4, n)]
    caps = [int(c) for c in rng.choice([16, 24, 32], n)]
    mode = "goodput" if seed % 2 else "load"
    lanes = [FakeLane(i, w, rows=r, capacity=c, pkg=pkg)
             for i, (w, r, c) in enumerate(zip(widths, rows, caps))]
    total = sum(ln.pool.num_blocks - 1 for ln in lanes)
    floor = sum(ln.sc.max_blocks_per_seq for ln in lanes)
    budget = (int(rng.integers(floor, total + 1)) if seed % 3 else None)
    router = pkg[1].LaneRouter(lanes, budget=budget, mode=mode,
                               spill_queue=(None if seed % 4 else 3))
    Req = SimpleNamespace
    out, uid, next_lane = [], 0, n
    for step in range(60):
        op = rng.choice(["route", "route", "route", "load", "alloc", "free",
                         "skew", "rebalance", "stats", "drain", "pop",
                         "add"])
        rts = router.runtimes
        if op == "skew":                       # one idle lane, one queued
            a, b = (rts[int(i)] for i in rng.integers(len(rts), size=2))
            a.sched.queue.clear()
            a.queue_depth = None
            b.queue_depth = int(rng.integers(1, 20))
            out.append(("rebalance", router.rebalance()))
        elif op == "route":
            r = Req(uid=uid, prompt=[1] * int(rng.integers(1, 20)),
                    max_new=int(rng.integers(1, 8)),
                    slo=rng.choice([None, *SLO_CLASSES]), lane=None,
                    routed_step=None)
            uid += 1
            try:
                i = router.route(r)
            except ValueError as e:
                out.append(("route-error", str(e)))
                continue
            r.routed_step = step
            rts[i].submit(r)
            out.append(("route", i, r.lane, r.slo))
        elif op == "load":
            ln = rts[int(rng.integers(len(rts)))]
            ln.active = int(rng.integers(0, ln.n_mux * ln.nrows + 1))
            ln.headroom = (None if rng.uniform() < 0.7
                           else int(rng.integers(0, 3)))
            if ln.sched.queue and rng.uniform() < 0.5:
                ln.sched.queue.popleft()       # admitted
        elif op == "alloc":
            ln = rts[int(rng.integers(len(rts)))]
            try:
                ln.pool.allocate(f"c{step}", int(rng.integers(1, 12)))
                out.append(("alloc", ln.pool.n_used_blocks))
            except pkg[0].PoolExhausted:
                out.append(("alloc-refused",))
        elif op == "free":
            ln = rts[int(rng.integers(len(rts)))]
            owned = sorted(ln.pool._tables)
            if owned:
                ln.pool.free(owned[int(rng.integers(len(owned)))])
        elif op == "rebalance":
            out.append(("rebalance", router.rebalance()))
        elif op == "stats":
            for ln in rts:
                ln.stats = {"completed": [
                    Req(t_submit=0.0, t_first=float(rng.exponential(0.5)),
                        slo=rng.choice(SLO_CLASSES),
                        output=[0] * int(rng.integers(1, 6)))
                    for _ in range(int(rng.integers(0, 3)))]}
            got = router.lane_stats(wall=float(rng.uniform(0.5, 2.0)))
            out.append(("stats", [(s["lane"], s["completed"], s["tokens"],
                                   s["slo_attainment"]) for s in got]))
        elif op == "drain":
            lane = rts[int(rng.integers(len(rts)))].lane
            try:
                out.append(("drain", router.drain_lane(lane, step=step)))
            except ValueError as e:
                out.append(("drain-error", str(e)))
        elif op == "pop":
            for ln in rts:
                if ln.lane in router.draining and rng.uniform() < 0.5:
                    ln.active = 0
                    ln.sched.queue.clear()
            out.append(("pop", [rt.lane for rt in router.pop_drained()]))
        else:
            w = int(rng.choice([1, 2, 3, 4, 8, 16, 32]))
            new = FakeLane(next_lane, w, rows=int(rng.integers(1, 3)),
                           capacity=int(rng.choice([16, 32])), pkg=pkg)
            try:
                out.append(("add", router.add_lane(new)))
                next_lane += 1
            except ValueError as e:
                out.append(("add-error", str(e)))
        out.append(_state(router))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_router_differential_against_the_reference(seed):
    """The same seeded sequence of loads, routes, rebalances, goodput
    publications, drains and adds through both routers: every choice,
    quota split, requeue, retirement and counter equal."""
    got, want = _drive(PORT, seed), _drive(REF, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
