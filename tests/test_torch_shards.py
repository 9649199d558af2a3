"""The port's logical data shards and kill-shard replay against the JAX
reference on the CPU: ``ShardedKVPool``, ``paged_write``'s per-row trash,
shard-aware admission, ``ServeRuntime.kill_shard``, straggler fencing,
``runtime.elastic``'s shrink plan and ``runtime.fault_tolerance``'s
``StragglerDetector``, and the CLI's shard flags.

Reduced qwen2-1.5b, 2 backbone rows, capacity 20, pages of 4 tokens,
``dtype=float32``, the port's weights carried over from the reference's
init (``repro_torch.interop``); schedules from the reference fuzz's
``_schedule`` rule, pools and requests from seeded numpy draws.

  * pools: a seeded allocate / append / free / migrate / quota / kill /
    dump / load churn through both packages' ``ShardedKVPool`` in
    lockstep — the same outcomes, tables, quotas and ``dump_state`` after
    every operation; the reference's kill and quota cases;
  * ``paged_write`` with a (B,) trash vector, bit for bit the reference's
    over fp32, bf16, int8 and fp8 pages;
  * admission: round-robin rows, ``skip_shards`` and dead shards, plan for
    plan the reference scheduler's;
  * replay: the reference's kill-shard, straggler and guard cases; the
    fuzz's kill-shard arm (seeds 0 and 1) and its disaggregated kill-shard
    arm (seeds 0 and 1), tokens, prefill events and the recovery counters
    equal to the reference's run of the same arm;
  * straggler fencing on injected step times, fenced shard, step and
    counters equal to the reference supervisor's;
  * the CLI's ``--shards 2 --kill-shard 4:1``, ``--shards 2
    --fence-stragglers`` and a lanes kill print the reference CLI's counts
    (the ``stragglers:`` line's two counts, wall-clock figures, masked).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import kvpool as ref_kvpool
from repro.serve.recovery import RecoverySupervisor as RefSupervisor
from repro.serve.router import LaneSpec as RefLaneSpec
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro.serve.scheduler import ContinuousScheduler as RefScheduler
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.launch import serve as cli
from repro_torch.runtime import elastic, fault_tolerance
from repro_torch.serve import engine, kvpool
from repro_torch.serve.batcher import Request
from repro_torch.serve.kvpool import PoolError, ShardedKVPool
from repro_torch.serve.recovery import RecoverySupervisor
from repro_torch.serve.router import LaneSpec
from repro_torch.serve.runtime import ServeRuntime
from repro_torch.serve.scheduler import ContinuousScheduler
from test_serve_fuzz import BLOCK, CAPACITY, ROWS, _schedule

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
KILL_STEP = 4          # the fuzz's kill-shard event step


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port cfg, port params) at N=1."""
    cfg_r = ref_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    ref = RefLM.init(KEY, cfg_r, RefMux(n=1))
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                         device="cpu")
    return cfg_r, ref, cfg, port


def sc_port(cfg, **kw):
    return engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), capacity=CAPACITY,
                              dtype=torch.float32, cache_layout="paged",
                              block_size=BLOCK, **kw)


def sc_ref(cfg_r, **kw):
    return RefServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=1),
                          capacity=CAPACITY, dtype=jnp.float32,
                          cache_layout="paged", block_size=BLOCK, **kw)


def requests(cfg, *, sampled=False):
    """The reference recovery tests' three requests (seed 5); with
    ``sampled`` the second one samples (the port's sampler, so sampled
    streams are held to the port's own undisturbed run)."""
    from repro_torch.serve.sampling import SamplingParams
    rng = np.random.default_rng(5)
    out = []
    for i, (plen, max_new) in enumerate([(6, 5), (9, 4), (4, 5)]):
        sp = (SamplingParams(temperature=0.7, top_k=11, seed=i)
              if sampled and i == 1 else None)
        out.append(dict(uid=i, max_new=max_new, sampling=sp,
                        prompt=[int(x) for x in
                                rng.integers(4, cfg.vocab_size, size=plen)]))
    return out


def drive(rt, reqs, request_cls, *, on_step=None, late_at=2):
    """Serve ``reqs`` (the last arriving at step ``late_at``) on either
    package's runtime, calling ``on_step(rt, step) -> rt`` before each
    step.  Returns (uid -> output tokens, the final runtime); the pool
    drains clean."""
    reqs = [request_cls(**r) for r in reqs]
    for r in reqs[:-1]:
        rt.submit(r)
    step = 0
    while rt.has_work() or step <= late_at:
        if step == late_at:
            rt.submit(reqs[-1])
        if on_step is not None:
            rt = on_step(rt, step) or rt
        rt.step()
        step += 1
    rt.pool.check_invariants()
    assert rt.pool.n_used_blocks == 0
    return {r.uid: [int(t) for t in r.output] for r in rt.sched.completed}, rt


def copy_arrivals(arrivals):
    return [(t, p.copy(), m) for t, p, m in arrivals]


def tokens(stats, arrivals):
    out = {r.uid: (tuple(int(t) for t in r.prompt),
                   [int(t) for t in r.output]) for r in stats["completed"]}
    assert len(out) == len(arrivals), "arm dropped requests"
    return out


def recovery_counts(rec):
    """The supervisor's counters, the latency lists as their lengths."""
    return {k: (len(v) if isinstance(v, list) else v) for k, v in rec.items()}


# ------------------------------------------------------------------ pools

N_SHARDS, N_ROWS, POOL_BLOCKS, MAX_BLOCKS = 3, 6, 24, 5


def _outcome(fn):
    try:
        return ("ok", fn())
    except PoolError as e:        # both packages' pool errors
        return (type(e).__name__, str(e))
    except ref_kvpool.PoolError as e:
        return (type(e).__name__, str(e))


def _state(p):
    return {"tables": p.table_array(range(N_ROWS)).tolist(),
            "dump": p.dump_state(), "quota": p.quota, "ceiling": p.ceiling,
            "headroom": p.headroom, "used": p.n_used_blocks,
            "free": p.n_free_blocks, "alive": p.alive_shards,
            "occupancy": p.occupancy_stats(),
            "util": p.utilization()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_pool_lockstep_churn(seed):
    """A seeded churn through both packages' ``ShardedKVPool`` in
    lockstep: every operation has the same outcome (result or error) and
    leaves the same tables, quotas, occupancy and ``dump_state``."""
    mk = dict(num_blocks=POOL_BLOCKS, block_size=BLOCK,
              max_blocks_per_seq=MAX_BLOCKS, n_shards=N_SHARDS, n_rows=N_ROWS)
    pools = [ShardedKVPool(**mk), ref_kvpool.ShardedKVPool(**mk)]
    rng = np.random.default_rng(seed)
    ops = ("allocate", "append", "free", "migrate", "quota", "kill",
           "reload")
    kinds = set()
    for _ in range(160):
        op = ops[int(rng.choice(len(ops), p=[.3, .25, .2, .1, .07, .04,
                                                .04]))]
        row, other = (int(x) for x in rng.integers(0, N_ROWS, size=2))
        n = int(rng.integers(0, 14))
        q = None if rng.random() < 0.3 else int(rng.integers(0, 22))
        shard = int(rng.integers(0, N_SHARDS))
        got = []
        for i, p in enumerate(pools):
            fn = {"allocate": lambda: p.allocate(row, n),
                  "append": lambda: p.append(row, max(n // 4, 1)),
                  "free": lambda: p.free(row),
                  "migrate": lambda: p.migrate_pages(row, other),
                  "quota": lambda: p.set_quota(q),
                  "kill": lambda: (p.free(row) if p.has(row) else None,
                                   p.kill_shard(shard))[1],
                  "reload": None}[op]
            if op == "reload":
                fresh = type(p)(**mk)
                fresh.load_state(p.dump_state())
                pools[i] = p = fresh
                fn = lambda: None
            got.append(_outcome(fn))
            p.check_invariants()
        assert got[0] == got[1], (op, got)
        assert _state(pools[0]) == _state(pools[1]), op
        kinds.add((op, got[0][0]))
    assert ("allocate", "ok") in kinds and ("kill", "ok") in kinds


def test_sharded_pool_kill_quota_and_guards():
    """The reference's kill / quota case on the port's pool."""
    pool = ShardedKVPool(num_blocks=12, block_size=4, max_blocks_per_seq=5,
                         n_shards=2, n_rows=2)
    pool.set_quota(8)
    pool.allocate(1, 7)
    with pytest.raises(PoolError, match="still owns rows"):
        pool.kill_shard(1)
    pool.free(1)
    assert pool.kill_shard(1) == 4
    assert pool.dead_shards == {1} and pool.alive_shards == [0]
    assert pool.quota == 8 and pool.ceiling == 5
    with pytest.raises(PoolError, match="dead"):
        pool.allocate(1, 4)
    with pytest.raises(PoolError, match="already dead"):
        pool.kill_shard(1)
    with pytest.raises(PoolError, match="last surviving"):
        pool.kill_shard(0)
    pool.check_invariants()
    clone = ShardedKVPool(num_blocks=12, block_size=4, max_blocks_per_seq=5,
                          n_shards=2, n_rows=2)
    clone.load_state(pool.dump_state())
    assert clone.dead_shards == {1} and clone.quota == 8
    assert pool.trash_vector(range(2)).tolist() == [0, 6]


def test_pool_sizing_and_refusals_as_the_reference(models):
    """``pool_blocks`` reserves a trash block per shard; ``make_pool``
    builds a ``ShardedKVPool`` beside the reference's; indivisible grids
    and pools are refused with the reference's errors."""
    cfg_r, _, cfg, _ = models
    for kw in ({"n_shards": 2}, {"n_shards": 2, "num_blocks": 12}):
        p, r = engine.make_pool(sc_port(cfg, **kw), ROWS), \
            ref_engine_make_pool(sc_ref(cfg_r, **kw))
        assert isinstance(p, ShardedKVPool)
        assert (p.num_blocks, p.n_shards, p.n_rows) == (
            r.num_blocks, r.n_shards, r.n_rows)
    assert sc_port(cfg, n_shards=2).pool_blocks(ROWS) == 2 * 5 + 2
    for kw, gb in (({"n_shards": 2, "num_blocks": 11}, 2),
                   ({"n_shards": 2}, 3)):
        with pytest.raises(ValueError) as want:
            sc_ref(cfg_r, **kw).pool_blocks(gb)
        with pytest.raises(ValueError) as got:
            sc_port(cfg, **kw).pool_blocks(gb)
        assert str(got.value) == str(want.value)


def ref_engine_make_pool(sc):
    from repro.serve.engine import make_pool
    return make_pool(sc, ROWS)


# ------------------------------------------------------- trash routing

def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8", "fp8"])
def test_paged_write_trash_vector_is_the_references(kv):
    """Three rows on three shards of 4 blocks each, positions past the
    table, negative and unallocated: every invalid write goes to its
    row's own trash block (positions stay -1), bit for bit the
    reference's ``paged_write(trash=vector)`` on every leaf."""
    rng = np.random.default_rng(7)
    P, BS, H, D = 12, 4, 2, 8
    quant = kv if kv in ("int8", "fp8") else None
    dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
    pages = ref_kvpool.init_pages(P, BS, H, D, dt, quant=quant)
    bt = np.array([[1, 2, -1], [5, -1, -1], [9, 10, 11]], np.int32)
    pages["bt"] = jnp.asarray(bt)
    pos = np.array([[0, 5, 9, -1, 13], [2, 4, -1, 1, 3],
                    [11, 12, -1, 0, 7]], np.int32)
    trash = np.array([0, 4, 8], np.int32)
    k = rng.standard_normal((3, 5, H, D)).astype(np.float32)
    v = rng.standard_normal((3, 5, H, D)).astype(np.float32)
    port = interop.pages_from_reference(pages, device="cpu")
    want = ref_kvpool.paged_write(pages, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), trash=jnp.asarray(trash))
    kvpool.paged_write(port, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(pos), trash=torch.from_numpy(trash))
    want = interop.pages_from_reference(want, device="cpu")
    assert set(port) == set(want)
    # every invalid write of a row lands in slot 0 of its trash block, so
    # which of them a trash slot holds is the scatter's choice: the trash
    # blocks are held to their positions, every other page bit for bit
    live = torch.as_tensor([b for b in range(P) if b not in trash])
    for key in want:
        got, ref = _bits(port[key]), _bits(want[key])
        if key != "bt":
            got, ref = got[live], ref[live]
        assert torch.equal(got, ref), key
    assert (port["ppos"][trash] == -1).all()
    assert int((port["ppos"] >= 0).sum()) == 8    # the 8 valid writes


# ------------------------------------------------------------ admission

def test_admission_rounds_robin_skips_and_fences_as_the_reference():
    """Rows visit round-robin over shards; ``skip_shards`` and dead shards
    keep groups off their rows; plans (rows, shards, tokens) equal the
    reference scheduler's at every stage."""
    scheds = [ContinuousScheduler(n_mux=2, backbone_batch=4, max_len=32,
                                  n_shards=2),
              RefScheduler(n_mux=2, backbone_batch=4, max_len=32,
                           n_shards=2)]
    rng = np.random.default_rng(3)
    batches = iter([[(4 * b + i, [int(x) for x in rng.integers(
        4, 99, size=int(rng.integers(2, 9)))]) for i in range(4)]
        for b in range(2)])

    def plans(**kw):
        batch, out = next(batches), []
        for s, cls in zip(scheds, (Request, RefRequest)):
            for uid, p in batch:
                s.submit(cls(uid=uid, prompt=list(p), max_new=3))
            out.append([(pl.row, pl.shard, pl.total, pl.tokens.tolist())
                        for pl in s.plan_admissions(0, **kw)])
        assert out[0] == out[1]
        return out[0]

    first = plans(skip_shards={1})
    assert [r for r, *_ in first] == [0, 1] and all(
        s == 0 for _, s, *_ in first)
    for s in scheds:
        s.dead_shards.add(0)
        s.preempt_row(0)
        s.preempt_row(1)
    assert [r for r, *_ in plans()] == [2, 3]
    assert [s.shard_of(3) for s in scheds] == [1, 1]
    assert scheds[0]._admission_order() == scheds[1]._admission_order() \
        == [0, 2, 1, 3]


def test_shrink_plans_and_straggler_detector_as_the_reference():
    """``plan_serve_shrink`` / ``plan_elastic`` field for field, and both
    packages' ``StragglerDetector`` fed the same seeded step times flag
    the same steps with the same z-scores."""
    from repro.runtime.elastic import plan_elastic, plan_serve_shrink
    from repro.runtime.fault_tolerance import StragglerDetector
    for alive, mp, rows in ((3, 2, 8), (1, 1, 2), (5, 1, 7)):
        a = elastic.plan_serve_shrink(alive, model_parallel=mp, rows=rows)
        b = plan_serve_shrink(alive, model_parallel=mp, rows=rows)
        assert (a.n_devices, a.mesh_shape, a.global_batch, a.dropped) == (
            b.n_devices, b.mesh_shape, b.global_batch, b.dropped)
    a = elastic.plan_elastic(7, model_parallel=2, old_global_batch=9,
                             microbatch=2)
    b = plan_elastic(7, model_parallel=2, old_global_batch=9, microbatch=2)
    assert a.__dict__ == b.__dict__
    p = elastic.plan_serve_shrink(3, model_parallel=2, rows=8)
    assert p.mesh_shape == (3, 2) and p.n_devices == 6
    for bad in (lambda: elastic.plan_serve_shrink(0, rows=8),
                lambda: elastic.plan_elastic(1, model_parallel=2,
                                             old_global_batch=4)):
        with pytest.raises(ValueError):
            bad()
    rng = np.random.default_rng(11)
    dts = np.abs(rng.normal(0.01, 0.002, size=200))
    dts[[40, 90, 91, 150]] *= 30
    dets = [fault_tolerance.StragglerDetector(warmup_steps=4),
            StragglerDetector(warmup_steps=4)]
    flags = [[d.observe(i, float(dt)) for i, dt in enumerate(dts)]
             for d in dets]
    assert flags[0] == flags[1] and sum(flags[0]) >= 3
    assert dets[0].events == dets[1].events


# -------------------------------------------------------------- replay

@pytest.fixture(scope="module")
def base2(models):
    """The port's undisturbed 2-shard run of ``requests``."""
    _, _, cfg, port = models
    out, _ = drive(ServeRuntime(port, sc_port(cfg, n_shards=2), ROWS,
                                chunk=4, device="cpu"), requests(cfg),
                   Request)
    return out


def test_kill_shard_replay_token_identical(models, base2):
    """Killing shard 1 at step 3: the survivors untouched, the lost stream
    replayed to completion on shard 0, all token-identical to the
    undisturbed 2-shard run and to the reference's same arm; the
    recovery counters equal the reference's; no new step signature."""
    cfg_r, ref, cfg, port = models
    runs = {}
    for name, sup, rt, req in (
            ("port", RecoverySupervisor(),
             ServeRuntime(port, sc_port(cfg, n_shards=2), ROWS, chunk=4,
                          device="cpu"), Request),
            ("ref", RefSupervisor(),
             RefRuntime(ref, sc_ref(cfg_r, n_shards=2), ROWS, chunk=4),
             RefRequest)):
        def on_step(rt, step, sup=sup):
            if step == 3:
                assert sup.kill_shard(rt, 1), "no live stream on shard 1"
                assert 1 in rt.sched.dead_shards
            sup.note_step()
            return rt

        out, rt = drive(rt, requests(cfg), req, on_step=on_step)
        runs[name] = (out, rt, sup)
    (out, rt, sup), (want, rt_r, sup_r) = runs["port"], runs["ref"]
    assert out == base2 == want
    assert rt.pool.dead_shards == {1} == rt_r.pool.dead_shards
    assert recovery_counts(sup.stats) == recovery_counts(sup_r.stats)
    assert sup.stats["replay_prefill_tokens"] > 0
    assert (len(sup.stats["recovery_latency_s"])
            == sup.stats["requests_replayed"] >= 1)
    assert all(v == 1 for v in rt.trace_counts.values())
    assert sup.shrink_plans[-1].mesh_shape == (1, 1)
    assert rt.stats["prefill_events"] == rt_r.stats["prefill_events"]


def test_straggler_fenced_before_failure(models, base2):
    """Shard 1's step times degrade 50x alone from step 4: it is fenced
    through the kill path, its streams replay, and every token equals
    the undisturbed run."""
    _, _, cfg, port = models
    sup = RecoverySupervisor()
    assert not sup.fencing_enabled
    sup.enable_straggler_fencing(warmup_steps=3)
    assert sup.fencing_enabled
    fenced = []

    def on_step(rt, step):
        times = {s: 0.01 for s in range(2) if s not in rt.sched.dead_shards}
        if step >= 4 and 1 in times:
            times[1] = 0.5
        got = sup.observe_shard_times(rt, times)
        if got is not None:
            fenced.append(got)
        sup.note_step()
        return rt

    out, rt = drive(ServeRuntime(port, sc_port(cfg, n_shards=2), ROWS,
                                 chunk=4, device="cpu"), requests(cfg),
                    Request, on_step=on_step)
    assert fenced == [1] and rt.pool.dead_shards == {1}
    assert sup.stats["stragglers_fenced"] == 1 == sup.stats["shards_killed"]
    assert sup.stats["global_slow_steps"] == 0
    assert out == base2
    assert all(v == 1 for v in rt.trace_counts.values())


def test_straggler_fencing_on_injected_times_as_the_reference(models):
    """Both packages' supervisors fed the same injected per-shard step
    times on the same arm — a global stall at step 4, shard 1 alone 50x
    slow from step 6 — fence the same shard at the same step, count the
    same global slow steps, kill and replay as the reference does, and
    serve the same tokens.  (The CLI's ``stragglers:`` counts read the
    wall clock, so ``cli_counts`` masks them.)"""
    cfg_r, ref, cfg, port = models
    runs = {}
    for name, sup, rt, req in (
            ("port", RecoverySupervisor(),
             ServeRuntime(port, sc_port(cfg, n_shards=2), ROWS, chunk=4,
                          device="cpu"), Request),
            ("ref", RefSupervisor(),
             RefRuntime(ref, sc_ref(cfg_r, n_shards=2), ROWS, chunk=4),
             RefRequest)):
        sup.enable_straggler_fencing(warmup_steps=3)
        fenced = []

        def on_step(rt, step, sup=sup, fenced=fenced):
            live = [s for s in range(2) if s not in rt.sched.dead_shards]
            times = {s: 0.5 if step == 4 else 0.01 for s in live}
            if step >= 6 and 1 in times:
                times[1] = 0.5
            got = sup.observe_shard_times(rt, times)
            if got is not None:
                fenced.append((step, got))
            sup.note_step()
            return rt

        out, rt = drive(rt, requests(cfg), req, on_step=on_step)
        runs[name] = (out, rt, sup, fenced)
    (out, rt, sup, fenced), (want, rt_r, sup_r, fenced_r) = (runs["port"],
                                                           runs["ref"])
    assert fenced == fenced_r and [s for _, s in fenced] == [1]
    assert sup.stats["global_slow_steps"] == 1
    assert recovery_counts(sup.stats) == recovery_counts(sup_r.stats)
    assert rt.pool.dead_shards == {1} == rt_r.pool.dead_shards
    assert out == want


def test_global_slowdown_is_not_fenced(models):
    """Every shard slow at once is a global stall: counted, not fenced;
    the sole shard of a one-shard runtime is never fenced."""
    _, _, cfg, port = models
    rt = ServeRuntime(port, sc_port(cfg, n_shards=2), ROWS, chunk=4,
                      device="cpu")
    sup = RecoverySupervisor()
    assert sup.observe_shard_times(rt, {0: 9.9, 1: 0.01}) is None
    sup.enable_straggler_fencing(warmup_steps=3)
    for _ in range(5):
        assert sup.observe_shard_times(rt, {0: 0.01, 1: 0.01}) is None
    assert sup.observe_shard_times(rt, {0: 0.5, 1: 0.5}) is None
    assert sup.stats["global_slow_steps"] == 1
    assert sup.stats["stragglers_fenced"] == 0 and not rt.sched.dead_shards
    single = ServeRuntime(port, sc_port(cfg), ROWS, chunk=4, device="cpu")
    for _ in range(5):
        sup.observe_shard_times(single, {0: 0.01})
    assert sup.observe_shard_times(single, {0: 0.9}) is None
    assert not single.sched.dead_shards


def test_kill_shard_guards(models):
    """The reference's guards: one shard, a dead shard, the last one; a
    killed shard's rows take no handoff and its tables read all -1."""
    _, _, cfg, port = models
    with pytest.raises(ValueError, match="n_shards >= 2"):
        ServeRuntime(port, sc_port(cfg), ROWS, chunk=4,
                     device="cpu").kill_shard(0)
    with pytest.raises(ValueError, match="not divisible by n_shards"):
        ServeRuntime(port, sc_port(cfg, n_shards=2), 3, chunk=4,
                     device="cpu")
    rt = ServeRuntime(port, sc_port(cfg, n_shards=2), ROWS, chunk=4,
                      device="cpu")
    assert rt.free_rows() == [0, 1]
    assert rt.kill_shard(1) == []
    assert rt.free_rows() == [0]
    assert (rt.cache["bt"][1] == -1).all()
    with pytest.raises(ValueError, match="already dead"):
        rt.kill_shard(1)
    with pytest.raises(ValueError, match="last surviving"):
        rt.kill_shard(0)


def _fuzz_arm(models, arrivals, *, lanes=None, events, n_shards=2,
              mode="chunked"):
    """The same arm on both packages: (port stats, reference stats)."""
    cfg_r, ref, cfg, port = models
    kw = dict(chunk=4, events=events, prefill_mode=mode)
    if lanes is not None:
        spec = lambda cls: (cls(n_mux=1, rows=ROWS, chunk=4, role="prefill"),
                            cls(n_mux=1, rows=ROWS, chunk=4, role="decode"))
        got = cli.run_continuous({1: port}, sc_port(cfg, n_shards=n_shards),
                                 ROWS, copy_arrivals(arrivals), device="cpu",
                                 lanes=spec(LaneSpec), use_kernels=False,
                                 **kw)
        want = ref_run_continuous({1: ref}, sc_ref(cfg_r, n_shards=n_shards),
                                  ROWS, copy_arrivals(arrivals),
                                  lanes=spec(RefLaneSpec), **kw)
        pools = zip(got["pools"], want["pools"])
    else:
        got = cli.run_continuous(port, sc_port(cfg, n_shards=n_shards), ROWS,
                                 copy_arrivals(arrivals), device="cpu",
                                 use_kernels=False, **kw)
        want = ref_run_continuous(ref, sc_ref(cfg_r, n_shards=n_shards),
                                  ROWS, copy_arrivals(arrivals), **kw)
        pools = [(got["pool"], want["pool"])]
    assert tokens(got, arrivals) == tokens(want, arrivals)
    for p, r in pools:
        assert p.n_used_blocks == 0 and p.dead_shards == r.dead_shards
        p.check_invariants()
        assert p.dump_state() == r.dump_state()
    for k in ("prefill_events", "prefill_tokens", "decode_steps"):
        assert got[k] == want[k], k
    assert (recovery_counts(got["recovery"])
            == recovery_counts(want["recovery"]))
    return got, want


@pytest.mark.parametrize("seed,mode", [(0, "chunked"), (1, "chunked"),
                                       (2, "blocking")])
def test_fuzz_kill_shard(models, seed, mode):
    """The fuzz's kill-shard arm (shard 1 at step 4; seeds 0 and 1, and a
    blocking-prefill run whose whole-prompt writes take the per-row trash
    too): the reference's tokens, prefill events, recovery counters and
    final pool; each stream equals its solo greedy run; no new step
    signature."""
    _, _, cfg, port = models
    arrivals = _schedule(cfg, seed)
    got, _ = _fuzz_arm(models, arrivals, mode=mode, events=[
        {"step": KILL_STEP, "op": "kill_shard", "shard": 1}])
    assert got["pool"].dead_shards == {1}
    assert got["recovery"]["shards_killed"] == 1
    assert (len(got["recovery"]["recovery_latency_s"])
            == got["recovery"]["requests_replayed"])
    assert all(v == 1 for v in got["trace_counts"].values())
    out = tokens(got, arrivals)
    for uid, (_, prompt, max_new) in enumerate(arrivals):
        want = engine.greedy_generate(port, sc_port(cfg),
                                      torch.as_tensor(prompt)[None],
                                      steps=max_new)[0]
        assert out[uid][1] == want.tolist(), uid


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_disagg_kill_shard(models, seed):
    """The fuzz's disaggregated arm with the decode lane's shard 1 killed
    at step 4: its rows bounce through the router to the prefill lane,
    replay and hand off again; tokens, handoffs and recovery counters
    equal the reference's; the decode lane still never prefills."""
    arrivals = _schedule(models[2], seed)
    got, want = _fuzz_arm(models, arrivals, lanes=True, events=[
        {"step": KILL_STEP, "op": "kill_shard", "shard": 1, "lane": 1}])
    pre, dec = got["lanes"]
    assert dec["prefill_events"] == 0 and pre["decode_steps"] == 0
    assert got["pools"][1].dead_shards == {1}
    assert got["routing"] == want["routing"]


# ------------------------------------------------------------------- CLI

CLI_BASE = ["--continuous", "--cache", "paged", "--requests", "4",
            "--prompt-len", "6", "--new-tokens", "3", "--block-size", "4",
            "--chunk", "4", "--mux-n", "1"]
CLI_CASES = {
    "kill": ["--shards", "2", "--kill-shard", "4:1"],
    "fence": ["--shards", "2", "--fence-stragglers"],
    "lanes-kill": ["--lanes", "1,2", "--slo-mix", "latency=1",
                   "--shards", "2", "--kill-shard", "3:1"],
}


def cli_counts(out: str):
    """A serve CLI's count lines (wall-clock figures dropped).  The two
    counts of the ``stragglers:`` line are wall-clock figures too: they
    come from each CLI's own step times, so a loaded machine can make one
    step slow in one CLI only
    (``test_straggler_fencing_on_injected_times_as_the_reference`` holds
    the fencing to the reference on injected times)."""
    got = []
    for line in out.splitlines():
        line = re.sub(r"in [0-9.]+s|[0-9.]+ tok/s|goodput [0-9.]+|"
                      r"attainment [0-9.]+|× [0-9.]+|/cpu|"
                      r"; (worst recovery latency|restore) [0-9.]+ms", "",
                      line)
        line = re.sub(r"^stragglers: [0-9]+ fenced, [0-9]+ global",
                      "stragglers: <n> fenced, <n> global", line)
        line = line.replace("compiled [", "step signatures [")
        if line.startswith(("continuous[", "  lane", "routing[", "disagg:",
                            "recovery:", "stragglers:")):
            got.append(line)
    return got


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_shards_print_the_reference_counts(capsys, case):
    from repro.launch import serve as ref_cli
    assert cli.main(CLI_BASE + CLI_CASES[case] + ["--device", "cpu"]) == 0
    got = cli_counts(capsys.readouterr().out)
    assert ref_cli.main(CLI_BASE + CLI_CASES[case]) == 0
    want = cli_counts(capsys.readouterr().out)
    assert got == want
    assert any(ln.startswith(("recovery:", "stragglers:")) for ln in got)
