"""The port's lane and handoff substrate against the reference on the CPU:
``KVPool`` quotas and ``migrate_rows``, ``copy_pages`` /
``copy_cache_pages``, the scheduler's lane tags and handoff plans,
``engine.lane_config`` and ``ServeRuntime`` roles, ``load()`` and
``handoff_to``.

  * quotas, migration and page copies: the cases of
    ``tests/test_kvpool.py`` (unsharded) on the port; ``copy_pages`` bit
    for bit over fp32, bf16, int8 and fp8 pages, and equal to the
    reference's copy of the same pages;
  * a seeded alloc / append / free / migrate churn through a port pool
    pair and a reference pool pair in lockstep: the same outcomes, block
    tables and free lists after every operation;
  * the scheduler cases of ``tests/test_scheduler.py`` (lane tags, the
    handoff round trip);
  * ``lane_config`` equal to the reference's field for field;
  * two runtimes, a prefill lane and a decode lane: every migrated page
    (payload, scales, positions) equals its source taken just before the
    move, the roles' refusals and the stats counters.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import engine as ref_engine
from repro.serve import kvpool as ref_kvpool
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.models import TransformerLM
from repro_torch.serve import engine, kvpool
from repro_torch.serve.batcher import Request
from repro_torch.serve.kvpool import (KVPool, PoolError, PoolExhausted,
                                      copy_pages, init_pages, paged_write)
from repro_torch.serve.runtime import ServeRuntime
from repro_torch.serve.scheduler import ContinuousScheduler

torch.set_num_threads(2)


# ---------------------------------------------------------------- quotas

def test_quota_caps_allocation_below_capacity():
    p = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4, quota=3)
    assert p.headroom == 3 and p.ceiling == 8
    p.allocate("a", 12)
    assert p.headroom == 0 and p.n_free_blocks == 5
    with pytest.raises(PoolExhausted):
        p.allocate("b", 1)
    p.check_invariants()
    p.free("a")
    assert p.headroom == 3
    assert p.occupancy_stats() == [{"used": 0, "free": 8, "headroom": 3,
                                    "quota": 3, "occupancy": 0.0}]


def test_quota_shrink_below_usage_blocks_growth_only():
    p = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4)
    p.allocate("a", 12)
    p.set_quota(1)
    assert p.headroom == 0 and p.n_used_blocks == 3
    with pytest.raises(PoolExhausted):
        p.append("a", 4)
    p.free("a")
    assert p.headroom == 1
    p.allocate("b", 4)
    p.check_invariants()


def test_quota_none_uncaps():
    p = KVPool(num_blocks=5, block_size=4, max_blocks_per_seq=4, quota=0)
    with pytest.raises(PoolExhausted):
        p.allocate("a", 1)
    p.set_quota(None)
    p.allocate("a", 1)
    assert p.headroom == 3
    with pytest.raises(ValueError):
        p.set_quota(-1)


# ------------------------------------------------------------- migration

def test_migrate_rows_frees_source_and_lands_whole():
    src = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4)
    dst = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4)
    src.allocate("a", 10)
    sb, db = src.migrate_rows("a", dst)
    assert len(sb) == len(db) == 3
    assert not src.has("a") and dst.has("a")
    assert dst.num_tokens("a") == 10
    assert src.n_free_blocks == 8 and dst.n_used_blocks == 3
    dst.append("a")
    assert dst.num_tokens("a") == 11
    src.check_invariants()
    dst.check_invariants()


def test_migrate_rows_rejects_self_and_missing():
    src = KVPool(num_blocks=5, block_size=4, max_blocks_per_seq=2)
    dst = KVPool(num_blocks=5, block_size=4, max_blocks_per_seq=2)
    with pytest.raises(PoolError):
        src.migrate_rows("ghost", dst)
    src.allocate("a", 4)
    with pytest.raises(PoolError):
        src.migrate_rows("a", src)
    src.migrate_rows("a", src, dst_cid="b")
    assert not src.has("a") and src.has("b")
    src.check_invariants()


def test_migrate_rows_atomic_on_dst_exhaustion():
    src = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4)
    dst = KVPool(num_blocks=3, block_size=4, max_blocks_per_seq=4)
    src.allocate("a", 12)
    with pytest.raises(PoolExhausted):
        src.migrate_rows("a", dst)
    assert src.has("a") and src.num_tokens("a") == 12
    assert not dst.has("a") and dst.n_used_blocks == 0
    src.check_invariants()
    dst.check_invariants()


def test_migrate_rows_respects_dst_quota():
    src = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4)
    dst = KVPool(num_blocks=9, block_size=4, max_blocks_per_seq=4, quota=1)
    src.allocate("a", 8)
    with pytest.raises(PoolExhausted):
        src.migrate_rows("a", dst)
    assert src.has("a") and not dst.has("a")
    dst.set_quota(None)
    src.migrate_rows("a", dst)
    assert dst.num_tokens("a") == 8
    dst.check_invariants()


# ------------------------------------------------------------ page copies

STORAGES = {"fp32": (torch.float32, jnp.float32, None),
            "bf16": (torch.bfloat16, jnp.bfloat16, None),
            "int8": (torch.float32, jnp.float32, "int8"),
            "fp8": (torch.float32, jnp.float32, "fp8")}


def _bits(x):
    """A tensor or array as its raw integer bits."""
    a = np.asarray(x.view(torch.uint8) if isinstance(x, torch.Tensor)
                   and x.dtype == torch.float8_e4m3fn else
                   (x.view(torch.int16) if isinstance(x, torch.Tensor)
                    and x.dtype == torch.bfloat16 else x))
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    if a.dtype.itemsize == 2:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype.kind == "f" else a


def _written_pages(storage, bs=4, hk=2, hd=8, n=6, tokens=6, seed=0):
    """Port and reference pages of one layer with ``tokens`` K/V entries
    written for client 0 (tail page half filled), and the pools."""
    dt, jdt, quant = STORAGES[storage]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((1, tokens, hk, hd)).astype(np.float32)
    v = rng.standard_normal((1, tokens, hk, hd)).astype(np.float32)
    pool = KVPool(num_blocks=n, block_size=bs, max_blocks_per_seq=3)
    pool.allocate(0, tokens)
    port = init_pages(n, bs, hk, hd, dt, quant=quant, device="cpu")
    paged_write(port, torch.from_numpy(k).to(dt),
                torch.from_numpy(v).to(dt), torch.arange(tokens)[None],
                block_tables=torch.from_numpy(pool.table_array([0])))
    ref = ref_kvpool.init_pages(n, bs, hk, hd, jdt, quant=quant)
    ref["bt"] = jnp.asarray(pool.table_array([0]))
    ref = ref_kvpool.paged_write(ref, jnp.asarray(k, jdt),
                                 jnp.asarray(v, jdt), jnp.arange(tokens)[None])
    return pool, port, ref


@pytest.mark.parametrize("storage", list(STORAGES))
def test_copy_pages_bit_exact(storage):
    """Migrated pages are bit for bit their source: payload, scales and
    the position mask (the tail page's unwritten slots stay -1); the
    destination's other pages are untouched; and the copy equals the
    reference's copy of the same pages."""
    dt, jdt, quant = STORAGES[storage]
    src_pool, src, ref_src = _written_pages(storage)
    dst_pool = KVPool(num_blocks=6, block_size=4, max_blocks_per_seq=3)
    dst_pool.allocate("pad", 4)
    dst = init_pages(6, 4, 2, 8, dt, quant=quant, device="cpu")
    before = {k: x.clone() for k, x in dst.items()}
    sb, db = src_pool.migrate_rows(0, dst_pool)
    assert copy_pages(src, dst, sb, db) is dst
    ref_dst = ref_kvpool.copy_pages(
        ref_src, ref_kvpool.init_pages(6, 4, 2, 8, jdt, quant=quant), sb, db)
    keys = ("kp", "vp", "ppos") + (("ksc", "vsc") if quant else ())
    assert set(keys) == set(dst)
    others = [i for i in range(6) if i not in db]
    for key in keys:
        assert torch.equal(_as_bits(dst[key][db]), _as_bits(src[key][sb]))
        assert torch.equal(_as_bits(dst[key][others]),
                           _as_bits(before[key][others]))
        np.testing.assert_array_equal(_bits(dst[key]), _bits(ref_dst[key]),
                                      err_msg=key)
    assert (dst["ppos"][db[-1], 2:] == -1).all()


def _as_bits(x):
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def test_copy_pages_rejects_dtype_mismatch():
    a = init_pages(4, 4, 1, 4, torch.float32, device="cpu")
    q = init_pages(4, 4, 1, 4, torch.float32, quant="int8", device="cpu")
    b = init_pages(4, 4, 1, 4, torch.bfloat16, device="cpu")
    with pytest.raises(ValueError):
        copy_pages(a, q, [1], [1])
    with pytest.raises(ValueError):
        copy_pages(a, b, [1], [1])
    with pytest.raises(ValueError):
        copy_pages(a, a, [1, 2], [1])
    assert copy_pages(a, q, [], []) is q


def test_copy_pages_within_one_cache():
    """src and dst may be one dict: a move inside one pool."""
    pool, pages, _ = _written_pages("int8")
    want = {k: x[[1, 2]].clone() for k, x in pages.items()}
    copy_pages(pages, pages, [1, 2], [4, 5])
    for k, x in pages.items():
        assert torch.equal(x[[4, 5]], want[k]) and torch.equal(x[[1, 2]],
                                                               want[k])


# ------------------------------------------ seeded churn, both packages

def _apply(pools, live, kind, cid, n):
    """One churn op on a pool pair; returns its outcome."""
    pa, pb = pools
    try:
        if kind == 0 and cid not in live:
            pa.allocate(cid, n)
            live[cid] = 0
            return "alloc"
        if kind == 1 and cid in live:
            return ("append", pools[live[cid]].append(cid, n))
        if kind == 2 and cid in live:
            pools[live.pop(cid)].free(cid)
            return "free"
        if kind == 3 and cid in live:
            s = live[cid]
            out = pools[s].migrate_rows(cid, pools[1 - s])
            live[cid] = 1 - s
            return ("migrate", out)
    except (PoolExhausted, ref_kvpool.PoolExhausted):
        return "exhausted"
    return "skip"


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_migrate_churn_matches_the_reference(seed):
    """alloc / append / free / migrate interleavings (the reference
    fuzz's op mix, the second pool under a quota for odd seeds) through
    both packages' pools in lockstep: every outcome, block table, length
    and free list equal after every op, invariants held, blocks
    conserved across the pair."""
    rng = np.random.default_rng(seed)
    quota = 6 if seed % 2 else None
    mk = lambda mod, q=None: mod.KVPool(num_blocks=11, block_size=4,
                                        max_blocks_per_seq=4, quota=q)
    port = (mk(kvpool), mk(kvpool, quota))
    ref = (mk(ref_kvpool), mk(ref_kvpool, quota))
    live_p, live_r = {}, {}
    for _ in range(300):
        op = (int(rng.integers(4)), int(rng.integers(6)),
              int(rng.integers(1, 12)))
        assert _apply(port, live_p, *op) == _apply(ref, live_r, *op), op
        for p, r in zip(port, ref):
            p.check_invariants()
            assert p._tables == r._tables and p._lens == r._lens
            assert p._free == r._free and p.headroom == r.headroom
        assert sum(p.n_used_blocks + p.n_free_blocks for p in port) == 20


# ------------------------------------------------------------- scheduler

def mk_req(uid, plen=4, max_new=4):
    return Request(uid=uid, prompt=list(range(1, plen + 1)), max_new=max_new)


def test_plans_carry_lane_tag():
    s = ContinuousScheduler(n_mux=1, backbone_batch=1, max_len=64, lane=3)
    s.submit(mk_req(0, plen=4, max_new=1))
    (ap,) = s.plan_admissions()
    assert ap.lane == 3 and ap.shard == 0
    (cp,) = s.plan_chunks(2)
    assert cp.lane == 3
    s.chunk_done(0, 4)
    assert s.plan_decode().lane == 3
    s.record_row_tokens(0, [9])
    (fp,) = s.plan_frees()
    assert fp.lane == 3
    assert s.queue_depth == 0


def test_handoff_plan_validation_and_roundtrip():
    src = ContinuousScheduler(n_mux=2, backbone_batch=2, max_len=64, lane=0)
    dst = ContinuousScheduler(n_mux=2, backbone_batch=2, max_len=64, lane=1)
    for i in range(2):
        src.submit(mk_req(i, max_new=3))
    src.plan_admissions()
    with pytest.raises(ValueError, match="mid-prefill"):
        src.plan_handoff(0, 1, 0, 4)
    src.chunk_done(0, 4)
    with pytest.raises(ValueError, match="no live streams"):
        src.plan_handoff(1, 1, 0, 4)
    plan = src.plan_handoff(0, 1, 1, 4)
    assert (plan.row, plan.dst_row, plan.lane, plan.dst_lane) == (0, 1, 0, 1)
    assert plan.uids == (0, 1) and plan.tokens == 4
    plan_taken = src.plan_handoff(0, 1, 0, 4)
    slots = src.retire_handoff(plan)
    assert src.n_active == 0 and not src.row_active(0)
    assert len(slots) == 2 and all(s.request is not None for s in slots)
    dst.submit(mk_req(9))
    dst.plan_admissions()
    with pytest.raises(ValueError, match="occupied"):
        dst.admit_handoff(plan_taken, slots)
    with pytest.raises(ValueError, match="width"):
        dst.admit_handoff(plan, slots[:1])
    dst.admit_handoff(plan, slots)
    assert dst.row_active(1)
    assert all(s.request.lane == 1 for s in dst.slots[1])
    for _ in range(3):
        dst.record_row_tokens(1, [7, 7])
    assert {r.uid for r in dst.completed} == {0, 1}
    for r in dst.completed:
        assert len(r.output) == 3 and r.lane == 1
    src.submit(mk_req(5))
    assert src.plan_admissions()


# ------------------------------------------------------------ lane_config

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("n_mux", [1, 2, 4, 8])
def test_lane_config_matches_the_reference(n_mux, kv_dtype):
    cfg = get_config("qwen2-1.5b", reduced=True)
    cfg_r = ref_config("qwen2-1.5b", reduced=True)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=20,
                            dtype=torch.float32, cache_layout="paged",
                            block_size=4, num_blocks=9, kv_dtype=kv_dtype)
    sc_r = RefServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=2), capacity=20,
                          dtype=jnp.float32, cache_layout="paged",
                          block_size=4, num_blocks=9, kv_dtype=kv_dtype)
    got, want = engine.lane_config(sc, n_mux), ref_engine.lane_config(
        sc_r, n_mux)
    assert dataclasses.asdict(got.mux) == dataclasses.asdict(want.mux)
    for f in ("capacity", "cache_layout", "block_size", "num_blocks",
              "kv_dtype", "kind", "max_blocks_per_seq", "kv_quant"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.cfg is sc.cfg
    for rows in (1, 2, 3):
        nb = rows * n_mux
        assert got.pool_blocks(nb) == want.pool_blocks(nb)
        assert got.pool_bytes(nb) == want.pool_bytes(nb)
    with pytest.raises(ValueError, match=">= 1"):
        engine.lane_config(sc, 0)


# -------------------------------------------------- runtimes and handoff

@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = TransformerLM.init(torch.Generator().manual_seed(0), cfg,
                                MuxSpec(n=2))
    return cfg, params


def _lane(cfg, params, role, lane, kv_dtype=None, chunk=4):
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=20,
                            dtype=torch.float32, cache_layout="paged",
                            block_size=4, kv_dtype=kv_dtype)
    return ServeRuntime(params, sc, 2, chunk=chunk, device="cpu", lane=lane,
                        role=role, use_kernels=False)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_handoff_moves_pages_bit_exact(model, kv_dtype):
    """A prefill lane's finished row moves into a decode lane: every page
    of every layer (payload, scales, positions) equals its source taken
    just before the move, the block tables follow the pools, the stats
    count the move, and the decode lane finishes the streams without a
    prefill."""
    cfg, params = model
    pre = _lane(cfg, params, "prefill", 0, kv_dtype)
    dec = _lane(cfg, params, "decode", 1, kv_dtype)
    dec.pool.allocate(0, 1)                      # offset the dst ids
    dec.pool.free(0)
    for uid in range(2):
        pre.submit(Request(uid=uid, prompt=list(range(5 + uid, 14 + uid)),
                           max_new=4))
    while not pre.handoff_ready():
        pre.step()
    assert pre.stats["decode_steps"] == 0
    (j,) = pre.handoff_ready()
    src_blocks = pre.pool.block_table(j)
    src_blocks = src_blocks[src_blocks >= 0].tolist()
    taken = [{k: x[src_blocks].clone() for k, x in c.items() if k != "bt"}
             for c in pre.cache["layers"]]
    load = dec.load()
    assert (load.lane, load.n_mux, load.slots, load.active) == (1, 2, 4, 0)
    (dst_row, *_) = dec.free_rows()
    plan = pre.handoff_to(dec, j, dst_row)
    assert plan.uids == (0, 1) and plan.dst_lane == 1
    dst_blocks = dec.pool.block_table(dst_row)
    dst_blocks = dst_blocks[dst_blocks >= 0].tolist()
    assert len(dst_blocks) == len(src_blocks)
    for c, want in zip(dec.cache["layers"], taken):
        for k, x in want.items():
            assert torch.equal(_as_bits(c[k][dst_blocks]), _as_bits(x)), k
    assert torch.equal(dec.cache["bt"][dst_row, :len(dst_blocks)],
                       torch.tensor(dst_blocks, dtype=torch.int32))
    assert (pre.cache["bt"][j] == -1).all() and pre.pool.n_used_blocks == 0
    nbytes = len(src_blocks) * 4 * pre.sc.kv_bytes_per_token()
    assert pre.stats["handoffs_out"] == dec.stats["handoffs_in"] == 1
    assert pre.stats["migrated_bytes"] == nbytes
    while dec.has_work():
        dec.step()
    assert dec.stats["prefill_events"] == 0
    assert sorted(r.uid for r in dec.stats["completed"]) == [0, 1]
    assert all(len(r.output) == 4 and r.lane == 1
               for r in dec.stats["completed"])
    assert dec.trace_counts == {"decode": 1}
    assert set(pre.trace_counts) <= {"prefill_4"}
    assert dec.pool.n_used_blocks == 0


def test_runtime_roles_and_refusals(model):
    cfg, params = model
    with pytest.raises(ValueError, match="role"):
        _lane(cfg, params, "both-ways", 0)
    with pytest.raises(ValueError, match="chunked prefill"):
        _lane(cfg, params, "prefill", 0, chunk=None)
    pre = _lane(cfg, params, "prefill", 0)
    assert pre.stats["lane"] == 0 and pre.stats["role"] == "prefill"
    with pytest.raises(ValueError, match="distinct"):
        pre.handoff_to(pre, 0, 0)
    sc1 = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), capacity=20,
                             dtype=torch.float32, cache_layout="paged",
                             block_size=4)
    narrow = ServeRuntime(params, sc1, 2, device="cpu", lane=1,
                          role="decode")
    with pytest.raises(ValueError, match="across widths"):
        pre.handoff_to(narrow, 0, 0)
    with pytest.raises(ValueError, match="geometry"):
        pre.handoff_to(_lane(cfg, params, "decode", 2, "int8"), 0, 0)
    # a decode lane never admits from its own queue
    dec = _lane(cfg, params, "decode", 3)
    dec.submit(Request(uid=0, prompt=[5, 6, 7], max_new=2))
    dec.step()
    assert dec.sched.queue_depth == 1 and dec.stats["prefill_events"] == 0


# ------------------------------------------------------------------- CLI

CLI_BASE = ["--continuous", "--cache", "paged", "--requests", "6",
            "--prompt-len", "6", "--new-tokens", "3", "--block-size", "4",
            "--chunk", "4"]
CLI_CASES = {
    "lanes": ["--lanes", "1,2", "--slo-mix", "latency=1,throughput=1"],
    "disagg": ["--disagg", "--prefill-lanes", "2", "--decode-lanes", "2"],
    "disagg-goodput": ["--disagg", "--prefill-lanes", "2",
                       "--decode-lanes", "2", "--route", "goodput"],
}


def _counts(out: str):
    """The counts of a serve CLI's lines: the served / prefill figures, per
    lane the requests, tokens and step signatures, the routing and
    handoff counters (wall-clock figures dropped)."""
    import re
    got = []
    for line in out.splitlines():
        line = re.sub(r"in [0-9.]+s|[0-9.]+ tok/s|goodput [0-9.]+|"
                      r"attainment [0-9.]+|× [0-9.]+|/cpu", "", line)
        line = line.replace("compiled [", "step signatures [")
        if line.startswith(("continuous[", "  lane", "routing[", "disagg:")):
            got.append(line)
    return got


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_lanes_print_the_reference_counts(capsys, tmp_path, case):
    """``--lanes`` / ``--disagg`` [``--route goodput``] with the telemetry
    flags: the port's CLI prints the reference CLI's counts on the same
    flags, and both write metrics with the same counters, the same
    Prometheus series and the same trace events per lane."""
    from repro.launch import serve as ref_cli
    from repro_torch.launch import serve as cli
    out = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, [])):
        m, t = tmp_path / f"{name}.json", tmp_path / f"{name}-trace.json"
        assert main(CLI_BASE + CLI_CASES[case] + extra + [
            "--metrics-out", str(m), "--trace-out", str(t),
            "--metrics-interval", "2"]) == 0
        text = capsys.readouterr().out
        assert f"metrics written to {m}" in text
        out[name] = (_counts(text), json.loads(m.read_text()),
                     m.with_suffix(".prom").read_text(),
                     json.loads(t.read_text()))
    (got, gm, gp, gt), (want, wm, wp, wt) = out["port"], out["ref"]
    assert got == want and len(got) >= 4
    assert gm["final"]["counters"] == wm["final"]["counters"]
    assert ([s["step"] for s in gm["snapshots"]]
            == [s["step"] for s in wm["snapshots"]])
    series = lambda text: sorted(ln.rsplit(" ", 1)[0]
                                 for ln in text.splitlines())
    assert series(gp) == series(wp)
    events = lambda doc: sorted((e["ph"], e["name"], e["pid"], e["tid"])
                                for e in doc["traceEvents"])
    assert events(gt) == events(wt)


@pytest.mark.parametrize("argv,match", [
    (["--disagg", "--lanes", "1,2", "--prefill-lanes", "2",
      "--decode-lanes", "2"], "--disagg replaces --lanes"),
    (["--disagg", "--prefill-lanes", "2"], "requires --prefill-lanes and"),
    (["--disagg", "--prefill-lanes", "2", "--decode-lanes", "2",
      "--prefill", "blocking"], "requires chunked prefill"),
    (["--lanes", "1,2", "--prefill-lanes", "2"], "require --disagg"),
    (["--route", "goodput"], "--route goodput requires --lanes or --disagg"),
    (["--disagg", "--prefill-lanes", "1,2", "--decode-lanes", "2"],
     "prefill widths [1] have no same-width decode lane"),
    (["--lanes", "1,2", "--lane-rows", "2"], "--lane-rows gives 1 entries"),
    (["--drain-lane", "3:2"], "--drain-lane/--add-lane require --lanes"),
    (["--lanes", "1,2", "--add-lane", "3"], "--add-lane expects N:N"),
    (["--lanes", "1,2", "--slo-mix", "fast=1"], "--slo-mix: expected"),
    (["--lanes", "1,2", "--cache", "ring"], "require --continuous --cache "
                                            "paged"),
    (["--kill-shard", "3:1"], "--kill-shard needs >= 2 data shards"),
    (["--shards", "2", "--cache", "ring"],
     "--shards requires --continuous --cache paged"),
    (["--lanes", "1,2", "--restart-step", "3", "--ckpt-dir", "x"],
     "--restart-step supports the single-runtime paged mode"),
    (["--fence-stragglers"], "--fence-stragglers needs >= 2 data shards"),
    (["--mesh", "2,2", "--shards", "4"],
     "--shards 4 must match the --mesh data axis (2)"),
])
def test_cli_refuses_as_the_reference(capsys, argv, match):
    """The reference CLI's refusals are argparse errors (its refusals of
    the shard, recovery and mesh flags included)."""
    from repro_torch.launch import serve as cli
    with pytest.raises(SystemExit) as e:
        cli.main(["--continuous", "--cache", "paged", "--device", "cpu",
                  *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_cli_lane_resize(capsys):
    """``--drain-lane`` / ``--add-lane`` resize the lane set under
    traffic and report it; the counts are the reference CLI's."""
    from repro.launch import serve as ref_cli
    from repro_torch.launch import serve as cli
    flags = CLI_BASE + ["--lanes", "1,2", "--slo-mix", "throughput=1",
                        "--drain-lane", "3:2", "--add-lane", "5:4"]
    assert cli.main(flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "resize: 1 drains / 1 adds (1 lanes retired)" in got
    assert ref_cli.main(flags) == 0
    assert _counts(got) == _counts(capsys.readouterr().out)
