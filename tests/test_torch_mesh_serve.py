"""Mesh serving of the port (``repro_torch.launch.mesh``, the serve mesh
over ``torch.distributed``) against the JAX reference, on gloo process
groups on the CPU.

One spawn of ranks per mesh shape, shared by a module fixture: each rank
runs every case of its shape and returns its results, and the tests read
them.  Each spawn has its own timeout and rendezvouses through a
``file://`` store under ``tmp_path``, so a hung rank fails one fixture.
The ranks import this module to find their work: it imports no JAX at
module level (the reference is imported inside the fixtures).

  * ``sharded_paged_attention`` / ``sharded_paged_prefill_attention`` on
    (2, 1) and (2, 2) (heads split), fp32 and int8 pages, each rank's
    rows against ``repro.kernels.ref`` on the whole inputs within 1e-5;
  * ``run_continuous`` on (2, 1), (2, 2) and (1, 4) (sequence-sharded
    attention: 4 heads over 2 KV heads on a model axis of 4) reproduces
    the reference's solo ``greedy_generate`` tokens, with the reference
    suite's config, arrivals and chunk, one decode signature and one per
    prefill bucket; reduced granite-moe-3b-a800m on (1, 2) (its 8 experts
    split 4 a rank, its vocabulary cut to the odd 515 so that the
    embedding takes the d axis, as the full model's 49155 does) equals
    the reference's single-device tokens;
  * shard-local backpressure, admission retry on a sibling shard and
    preemption on (2, 1), each stream equal to its solo greedy run;
  * the reference's validation errors and the ``--mesh`` CLI against the
    unsharded CLI's counts.
"""
import functools
import re

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import _head_axis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import run_continuous
from repro_torch.models import TransformerLM
from repro_torch.serve import engine
from repro_torch.serve.batcher import Request
from repro_torch.serve.runtime import ServeRuntime

SPAWN_TIMEOUT = 120
KERNEL_TOL = 1e-5
GRANITE_VOCAB = 515       # odd: the embedding falls back to the d axis


# ------------------------------------------------------------ inputs

def _sharded_pool(lens, *, n_shards, bps, block_size, max_blocks, hkv, dh,
                  seed):
    """Pages with ``ShardedKVPool``'s layout (the reference suite's
    ``_sharded_pool``): row r lives on shard r // (rows / n_shards), shard
    s owns blocks [s * bps, (s + 1) * bps) with local block 0 its trash."""
    rng = np.random.default_rng(seed)
    num_blocks = n_shards * bps
    kp = rng.standard_normal((num_blocks, block_size, hkv, dh), np.float32)
    vp = rng.standard_normal((num_blocks, block_size, hkv, dh), np.float32)
    bt = np.full((len(lens), max_blocks), -1, np.int32)
    ppos = np.full((num_blocks, block_size), -1, np.int32)
    free = {s: list(range(s * bps + 1, (s + 1) * bps))
            for s in range(n_shards)}
    rps = len(lens) // n_shards
    for r, n in enumerate(lens):
        if n < 0:
            continue
        blocks = [free[r // rps].pop(0) for _ in range(-(-n // block_size))]
        bt[r, :len(blocks)] = blocks
        for t in range(n):
            ppos[blocks[t // block_size], t % block_size] = t
    return kp, vp, bt, ppos


@functools.lru_cache(maxsize=None)
def _kernel_inputs():
    """The reference suite's two cases (8 query heads over 2 KV heads of
    16, pages of 8, 2 shards of 8 blocks), fp32 and int8 pages."""
    from repro.core import quant as ref_quant
    import jax.numpy as jnp
    cases = {}
    for kind in ("fp32", "int8"):
        for op, lens, lq in (("decode", [20, 9, 13, -1], 1),
                             ("prefill", [20, 9, 13, 5], 4)):
            kp, vp, bt, ppos = _sharded_pool(
                lens, n_shards=2, bps=8, block_size=8, max_blocks=4, hkv=2,
                dh=16, seed=len(cases))
            rng = np.random.default_rng(100 + len(cases))
            case = {"q": rng.standard_normal((4, lq, 8, 16), np.float32),
                    "bt": bt, "ppos": ppos, "kp": kp, "vp": vp}
            if op == "decode":
                case["vecs"] = (np.asarray([19, 8, 12, -1], np.int32),)
            else:
                case["vecs"] = (np.asarray([16, 5, 9, 1], np.int32),
                                np.asarray([4, 4, 4, 3], np.int32))
            if kind == "int8":
                for name in ("kp", "vp"):
                    q8, sc = ref_quant.quantize_kv(jnp.asarray(case[name]),
                                                   "int8")
                    case[name] = np.asarray(q8)
                    case[name[0] + "sc"] = np.asarray(sc)
            cases[(kind, op)] = case
    return cases


def _ref_kernel(case, op):
    from repro.kernels import ref
    import jax.numpy as jnp
    args = [jnp.asarray(case[k]) for k in ("q", "kp", "vp")]
    rest = [jnp.asarray(case["bt"]), jnp.asarray(case["ppos"]),
            *map(jnp.asarray, case["vecs"])]
    if "ksc" in case:
        fn = (ref.paged_attention_quant_ref if op == "decode"
              else ref.paged_prefill_attention_quant_ref)
        return np.asarray(fn(*args, jnp.asarray(case["ksc"]),
                             jnp.asarray(case["vsc"]), *rest))
    fn = (ref.paged_attention_ref if op == "decode"
          else ref.paged_prefill_attention_ref)
    return np.asarray(fn(*args, *rest))


def _staggered(vocab, lens, seed=0, max_new=4, every=2):
    rng = np.random.default_rng(seed)
    return [(i * every, rng.integers(4, vocab, size=(n,)).astype(np.int32),
             max_new) for i, n in enumerate(lens)]


def _same_prompt_arrivals(vocab, seed, n, length, max_new=4):
    rng = np.random.default_rng(seed)
    return [(0, rng.integers(4, vocab, size=(length,)).astype(np.int32),
             max_new) for _ in range(n)]


def _sc(cfg, n_shards=1, capacity=48, **kw):
    return engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), capacity=capacity,
                              dtype=torch.float32, cache_layout="paged",
                              block_size=4, n_shards=n_shards, **kw)


# ------------------------------------------------------------ the ranks

def _kernel_shard(mesh, cases):
    """This rank's shard of each kernel case and its output."""
    d, m = mesh.coords["data"], mesh.coords["model"]
    out = {}
    for (kind, op), c in cases.items():
        rows = c["q"].shape[0] // mesh.shape["data"]
        bps = c["kp"].shape[0] // mesh.shape["data"]
        r, b = slice(d * rows, (d + 1) * rows), slice(d * bps, (d + 1) * bps)
        h, hkv = c["q"].shape[2], c["kp"].shape[2]
        hs = hks = slice(None)
        if _head_axis(mesh.shape, h, hkv):
            n, nk = h // mesh.shape["model"], hkv // mesh.shape["model"]
            hs, hks = slice(m * n, (m + 1) * n), slice(m * nk, (m + 1) * nk)
        t = torch.as_tensor
        kw = {}
        if "ksc" in c:
            kw = {"k_scales": t(c["ksc"][b, :, hks]),
                  "v_scales": t(c["vsc"][b, :, hks])}
        fn = (ops.sharded_paged_attention if op == "decode"
              else ops.sharded_paged_prefill_attention)
        o = fn(mesh, t(c["q"][r, :, hs]), t(c["kp"][b, :, hks]),
               t(c["vp"][b, :, hks]), t(c["bt"][r]), t(c["ppos"][b]),
               *(t(v[r]) for v in c["vecs"]), **kw)
        out[(kind, op)] = (r, hs, o.numpy())
    return out


def _serve(mesh, ref_params, arch, vocab, n_shards, arrivals, chunk=8,
           rows=2, events=None, ckpt_dir=None, **sc_kw):
    cfg = get_config(arch, reduced=True)
    if vocab:
        cfg = cfg.replace(vocab_size=vocab)
    params = interop.params_from_reference(ref_params, cfg, device="cpu")
    sc = _sc(cfg, n_shards=n_shards, **sc_kw)
    ops.reset_counts()
    stats = run_continuous(params, sc, rows,
                           [(t, p.copy(), m) for t, p, m in arrivals],
                           chunk=chunk, device="cpu", mesh=mesh,
                           events=events, ckpt_dir=ckpt_dir)
    pool = stats["pool"]
    pool.check_invariants()
    return {"out": {tuple(r.prompt): list(r.output)
                    for r in stats["completed"]},
            "trace_counts": dict(stats["trace_counts"]),
            "used_blocks": pool.n_used_blocks,
            "sharded": {w.__name__: w.calls for w in ops.SHARDED},
            "collectives": dict(mesh.counts),
            "prefill_tokens": stats["prefill_tokens"],
            "restarts": stats["recovery"]["restarts"]}


def _admission_retry(mesh, ref_params, prompts):
    """The reference suite's sibling-shard retry: 2 shards of 3 blocks, a
    2-block cap a sequence, admission order rows [0, 2, 1, 3]."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = interop.params_from_reference(ref_params, cfg, device="cpu")
    rt = ServeRuntime(params, _sc(cfg, n_shards=2, capacity=8, num_blocks=6),
                      4, chunk=4, device="cpu", mesh=mesh)
    for uid, p in enumerate(prompts):
        rt.submit(Request(uid=uid, prompt=[int(t) for t in p], max_new=2))
    rt.step()
    first = {"queue": len(rt.sched.queue),
             "placed": sorted({r for rows_, _ in rt.stats["prefill_log"]
                               for r in rows_})}
    while rt.has_work():
        rt.step()
    rt.pool.check_invariants()
    return {**first, "used_blocks": rt.pool.n_used_blocks,
            "out": {r.uid: list(r.output) for r in rt.stats["completed"]}}


def _snapshot(mesh, ref_params, arrivals, steps):
    """Serve ``steps`` engine steps, then ``snapshot_state``: the tree as
    numpy leaves and the metadata (every rank gathers; all return it)."""
    from repro_torch.serve.recovery import snapshot_state
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = interop.params_from_reference(ref_params, cfg, device="cpu")
    rt = ServeRuntime(params, _sc(cfg, n_shards=2), 2, chunk=8,
                      device="cpu", mesh=mesh)
    for uid, (_, p, m) in enumerate(arrivals):
        rt.submit(Request(uid=uid, prompt=[int(t) for t in p], max_new=m))
    for _ in range(steps):
        rt.step()
    tree, meta = snapshot_state(rt)
    return _numpy_tree(tree), meta


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_numpy_tree(v) for v in t]
    return t if t is None else t.view(torch.uint8).numpy() \
        if t.dtype == torch.float8_e4m3fn else t.numpy()


def _elastic(mesh):
    """The shrink plan's mesh after losing one of two data shards on
    (2, 2): ranks 0 and 1 hold it, the others are past it."""
    from repro_torch.runtime import make_elastic_mesh, plan_serve_shrink
    plan = plan_serve_shrink(1, model_parallel=2, rows=2)
    m = make_elastic_mesh(plan, device="cpu")
    return None if m is None else (m.shape, m.coords)


def _rank_work(mesh, work):
    """Every case of one mesh shape, on this rank."""
    torch.set_num_threads(1)
    out = {}
    for name, (fn, args, kw) in work.items():
        out[name] = fn(mesh, *args, **kw)
    return out


# ------------------------------------------------------------ fixtures

@functools.lru_cache(maxsize=None)
def _weights(arch, vocab=None):
    """(the reference's reduced config, its param tree, the same with numpy
    leaves) at N=1: the port's seeded init carried to the reference's
    layout (the reference's eager init costs seconds a model)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    cfg_r, cfg = ref_config(arch, reduced=True), get_config(arch,
                                                            reduced=True)
    if vocab:
        cfg_r, cfg = cfg_r.replace(vocab_size=vocab), cfg.replace(
            vocab_size=vocab)
    port = TransformerLM.init(torch.Generator().manual_seed(0), cfg,
                              MuxSpec(n=1))
    np_params = interop.params_to_reference(port, cfg)
    return cfg_r, jax.tree.map(jnp.asarray, np_params), np_params


@pytest.fixture(scope="module")
def qwen():
    """The reduced qwen2-1.5b of every qwen case (``_weights``)."""
    return _weights("qwen2-1.5b")


def _ref_solo(cfg, params, prompt, steps):
    """The reference's solo greedy_generate, as its suite runs it, with its
    two steps jitted (eager, each recompiles its layer scan; fp32 gives the
    same numbers either way)."""
    import jax
    import jax.numpy as jnp
    from repro.core import MuxSpec as RefMux
    from repro.serve import ServeConfig as RefSC
    from repro.serve import engine as ref_engine
    sc1 = RefSC(cfg=cfg, kind="lm", mux=RefMux(n=1), capacity=48,
                dtype=jnp.float32, cache_layout="paged", block_size=4)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("prefill", "decode_step"):
            mp.setattr(ref_engine, name, _jitted(getattr(ref_engine, name)))
        out = ref_engine.greedy_generate(params, sc1,
                                         jnp.asarray(prompt)[None],
                                         steps=steps)
    return [int(t) for t in np.asarray(out[0])]


_JIT = {}


def _jitted(fn):
    import jax
    if fn not in _JIT:
        _JIT[fn] = jax.jit(fn, static_argnames=("sc",))
    return _JIT[fn]


def _port_solo(np_params, prompt, steps, capacity):
    """The port's single-device solo greedy_generate (the reference suite
    holds shard-local serving to its own solo runs)."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = interop.params_from_reference(np_params, cfg, device="cpu")
    return [int(t) for t in engine.greedy_generate(
        params, _sc(cfg, capacity=capacity), torch.as_tensor(prompt)[None],
        steps=steps)[0]]


# the reference suite's mesh-serve arrivals (tests/test_distributed.py)
ARRIVAL_LENS = (5, 12)
SNAPSHOT_STEPS = 4        # both prompts admitted, the second mid-prefill
RESTART_STEP = 6
SNAPSHOT_TOL = 1e-5       # fp32 K/V of O(1), batch shapes apart


def _spawn(shape, work, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    results = mesh_lib.spawn(_rank_work, *shape, device="cpu",
                             args=(work,), timeout=SPAWN_TIMEOUT,
                             tmpdir=str(tmp))
    return results


@pytest.fixture(scope="module")
def mesh21(qwen, tmp_path_factory):
    cfg, _, np_params = qwen
    arr = _staggered(cfg.vocab_size, ARRIVAL_LENS)
    pressure = _same_prompt_arrivals(cfg.vocab_size, 5, 4, 8)
    preempt = _same_prompt_arrivals(cfg.vocab_size, 6, 4, 8)
    rng = np.random.default_rng(8)
    retry = [rng.integers(4, cfg.vocab_size, size=(n,)) for n in (5, 3, 3)]
    work = {
        "kernels": (_kernel_shard, (_kernel_inputs(),), {}),
        "serve": (_serve, (np_params, "qwen2-1.5b", None, 2, arr), {}),
        "backpressure": (_serve, (np_params, "qwen2-1.5b", None, 2,
                                  pressure),
                         {"rows": 4, "capacity": 12, "num_blocks": 8}),
        "preempt": (_serve, (np_params, "qwen2-1.5b", None, 2, preempt),
                    {"rows": 4, "capacity": 12, "num_blocks": 10}),
        "retry": (_admission_retry, (np_params, retry), {}),
        "snapshot": (_snapshot, (np_params, arr, SNAPSHOT_STEPS), {}),
    }
    return {"results": _spawn((2, 1), work, tmp_path_factory),
            "arrivals": arr, "pressure": pressure, "preempt": preempt,
            "retry": retry}


@pytest.fixture(scope="module")
def mesh22(qwen, tmp_path_factory):
    cfg, _, np_params = qwen
    arr = _staggered(cfg.vocab_size, ARRIVAL_LENS)
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    work = {"kernels": (_kernel_shard, (_kernel_inputs(),), {}),
            "serve": (_serve, (np_params, "qwen2-1.5b", None, 2, arr), {}),
            "restart": (_serve, (np_params, "qwen2-1.5b", None, 2, arr),
                        {"events": [{"step": RESTART_STEP,
                                     "op": "restart"}],
                         "ckpt_dir": ckpt}),
            "elastic": (_elastic, (), {})}
    return {"results": _spawn((2, 2), work, tmp_path_factory),
            "arrivals": arr}


@pytest.fixture(scope="module")
def mesh14(qwen, tmp_path_factory):
    cfg, _, np_params = qwen
    arr = _staggered(cfg.vocab_size, ARRIVAL_LENS)
    work = {"serve": (_serve, (np_params, "qwen2-1.5b", None, 1, arr), {})}
    return {"results": _spawn((1, 4), work, tmp_path_factory),
            "arrivals": arr}


@pytest.fixture(scope="module")
def solo(qwen):
    """The reference's solo greedy tokens of the suite's arrivals."""
    cfg, params, _ = qwen
    return {tuple(int(t) for t in p): _ref_solo(cfg, params, p, m)
            for _, p, m in _staggered(cfg.vocab_size, ARRIVAL_LENS)}


# ------------------------------------------------------------ kernels

@pytest.mark.parametrize("mesh", ["mesh21", "mesh22"])
@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("op", ["decode", "prefill"])
def test_sharded_paged_kernels_match_ref(request, mesh, kind, op):
    """Each rank's shard-local call, its rows and heads put together,
    equals the reference's plain version on the whole pool (the
    reference suite's inputs; the inactive decode row and the padded
    prefill query excluded, as there)."""
    got = request.getfixturevalue(mesh)["results"]
    case = _kernel_inputs()[(kind, op)]
    want = _ref_kernel(case, op)
    full = np.full(want.shape, np.nan, np.float32)
    for res in got:
        r, hs, o = res["kernels"][(kind, op)]
        full[r, :, hs] = o
    if op == "decode":
        np.testing.assert_allclose(full[:3], want[:3], atol=KERNEL_TOL,
                                   rtol=0)
    else:
        np.testing.assert_allclose(full[:3], want[:3], atol=KERNEL_TOL,
                                   rtol=0)
        np.testing.assert_allclose(full[3, :3], want[3, :3],
                                   atol=KERNEL_TOL, rtol=0)


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("mesh", ["mesh21", "mesh22", "mesh14"])
def test_mesh_serve_matches_reference_solo_greedy(request, mesh, solo):
    """The reference suite's mesh check (tests/test_distributed.py): every
    stream equals its solo greedy run, one decode signature and one per
    prefill bucket, on every rank; the data-sharded meshes went through
    the shard-local kernels."""
    fx = request.getfixturevalue(mesh)
    for res in fx["results"]:
        got = res["serve"]
        assert got["out"] == solo
        counts = got["trace_counts"]
        assert counts["decode"] == 1, counts
        assert all(v == 1 for k, v in counts.items()
                   if k.startswith("prefill_"))
        assert got["used_blocks"] == 0
        if mesh != "mesh14":
            assert all(got["sharded"].values()), got["sharded"]
        else:
            assert not any(got["sharded"].values())
    first = fx["results"][0]["serve"]["collectives"]
    if mesh == "mesh21":
        # the token gathers, and the stats' wall clock made rank 0's (one
        # broadcast over data)
        assert set(first) == {"all_reduce", "agree"}
        assert first["agree"] == 1
    else:
        assert first["all_reduce"] > 0 and first["gather"] > 0


def test_granite_moe_on_a_model_axis(qwen, tmp_path_factory):
    """Reduced granite-moe-3b-a800m on (1, 2): expert parallelism (4 of 8
    experts a rank) and the embedding on its d fallback; greedy tokens
    equal the reference's single-device run."""
    cfg, params, np_params = _weights("granite-moe-3b-a800m", GRANITE_VOCAB)
    arr = _staggered(cfg.vocab_size, ARRIVAL_LENS)
    work = {"serve": (_serve, (np_params, "granite-moe-3b-a800m",
                               GRANITE_VOCAB, 1, arr), {})}
    results = _spawn((1, 2), work, tmp_path_factory)
    want = {tuple(int(t) for t in p): _ref_solo(cfg, params, p, m)
            for _, p, m in arr}
    for res in results:
        assert res["serve"]["out"] == want
        assert res["serve"]["trace_counts"]["decode"] == 1
    # the d-split table gathers its entry; no weight needed whole but the
    # wq / wk / wv biases' (none here) and the mux keys' (N=1: none)
    assert results[0]["serve"]["collectives"]["gather"] > 0


# ------------------------------------------------------------ recovery

def test_mesh_snapshot_is_the_unsharded_runtimes(mesh21, qwen):
    """``snapshot_state`` on a (2, 1) mesh writes what one device writes:
    the whole cache in the reference's layout, gathered from both data
    shards, with the same metadata, on every rank.  Positions and tables
    are equal; the pages within ``SNAPSHOT_TOL`` (a rank's decode runs
    its own rows, a batch of another shape, whose products round
    apart).  The trash blocks' payload is left out: every invalid write
    of a step lands in slot 0 of its shard's trash block, and which one
    stays there depends on the batch (their positions stay -1, so
    nothing reads them)."""
    from repro_torch.serve.recovery import snapshot_state
    _, _, np_params = qwen
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = interop.params_from_reference(np_params, cfg, device="cpu")
    rt = ServeRuntime(params, _sc(cfg, n_shards=2), 2, chunk=8,
                      device="cpu")
    for uid, (_, p, m) in enumerate(mesh21["arrivals"]):
        rt.submit(Request(uid=uid, prompt=[int(t) for t in p], max_new=m))
    for _ in range(SNAPSHOT_STEPS):
        rt.step()
    tree, meta = snapshot_state(rt)
    want = _numpy_tree(tree)
    for res in mesh21["results"]:
        got, got_meta = res["snapshot"]
        assert got_meta == meta
        flat_w, flat_g = [], []

        def walk(a, b, path):
            if isinstance(a, dict):
                assert a.keys() == b.keys(), path
                for k in a:
                    walk(a[k], b[k], path + (k,))
            elif isinstance(a, list):
                for i, (x, y) in enumerate(zip(a, b, strict=True)):
                    walk(x, y, path + (i,))
            else:
                assert (a is None) == (b is None), path
                if a is not None:
                    assert a.dtype == b.dtype and a.shape == b.shape, path
                    if path[-1] in ("kp", "vp"):
                        trash = [0, a.shape[1] // 2]     # (periods, P, ..)
                        np.testing.assert_allclose(
                            np.delete(a, trash, 1), np.delete(b, trash, 1),
                            atol=SNAPSHOT_TOL, rtol=0, err_msg=str(path))
                    else:
                        assert np.array_equal(a, b), path
        walk(want, got, ())


def test_mesh_restart_reprefills_nothing(mesh22, solo):
    """A restart at step 6 on (2, 2): rank 0 writes the whole cache, every
    rank restores its part; the tokens are the reference's, with no more
    prefill than the undisturbed run."""
    for res in mesh22["results"]:
        got, base = res["restart"], res["serve"]
        assert got["restarts"] == 1
        assert got["out"] == solo
        assert got["prefill_tokens"] == base["prefill_tokens"]


def test_shrink_plan_and_elastic_mesh(mesh22):
    """A kill on a (2, 2) mesh keeps the model axis in the shrink plan (the
    reference's ``plan_serve_shrink``), and ``make_elastic_mesh`` builds
    the plan's (1, 2) mesh over the first two ranks."""
    from repro.runtime.elastic import plan_serve_shrink as ref_plan
    from repro_torch.serve.recovery import RecoverySupervisor
    sup = RecoverySupervisor()
    rt = FakeMesh(data=2, model=2)
    killed = type("Rt", (), {
        "kill_shard": lambda self, shard: [], "mesh": rt, "nrows": 2,
        "sc": type("Sc", (), {"n_shards": 2})(),
        "sched": type("S", (), {"dead_shards": {1}})()})()
    sup.kill_shard(killed, 1)
    want = ref_plan(1, model_parallel=2, rows=2)
    got = sup.shrink_plans[-1]
    assert (got.n_devices, got.mesh_shape, got.global_batch, got.dropped) \
        == (want.n_devices, tuple(want.mesh_shape), want.global_batch,
            want.dropped)
    elastic = [r["elastic"] for r in mesh22["results"]]
    assert elastic[2:] == [None, None]
    assert [e[1] for e in elastic[:2]] == [{"data": 0, "model": 0},
                                           {"data": 0, "model": 1}]
    assert elastic[0][0] == {"data": 1, "model": 2}


# ------------------------------------------------------------ shard-local

def test_mesh_backpressure_is_shard_local(mesh21):
    """Each shard fits one live row (4 blocks: a trash block and 3 of 4
    tokens at capacity 12): admissions past it roll back and retry after
    the shard's own drains; every stream exact, the pool drained."""
    for res in mesh21["results"]:
        got = res["backpressure"]
        assert len(got["out"]) == 4 and got["used_blocks"] == 0
        for _, p, m in mesh21["pressure"]:
            want = _port_solo_cached(p, m, 12)
            assert got["out"][tuple(int(t) for t in p)] == want


def test_admission_retries_on_sibling_shard(mesh21):
    """A group whose first-choice shard has no blocks is re-planned onto a
    sibling shard in the same step: rows {0, 2, 3} placed, nothing
    queued; every stream exact."""
    for res in mesh21["results"]:
        got = res["retry"]
        assert got["queue"] == 0 and got["placed"] == [0, 2, 3]
        assert got["used_blocks"] == 0
        for uid, p in enumerate(mesh21["retry"]):
            assert got["out"][uid] == _port_solo_cached(p, 2, 8)


def test_mesh_preemption_is_shard_local(mesh21):
    """Two rows a shard whose decode growth exhausts it: the preempted
    rows requeue and resume on their own shard; outputs exact, the pool
    drained."""
    for res in mesh21["results"]:
        got = res["preempt"]
        assert len(got["out"]) == 4 and got["used_blocks"] == 0
        for _, p, m in mesh21["preempt"]:
            assert got["out"][tuple(int(t) for t in p)] == \
                _port_solo_cached(p, m, 12)


_SOLO = {}


def _port_solo_cached(prompt, steps, capacity):
    key = (tuple(int(t) for t in prompt), steps, capacity)
    if key not in _SOLO:
        _SOLO[key] = _port_solo(_weights("qwen2-1.5b")[2], prompt, steps,
                                capacity)
    return _SOLO[key]


# ------------------------------------------------------------ validation

class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes
        self.coords = dict.fromkeys(axes, 0)


def test_serve_mesh_validates_device_count():
    with pytest.raises(ValueError, match="devices"):
        mesh_lib.make_serve_mesh(2, 1, device="cpu")
    assert mesh_lib.make_production_mesh() == {"data": 16, "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True)["pod"] == 2
    assert mesh_lib.pick_backend("cpu", 4) == "gloo"


def test_runtime_validates_shard_config(qwen):
    """n_shards > 1 without a mesh is logical sharding; rows must split
    evenly; a mesh's data axis must equal n_shards."""
    _, _, np_params = qwen
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = interop.params_from_reference(np_params, cfg, device="cpu")
    rt = ServeRuntime(params, _sc(cfg, n_shards=2), 2, device="cpu")
    assert rt.pool.n_shards == 2 and rt.mesh is None
    with pytest.raises(ValueError, match="not divisible"):
        ServeRuntime(params, _sc(cfg, n_shards=2), 3, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ServeRuntime(params, _sc(cfg), 2, device="cpu",
                     mesh=FakeMesh(data=2, model=1))
    with pytest.raises(ValueError, match="not divisible by the mesh"):
        ServeRuntime(params, _sc(cfg, n_shards=2), 3, device="cpu",
                     mesh=FakeMesh(data=2, model=1))
    with pytest.raises(ValueError, match="paged"):
        run_continuous(params, _sc(cfg, cache_layout="ring")
                       if False else engine.ServeConfig(
                           cfg=cfg, mux=MuxSpec(n=1), capacity=48,
                           dtype=torch.float32), 2, [], device="cpu",
                       mesh=FakeMesh(data=1, model=1))


def test_pool_blocks_divisibility_errors():
    cfg = get_config("qwen2-1.5b", reduced=True)
    with pytest.raises(ValueError, match="divisible"):
        _sc(cfg, n_shards=2, num_blocks=9).pool_blocks(4)
    with pytest.raises(ValueError, match="divisible"):
        _sc(cfg, n_shards=2).pool_blocks(3)


@pytest.mark.parametrize("argv,match", [
    (["--continuous", "--mesh", "2,2"],
     "--mesh requires --continuous --cache paged"),
    (["--continuous", "--cache", "paged", "--mesh", "2"],
     "--mesh expects DATA,MODEL"),
    (["--continuous", "--cache", "paged", "--mesh", "2,2", "--shards", "4"],
     "must match the --mesh data axis"),
])
def test_cli_mesh_refusals(capsys, argv, match):
    from repro_torch.launch import serve as cli
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--device", "cpu"])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


CLI_FLAGS = ["--device", "cpu", "--reduced", "--continuous", "--cache",
             "paged", "--requests", "5", "--new-tokens", "4",
             "--prompt-len", "8", "--block-size", "4"]


def _counts(out):
    m = re.search(r"served (\d+) requests \((\d+) tokens\).*prefill (\d+) "
                  r"backbone tokens \((\d+) padded\) in (\d+) events", out)
    return m.groups(), re.search(r"step signatures: (.*)", out).group(1)


def test_cli_mesh_matches_unsharded(capfd):
    """``--mesh 2,2`` serves every request with the unsharded CLI's
    request, token and prefill counts and one decode signature, printed
    once (rank 0), tagged ``mesh(2, 2)`` with its backend."""
    from repro_torch.launch import serve as cli
    assert cli.main(CLI_FLAGS) == 0
    want = capfd.readouterr().out
    assert cli.main(CLI_FLAGS + ["--mesh", "2,2"]) == 0
    got = capfd.readouterr().out
    assert _counts(got) == _counts(want)
    assert "decode×1" in _counts(got)[1]
    assert got.count("served 5 requests") == 1
    assert "continuous[paged/chunked/mesh(2, 2)/cpu]" in got
    assert "mesh(2, 2): 4 ranks over gloo (gloo: CPU tensors)" in got
