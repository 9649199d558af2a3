"""Width lanes, disaggregated serving and lane resize on a serve mesh
(``run_continuous(mesh=, lanes=)``, ``ServeRuntime.handoff_to`` between
ranks, ``engine.copy_cache_pages(mesh=)``) against the JAX reference, on
gloo process groups on the CPU.

One module fixture spawns the ranks once a mesh shape, (2, 2) and (2, 1),
and each rank runs every case and returns its results; meanwhile one JAX
subprocess with four fake devices runs the reference's
``run_continuous(mesh=make_serve_mesh(2, 2), lanes=...)`` on the same
seeded weights (the port's init carried to the reference's layout by
``interop``).  Inputs and results pass by pickle files in the fixture's
tmp dir.  The ranks import this module to find their work: it imports no
JAX at module level.

Cases, reduced fp32 qwen2-1.5b, 2 data shards (the mesh's data axis;
the unsharded runs use 2 logical shards):

  * ``lanes``: widths 1 and 2, latency and throughput requests;
  * ``disagg``: a prefill lane handing rows to a decode lane (N=2), on a
    trace where rows move between data shards, so between ranks;
  * ``kill``: lane 0's shard 1 killed at step 3, its stream replayed;
  * ``resize``: a lane at width 4 added at step 2, the width-1 lane
    drained at step 4;
  * ``budget``: a block budget of 15 that the router rebalances.

Each is held to the reference's mesh run (greedy tokens, prefill tokens
and events, per-lane requests, tokens and step signatures, routing,
handoffs and migrated bytes, recovery counts) and to the port's
unsharded run; every rank returns the same stats, wall-clock figures
included, as it does on one runtime without lanes, and a straggler's
step time reaches every rank as its shard's.  A unit case moves pages of the four storages between ranks
and holds them to their source bit for bit, and the CLI's lanes, disagg,
kill and resize flags print the reference CLI's counts on ``--mesh 2,2``.
"""
import contextlib
import io
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as cli
from repro_torch.models import TransformerLM
from repro_torch.serve import engine
from repro_torch.serve.kvpool import PAGE_KEYS, init_pages
from repro_torch.serve.router import LaneSpec

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPAWN_TIMEOUT = 240
REF_TIMEOUT = 600
ARCH = "qwen2-1.5b"
WIDTHS = (1, 2, 4)
PROMPT, NEW, BLOCK, CHUNK = 6, 3, 4, 4
CAPACITY = PROMPT + NEW + 8          # the CLI's
SHARDS = 2                           # both meshes' data axis

# name -> rows a lane, lanes (width, rows, chunk, role), the trace
# (requests, steps between arrivals, SLO classes in turn), events, budget
CASES = {
    "lanes": {"rows": 2, "lanes": [(1, 2, CHUNK, "both"),
                                   (2, 2, CHUNK, "both")],
              "trace": (6, 2, ("latency", "throughput"))},
    "disagg": {"rows": 4, "lanes": [(2, 4, CHUNK, "prefill"),
                                    (2, 4, CHUNK, "decode")],
               "trace": (8, 1, ("balanced",))},
    "kill": {"rows": 2, "lanes": [(1, 2, CHUNK, "both"),
                                  (2, 2, CHUNK, "both")],
             "trace": (6, 2, ("latency",)),
             "events": [{"step": 3, "op": "kill_shard", "shard": 1}]},
    "resize": {"rows": 2, "lanes": [(1, 2, CHUNK, "both"),
                                    (2, 2, CHUNK, "both")],
               "trace": (8, 2, ("balanced",)),
               "events": [{"step": 2, "op": "add_lane", "width": 4},
                          {"step": 4, "op": "drain_lane", "width": 1}]},
    "budget": {"rows": 2, "lanes": [(1, 2, CHUNK, "both"),
                                    (2, 2, CHUNK, "both")],
               "trace": (6, 1, ("latency",)), "budget": 15},
}
# run on the port's ranks alone: the lanes case with straggler fencing
# armed (the reference's detectors read its own clock)
RANK_CASES = {**CASES, "fence": {**CASES["lanes"], "fence": True}}
REC_KEYS = ("shards_killed", "requests_replayed", "replay_prefill_tokens",
            "handoffs", "handoff_streams", "migrated_kv_bytes",
            "lane_drains", "lane_adds", "lanes_retired",
            "stragglers_fenced", "global_slow_steps")


# ------------------------------------------------------------ inputs

def _arrivals(vocab, case):
    n, every, slo = RANK_CASES[case]["trace"]
    rng = np.random.default_rng(len(case))
    return [(i * every, rng.integers(4, vocab, size=(PROMPT,)).astype(
        np.int32), NEW, None, slo[i % len(slo)]) for i in range(n)]


def _np_params():
    """width -> the port's seeded init (seed = width) as the reference's
    numpy tree."""
    cfg = get_config(ARCH, reduced=True)
    return {w: interop.params_to_reference(TransformerLM.init(
        torch.Generator().manual_seed(w), cfg, MuxSpec(n=w)), cfg)
        for w in WIDTHS}


def _sc(cfg):
    return engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), capacity=CAPACITY,
                              dtype=torch.float32, cache_layout="paged",
                              block_size=BLOCK, n_shards=SHARDS)


def _core(stats):
    """What the port's and the reference's runs must share."""
    return {
        "tokens": {r.uid: [int(t) for t in r.output]
                   for r in stats["completed"]},
        "routed": {r.uid: (r.lane, r.routed_step)
                   for r in stats["completed"]},
        "prefill": (stats["prefill_tokens"], stats["prefill_compute_tokens"],
                    stats["prefill_events"], stats["decode_steps"]),
        "lanes": [(ls["lane"], ls["n_mux"], len(ls["completed"]),
                   sum(len(r.output) for r in ls["completed"]),
                   dict(ls["trace_counts"])) for ls in stats["lanes"]],
        "routing": {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in stats["routing"].items()},
        "recovery": {k: stats["recovery"][k] for k in REC_KEYS},
        "used_blocks": [p.n_used_blocks for p in stats["pools"]],
    }


def _serve(params_np, case, mesh=None):
    """One case on the port (on ``mesh``, or unsharded over logical
    shards): ``_core`` plus what must agree between ranks."""
    cfg = get_config(ARCH, reduced=True)
    params = {w: interop.params_from_reference(p, cfg, device="cpu")
              for w, p in params_np.items()}
    c = RANK_CASES[case]
    if mesh is not None:
        mesh.counts.clear()
        mesh.bytes.clear()
    ops.reset_counts()
    stats = cli.run_continuous(
        params, _sc(cfg), c["rows"], _arrivals(cfg.vocab_size, case),
        chunk=CHUNK, device="cpu", mesh=mesh,
        lanes=[LaneSpec(*spec) for spec in c["lanes"]],
        events=c.get("events"), pool_budget=c.get("budget"),
        fence_stragglers=c.get("fence", False))
    for p in stats["pools"]:
        p.check_invariants()
    out = _core(stats)
    out["clock"] = {
        "wall": stats["wall"],
        "lane_stats": stats["lane_stats"],
        "stamps": sorted((r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done)
                         for r in stats["completed"]),
        "recovery_latency_s": stats["recovery"]["recovery_latency_s"]}
    if mesh is not None:
        out["page_moves"] = mesh.counts["page_move"]
        out["page_bytes"] = mesh.bytes["page_move"]
        out["sharded"] = {w.__name__: w.calls for w in ops.SHARDED}
    return out


def _serve_one_runtime(params_np, mesh):
    """The kill case's trace on one runtime at width 2 (no lanes) on
    ``mesh``, lane 0's kill as its own: tokens, counts and the wall
    clock's figures."""
    cfg = get_config(ARCH, reduced=True)
    params = interop.params_from_reference(params_np[2], cfg, device="cpu")
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), capacity=CAPACITY,
                            dtype=torch.float32, cache_layout="paged",
                            block_size=BLOCK, n_shards=SHARDS)
    stats = cli.run_continuous(
        params, sc, 2, _arrivals(cfg.vocab_size, "kill"), chunk=CHUNK,
        device="cpu", mesh=mesh, events=CASES["kill"]["events"])
    return {"tokens": {r.uid: [int(t) for t in r.output]
                       for r in stats["completed"]},
            "recovery": {k: stats["recovery"][k] for k in REC_KEYS},
            "clock": {"wall": stats["wall"],
                      "stamps": sorted((r.uid, r.t_submit, r.t_admit,
                                        r.t_first, r.t_done)
                                       for r in stats["completed"]),
                      "recovery_latency_s":
                          stats["recovery"]["recovery_latency_s"]}}


def _own_step_time(coords) -> float:
    """A made-up step time for the rank at ``coords``: data shard 1's
    last model rank is the slow one."""
    return 0.01 * (1 + coords["model"]) + (0.5 if coords == {
        "data": 1, "model": 1} else 0.1 * coords["data"])


# ------------------------------------------------------------ page moves

STORAGES = {"fp32": (torch.float32, None), "bf16": (torch.bfloat16, None),
            "int8": (torch.float32, "int8"), "fp8": (torch.float32, "fp8")}
PM_BLOCKS, PM_BS, PM_HKV, PM_DH, PM_LAYERS = 4, 4, 2, 8, 2   # a shard's
PM_MOVES = {"cross": ((0, [1, 3]), (1, [2, 1])),   # (shard, local ids)
            "local": ((0, [1, 2]), (0, [3, 1]))}


def _page_bits(x):
    """A page tensor's raw bits (a float's sign of zero included)."""
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        x.element_size()])


def _whole_pages(storage):
    """Every shard's pages of ``PM_LAYERS`` layers, seeded, the fp32
    payload holding a -0.0 and a subnormal in each moved block."""
    dt, quant = STORAGES[storage]
    g = torch.Generator().manual_seed(7)
    n = SHARDS * PM_BLOCKS
    layers = []
    for _ in range(PM_LAYERS):
        c = init_pages(n, PM_BS, PM_HKV, PM_DH, dt, quant=quant,
                       device="cpu")
        for k, x in c.items():
            bits = _page_bits(x)
            if x.dtype == torch.int32:
                bits.copy_(torch.randint(-1, 40, x.shape, generator=g,
                                         dtype=torch.int32))
            elif x.is_floating_point() and x.element_size() > 1:
                x.copy_(torch.randn(x.shape, generator=g).to(x.dtype))
                x[:, 0, :, ...] = -0.0
                if x.dtype == torch.float32 and x.ndim == 4:
                    x[:, 1, :, 0] = torch.finfo(torch.float32).smallest_normal / 8
            else:
                bits.copy_(torch.randint(0, 256, bits.shape, generator=g,
                                         dtype=torch.int32).to(bits.dtype))
        layers.append(c)
    return layers


def _rank_pages(layers, shard, mesh):
    """Shard ``shard``'s segment of each layer on this model rank (its KV
    heads when the model axis splits them), as a paged cache."""
    seg = slice(shard * PM_BLOCKS, (shard + 1) * PM_BLOCKS)
    m, nm = mesh.coords["model"], mesh.shape["model"]
    hk = PM_HKV // nm
    heads = slice(m * hk, (m + 1) * hk)
    out = [{k: (x[seg] if k == "ppos" else x[seg, :, heads]).clone()
            for k, x in c.items()} for c in layers]
    return {"layers": out, "bt": torch.zeros(1, 1, dtype=torch.int32)}


def _page_moves(mesh):
    """Each storage's pages moved between this mesh's data shards and
    within one, by ``copy_cache_pages(mesh=)``: this rank's cache after
    each move; and the fp32 pages sent by a float sum instead (a gather
    as ``ServeMesh`` sums it), which loses the -0.0."""
    out = {}
    for storage in STORAGES:
        layers = _whole_pages(storage)
        for name, ((a, src_ids), (b, dst_ids)) in PM_MOVES.items():
            me = mesh.coords["data"]
            src = _rank_pages(layers, me, mesh)
            dst = _rank_pages(layers, me, mesh)
            engine.copy_cache_pages(src, dst, src_ids, dst_ids, mesh=mesh,
                                    src_shard=a, dst_shard=b)
            out[storage, name] = [{k: _page_bits(x).numpy().copy()
                                   for k, x in c.items()}
                                  for c in dst["layers"]]
    # storages that differ: every rank refuses before the collective
    (a, src_ids), (b, dst_ids) = PM_MOVES["cross"]
    me = mesh.coords["data"]
    src = _rank_pages(_whole_pages("fp32"), me, mesh)
    dst = _rank_pages(_whole_pages("bf16"), me, mesh)
    try:
        engine.copy_cache_pages(src, dst, src_ids, dst_ids, mesh=mesh,
                                src_shard=a, dst_shard=b)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    layers = _whole_pages("fp32")
    mine = _rank_pages(layers, mesh.coords["data"], mesh)["layers"][0]["kp"]
    buf = torch.zeros((len(src_ids), *mine.shape[1:]))
    if mesh.coords["data"] == a:
        buf.copy_(mine[src_ids])
    mesh.all_reduce(buf, "data", kind="check")
    out["float_sum"] = buf.numpy().copy()
    return out


# ------------------------------------------------------------ the CLI

CLI_BASE = ["--device", "cpu", "--reduced", "--continuous", "--cache",
            "paged", "--new-tokens", "3", "--prompt-len", "6",
            "--block-size", "4", "--chunk", "4"]
# the reference CLI's counts on these flags (on a (2, 2) mesh of fake
# devices as unsharded)
CLI_CASES = {
    "lanes": (["--lanes", "1,2", "--slo-mix", "latency=1,throughput=1",
               "--requests", "6"],
              ["served 6 requests (18 tokens)",
               "prefill 36 backbone tokens (48 padded) in 12 events",
               "lane0 N=1 rows=2: 4 requests, 12 tokens",
               "lane1 N=2 rows=2: 2 requests, 6 tokens",
               "routing[load]: latency=4, balanced=0, throughput=2"]),
    "disagg": (["--disagg", "--prefill-lanes", "2", "--decode-lanes", "2",
                "--requests", "6"],
               ["disagg: 6 handoffs (6 streams, 196992 KV bytes migrated, "
                "zero re-prefill)", "step signatures [prefill_4×1]",
                "step signatures [decode×1]"]),
    "kill": (["--lanes", "1,2", "--slo-mix", "latency=1", "--kill-shard",
              "3:1", "--requests", "6"],
             ["prefill 40 backbone tokens (52 padded) in 13 events",
              "recovery: 1 shard kills, 1 streams replayed (6 re-prefill "
              "tokens)"]),
    "resize": (["--lanes", "1,2", "--add-lane", "2:4", "--drain-lane", "4:1",
                "--requests", "8"],
               ["resize: 1 drains / 1 adds (1 lanes retired)",
                "1 drains / 1 adds (1 lanes retired)"]),
}


def _cli_text(argv, mesh=None):
    """The CLI's standard output (on ``mesh``: this rank's, as the
    spawned ``--mesh`` CLI runs it)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (cli.main(argv) if mesh is None
              else cli._mesh_rank(mesh, argv))
    assert rc == 0
    return buf.getvalue()


def _counts(text):
    """The count lines of a lanes run, wall-clock figures and the mode
    tag's mesh and device parts dropped."""
    got = []
    for line in text.splitlines():
        line = re.sub(r"in [0-9.]+s|[0-9.]+ tok/s|goodput [0-9.]+|"
                      r"attainment [0-9.]+|× [0-9.]+|/cpu|/mesh\(2, 2\)|"
                      r"; worst recovery latency .*", "", line)
        if line.startswith(("continuous[", "  lane", "routing[", "disagg:",
                            "resize:", "recovery:")):
            got.append(line)
    return got


# ------------------------------------------------------------ the ranks

def _rank(mesh, params_np, cli_cases):
    """Every case of this mesh on this rank."""
    torch.set_num_threads(1)
    out = {case: _serve(params_np, case, mesh) for case in RANK_CASES}
    out["one_runtime"] = _serve_one_runtime(params_np, mesh)
    out["step_times"] = cli._shard_step_times(mesh, SHARDS,
                                              _own_step_time(mesh.coords))
    out["pages"] = _page_moves(mesh)
    out["cli"] = {name: _cli_text(CLI_BASE + flags + ["--mesh", "2,2"],
                                  mesh)
                  for name, (flags, _) in cli_cases.items()}
    return out


# ------------------------------------------------------------ the reference

REF_SCRIPT = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core import MuxSpec
from repro.launch.mesh import make_serve_mesh
from repro.launch.serve import run_continuous
from repro.serve import ServeConfig
from repro.serve.router import LaneSpec

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = get_config(inp["arch"], reduced=True)
params = {w: jax.tree.map(jnp.asarray, p) for w, p in inp["params"].items()}
sc = ServeConfig(cfg=cfg, kind="lm", mux=MuxSpec(n=1),
                 capacity=inp["capacity"], dtype=jnp.float32,
                 cache_layout="paged", block_size=inp["block"],
                 n_shards=inp["shards"])
mesh = make_serve_mesh(2, 2)
out = {}
for name, c in inp["cases"].items():
    st = run_continuous(params, sc, c["rows"], inp["arrivals"][name],
                        chunk=inp["chunk"], mesh=mesh,
                        lanes=[LaneSpec(*s) for s in c["lanes"]],
                        events=c.get("events"), pool_budget=c.get("budget"))
    out[name] = {
        "tokens": {r.uid: [int(t) for t in r.output]
                   for r in st["completed"]},
        "routed": {r.uid: (r.lane, r.routed_step) for r in st["completed"]},
        "prefill": (st["prefill_tokens"], st["prefill_compute_tokens"],
                    st["prefill_events"], st["decode_steps"]),
        "lanes": [(ls["lane"], ls["n_mux"], len(ls["completed"]),
                   sum(len(r.output) for r in ls["completed"]),
                   dict(ls["trace_counts"])) for ls in st["lanes"]],
        "routing": {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in st["routing"].items()},
        "recovery": {k: st["recovery"][k] for k in inp["rec_keys"]},
        "used_blocks": [p.n_used_blocks for p in st["pools"]]}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (2, 2) and (2, 1) ranks' results, the reference's mesh runs and
    the port's unsharded runs, side by side."""
    tmp = tmp_path_factory.mktemp("mesh_lanes")
    params_np = _np_params()
    vocab = get_config(ARCH, reduced=True).vocab_size
    ref_in, ref_out = tmp / "ref_in.pkl", tmp / "ref_out.pkl"
    with open(ref_in, "wb") as f:
        pickle.dump({"arch": ARCH, "params": params_np, "cases": CASES,
                     "arrivals": {c: _arrivals(vocab, c) for c in CASES},
                     "capacity": CAPACITY, "block": BLOCK, "chunk": CHUNK,
                     "shards": SHARDS, "rec_keys": REC_KEYS}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(ref_in),
                             str(ref_out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = {shape: mesh_lib.spawn(
            _rank, *shape, device="cpu",
            args=(params_np, CLI_CASES if shape == (2, 2) else {}),
            timeout=SPAWN_TIMEOUT, tmpdir=str(tmp))
            for shape in ((2, 2), (2, 1))}
        unsharded = {case: _serve(params_np, case) for case in CASES}
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    with open(ref_out, "rb") as f:
        ref = pickle.load(f)
    return {"ranks": ranks, "ref": ref, "unsharded": unsharded}


def _without(d, *keys):
    return {k: v for k, v in d.items() if k not in keys}


# ------------------------------------------------------------ the cases

@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lanes_match_reference_mesh_run(runs, case, shape):
    """Greedy tokens, routing, prefill and per-lane counts, handoffs,
    migrated bytes and recovery counts equal the reference's run of the
    same case on a (2, 2) mesh; every lane declared one decode and one
    signature per bucket, and every pool drained."""
    want = runs["ref"][case]
    for res in runs["ranks"][shape]:
        got = _without(res[case], "clock", "page_moves", "page_bytes",
                       "sharded")
        assert got == want
        assert not any(got["used_blocks"])
        for *_, counts in got["lanes"]:
            assert set(counts) <= {"decode", "prefill_4"}
            assert all(v == 1 for v in counts.values())


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lanes_match_unsharded_run(runs, case, shape):
    """The same case unsharded (2 logical shards on one device) gives the
    same tokens and counts; the paged kernels ran through the shard-local
    wrappers on every rank."""
    want = _without(runs["unsharded"][case], "clock")
    for res in runs["ranks"][shape]:
        assert _without(res[case], "clock", "page_moves", "page_bytes",
                        "sharded") == want
        assert res[case]["sharded"]["sharded_paged_attention"] > 0


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
@pytest.mark.parametrize("case", [*RANK_CASES, "one_runtime"])
def test_every_rank_returns_the_same_stats(runs, case, shape):
    """Every rank's stats are rank 0's, the wall clock's figures too:
    the serve wall, goodput and TTFT attainment, each request's stamps
    and the recovery latencies are rank 0's readings
    (``ServeMesh.agree``), with lanes and on one runtime alike; the page
    moves are every rank's collective."""
    first, *rest = runs["ranks"][shape]
    for res in rest:
        assert _without(res[case], "sharded") == _without(first[case],
                                                          "sharded")
    if case == "one_runtime":
        assert first[case]["recovery"]["shards_killed"] == 1
        assert first[case]["clock"]["recovery_latency_s"]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_straggler_fencing_on_a_mesh_agrees(runs, shape):
    """With fencing armed every rank feeds its detectors the same
    per-shard step times (``_shard_step_times``), so all fence alike
    (the same-stats test holds the counts equal on every rank); every
    request completes, and where nothing was fenced the tokens and
    counts are the unfenced run's."""
    for res in runs["ranks"][shape]:
        got = res["fence"]
        assert len(got["tokens"]) == RANK_CASES["fence"]["trace"][0]
        assert all(len(t) == NEW for t in got["tokens"].values())
        if got["recovery"]["stragglers_fenced"] == 0:
            assert _without(got, "clock", "recovery", "sharded") == \
                _without(res["lanes"], "clock", "recovery", "sharded")
        assert got["page_moves"] == 0


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_a_slow_rank_is_its_shards_step_time(runs, shape):
    """Each rank times its own step; every rank gets each shard's slowest
    rank's time, exactly, so a slow rank's shard is the one whose
    detector sees it."""
    d, m = shape
    coords = [{"data": i, "model": j} for i in range(d) for j in range(m)]
    want = [max(_own_step_time(c) for c in coords if c["data"] == s)
            for s in range(SHARDS)]
    for res in runs["ranks"][shape]:
        assert res["step_times"] == want
    if m == 2:
        assert want[1] > 0.5 > want[0]


def test_disagg_moves_rows_between_ranks(runs):
    """The disagg trace hands rows across data shards: each such handoff
    is one ``page_move`` broadcast of the row's pages, whose bytes on a
    rank are its model slice of the KV bytes the handoff migrated."""
    for shape, results in runs["ranks"].items():
        res = results[0]["disagg"]
        assert res["page_moves"] >= 1, shape
        assert res["recovery"]["handoffs"] > res["page_moves"]
        assert 0 < res["page_bytes"] < res["recovery"]["migrated_kv_bytes"]
    for case in ("lanes", "kill", "resize", "budget"):
        assert runs["ranks"][(2, 2)][0][case]["page_moves"] == 0


def test_kill_resize_and_budget_cases_exercise_their_paths(runs):
    """The kill replays a stream, the resize adds and retires a lane, the
    budget moves quota: each case reaches the path it names."""
    ref = runs["ref"]
    assert ref["kill"]["recovery"]["requests_replayed"] >= 1
    assert ref["resize"]["recovery"]["lane_adds"] == 1
    assert ref["resize"]["recovery"]["lanes_retired"] == 1
    assert ref["budget"]["routing"]["rebalanced_blocks"] > 0
    assert len(ref["lanes"]["lanes"]) == 2 and all(
        n for _, _, n, _, _ in ref["lanes"]["lanes"])


# ------------------------------------------------------------ page moves

@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("move", list(PM_MOVES))
def test_page_move_is_bit_for_bit(runs, shape, storage, move):
    """Pages, scales and positions arrive on the destination shard's ranks
    as their source's bytes (equal bit views; the fp32
    payload's -0.0 and subnormal included), the other pages and ranks
    untouched."""
    layers = _whole_pages(storage)
    (a, src_ids), (b, dst_ids) = PM_MOVES[move]
    for rank, res in enumerate(runs["ranks"][shape]):
        d, m = divmod(rank, shape[1])
        hk = PM_HKV // shape[1]
        heads = slice(m * hk, (m + 1) * hk)
        for got, whole in zip(res["pages"][storage, move], layers,
                              strict=True):
            assert set(got) == {k for k in PAGE_KEYS if k in whole}
            for k, x in whole.items():
                part = _page_bits(x[d * PM_BLOCKS:(d + 1) * PM_BLOCKS]
                                  if k == "ppos" else
                                  x[d * PM_BLOCKS:(d + 1) * PM_BLOCKS, :,
                                    heads])
                want = part.clone()
                if d == b:
                    srcp = _page_bits(x[a * PM_BLOCKS:(a + 1) * PM_BLOCKS]
                                      if k == "ppos" else
                                      x[a * PM_BLOCKS:(a + 1) * PM_BLOCKS,
                                        :, heads])
                    want[dst_ids] = srcp[src_ids]
                assert np.array_equal(got[k], want.numpy()), (rank, k)


def test_page_move_between_storages_fails_on_every_rank(runs):
    """fp32 pages to a bf16 cache across shards: every rank raises before
    the move's collective (none waits for a sender that refused)."""
    for results in runs["ranks"].values():
        for res in results:
            assert "page storage differs" in res["pages"]["mismatch"]


def test_a_float_sum_would_not_move_pages_bit_for_bit(runs):
    """The pages the test moves are ones a zero-filled float sum (what
    ``ServeMesh.gather`` does) cannot carry: their -0.0 comes back +0.0,
    so the page move's bytes are the broadcast's, not a sum's."""
    layers = _whole_pages("fp32")
    (a, src_ids), (b, _) = PM_MOVES["cross"]
    for shape, results in runs["ranks"].items():
        hk = PM_HKV // shape[1]
        for rank, res in enumerate(results):
            m = rank % shape[1]
            src = layers[0]["kp"][a * PM_BLOCKS:(a + 1) * PM_BLOCKS, :,
                                  m * hk:(m + 1) * hk][src_ids]
            got = res["pages"]["float_sum"]
            assert np.array_equal(got, src.numpy())              # as values
            assert not np.array_equal(got.view(np.int32),
                                      _page_bits(src).numpy())   # as bits


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_on_a_mesh_prints_the_reference_counts(runs, name):
    """``--mesh 2,2`` with ``--lanes`` / ``--disagg`` / ``--kill-shard`` /
    ``--add-lane`` ``--drain-lane``: rank 0 prints the reference CLI's
    counts (the unsharded CLI's, on 2 logical shards), tagged
    ``mesh(2, 2)``; the other ranks print nothing."""
    flags, want = CLI_CASES[name]
    texts = [r["cli"][name] for r in runs["ranks"][(2, 2)]]
    got = texts[0]
    assert not any(texts[1:])
    for line in want:
        assert line in got, line
    assert "/mesh(2, 2)/" in got and "/cpu]" in got
    assert "mesh(2, 2): 4 ranks over gloo (gloo: CPU tensors)" in got
    unsharded = _cli_text(CLI_BASE + flags + ["--shards", "2"])
    assert _counts(got) == _counts(unsharded) and len(_counts(got)) >= 3


def test_cli_spawns_the_mesh_for_disagg(capfd):
    """The CLI itself (``main`` without a mesh, as ``python -m
    repro_torch.launch.serve`` runs it) starts the four ranks for
    ``--disagg ... --mesh 2,2`` and prints the reference CLI's handoff
    line once, from rank 0."""
    flags, want = CLI_CASES["disagg"]
    assert cli.main(CLI_BASE + flags + ["--mesh", "2,2"]) == 0
    got = capfd.readouterr().out
    assert got.count("served 6 requests (18 tokens)") == 1
    assert "continuous[paged/chunked/mesh(2, 2)/disagg[P:2>D:2]/cpu]" in got
    for line in want:
        assert line in got, line
