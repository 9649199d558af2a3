"""The port's hot snapshot / restore and its checkpoint manager against the
JAX reference on the CPU.

Reduced qwen2-1.5b, 2 backbone rows, capacity 20, pages of 4 tokens,
``dtype=float32`` (the reference's fault case in its default bf16), the
port's weights carried over from the reference's init; the requests of
the reference's ``tests/test_recovery.py`` (seeded numpy draws).

  * ``checkpoint.manager``: the seven mesh-free cases of
    ``tests/test_checkpoint.py`` on torch tensors, and the on-disk files
    (``tree.json`` and every ``.npy``, bf16 and fp8 leaves included) byte
    for byte the reference's for the same tree;
  * snapshot / restore: mid-decode with no re-prefill, mid-prefill
    finishing only the remaining chunks, int8 pages bit for bit, the
    mismatched-grid and format / ``kv_dtype`` gates, the torn-handoff
    check of a prefill lane;
  * across packages: a reference-written snapshot on fp32, bf16, int8 and
    fp8 pages restored by the port continues token-identically with the
    reference's undisturbed run; a port-written one on fp32 and int8
    pages restored by the reference does the same; the two packages'
    ``tree.json`` of the same state agree (leaves and metadata, the
    requests' ``t_*`` stamps aside);
  * the reference's own fault: it cannot restore its snapshot of bf16 or
    fp8 pages (``TypeError``, ROADMAP §3), which the port restores;
  * the fuzz's restart arm and the CLI's ``--restart-step`` against the
    reference's.
"""
import hashlib
import json
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import manager as ref_manager
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.serve import Request as RefRequest
from repro.serve import recovery as ref_recovery
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro_torch import interop
from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint import (AsyncCheckpointManager, available_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.launch import serve as cli
from repro_torch.serve import recovery
from repro_torch.serve.batcher import Request
from repro_torch.serve.recovery import (RecoverySupervisor, restore_into,
                                        restore_state, snapshot_state)
from repro_torch.serve.runtime import ServeRuntime
from test_serve_fuzz import ROWS, _schedule
from test_torch_shards import (cli_counts, copy_arrivals, drive,
                               recovery_counts, requests, sc_port, sc_ref,
                               tokens)
from test_torch_shards import models  # noqa: F401  (module fixture)

torch.set_num_threads(2)

TREE = {"a": torch.arange(12.0).reshape(3, 4),
        "b": {"c": torch.ones(8, dtype=torch.int32),
              "d": torch.full((2, 2), 3.5)}}
KV = {"fp32": None, "bf16": "bf16", "int8": "int8", "fp8": "fp8"}


def assert_tree_equal(got, want):
    assert M._flatten(got).__len__() == M._flatten(want).__len__()
    for (pg, g), (pw, w) in zip(M._flatten(got), M._flatten(want)):
        assert pg == pw and g.dtype == w.dtype
        assert torch.equal(interop._bits(g), interop._bits(w)), pg


# ------------------------------------------------------ checkpoint manager

def test_roundtrip_and_keep_k(tmp_path):
    d = str(tmp_path)
    for s in (5, 10, 15, 20):
        save_checkpoint(d, s, TREE, metadata={"s": s}, keep_k=2)
    assert available_steps(d) == [15, 20]
    r, step, md = restore_checkpoint(d, TREE)
    assert step == 20 and md["s"] == 20
    assert_tree_equal(r, TREE)


def test_restore_specific_step(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.zeros(2)})
    save_checkpoint(d, 2, {"a": torch.ones(2)})
    r, step, _ = restore_checkpoint(d, {"a": torch.zeros(2)}, step=1)
    assert step == 1 and float(r["a"][0]) == 0.0


def test_structure_validation(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, TREE)
    with pytest.raises(KeyError):
        restore_checkpoint(d, {"unknown": torch.zeros(1)})
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"a": torch.zeros(5, 5), "b": TREE["b"]})


def test_no_partial_checkpoint_on_failure(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_000000099.tmp"))
    assert available_steps(d) == []


def test_async_manager(tmp_path):
    d = str(tmp_path)
    mgr = AsyncCheckpointManager(d, keep_k=2)
    mgr.save(1, TREE)
    mgr.save(2, TREE)
    mgr.wait()
    assert available_steps(d) == [1, 2]
    r, step, _ = mgr.restore(TREE)
    assert step == 2
    assert_tree_equal(r, TREE)


def test_async_manager_surfaces_background_failure(tmp_path, monkeypatch):
    """A failed background write raises from the next wait(), once; the
    manager stays usable."""
    d = str(tmp_path)
    mgr = AsyncCheckpointManager(d, keep_k=2)
    mgr.save(1, TREE)
    mgr.wait()
    real, boom = M.save_checkpoint, {"armed": True}

    def flaky(*a, **kw):
        if boom["armed"]:
            boom["armed"] = False
            raise OSError("disk full")
        return real(*a, **kw)

    monkeypatch.setattr(M, "save_checkpoint", flaky)
    mgr.save(2, TREE)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        mgr.wait()
    mgr.save(3, TREE)
    mgr.wait()
    assert mgr.last_committed == 3
    _, step, _ = mgr.restore(TREE)
    assert step == 3


def test_async_manager_restore_waits_for_inflight_save(tmp_path,
                                                       monkeypatch):
    d = str(tmp_path)
    mgr = AsyncCheckpointManager(d, keep_k=2)
    real, release = M.save_checkpoint, threading.Event()

    def slow(*a, **kw):
        release.wait(timeout=10)
        return real(*a, **kw)

    monkeypatch.setattr(M, "save_checkpoint", slow)
    mgr.save(7, TREE)
    assert available_steps(d) == []
    release.set()
    _, step, _ = mgr.restore(TREE)
    assert step == 7 and mgr.last_committed == 7


def _files(d):
    return {f: hashlib.sha1(open(os.path.join(d, f), "rb").read()
                            ).hexdigest() for f in sorted(os.listdir(d))}


def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path):
    """The same tree (fp32, int32, int8, bf16 and fp8 leaves under nested
    dicts and a tuple) saved by both packages: identical directories,
    ``tree.json`` and every ``.npy`` byte for byte; bf16 / fp8 files carry
    a void header a plain ``np.load`` reads as void; the port restores the
    reference's files bit for bit, and a '|V2' header as well."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    f8 = rng.standard_normal((4, 2)).astype(ml_dtypes.float8_e4m3fn)
    arrays = {"z": rng.standard_normal((2, 3)).astype(np.float32),
              "c": {"kp": bf, "q": rng.integers(-9, 9, (2, 2)).astype(
                  np.int8), "f": f8},
              "t": (np.arange(4, dtype=np.int32), None,
                    np.ones((1, 2), np.float32))}

    def to_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        if a.dtype == ml_dtypes.float8_e4m3fn:
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(a.copy())

    tt = interop._map(lambda a: None if a is None else to_torch(a), arrays)
    jt = jax.tree.map(jnp.asarray, arrays)
    meta = {"format": "x", "n": [1, 2]}
    save_checkpoint(str(tmp_path / "port"), 3, tt, metadata=meta)
    ref_manager.save_checkpoint(str(tmp_path / "ref"), 3, jt, metadata=meta)
    pd, rd = (str(tmp_path / k / "step_000000003") for k in ("port", "ref"))
    assert _files(pd) == _files(rd)
    index = json.load(open(os.path.join(pd, "tree.json")))
    by = {e["path"]: e for e in index["leaves"]}
    assert by["c/kp"]["dtype"] == "bfloat16"
    assert by["c/f"]["dtype"] == "float8_e4m3fn"
    for path, descr in (("c/kp", "<V2"), ("c/f", "<V1")):
        raw = open(os.path.join(pd, by[path]["file"]), "rb").read(128)
        assert f"'descr': '{descr}'".encode() in raw
        assert np.load(os.path.join(pd, by[path]["file"])).dtype.kind == "V"
    got, _, md = restore_checkpoint(str(tmp_path / "ref"), tt)
    assert md == meta
    assert_tree_equal(got, tt)
    # a '|V2' header (plain numpy's void) reads by the tree.json dtype too
    f = os.path.join(pd, by["c/kp"]["file"])
    np.save(f, np.frombuffer(bf.tobytes(), "V2").reshape(bf.shape))
    got, _, _ = restore_checkpoint(str(tmp_path / "port"), tt)
    assert_tree_equal(got, tt)


# --------------------------------------------------------- serve snapshots

def _decoding(rt, step):
    """The snapshot point of the reference's tests: step >= 4 with nothing
    queued and nothing mid-prefill."""
    return step >= 4 and not rt.sched.queue and not rt.sched.prefill_progress


def _finish(rt):
    while rt.has_work():
        rt.step()
    rt.pool.check_invariants()
    assert rt.pool.n_used_blocks == 0
    return {r.uid: [int(t) for t in r.output] for r in rt.sched.completed}


def _snapshot_run(rt, cfg, request_cls, sup, *, sampled=False):
    """Serve ``requests`` on ``rt``, snapshotting through ``sup`` at the
    first all-decoding step and carrying on undisturbed.  Returns (uid ->
    tokens, the step, uid -> tokens of the requests done before it)."""
    seen = {}

    def on_step(rt, step):
        if not seen and _decoding(rt, step):
            sup.snapshot(rt, step)
            sup.ckpt.wait()
            seen.update(step=step, done={
                r.uid: [int(t) for t in r.output]
                for r in rt.sched.completed})
        return rt

    out, _ = drive(rt, requests(cfg, sampled=sampled), request_cls,
                   on_step=on_step)
    assert seen, "the schedule never reached an all-decoding step"
    return out, seen["step"], seen["done"]


@pytest.fixture(scope="module")
def ref_snapshots(models, tmp_path_factory):
    """Per page storage: the reference's undisturbed run with a snapshot at
    its all-decoding step.  kind -> (dir, tokens, step, done before)."""
    cfg_r, ref, cfg, _ = models
    out = {}
    for kind, kv in KV.items():
        d = str(tmp_path_factory.mktemp(f"ref-{kind}"))
        rt = RefRuntime(ref, sc_ref(cfg_r, kv_dtype=kv), ROWS, chunk=4)
        res = _snapshot_run(rt, cfg, RefRequest,
                            ref_recovery.RecoverySupervisor(ckpt_dir=d))
        out[kind] = (d, *res)
    return out


@pytest.fixture(scope="module")
def port_snapshots(models, tmp_path_factory):
    """As ``ref_snapshots`` on the port, fp32 and int8 pages."""
    _, _, cfg, port = models
    out = {}
    for kind in ("fp32", "int8"):
        d = str(tmp_path_factory.mktemp(f"port-{kind}"))
        rt = ServeRuntime(port, sc_port(cfg, kv_dtype=KV[kind]), ROWS,
                          chunk=4, device="cpu")
        out[kind] = (d, *_snapshot_run(rt, cfg, Request,
                                       RecoverySupervisor(ckpt_dir=d)))
    return out


def test_snapshot_restore_no_reprefill(models, tmp_path):
    """Snapshot with every stream decoding (one of them sampled), restore
    into a fresh runtime in flight: the tokens of the undisturbed run, and
    the restored runtime prefills nothing."""
    _, _, cfg, port = models
    mk = lambda: ServeRuntime(port, sc_port(cfg), ROWS, chunk=4,
                              device="cpu")
    base, _ = drive(mk(), requests(cfg, sampled=True), Request)
    sup = RecoverySupervisor(ckpt_dir=str(tmp_path))
    swapped = {}

    def on_step(rt, step):
        if not swapped and _decoding(rt, step):
            sup.snapshot(rt, step)
            rt2, got = sup.restore(mk())
            assert got == step and rt2.engine_steps == rt.engine_steps
            rt2.sched.completed[:0] = rt.sched.completed
            swapped["at"] = step
            return rt2
        return rt

    out, rt2 = drive(mk(), requests(cfg, sampled=True), Request,
                     on_step=on_step)
    assert swapped and out == base
    assert rt2.stats["prefill_events"] == 0
    assert sup.stats["snapshots"] == 1 == sup.stats["restarts"]
    assert sup.stats["restore_latency_s"]
    with pytest.raises(ValueError, match="needs ckpt_dir"):
        RecoverySupervisor().snapshot(rt2, 0)


def test_snapshot_restore_mid_prefill(models, tmp_path):
    """A row mid-way through chunked prefill: the restored runtime runs
    only the remaining chunks; the tokens equal the undisturbed run and
    the reference's."""
    cfg_r, ref, cfg, port = models
    rng = np.random.default_rng(9)
    long_prompt = [int(x) for x in rng.integers(4, cfg.vocab_size, size=14)]
    reqs = [dict(uid=0, prompt=list(long_prompt), max_new=4),
            dict(uid=1, prompt=[7, 8, 9], max_new=6)]
    mk = lambda: ServeRuntime(port, sc_port(cfg), ROWS, chunk=4,
                              device="cpu")
    want, _ = drive(RefRuntime(ref, sc_ref(cfg_r), ROWS, chunk=4), reqs,
                    RefRequest, late_at=0)
    sup = RecoverySupervisor(ckpt_dir=str(tmp_path))
    seen = {}

    def on_step(rt, step):
        if not seen and rt.sched.prefill_progress:
            _, (filled, total) = next(iter(rt.sched.prefill_progress.items()))
            assert 0 < filled < total
            sup.snapshot(rt, step)
            rt2, _ = sup.restore(mk())
            rt2.sched.completed[:0] = rt.sched.completed
            seen["remaining"] = -(-(total - filled) // 4)
            return rt2
        return rt

    out, rt2 = drive(mk(), reqs, Request, on_step=on_step, late_at=0)
    assert seen and out == want
    assert rt2.stats["prefill_events"] == seen["remaining"]


def test_restore_rejects_mismatched_grid(models, tmp_path):
    _, _, cfg, port = models
    rt = ServeRuntime(port, sc_port(cfg), ROWS, chunk=4, device="cpu")
    mgr = AsyncCheckpointManager(str(tmp_path))
    tree, meta = snapshot_state(rt)
    mgr.save(0, tree, metadata=meta)
    mgr.wait()
    other = ServeRuntime(port, sc_port(cfg), ROWS, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        restore_into(other, mgr)
    with pytest.raises(ValueError, match="not a serve snapshot"):
        restore_state(rt, tree, {"format": "bogus"})


def test_snapshot_format_v2_gates_kv_dtype(models):
    """v2 snapshots carry ``kv_dtype``: a v1 one is refused, and an int8
    snapshot does not restore into fp32 pages."""
    _, _, cfg, port = models
    assert recovery.SNAPSHOT_FORMAT == "mux-serve-v2"
    rt = ServeRuntime(port, sc_port(cfg, kv_dtype="int8"), ROWS, chunk=4,
                      device="cpu")
    tree, meta = snapshot_state(rt)
    assert meta["config"]["kv_dtype"] == "int8"
    with pytest.raises(ValueError, match="not a serve snapshot"):
        restore_state(rt, tree, {**meta, "format": "mux-serve-v1"})
    plain = ServeRuntime(port, sc_port(cfg), ROWS, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        restore_state(plain, tree, meta)


def test_snapshot_restore_quantized_pages(models, port_snapshots):
    """int8 pages: payloads and scales restored bit for bit (every leaf of
    the tree equal to the file's), zero re-prefill, the undisturbed
    run's tokens."""
    _, _, cfg, port = models
    d, want, step, done = port_snapshots["int8"]
    rt = ServeRuntime(port, sc_port(cfg, kv_dtype="int8"), ROWS, chunk=4,
                      device="cpu")
    rt, got = restore_into(rt, d)
    assert got == step
    layer = rt.cache["layers"][0]
    assert layer["kp"].dtype == torch.int8 and "ksc" in layer
    tree, _, _ = restore_checkpoint(d, {"cache": interop.
                                        paged_cache_to_reference(
                                            rt.cache, cfg, meta=True)})
    assert_tree_equal({"cache": interop.paged_cache_to_reference(rt.cache,
                                                                 cfg)}, tree)
    assert {**done, **_finish(rt)} == want
    assert rt.stats["prefill_events"] == 0


def test_restore_refuses_tables_that_differ_across_layers(models,
                                                          port_snapshots):
    _, _, cfg, port = models
    d = port_snapshots["fp32"][0]
    rt = ServeRuntime(port, sc_port(cfg), ROWS, chunk=4, device="cpu")
    tree, _, meta = AsyncCheckpointManager(d).restore(
        {"cache": interop.paged_cache_to_reference(rt.cache, cfg,
                                                   meta=True)})
    tree["cache"]["periods"][0]["bt"][1, 0, 0] += 1
    with pytest.raises(ValueError, match="block table differs"):
        restore_state(rt, tree, meta)


def test_torn_handoff_is_refused(models):
    """A prefill lane's parked rows are recorded; a restore whose state
    re-derives another set is a torn handoff."""
    _, _, cfg, port = models
    mk = lambda: ServeRuntime(port, sc_port(cfg), ROWS, chunk=4,
                              device="cpu", role="prefill")
    rt = mk()
    rt.submit(Request(uid=0, prompt=[5, 6, 7, 8, 9], max_new=3))
    while not rt.handoff_ready():
        rt.step()
    tree, meta = snapshot_state(rt)
    assert meta["pending_handoffs"] == [0]
    assert restore_state(mk(), tree, meta).handoff_ready() == [0]
    with pytest.raises(ValueError, match="torn handoff"):
        restore_state(mk(), tree, {**meta, "pending_handoffs": []})


# ----------------------------------------------------------- cross-restore

@pytest.mark.parametrize("kind", list(KV))
def test_port_restores_reference_snapshots(models, ref_snapshots, kind):
    """A reference-written snapshot on each page storage, restored by the
    port, continues token-identically with the reference's undisturbed
    run, with no re-prefill."""
    _, _, cfg, port = models
    d, want, step, done = ref_snapshots[kind]
    rt = ServeRuntime(port, sc_port(cfg, kv_dtype=KV[kind]), ROWS, chunk=4,
                      device="cpu")
    rt, got = restore_into(rt, d)
    assert got == step
    assert {**done, **_finish(rt)} == want
    assert rt.stats["prefill_events"] == 0


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_reference_restores_port_snapshots(models, ref_snapshots,
                                           port_snapshots, kind):
    """A port-written snapshot on fp32 / int8 pages, restored by the
    reference, continues token-identically with the reference's
    undisturbed run (and the port's)."""
    cfg_r, ref, cfg, _ = models
    d, port_out, step, done = port_snapshots[kind]
    want = ref_snapshots[kind][1]
    assert port_out == want
    rt = RefRuntime(ref, sc_ref(cfg_r, kv_dtype=KV[kind]), ROWS, chunk=4)
    rt, got = ref_recovery.restore_into(rt, d)
    assert got == step
    assert {**done, **_finish(rt)} == want
    assert rt.stats["prefill_events"] == 0


def _no_stamps(x):
    if isinstance(x, dict):
        return {k: _no_stamps(v) for k, v in x.items()
                if not k.startswith("t_")}
    if isinstance(x, list):
        return [_no_stamps(v) for v in x]
    return x


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_snapshot_tree_json_is_the_references(ref_snapshots, port_snapshots,
                                              kind):
    """Both packages' snapshots of the same state (the same step of the
    same run): the same leaves (paths, files, shapes, dtypes) and the same
    metadata, the requests' wall-clock stamps aside."""
    def index(d, step):
        with open(os.path.join(d, f"step_{step:09d}", "tree.json")) as f:
            return json.load(f)

    (pd, _, ps, _), (rd, _, rs, _) = port_snapshots[kind], ref_snapshots[kind]
    assert ps == rs
    p, r = index(pd, ps), index(rd, rs)
    assert p["leaves"] == r["leaves"] and p["step"] == r["step"]
    assert _no_stamps(p["metadata"]) == _no_stamps(r["metadata"])
    assert p["metadata"]["slots"] and p["metadata"]["row_tokens"]


@pytest.mark.parametrize("kind", ["bf16-default", "bf16", "fp8"])
def test_reference_restore_fails_on_bf16_and_fp8_pages(models, ref_snapshots,
                                                       tmp_path, kind):
    """The reference's ``restore_checkpoint`` ``np.load`` s a bf16 / fp8
    leaf as void and ``jax.device_put`` refuses it (ROADMAP §3): it
    cannot restore its own snapshot of such pages, its default
    ``ServeConfig`` (bf16 compute, pages in it) included.  The port
    restores the same snapshot, every page bit for bit."""
    cfg_r, ref, cfg, port = models
    if kind == "bf16-default":
        from repro.serve import ServeConfig as RefServeConfig
        from repro.core import MuxSpec as RefMux
        from repro_torch.core import MuxSpec
        from repro_torch.serve.engine import ServeConfig
        sc_r = RefServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=1),
                              capacity=20, cache_layout="paged", block_size=4)
        sc = ServeConfig(cfg=cfg, mux=MuxSpec(n=1), capacity=20,
                         cache_layout="paged", block_size=4)
        d = str(tmp_path)
        rt_r = RefRuntime(ref, sc_r, ROWS, chunk=4)
        for r in requests(cfg)[:2]:
            rt_r.submit(RefRequest(**r))
        for _ in range(3):
            rt_r.step()
        sup = ref_recovery.RecoverySupervisor(ckpt_dir=d)
        sup.snapshot(rt_r, 3)
        sup.ckpt.wait()
    else:
        d = ref_snapshots[kind][0]
        sc_r, sc = sc_ref(cfg_r, kv_dtype=KV[kind]), sc_port(
            cfg, kv_dtype=KV[kind])
    with pytest.raises(TypeError, match="not a valid JAX array type"):
        ref_recovery.restore_into(RefRuntime(ref, sc_r, ROWS, chunk=4), d)
    rt = ServeRuntime(port, sc, ROWS, chunk=4, device="cpu")
    restore_into(rt, d)
    step = available_steps(d)[-1]
    index = json.load(open(os.path.join(d, f"step_{step:09d}",
                                        "tree.json")))
    kp = next(e for e in index["leaves"] if e["path"].endswith("/kp"))
    assert kp["dtype"] in ("bfloat16", "float8_e4m3fn")
    tree, _, _ = restore_checkpoint(d, {"cache": interop.
                                        paged_cache_to_reference(
                                            rt.cache, cfg, meta=True)})
    assert_tree_equal({"cache": interop.paged_cache_to_reference(rt.cache,
                                                                 cfg)}, tree)
    assert rt.pool.n_used_blocks > 0


# ------------------------------------------------------- fuzz arm and CLI

def test_fuzz_restart(models, tmp_path):
    """The fuzz's restart arm (seed 5, restart at step 6): the reference's
    tokens, prefill events and recovery counters; pools drained."""
    cfg_r, ref, cfg, port = models
    arrivals = _schedule(cfg, 5)
    kw = dict(chunk=4, events=[{"step": 6, "op": "restart"}])
    got = cli.run_continuous(port, sc_port(cfg), ROWS,
                             copy_arrivals(arrivals), device="cpu",
                             ckpt_dir=str(tmp_path / "port"), **kw)
    want = ref_run_continuous(ref, sc_ref(cfg_r), ROWS,
                              copy_arrivals(arrivals),
                              ckpt_dir=str(tmp_path / "ref"), **kw)
    assert tokens(got, arrivals) == tokens(want, arrivals)
    for k in ("prefill_events", "prefill_tokens", "decode_steps"):
        assert got[k] == want[k], k
    assert recovery_counts(got["recovery"]) == recovery_counts(
        want["recovery"])
    assert got["recovery"]["restarts"] == 1
    assert got["pool"].n_used_blocks == 0
    got["pool"].check_invariants()


def test_cli_restart_prints_the_reference_counts(capsys, tmp_path):
    from repro.launch import serve as ref_cli
    base = ["--continuous", "--cache", "paged", "--requests", "4",
            "--prompt-len", "6", "--new-tokens", "3", "--block-size", "4",
            "--chunk", "4", "--mux-n", "1", "--restart-step", "6"]
    assert cli.main(base + ["--ckpt-dir", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    got = cli_counts(capsys.readouterr().out)
    assert ref_cli.main(base + ["--ckpt-dir", str(tmp_path / "ref")]) == 0
    assert got == cli_counts(capsys.readouterr().out)
    assert any(ln.startswith("recovery:") and "1 restarts" in ln
               for ln in got)
    assert available_steps(str(tmp_path / "port")) == [6]
