"""The port's serve stack against the JAX reference, on the CPU.

A churn trace (requests of different prompt lengths arriving over time,
more requests than slots, rows draining and refilling) goes through the
reference's ``ServeRuntime`` / ``run_continuous`` and the port's, from the
same weights (``repro_torch.interop``): greedy decoding must be
token-identical, and the step signatures (``trace_counts``) must be the
reference's compile counts.  Also: wrapper call counts per step, the
``cuda`` default of the entry points, the CLI's modes (ring, blocking,
fill-drain, chunked paged) and rejected flags, and the host-side copies (pool, sampling, telemetry).
"""
import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro.serve.batcher import Request as RefRequest
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve as cli
from repro_torch.serve import engine, sampling
from repro_torch.serve.batcher import Request
from repro_torch.models import TransformerLM
from repro_torch.serve.kvpool import (KVPool, PoolExhausted, init_pages,
                                      paged_write)
from repro_torch.serve.runtime import ServeRuntime
from repro_torch.serve.telemetry import Telemetry

torch.set_num_threads(2)

ARCH = "qwen2-1.5b"
CAPACITY = 48


def _pair(n, kv_dtype=None):
    cfg_r = ref_config(ARCH, reduced=True)
    ref = RefLM.init(jax.random.PRNGKey(3), cfg_r, RefMux(n=n))
    cfg = get_config(ARCH, reduced=True)
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                          device="cpu")
    sc_r = RefServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=n),
                          capacity=CAPACITY, dtype=jnp.float32,
                          cache_layout="paged", block_size=4,
                          kv_dtype=kv_dtype)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), dtype=torch.float32,
                            capacity=CAPACITY, cache_layout="paged",
                            block_size=4, kv_dtype=kv_dtype)
    return ref, port, sc_r, sc


def _churn(n_req=5, seed=0):
    """(step, prompt, max_new): staggered arrivals, mixed lengths (a
    single-token prompt, chunk-spanning prompts, a prompt ending on a
    block boundary)."""
    rng = np.random.default_rng(seed)
    lens = [13, 1, 20, 8, 11, 5, 17][:n_req]
    news = [6, 4, 3, 7, 5, 2, 4][:n_req]
    steps = [0, 0, 1, 3, 4, 6, 6][:n_req]
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip(steps, lens, news)]


def _drive(rt, arrivals, request_cls):
    arrivals = sorted(arrivals, key=lambda a: a[0])
    step = uid = 0
    while arrivals or rt.has_work():
        while arrivals and arrivals[0][0] <= step:
            s, prompt, m = arrivals.pop(0)
            rt.submit(request_cls(uid=uid, prompt=list(prompt), max_new=m))
            uid += 1
        rt.step()
        step += 1
    return {r.uid: list(r.output) for r in rt.stats["completed"]}


@pytest.mark.parametrize("n,rows,chunk", [(2, 2, 8), (1, 3, 4)])
def test_runtime_churn_token_identical(n, rows, chunk):
    ref, port, sc_r, sc = _pair(n)
    arrivals = _churn()
    rt_r = RefRuntime(ref, sc_r, rows, chunk=chunk, use_kernels=False)
    rt = ServeRuntime(port, sc, rows, chunk=chunk, use_kernels=False,
                      device="cpu")
    want = _drive(rt_r, arrivals, RefRequest)
    got = _drive(rt, arrivals, Request)
    assert len(got) == len(arrivals)
    assert got == want
    assert rt.trace_counts == rt_r.trace_counts
    assert set(rt.trace_counts) == {"decode"} | {
        f"prefill_{b}" for b in rt.buckets if b <= chunk}
    rt.check_compile_once()
    rt.pool.check_invariants()
    assert rt.pool.n_used_blocks == 0


def test_run_continuous_token_identical():
    """``run_continuous``'s paged arm, both packages, same trace."""
    ref, port, sc_r, sc = _pair(2)
    arrivals = _churn()
    want = ref_run_continuous(ref, sc_r, 2, arrivals, chunk=8)
    got = cli.run_continuous(port, sc, 2, arrivals, chunk=8,
                             use_kernels=False, device="cpu")
    outs = {r.uid: r.output for r in got["completed"]}
    assert outs == {r.uid: r.output for r in want["completed"]}
    assert got["trace_counts"] == want["trace_counts"]
    for k in ("prefill_tokens", "prefill_compute_tokens", "prefill_events",
              "decode_steps", "prefill_log"):
        assert got[k] == want[k], k


def test_runtime_kernel_path_token_identical():
    """The kernel path (reference: Pallas interpret; port: the wrappers'
    plain versions on CPU) on a small trace."""
    ref, port, sc_r, sc = _pair(2)
    arrivals = _churn(n_req=2)
    rt_r = RefRuntime(ref, sc_r, 1, chunk=8, use_kernels=True)
    rt = ServeRuntime(port, sc, 1, chunk=8, use_kernels=True, device="cpu")
    assert _drive(rt, arrivals, Request) == _drive(rt_r, arrivals,
                                                   RefRequest)
    assert rt.trace_counts == rt_r.trace_counts


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_churn_token_identical(kv_dtype):
    """Quantized pages through ``run_continuous`` on both sides, kernel
    path (reference: the fused-dequant Pallas kernels in interpret mode;
    port: the wrappers' plain dequantize-then-attend versions), chunk 4:
    greedy token-identical, the same step signatures and prefill
    accounting, and the pool's byte accounting in the port's stats."""
    ref, port, sc_r, sc = _pair(2, kv_dtype)
    arrivals = _churn(n_req=4)
    want = ref_run_continuous(ref, sc_r, 2, arrivals, chunk=4,
                              use_kernels=True)
    got = cli.run_continuous(port, sc, 2, arrivals, chunk=4,
                             use_kernels=True, device="cpu")
    outs = {r.uid: r.output for r in got["completed"]}
    assert len(outs) == len(arrivals)
    assert outs == {r.uid: r.output for r in want["completed"]}
    assert got["trace_counts"] == want["trace_counts"]
    for k in ("prefill_tokens", "prefill_events", "decode_steps"):
        assert got[k] == want[k], k
    assert got["pool_bytes"] == sc_r.pool_bytes(4)
    assert got["kv_bytes_per_token"] == sc_r.kv_bytes_per_token()
    layer = got["runtime"].cache["layers"][0]
    assert layer["kp"].dtype == sc.page_dtype and "ksc" in layer


@pytest.mark.parametrize("n,extra", [(1, 0), (2, 2)])
def test_wrapper_calls_per_step(n, extra):
    """A decode step calls n_layers paged-attention wrappers plus, at
    N > 1, the fused entry and exit (the reference's trace-asserted
    n_layers + 2); a prefill chunk calls n_layers prefill wrappers."""
    _, port, _, sc = _pair(n)
    cfg = sc.cfg
    cache = engine.init_cache(sc, 2 * n, device="cpu")
    pool = engine.make_pool(sc, 2 * n)
    for r in range(2):
        pool.allocate(r, 9)
    engine.set_block_tables(cache, pool.table_array(range(2)))
    ops.reset_counts()
    engine.prefill_chunk(port, sc, cache, torch.zeros((n, 8), dtype=torch.long),
                         rows=[0], start=0, length=8)
    assert ops.counts("calls") == {
        "paged_prefill_attention": cfg.n_layers, "paged_attention": 0,
        "mux_embed_combine": extra // 2, "demux_rsa": extra // 2,
        "decode_attention": 0, "flash_attention": 0, "rwkv6_chunked": 0,
        "mux_combine": 0}
    ops.reset_counts()
    engine.decode_step(port, sc, cache, torch.zeros((2 * n, 1), dtype=torch.long),
                       torch.tensor([8, -1]))
    calls = ops.counts("calls")
    assert calls["paged_attention"] == cfg.n_layers
    assert sum(calls.values()) == cfg.n_layers + extra
    assert ops.counts("launches") == dict.fromkeys(calls, 0)   # CPU: plain


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid")
    _, port, _, sc = _pair(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeRuntime(port, sc, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run_continuous(port, sc, 2, _churn(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--continuous", "--requests", "1"])


def test_cli_serves_on_cpu(capsys):
    assert cli.main(["--continuous", "--cache", "paged", "--device", "cpu",
                     "--requests", "3", "--prompt-len", "6",
                     "--new-tokens", "3", "--block-size", "4",
                     "--chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests (9 tokens)" in out
    assert "decode×1" in out and "prefill_4×1" in out


@pytest.mark.parametrize("kv_dtype,per_token", [("int8", 1064),
                                                ("fp8", 1064),
                                                ("bf16", 2056)])
def test_cli_serves_quantized_pages_on_cpu(capsys, kv_dtype, per_token):
    """Reduced qwen2-1.5b (2 layers, Hkv=2, Dh=128): per layer and token
    2 x 2 x 128 payload bytes + 2 x 2 x 4 scale bytes + 4 position bytes
    = 532 at int8/fp8, 2 x 2 x 256 + 4 = 1028 at bf16; the pool holds
    2 rows x 5 blocks + the trash block, of 4 tokens each."""
    assert cli.main(["--continuous", "--cache", "paged", "--device", "cpu",
                     "--kv-dtype", kv_dtype, "--requests", "3",
                     "--prompt-len", "6", "--new-tokens", "3",
                     "--block-size", "4", "--chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests (9 tokens)" in out
    assert "decode×1" in out and "prefill_4×1" in out
    assert (f"pool {11 * 4 * per_token} bytes, {per_token} bytes per token"
            in out)


@pytest.mark.parametrize("build", [
    lambda sc, cfg: engine.init_cache(sc, 2),
    lambda sc, cfg: TransformerLM.init_cache(cfg, 1, 8, num_blocks=3),
    lambda sc, cfg: init_pages(3, 4, 2, 16, torch.float32),
    lambda sc, cfg: interop.params_from_reference({}, cfg),
], ids=["engine.init_cache", "TransformerLM.init_cache", "init_pages",
        "params_from_reference"])
def test_constructors_require_a_device(build):
    """No public constructor puts tensors on a device the caller did not
    name: ``device`` is a required keyword."""
    _, _, _, sc = _pair(2)
    with pytest.raises(TypeError, match="device"):
        build(sc, sc.cfg)


@pytest.mark.parametrize("argv,want", [
    (["--continuous", "--cache", "ring"],
     ["continuous[ring/cpu] served 3 requests (9 tokens)",
      "prefill 36 backbone tokens (36 padded) in 3 events"]),
    (["--continuous", "--cache", "paged", "--prefill", "blocking"],
     ["continuous[paged/blocking/cpu] served 3 requests (9 tokens)",
      "prefill 18 backbone tokens (18 padded) in 3 events",
      "step signatures: decode×1\n"]),
    ([], ["served 3 requests x 3 tokens in ",
          "(mux N=2, backbone batch 2; throughput "]),
], ids=["ring", "paged-blocking", "fill-drain"])
def test_cli_serves_ring_blocking_and_fill_drain_on_cpu(capsys, argv, want):
    """The reference CLI's modes and summary lines; the counts are the
    ones ``python -m repro.launch.serve`` prints for the same flags (its
    ring re-prefills both rows at every admission: 3 events of 6 tokens
    x 2 rows; blocking prefills each joining row once, unpadded)."""
    assert cli.main(argv + ["--device", "cpu", "--requests", "3",
                            "--prompt-len", "6", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    for line in want:
        assert line in out


def test_cli_use_kernels_flag_runs_the_reference_drive_line(capsys):
    """The reference's ``store_true`` spelling ``--use-kernels`` parses:
    the verify recipe's quantized-pages line serves on the kernel path
    (the wrappers' plain versions on CPU tensors: calls, no launches)."""
    ops.reset_counts()
    assert cli.main(["--continuous", "--cache", "paged", "--use-kernels",
                     "--kv-dtype", "int8", "--requests", "5",
                     "--new-tokens", "4", "--prompt-len", "8",
                     "--block-size", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "continuous[paged/chunked/cpu] served 5 requests (20 tokens)" in out
    assert "decode×1" in out
    calls = ops.counts("calls")
    assert calls["paged_attention"] and calls["paged_prefill_attention"]
    assert calls["mux_embed_combine"] and calls["demux_rsa"]
    assert not any(ops.counts("launches").values())


@pytest.mark.parametrize("argv", [
    ["--continuous", "--cache", "paged"],
    ["--continuous", "--cache", "paged", "--prefill", "blocking"],
    ["--continuous", "--cache", "ring"],
    [],
], ids=["paged-chunked", "paged-blocking", "ring", "fill-drain"])
def test_cli_no_use_kernels_runs_the_plain_path(capsys, argv):
    """``--no-use-kernels`` reaches every mode's plain model path: no
    wrapper is called at all."""
    ops.reset_counts()
    assert cli.main(argv + ["--no-use-kernels", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "6",
                            "--new-tokens", "3", "--block-size", "4"]) == 0
    assert "served 3 requests" in capsys.readouterr().out
    assert not any(ops.counts("calls").values())


@pytest.mark.parametrize("argv,match", [
    (["--kv-dtype", "int4"], "invalid choice"),
    (["--cache", "ring", "--kv-dtype", "int8"],
     "--kv-dtype requires --continuous --cache paged"),
    (["--lanes", "1,2"], "--lanes/--disagg require --continuous --cache "
                         "paged"),
    (["--mesh", "2,2"], "--mesh requires --continuous --cache paged"),
    (["--cache", "paged", "--kill-shard", "3:1"],
     "--kill-shard needs >= 2 data shards"),
    (["--shards", "2"], "--shards requires --continuous --cache paged"),
    (["--restart-step", "3"], "--restart-step requires --ckpt-dir"),
])
def test_cli_rejects_later_slices(capsys, argv, match):
    with pytest.raises(SystemExit) as e:
        cli.main(["--continuous", *argv, "--device", "cpu"])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_kvpool_and_paged_write():
    pool = KVPool(num_blocks=5, block_size=4, max_blocks_per_seq=3)
    assert pool.allocate(0, 5) == [1, 2]
    assert pool.append(0, 3) == []
    assert pool.append(0, 1) == [3]
    with pytest.raises(PoolExhausted):
        pool.append(0, 4)
    pool.free(0)
    pool.check_invariants()
    cache = {"kp": torch.zeros(3, 2, 1, 1), "vp": torch.zeros(3, 2, 1, 1),
             "ppos": torch.full((3, 2), -1, dtype=torch.int32),
             "bt": torch.tensor([[1, 2], [-1, -1]], dtype=torch.int32)}
    k = torch.arange(1., 5.).reshape(2, 2, 1, 1)
    paged_write(cache, k, -k, torch.tensor([[1, 2], [0, 1]]))
    assert cache["ppos"].tolist() == [[-1, -1], [-1, 1], [2, -1]]
    assert cache["kp"][1, 1].item() == 1. and cache["kp"][2, 0].item() == 2.


def test_sampling_greedy_and_seeded():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    arr = sampling.params_arrays(
        [None, sampling.SamplingParams(temperature=1.0, seed=7),
         sampling.SamplingParams(temperature=0.7, top_k=1, seed=1),
         sampling.SamplingParams(temperature=1.0, top_p=0.5, seed=2)])
    step = np.asarray([0, 3, 0, 1])
    a = sampling.sample(logits, arr["temperature"], arr["top_k"],
                        arr["top_p"], arr["seed"], step)
    b = sampling.sample(logits, arr["temperature"], arr["top_k"],
                        arr["top_p"], arr["seed"], step)
    assert torch.equal(a, b)                        # per (seed, step)
    assert a[0] == logits[0].argmax() and a[2] == logits[2].argmax()
    order = logits[3].argsort(descending=True)
    p = torch.softmax(logits[3], -1)[order].cumsum(0)
    assert a[3] in order[:int((p < 0.5).sum()) + 1]


def test_telemetry_records_the_runtime():
    """The telemetry copy records one span per decode step and chunk, one
    compile instant per step signature and the scheduler's counters, and
    changes no token (it reads no device value the runtime does not)."""
    _, port, _, sc = _pair(2)
    arrivals = _churn(n_req=3)
    tele = Telemetry()
    on = cli.run_continuous(port, sc, 2, arrivals, chunk=8,
                            use_kernels=False, telemetry=tele, device="cpu")
    off = cli.run_continuous(port, sc, 2, arrivals, chunk=8,
                             use_kernels=False, device="cpu")
    assert ({r.uid: r.output for r in on["completed"]}
            == {r.uid: r.output for r in off["completed"]})
    spans = collections.Counter(ev[1] for ev in tele.tracer.events
                                if ev[0] == "X")
    assert spans["decode"] == on["decode_steps"]
    assert spans["prefill_chunk"] == on["prefill_events"]
    compiles = [ev[6]["program"] for ev in tele.tracer.events
                if ev[0] == "i" and ev[1] == "compile"]
    assert sorted(compiles) == sorted(on["trace_counts"])
    reg = tele.registry
    assert reg.value("requests_completed", lane=0) == len(arrivals)
    assert reg.value("tokens_generated", lane=0) == on["generated_tokens"]
    h = reg.hist("decode_step_s", lane=0, shard=0)
    assert h.count == on["decode_steps"]
    assert h.vmin <= h.percentile(50) <= h.percentile(99) <= h.vmax
    assert reg.hist("ttft_s", lane=0).count == len(arrivals)
