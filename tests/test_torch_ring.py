"""The port's ring-cache, blocking-prefill and fill-drain serving against
the JAX reference, on the CPU.

A churn trace (staggered arrivals, mixed prompt lengths, more requests
than slots) goes through the reference's ``run_continuous`` ring arm and
``ServeRuntime(chunk=None)`` and through the port's, from the same weights
(``repro_torch.interop``): greedy decoding must be token-identical, with
the same prefill accounting (``prefill_events``, ``prefill_tokens``,
``prefill_log``), the same ``max_grid_pos`` on the ring (whose capacity
here is small enough that the write position reaches it and forces a
rebuild) and the same ``trace_counts`` on the pages.  The port's ring
decode runs ``decode_attention`` and the fused entry and exit under
``use_kernels`` (their plain versions on the CPU), which the reference's
CLI arm does not; tokens must not change.  ``attn_impl='flash'`` cases run
the reference's Pallas flash kernel in interpret mode.  Also:
``greedy_generate`` on both layouts, fill-drain, and each step's wrapper
calls.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.serve import engine as ref_engine
from repro.serve.batcher import MuxBatcher as RefBatcher
from repro.serve.batcher import Request as RefRequest
from repro.serve.runtime import ServeRuntime as RefRuntime
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve as cli
from repro_torch.serve import engine
from repro_torch.serve.batcher import MuxBatcher, Request
from repro_torch.serve.runtime import ServeRuntime

torch.set_num_threads(2)

ARCH = "qwen2-1.5b"


def _pair(n, layout, capacity, impl="auto"):
    cfg_r = ref_config(ARCH, reduced=True).replace(attn_impl=impl)
    ref = RefLM.init(jax.random.PRNGKey(5), cfg_r, RefMux(n=n))
    cfg = get_config(ARCH, reduced=True).replace(attn_impl=impl)
    port = interop.params_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                          device="cpu")
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=n),
                                  capacity=capacity, dtype=jnp.float32,
                                  cache_layout=layout, block_size=4)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), capacity=capacity,
                            dtype=torch.float32, cache_layout=layout,
                            block_size=4)
    return ref, port, sc_r, sc


def _churn(n_req=5, seed=0):
    """(step, prompt, max_new): staggered arrivals, mixed lengths (a
    single-token prompt among them)."""
    rng = np.random.default_rng(seed)
    lens = [9, 1, 14, 6, 11][:n_req]
    news = [6, 4, 3, 7, 5][:n_req]
    steps = [0, 0, 1, 3, 4][:n_req]
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip(steps, lens, news)]


def _outputs(stats):
    return {r.uid: list(r.output) for r in stats["completed"]}


def _ring_churn(seed=0):
    """A long prompt with 2 new tokens beside a short one with 12: once
    the long stream retires, the write position (set by its length) runs
    ahead of every live stream and reaches capacity 18, which forces a
    rebuild between admissions."""
    rng = np.random.default_rng(seed)
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip([0, 0, 1, 4, 6], [14, 3, 5, 8, 2],
                               [2, 12, 6, 4, 9])]


@pytest.mark.parametrize("use_kernels,impl", [(False, "auto"),
                                              (True, "flash")])
def test_ring_arm_token_identical(use_kernels, impl):
    ref, port, sc_r, sc = _pair(2, "ring", 18, impl)
    arrivals = _ring_churn()
    want = ref_run_continuous(ref, sc_r, 2, arrivals)
    got = cli.run_continuous(port, sc, 2, arrivals, use_kernels=use_kernels,
                             device="cpu")
    assert [len(r.output) for r in got["completed"]] == [2, 6, 4, 12, 9]
    assert _outputs(got) == _outputs(want)
    for k in ("prefill_events", "prefill_tokens", "prefill_compute_tokens",
              "prefill_log", "decode_steps", "max_grid_pos", "slot_util",
              "cache_util"):
        assert got[k] == want[k], k
    # four admissions and one rebuild at capacity
    assert got["prefill_events"] == 5 and got["max_grid_pos"] == 18


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


@pytest.mark.parametrize("n,rows", [(2, 2), (1, 3)])
def test_paged_blocking_runtime_token_identical(n, rows):
    ref, port, sc_r, sc = _pair(n, "paged", 40)
    arrivals = _churn()
    rt_r = RefRuntime(ref, sc_r, rows, chunk=None)
    rt = ServeRuntime(port, sc, rows, chunk=None, use_kernels=False,
                      device="cpu")
    assert _drive(rt, arrivals, Request) == _drive(rt_r, arrivals,
                                                   RefRequest)
    assert rt.trace_counts == rt_r.trace_counts == {"decode": 1}
    assert rt.stats["prefill_mode"] == rt_r.stats["prefill_mode"] \
        == "blocking"
    for k in ("prefill_events", "prefill_tokens", "prefill_compute_tokens",
              "prefill_log", "decode_steps"):
        assert rt.stats[k] == rt_r.stats[k], k
    rt.check_compile_once()
    rt.pool.check_invariants()
    assert rt.pool.n_used_blocks == 0


def test_paged_blocking_run_continuous_flash_kernels():
    """``run_continuous(prefill_mode='blocking')`` on the kernel path with
    the flash prefill (reference: paged decode and flash kernels in
    interpret mode)."""
    ref, port, sc_r, sc = _pair(2, "paged", 40, "flash")
    arrivals = _churn(n_req=3)
    want = ref_run_continuous(ref, sc_r, 2, arrivals, prefill_mode="blocking",
                              use_kernels=True)
    got = cli.run_continuous(port, sc, 2, arrivals, prefill_mode="blocking",
                             use_kernels=True, device="cpu")
    assert _outputs(got) == _outputs(want)
    assert got["trace_counts"] == want["trace_counts"]
    for k in ("prefill_events", "prefill_tokens", "prefill_mode"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_greedy_generate_token_identical(layout):
    ref, port, sc_r, sc = _pair(2, layout, 24)
    prompt = np.random.default_rng(2).integers(4, 512, (4, 7)).astype(
        np.int32)
    want = ref_engine.greedy_generate(ref, sc_r, jnp.asarray(prompt),
                                      steps=6)
    got = engine.greedy_generate(port, sc, torch.as_tensor(prompt), steps=6)
    assert got.tolist() == np.asarray(want).tolist()


def ref_fill_drain(ref, sc_r, rows, prompts, new_tokens):
    """The reference CLI's fill-drain loop (``repro/launch/serve.py``
    ``_fill_drain``), greedy: each request's tokens, in batch order."""
    batcher = RefBatcher(n_mux=sc_r.mux.n, backbone_batch=rows)
    for p in prompts:
        batcher.submit(p, max_new=new_tokens)
    out = []
    while True:
        slots, owners = batcher.next_batch()
        if slots is None:
            return out
        uniq = list({id(s): s for s in slots}.values())
        toks = jnp.stack([jnp.asarray(s.prompt) for s in slots])
        cache = ref_engine.init_cache(sc_r, toks.shape[0])
        logits, cache = ref_engine.prefill(ref, sc_r, cache, toks)
        tok = jnp.argmax(RefBatcher.combine_logits(logits, owners,
                                                   len(uniq)), -1)
        outs = [tok]
        for t in range(new_tokens - 1):
            lg, cache = ref_engine.decode_step(
                ref, sc_r, cache, tok[jnp.asarray(owners)][:, None],
                toks.shape[1] + t)
            tok = jnp.argmax(RefBatcher.combine_logits(lg[:, 0], owners,
                                                       len(uniq)), -1)
            outs.append(tok)
        out += [[int(o[j]) for o in outs] for j in range(len(uniq))]


def test_fill_drain_token_identical():
    """Fill-drain over the ring, the reference CLI's loop against the
    port's ``fill_drain``: 3 requests in a grid of 4 slots (one
    duplicate, its logits averaged), then one more batch."""
    ref, port, sc_r, sc = _pair(2, "ring", 20)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 512, 6).astype(np.int32) for _ in range(5)]
    want = ref_fill_drain(ref, sc_r, 2, prompts, 4)
    got = cli.fill_drain(port, sc, 2, prompts, 4, device="cpu")
    assert [r.output for r in got["completed"]] == want
    assert (got["prefill_events"], got["decode_steps"]) == (2, 6)


def test_mux_batcher_duplicates_and_averages():
    b = MuxBatcher(n_mux=2, backbone_batch=2)
    reqs = [b.submit([i], max_new=1) for i in range(3)]
    slots, owners = b.next_batch()
    assert owners == [0, 1, 2, 0] and slots == [*reqs, reqs[0]]
    logits = torch.arange(8.).reshape(4, 2)
    want = RefBatcher.combine_logits(jnp.arange(8.).reshape(4, 2), owners, 3)
    assert MuxBatcher.combine_logits(logits, owners, 3).tolist() == \
        np.asarray(want).tolist()
    assert b.next_batch() == (None, None)


@pytest.mark.parametrize("impl,layout", [("flash", "ring"),
                                         ("naive", "ring"),
                                         ("flash", "paged")])
def test_wrapper_calls_per_step(impl, layout):
    """A blocking prefill calls flash_attention once per layer under
    attn_impl='flash' and no other wrapper (the reference's prefill runs
    the plain entry and exit); a ring decode step calls decode_attention
    once per layer plus the fused entry and exit, a paged one
    paged_attention."""
    _, port, _, sc = _pair(2, layout, 24, impl)
    layers = sc.cfg.n_layers
    cache = engine.init_cache(sc, 4, device="cpu")
    if layout == "paged":
        pool = engine.make_pool(sc, 4)
        for r in range(2):
            pool.allocate(r, 9)
        engine.set_block_tables(cache, pool.table_array(range(2)))
    ops.reset_counts()
    engine.prefill(port, sc, cache, torch.zeros((4, 8), dtype=torch.long))
    calls = ops.counts("calls")
    assert calls.pop("flash_attention") == (layers if impl == "flash" else 0)
    assert not any(calls.values())
    ops.reset_counts()
    pos = 8 if layout == "ring" else torch.tensor([8, 8])
    engine.decode_step(port, sc, cache, torch.zeros((4, 1), dtype=torch.long),
                       pos)
    attn = "decode_attention" if layout == "ring" else "paged_attention"
    assert ops.counts("calls") == {
        **dict.fromkeys(ops.counts(), 0), attn: layers,
        "mux_embed_combine": 1, "demux_rsa": 1}
    assert not any(ops.counts("launches").values())           # CPU: plain
    if layout == "ring":
        with pytest.raises(TypeError, match="int position"):
            engine.decode_step(port, sc, cache, torch.zeros((4, 1)),
                               torch.tensor([9, 9]))


def test_ring_entry_points_default_to_cuda():
    """The ring arm and fill-drain resolve to ``cuda`` like the paged
    runtime: without a card they raise rather than serve on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid")
    _, port, _, sc = _pair(2, "ring", 24)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run_continuous(port, sc, 2, _ring_churn()[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.fill_drain(port, sc, 2, [[5, 6, 7]], 2)
