"""The three dense architectures that serve on the port's existing blocks —
gemma-2b (MQA, head_dim 256, GeGLU, embeddings scaled by sqrt(d)),
gemma-7b (MHA at head_dim 256) and h2o-danube-1.8b (head_dim 80 from
2560 / 32, a sliding window) — against the JAX reference on the CPU, at
the reference's reduced configs.  The reduced h2o-danube keeps head_dim
80 at d 64 and a window of 16, as the reference's does.

  * the registry: ``get_config`` of every served architecture (the MoE
    pair and recurrentgemma-9b too), full and reduced, equal to the reference's field for field
    (the reference's training-only fields aside; ``moe`` field by field),
    with the same ``param_count`` and ``active_param_count``;
  * ``interop``: reference -> port -> reference, leaf for leaf;
  * logits within test_torch_model.py's 1e-5 on the plain and the kernel
    path (reference: Pallas in interpret mode; port: the wrappers' plain
    versions on CPU tensors): paged chunks and a decode step; blocking
    prefills of a 20-token prompt (past h2o's window) with attn_impl
    naive, chunked (8-key chunks) and flash, then ring decode steps;
  * greedy tokens identical to the reference on the ring, paged-chunked
    and paged-blocking arms of ``run_continuous`` and in fill-drain, with
    prompt plus new tokens past h2o's window;
  * the CLI serves each architecture on ``--device cpu --reduced``.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as ref_archs
from repro.configs import get_config as ref_config
from repro.configs import model_kind as ref_model_kind
from repro.core import MuxSpec as RefMux
from repro.launch.serve import run_continuous as ref_run_continuous
from repro.models import TransformerLM as RefLM
from repro.models.config import active_param_count as ref_active_param_count
from repro.models.config import param_count as ref_param_count
from repro.serve import engine as ref_engine
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.launch import serve as cli
from repro_torch.models import active_param_count, param_count
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serve import engine
from test_torch_model import _leaves
from test_torch_ring import ref_fill_drain

torch.set_num_threads(2)

DENSE = ("gemma-2b", "gemma-7b", "h2o-danube-1.8b")
TOL = dict(atol=1e-5, rtol=1e-5)      # tests/test_torch_model.py's TOL
N = 2


def _same_config(mine, want):
    """Every field of the port's ``ModelConfig`` equals the reference's
    (an encoder config and an ``MoEConfig`` field by field)."""
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(mine, f.name), getattr(want, f.name)
        if isinstance(a, ModelConfig):
            _same_config(a, b)
        elif isinstance(a, MoEConfig):
            assert [f.name for f in dataclasses.fields(a)] == [
                f.name for f in dataclasses.fields(b)]
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_configs_match_reference(arch, reduced):
    mine, want = get_config(arch, reduced=reduced), ref_config(
        arch, reduced=reduced)
    _same_config(mine, want)
    assert (mine.moe is None) == (want.moe is None)
    assert param_count(mine) == ref_param_count(want)
    assert active_param_count(mine) == ref_active_param_count(want)
    assert model_kind(arch) == ref_model_kind(arch)


def test_registry_serves_six_architectures():
    """The six dense / RWKV / encoder-decoder architectures, since the
    MoE slice granite-moe-3b-a800m and qwen2-moe-a2.7b, since the hybrid
    slice recurrentgemma-9b, and since the VLM slice
    llava-next-mistral-7b: all ten of the reference's."""
    assert set(DENSE) < set(ARCHS) and len(ARCHS) == 10
    assert {"granite-moe-3b-a800m", "qwen2-moe-a2.7b",
            "recurrentgemma-9b", "llava-next-mistral-7b"} < set(ARCHS)
    assert set(ARCHS) == set(ref_archs)
    h2o = get_config("h2o-danube-1.8b", reduced=True)
    assert (h2o.d_model, h2o.head_dim, h2o.window) == (64, 80, 16)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, n=N, impl="auto"):
    cfg_r = ref_config(arch, reduced=True).replace(attn_impl=impl,
                                                   attn_chunk=8)
    ref = jax.tree.map(np.asarray, RefLM.init(jax.random.PRNGKey(7), cfg_r,
                                              RefMux(n=n)))
    cfg = get_config(arch, reduced=True).replace(attn_impl=impl, attn_chunk=8)
    return cfg_r, ref, cfg, interop.params_from_reference(ref, cfg,
                                                          device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_interop_round_trip(arch):
    _, ref, cfg, port = _ref_params(arch)
    assert port["layers"][0]["wq"]["w"].shape == (cfg.d_model, cfg.n_heads,
                                                  cfg.head_dim)
    a = dict(_leaves(ref))
    b = dict(_leaves(interop.params_to_reference(port, cfg)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _paged_steps(arch, use_kernels):
    """Three chunks (one crossing a block boundary, one bucket-padded) and
    one decode step through both packages' paged engines; yields (port
    logits, reference logits)."""
    cfg_r, ref, cfg, port = _ref_params(arch)
    kw = dict(capacity=40, cache_layout="paged", block_size=4)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                  dtype=jnp.float32, **kw)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), dtype=torch.float32,
                            **kw)
    rows = 3
    cache_r = ref_engine.init_cache(sc_r, N * rows)
    cache = engine.init_cache(sc, N * rows, device="cpu")
    pool = ref_engine.make_pool(sc_r, N * rows)
    pool.allocate(0, 30)
    pool.allocate(1, 21)          # row 2 stays unallocated (inactive)
    tables = pool.table_array(range(rows))
    cache_r = ref_engine.set_block_tables(cache_r, tables)
    engine.set_block_tables(cache, tables)
    rng = np.random.default_rng(1)
    # row 0 reaches position 22, past h2o's window of 16
    for row, start, length in [(0, 0, 8), (0, 8, 8), (0, 16, 6), (1, 0, 5)]:
        toks = rng.integers(4, 512, size=(N, 8)).astype(np.int32)
        want, cache_r = ref_engine.prefill_chunk(
            ref, sc_r, cache_r, jnp.asarray(toks), rows=jnp.asarray([row]),
            start=start, length=length, use_kernels=use_kernels)
        got, _ = engine.prefill_chunk(port, sc, cache, torch.as_tensor(toks),
                                      rows=[row], start=start, length=length,
                                      use_kernels=use_kernels)
        yield got, want
    toks = rng.integers(4, 512, size=(N * rows, 1)).astype(np.int32)
    pos = np.asarray([22, 5, -1], np.int32)
    want, _ = ref_engine.decode_step(ref, sc_r, cache_r, jnp.asarray(toks),
                                     jnp.asarray(pos),
                                     use_kernels=use_kernels)
    got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(toks),
                                torch.as_tensor(pos), use_kernels=use_kernels)
    yield got, want


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_paged_logits_match_reference(arch, use_kernels):
    for got, want in _paged_steps(arch, use_kernels):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl,use_kernels", [("naive", False),
                                              ("naive", True),
                                              ("chunked", False),
                                              ("flash", True)])
@pytest.mark.parametrize("arch", DENSE)
def test_blocking_prefill_and_ring_decode_match_reference(arch, impl,
                                                          use_kernels):
    """A blocking prefill of a 20-token prompt (the attention follows
    ``attn_impl``; under use_kernels the port's entry runs the
    mux-combine wrapper) into a ring of capacity 24 (h2o's is cut to its
    window of 16 and wraps), then three ring decode steps (under
    use_kernels the flash-decode and fused entry / exit wrappers;
    reference: its Pallas kernels in interpret mode)."""
    cfg_r, ref, cfg, port = _ref_params(arch, impl=impl)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                  capacity=24, dtype=jnp.float32)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), capacity=24,
                            dtype=torch.float32)
    toks = np.random.default_rng(2).integers(4, 512, (2 * N, 20)).astype(
        np.int32)
    cache_r = ref_engine.init_cache(sc_r, 2 * N)
    cache = engine.init_cache(sc, 2 * N, device="cpu")
    want, cache_r = ref_engine.prefill(ref, sc_r, cache_r, jnp.asarray(toks))
    got, _ = engine.prefill(port, sc, cache, torch.as_tensor(toks),
                            use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    for t in range(3):
        want, cache_r = ref_engine.decode_step(ref, sc_r, cache_r,
                                               jnp.asarray(tok), 20 + t,
                                               use_kernels=use_kernels)
        got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(tok),
                                    20 + t, use_kernels=use_kernels)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want)[:, 0].argmax(-1)[:, None].astype(np.int32)


def _trace():
    """(step, prompt, max_new): staggered arrivals, every request's prompt
    plus new tokens past h2o's window of 16."""
    rng = np.random.default_rng(4)
    return [(s, rng.integers(4, 512, size=(k,)).tolist(), m)
            for s, k, m in zip([0, 0, 2, 5], [14, 9, 18, 6], [6, 8, 4, 12])]


def _outputs(stats):
    return {r.uid: list(r.output) for r in stats["completed"]}


@pytest.mark.parametrize("arm", ["ring", "paged-chunked", "paged-blocking",
                                 "fill-drain"])
@pytest.mark.parametrize("arch", DENSE)
def test_greedy_arms_token_identical(arch, arm):
    """The port's kernel path (plain versions on the CPU) against the
    reference's arms on one trace, 2 rows at N=2: the same greedy tokens
    and prefill accounting."""
    cfg_r, ref, cfg, port = _ref_params(arch)
    layout = "ring" if arm in ("ring", "fill-drain") else "paged"
    kw = dict(capacity=40, cache_layout=layout, block_size=4)
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=N),
                                  dtype=jnp.float32, **kw)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=N), dtype=torch.float32,
                            **kw)
    if arm == "fill-drain":
        rng = np.random.default_rng(5)
        prompts = [rng.integers(4, 512, 12).astype(np.int32)
                   for _ in range(5)]
        got = cli.fill_drain(port, sc, 2, prompts, 8, device="cpu")
        assert [r.output for r in got["completed"]] == ref_fill_drain(
            ref, sc_r, 2, prompts, 8)
        return
    mode = "blocking" if arm == "paged-blocking" else "chunked"
    trace = _trace()
    want = ref_run_continuous(ref, sc_r, 2, trace, chunk=8,
                              prefill_mode=mode)
    got = cli.run_continuous(port, sc, 2, trace, chunk=8, prefill_mode=mode,
                             device="cpu")
    assert [len(r.output) for r in got["completed"]] == \
        [len(r.output) for r in want["completed"]]
    assert _outputs(got) == _outputs(want)
    for k in ("prefill_events", "prefill_tokens", "prefill_compute_tokens",
              "prefill_log", "decode_steps"):
        assert got[k] == want[k], k
    if layout == "paged":
        assert got["trace_counts"] == want["trace_counts"]
        assert got["runtime"].pool.n_used_blocks == 0


@pytest.mark.parametrize("arch", DENSE)
def test_cli_serves_on_cpu(capsys, arch):
    """Paged chunked serving of the reduced config through the CLI: the
    reference CLI's counts and its pool bytes per token."""
    assert cli.main(["--arch", arch, "--device", "cpu", "--continuous",
                     "--cache", "paged", "--requests", "3", "--prompt-len",
                     "6", "--new-tokens", "3", "--block-size", "4",
                     "--chunk", "4"]) == 0
    out = capsys.readouterr().out
    sc_r = ref_engine.ServeConfig(cfg=ref_config(arch, reduced=True),
                                  kind="lm", mux=RefMux(n=2), capacity=17,
                                  dtype=jnp.float32, cache_layout="paged",
                                  block_size=4)
    assert "continuous[paged/chunked/cpu] served 3 requests (9 tokens)" in out
    assert (f"kv pages torch.float32: pool {sc_r.pool_bytes(4)} bytes, "
            f"{sc_r.kv_bytes_per_token()} bytes per token") in out
    assert re.search(r"step signatures: decode×1, prefill_4×1", out)
