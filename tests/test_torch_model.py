"""The port's TransformerLM against the JAX reference, on the CPU.

Weights cross over through ``repro_torch.interop`` from the reference's
own init; the same numpy inputs go through both.  Logits are compared for
one chunked-prefill chunk and one decode step at mux N=1 and N=2, on the
plain path and on the kernel path (reference: Pallas in interpret mode;
port: the wrappers' plain versions on CPU tensors).  Whole tensors are
compared, inactive rows included: both sides route the same writes to the
trash block and return the same uniform mean for a fully masked query.

Tolerance: atol = rtol = 1e-5 on logits of magnitude < 1 — fp32 on both
sides, differing only in summation order through two small layers
(measured differences are ~4e-7).  bf16, int8 and fp8 pages: QUANT_TOL,
with its reason below.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.models import TransformerLM as RefLM
from repro.serve import engine as ref_engine
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.models import TransformerLM, param_count
from repro_torch.serve import engine

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 / int8 / fp8 pages: a K or V element computed ~1e-7 apart by the two
# packages can round to neighbouring storage levels (one bf16 ulp, one int8
# level); such a flip in layer 0 moves the next layer's K/V by ~1e-5 and
# flips more there.  Measured: logits ~5e-5 apart at bf16, ~2e-6 at int8,
# ~3e-7 at fp8.  1e-4 is a fifth of what bf16 storage itself moves the
# logits from fp32 pages (5e-4 to 7e-4; int8 2e-3, fp8 1e-2).
QUANT_TOL = dict(atol=1e-4, rtol=1e-5)
ARCH = "qwen2-1.5b"


def _ref_params(n, seed=0):
    cfg = ref_config(ARCH, reduced=True)
    return jax.tree.map(np.asarray, RefLM.init(jax.random.PRNGKey(seed), cfg,
                                               RefMux(n=n)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("n", [1, 2])
def test_interop_round_trip(n):
    """reference -> port -> reference reproduces every leaf exactly, and
    the port holds one dict per layer with the reference's leaf layouts."""
    cfg = get_config(ARCH, reduced=True)
    ref = _ref_params(n)
    port = interop.params_from_reference(ref, cfg, device="cpu")
    assert len(port["layers"]) == cfg.n_layers
    assert port["layers"][0]["wq"]["w"].shape == (cfg.d_model, cfg.n_heads,
                                                  cfg.head_dim)
    back = interop.params_to_reference(port, cfg)
    a, b = dict(_leaves(ref)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            port["layers"][i]["ffn"]["up"]["w"].numpy(),
            ref["periods"][0]["ffn"]["up"]["w"][i])


@pytest.mark.parametrize("n", [1, 2])
def test_port_init_matches_reference_structure(n):
    """The port's own seeded init: the reference's tree, shapes and
    parameter count; zero RMSNorm scales and biases; unit-variance mux and
    demux keys; reproducible from the generator's seed."""
    cfg = get_config(ARCH, reduced=True)

    def init(seed):
        return TransformerLM.init(torch.Generator().manual_seed(seed), cfg,
                                  MuxSpec(n=n))
    p = init(0)
    ref = dict(_leaves(_ref_params(n)))
    mine = dict(_leaves(interop.params_to_reference(p, cfg)))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in ref.items()}
    n_dense = sum(v.size for k, v in mine.items() if "mux_engine" not in k)
    assert n_dense == param_count(cfg)
    assert not p["final_norm"]["scale"].any()
    assert not p["layers"][0]["wq"]["b"].any()
    if n > 1:
        keys = torch.cat([p["mux_engine"]["mux"]["v"].flatten(),
                          p["mux_engine"]["demux"]["k"].flatten()])
        assert 0.8 < keys.std() < 1.2
    w = p["layers"][1]["ffn"]["down"]["w"]
    assert 0.015 < w.std() < 0.025
    assert torch.equal(init(0)["embed"]["table"], p["embed"]["table"])
    assert not torch.equal(init(1)["embed"]["table"], p["embed"]["table"])


def _setup(n, kv_dtype=None):
    cfg_r = ref_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    ref = _ref_params(n)
    port = interop.params_from_reference(ref, cfg, device="cpu")
    sc_r = ref_engine.ServeConfig(cfg=cfg_r, kind="lm", mux=RefMux(n=n),
                                  capacity=40, dtype=jnp.float32,
                                  cache_layout="paged", block_size=4,
                                  kv_dtype=kv_dtype)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=n), capacity=40,
                            dtype=torch.float32, cache_layout="paged",
                            block_size=4,
                            kv_dtype=kv_dtype)
    rows = 3
    cache_r = ref_engine.init_cache(sc_r, n * rows)
    cache = engine.init_cache(sc, n * rows, device="cpu")
    pool = ref_engine.make_pool(sc_r, n * rows)
    pool.allocate(0, 30)
    pool.allocate(1, 21)          # row 2 stays unallocated (inactive)
    tables = pool.table_array(range(rows))
    cache_r = ref_engine.set_block_tables(cache_r, tables)
    engine.set_block_tables(cache, tables)
    return ref, port, sc_r, sc, cache_r, cache, rows


def _prefill_then_decode(n, use_kernels, kv_dtype=None):
    """Three chunks and one decode step through both packages; yields
    (port logits, reference logits) per step."""
    ref, port, sc_r, sc, cache_r, cache, rows = _setup(n, kv_dtype)
    rng = np.random.default_rng(n)
    # row 0: a 16-token prompt in a bucket-8 chunk (6 valid), then 8 more
    # (chunk ending on a block boundary); row 1: one chunk of 5
    for row, start, length in [(0, 0, 6), (0, 6, 8), (1, 0, 5)]:
        toks = rng.integers(4, 512, size=(n, 8)).astype(np.int32)
        want, cache_r = ref_engine.prefill_chunk(
            ref, sc_r, cache_r, jnp.asarray(toks), rows=jnp.asarray([row]),
            start=start, length=length, use_kernels=use_kernels)
        got, _ = engine.prefill_chunk(port, sc, cache, torch.as_tensor(toks),
                                      rows=[row], start=start, length=length,
                                      use_kernels=use_kernels)
        yield got, want
    toks = rng.integers(4, 512, size=(n * rows, 1)).astype(np.int32)
    pos = np.asarray([14, 5, -1], np.int32)
    want, _ = ref_engine.decode_step(ref, sc_r, cache_r, jnp.asarray(toks),
                                     jnp.asarray(pos),
                                     use_kernels=use_kernels)
    got, _ = engine.decode_step(port, sc, cache, torch.as_tensor(toks),
                                torch.as_tensor(pos), use_kernels=use_kernels)
    assert got.shape == (n * rows, 1, 512)
    yield got, want


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_logits_match_reference(n, use_kernels):
    for got, want in _prefill_then_decode(n, use_kernels):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_dtype,n,use_kernels", [
    ("bf16", 1, True), ("bf16", 2, True), ("int8", 1, True),
    ("int8", 2, True), ("fp8", 1, True), ("fp8", 2, True),
    ("int8", 2, False)])
def test_quantized_page_logits_match_reference(kv_dtype, n, use_kernels):
    """bf16, int8 and fp8 pages: the kernel path (reference: the fused-
    dequant Pallas kernels in interpret mode; port: the wrappers' plain
    dequantize-then-attend versions) and, for int8, the plain path.  Both
    sides store the same payloads unless a K/V element computed ~1e-7
    apart lands on the other side of a rounding boundary (QUANT_TOL)."""
    for got, want in _prefill_then_decode(n, use_kernels, kv_dtype):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **QUANT_TOL)
