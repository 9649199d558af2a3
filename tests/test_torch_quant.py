"""The port's quantized KV pages against the JAX reference, on the CPU.

``repro_torch.core.quant`` must give payloads and scales bit-identical to
``repro.core.quant`` (the same expressions; both round half to even), the
same analytic error bounds and the same dtype spellings; the pool's page
ops (``paged_write`` / ``paged_view``) must leave pages, scales and
positions bit-equal to the reference's on the same K/V; and the serve
config's byte accounting must be the reference's for every storage kind.
Inputs come from ``np.random.default_rng``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.core import MuxSpec as RefMux
from repro.core import quant as rq
from repro.serve import kvpool as ref_kvpool
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.core import quant as tq
from repro_torch.serve import engine
from repro_torch.serve import kvpool

torch.set_num_threads(2)

KINDS = ["int8", "fp8"]


def _bits(a) -> np.ndarray:
    """Any array (numpy, JAX or torch) as its raw bytes, for bit equality."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


# (case, shape, maker): the magnitudes and degenerate blocks of
# tests/test_quant.py
BLOCKS = {
    "mag_1e-3": lambda rng: rng.standard_normal((6, 2, 16)) * 1e-3,
    "mag_1": lambda rng: rng.standard_normal((6, 2, 16)),
    "mag_100": lambda rng: rng.standard_normal((6, 2, 16)) * 100,
    "all_zero": lambda rng: np.zeros((3, 16)),
    "denormal": lambda rng: np.full((2, 16), 1e-30),
    "max_magnitude": lambda rng: rng.standard_normal((4, 16)) * 1e30,
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_kv_bit_identical(kind, case):
    x = BLOCKS[case](np.random.default_rng(7)).astype(np.float32)
    q_r, s_r = rq.quantize_kv(jnp.asarray(x), kind)
    q, s = tq.quantize_kv(torch.from_numpy(x), kind)
    assert q.dtype == tq.kv_store_dtype(kind)
    np.testing.assert_array_equal(_bits(q), _bits(q_r))
    np.testing.assert_array_equal(_bits(s), _bits(s_r))
    np.testing.assert_array_equal(
        _bits(tq.dequantize_kv(q, s)), _bits(rq.dequantize_kv(q_r, s_r)))
    assert torch.isfinite(tq.dequantize_kv(q, s)).all()


@pytest.mark.parametrize("kind", KINDS)
def test_error_bounds_equal_reference(kind):
    rng = np.random.default_rng(3)
    s = np.abs(rng.standard_normal((5, 4, 2))).astype(np.float32)
    for fn in ("kv_error_bound", "kv_value_bound"):
        np.testing.assert_array_equal(
            getattr(tq, fn)(torch.from_numpy(s), kind).numpy(),
            np.asarray(getattr(rq, fn)(jnp.asarray(s), kind)), err_msg=fn)
    q = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    ks = np.abs(rng.standard_normal((6, 4, 2))).astype(np.float32)
    vs = np.abs(rng.standard_normal((6, 4, 2))).astype(np.float32)
    got = tq.paged_attention_error_bound(torch.from_numpy(q),
                                         torch.from_numpy(ks),
                                         torch.from_numpy(vs), kind)
    want = rq.paged_attention_error_bound(jnp.asarray(q), jnp.asarray(ks),
                                          jnp.asarray(vs), kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown kv quant kind"):
        tq.kv_error_bound(torch.ones(1), "int4")


def test_kv_dtype_names_match_reference():
    assert tq.KV_DTYPES == rq.KV_DTYPES
    assert tq.KV_QUANT_KINDS == rq.KV_QUANT_KINDS
    for name in [None, "fp32", "f32", "float32", "BF16", "bfloat16", "int8",
                 "fp8", "f8", "float8", "E4M3"]:
        assert tq.resolve_kv_dtype(name) == rq.resolve_kv_dtype(name), name
    for bad in ("int4", "fp16"):
        with pytest.raises(ValueError, match="unknown kv dtype"):
            tq.resolve_kv_dtype(bad)
        with pytest.raises(ValueError, match="unknown kv dtype"):
            rq.resolve_kv_dtype(bad)
    for kind in tq.KV_DTYPES:
        dt = tq.kv_store_dtype(kind)
        assert dt.itemsize == jnp.dtype(rq.kv_store_dtype(kind)).itemsize
        assert tq.kv_quant_kind(dt) == rq.kv_quant_kind(
            rq.kv_store_dtype(kind))


def _pools(kind, *, p=6, bs=4, hkv=2, dh=8):
    """The reference's and the port's empty page pools for ``kind``."""
    quant = kind if kind in KINDS else None
    ref = ref_kvpool.init_pages(p, bs, hkv, dh, rq.kv_store_dtype(kind),
                                quant=quant)
    port = kvpool.init_pages(p, bs, hkv, dh, tq.kv_store_dtype(kind), quant,
                             device="cpu")
    return ref, port


@pytest.mark.parametrize("kind", tq.KV_DTYPES)
def test_paged_write_and_view_bit_equal_reference(kind):
    """Two writes (a chunk, then one decode token per row) into the same
    pages on both sides: payloads, scales and slot positions bit-equal
    outside the trash block (its contents are whatever the last of
    several masked writes left, on either side), and the gathered views
    equal."""
    rng = np.random.default_rng(11)
    ref, port = _pools(kind)
    assert ref.keys() == port.keys()
    bt = np.asarray([[1, 3, -1], [2, 4, 5]], np.int32)
    ref["bt"], port["bt"] = jnp.asarray(bt), torch.from_numpy(bt)
    for positions in ([[0, 1, 2, 3, 4, -1], [0, 1, 2, 3, 4, 5]],
                      [[5], [-1]]):
        pos = np.asarray(positions, np.int32)
        k = (rng.standard_normal((2, pos.shape[1], 2, 8)) * 3).astype(
            np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        ref = ref_kvpool.paged_write(ref, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos))
        kvpool.paged_write(port, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos))
    carried = interop.pages_from_reference(ref, device="cpu")
    for key in port:
        assert port[key].dtype == carried[key].dtype, key
        np.testing.assert_array_equal(_bits(port[key][1:]),
                                      _bits(carried[key][1:]), err_msg=key)
    kr, vr, pr = ref_kvpool.paged_view(ref)
    kt, vt, pt = kvpool.paged_view(port)
    # the view's dtype is the reference's: bf16 pages as stored, fp32 and
    # dequantized pages fp32
    want = torch.bfloat16 if kind == "bf16" else torch.float32
    assert kt.dtype == vt.dtype == want
    assert np.dtype(kr.dtype).itemsize == want.itemsize
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pr))
    live = pt.numpy() >= 0
    np.testing.assert_array_equal(kt.float().numpy()[live],
                                  np.asarray(kr, np.float32)[live])
    np.testing.assert_array_equal(vt.float().numpy()[live],
                                  np.asarray(vr, np.float32)[live])


@pytest.mark.parametrize("kind", [None, *tq.KV_DTYPES])
def test_byte_accounting_equals_reference(kind):
    """``kv_bytes_per_token`` and ``pool_bytes`` for qwen2-1.5b, full and
    reduced, against the reference's ``ServeConfig`` with fp32 serving."""
    for reduced in (False, True):
        sc = engine.ServeConfig(cfg=get_config("qwen2-1.5b", reduced=reduced),
                                mux=MuxSpec(n=2), capacity=124,
                                dtype=torch.float32,
                                cache_layout="paged", block_size=16,
                                kv_dtype=kind)
        sc_r = RefServeConfig(cfg=ref_config("qwen2-1.5b", reduced=reduced),
                              kind="lm", mux=RefMux(n=2), capacity=124,
                              dtype=jnp.float32, cache_layout="paged",
                              block_size=16, kv_dtype=kind)
        assert sc.kv_quant == sc_r.kv_quant
        assert sc.page_dtype.itemsize == jnp.dtype(sc_r.page_dtype).itemsize
        assert sc.kv_bytes_per_token() == sc_r.kv_bytes_per_token()
        assert sc.pool_bytes(8) == sc_r.pool_bytes(8)
        cache = engine.init_cache(sc, 8, device="meta")
        layer = cache["layers"][0]
        assert layer["kp"].dtype == sc.page_dtype
        held = sum(t.numel() * t.element_size() for lc in cache["layers"]
                   for key, t in lc.items() if key != "bt")
        assert held == sc.pool_bytes(8)
    full = {None: 57456, "fp32": 57456, "bf16": 28784, "int8": 14896,
            "fp8": 14896}[kind]
    sc = engine.ServeConfig(cfg=get_config("qwen2-1.5b"), mux=MuxSpec(n=2),
                            capacity=124, dtype=torch.float32, kv_dtype=kind)
    assert sc.kv_bytes_per_token() == full
    assert sc.pool_bytes(8) == 33 * 16 * full


def test_serve_config_rejects_unknown_kv_dtype():
    with pytest.raises(ValueError, match="unknown kv dtype"):
        engine.ServeConfig(cfg=get_config("qwen2-1.5b"), mux=MuxSpec(n=2),
                           capacity=16, kv_dtype="int4")
