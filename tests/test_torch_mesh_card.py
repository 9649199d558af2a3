"""The mesh path's pieces that need no reference (this file imports no
JAX, so its card tests run under ``pytest --noconftest -m cuda``):

  * the shard-local paged wrappers (``kernels.ops.sharded_paged_*``) at
    every position of a (2, 2) mesh, in this process, against the
    unsharded wrapper's rows and heads on the whole pool, over fp32 and
    int8 pages: on the CPU (the plain versions) and on the card (the
    kernels, marked ``cuda``);
  * on the card, a (1, 2) mesh of two ranks sharing it: gloo over CUDA
    tensors (``launch.mesh.pick_backend``), ``all_reduce`` and the
    zero-filled gather through ``ServeMesh``;
  * what training on a mesh needs of gloo, on the CPU and on the card:
    an int32 ``all_reduce(SUM)`` and an fp32 ``all_reduce(MAX)`` (the
    compressed gradient mean's), and one round trip through the
    collectives' autograd ``Function``s (sum, gather, enter, shift).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import _head_axis, _local_tables
from repro_torch.launch import mesh as mesh_lib

TOL = 1e-5          # fp32, the same pages and rows: summation order only


class At:
    """One mesh position, what the shard-local wrappers read."""

    def __init__(self, data, model, shape):
        self.coords = {"data": data, "model": model}
        self.shape = shape


def _pool(rng, lens, n_shards, bps, bs, mb, hkv, dh):
    kp = rng.standard_normal((n_shards * bps, bs, hkv, dh), np.float32)
    vp = rng.standard_normal((n_shards * bps, bs, hkv, dh), np.float32)
    bt = np.full((len(lens), mb), -1, np.int32)
    pp = np.full((n_shards * bps, bs), -1, np.int32)
    rps = len(lens) // n_shards
    free = {s: list(range(s * bps + 1, (s + 1) * bps))
            for s in range(n_shards)}
    for r, n in enumerate(lens):
        blocks = [free[r // rps].pop(0) for _ in range(-(-n // bs))]
        bt[r, :len(blocks)] = blocks
        for i in range(n):
            pp[blocks[i // bs], i % bs] = i
    return kp, vp, bt, pp


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(request.param)


def test_local_tables_rebase_to_the_segment():
    bt = torch.tensor([[17, 18, -1], [20, -1, -1]])
    assert _local_tables(bt, 1, 17).tolist() == [[0, 1, -1], [3, -1, -1]]
    assert _head_axis({"model": 2}, 12, 2) == "model"
    assert _head_axis({"model": 4}, 4, 2) is None
    assert _head_axis({"data": 2}, 4, 2) is None


@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("op", ["decode", "prefill"])
def test_sharded_wrappers_match_unsharded(device, kind, op):
    """qwen2-1.5b's heads (12 over 2 of 128), 4 rows over 2 data shards of
    11 blocks of 16 and a model axis of 2: each position's call equals the
    unsharded wrapper's rows and heads on the whole pool (a padded query,
    fully masked, has no defined output and is left out, as in the
    reference suite)."""
    rng = np.random.default_rng(3)
    lens = [70, 61, 40, 33]
    kp, vp, bt, pp = _pool(rng, lens, 2, 11, 16, 5, 2, 128)
    lq = 1 if op == "decode" else 8
    q = rng.standard_normal((4, lq, 12, 128), np.float32)
    vecs = ([69, 60, 39, 32],) if op == "decode" else \
        ([62, 53, 32, 25], [8, 8, 8, 7])

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    k_p, v_p, kw = t(kp), t(vp), {}
    if kind == "int8":
        k_p, ks = quant.quantize_kv(k_p, "int8")
        v_p, vs = quant.quantize_kv(v_p, "int8")
        kw = {"k_scales": ks, "v_scales": vs}
    vec = [t(np.asarray(v, np.int32)) for v in vecs]
    whole_fn = ops.paged_attention if op == "decode" else \
        ops.paged_prefill_attention
    shard_fn = ops.sharded_paged_attention if op == "decode" else \
        ops.sharded_paged_prefill_attention
    whole = whole_fn(t(q), k_p, v_p, t(bt), t(pp), *vec, **kw)
    q_len = vec[1] if op == "prefill" else torch.ones(4, device=device)
    valid = (torch.arange(lq, device=device)[None]
             < q_len[:, None])[..., None, None]
    shape = {"data": 2, "model": 2}
    for d in (0, 1):
        for m in (0, 1):
            r, b = slice(2 * d, 2 * d + 2), slice(11 * d, 11 * d + 11)
            hs, ks_ = slice(6 * m, 6 * m + 6), slice(m, m + 1)
            got = shard_fn(At(d, m, shape), t(q)[r, :, hs].contiguous(),
                           k_p[b, :, ks_].contiguous(),
                           v_p[b, :, ks_].contiguous(), t(bt)[r], t(pp)[b],
                           *(v[r] for v in vec),
                           **{k: x[b, :, ks_].contiguous()
                              for k, x in kw.items()})
            err = ((got - whole[r, :, hs]).abs() * valid[r]).max().item()
            assert err <= TOL, (d, m, err)


def _all_reduce_rank(mesh):
    x = torch.full((3,), float(mesh.coords["model"] + 1), device="cuda")
    s = mesh.all_reduce(x, "model").cpu().tolist()
    g = mesh.gather(torch.full((2, 1), float(mesh.coords["model"]),
                               device="cuda"), "model", 1).cpu().tolist()
    return {"sum": s, "gather": g, "backend": mesh.backend,
            "reason": mesh.backend_reason, "counts": dict(mesh.counts)}


@pytest.mark.cuda
def test_gloo_over_cuda_all_reduce_on_card(tmp_path):
    """Two ranks on one card: NCCL refuses that, so the mesh takes gloo
    over CUDA tensors, and both collectives come back right."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() != 1:
        pytest.skip("the ranks must share one card")
    assert mesh_lib.pick_backend("cuda", 2) == "gloo"
    res = mesh_lib.spawn(_all_reduce_rank, 1, 2, device="cuda",
                         timeout=120, tmpdir=str(tmp_path))
    for r in res:
        assert r["sum"] == [3.0, 3.0, 3.0]
        assert r["gather"] == [[0.0, 1.0], [0.0, 1.0]]
        assert r["backend"] == "gloo" and "CUDA" in r["reason"]
        assert r["counts"] == {"all_reduce": 1, "gather": 1}


def _train_collectives_rank(mesh, device):
    """Rank i of (1, 2): the int32 sum and fp32 max the compressed mean
    runs, then y = gather(all_reduce(x * w)) and shift(enter(x) * w),
    their gradients by autograd."""
    i = mesh.coords["model"]
    ints = mesh.all_reduce(torch.tensor([i + 1, -7 * i, (i + 1) * 2 ** 29],
                                        dtype=torch.int32, device=device),
                           "model", kind="grad_sum")
    big = mesh.all_reduce(torch.tensor([float(i), -1.0 - i, 0.5],
                                       device=device), "model",
                          kind="grad_scale", op="max")
    w = torch.full((3,), 2.0 + i, device=device, requires_grad=True)
    x = torch.arange(3.0, device=device).requires_grad_()
    summed = mesh.all_reduce(x * w, "model")          # (2 + 3) x
    y = mesh.gather(summed[None], "model", 0)          # (2, 3)
    s = mesh.shift(mesh.enter(x, "model") * w, "model")
    loss = (y * torch.tensor([[1.0], [10.0]], device=device)).sum() \
        + s.sum()
    gx, gw = torch.autograd.grad(loss, [x, w])
    return {"ints": ints.tolist(), "max": big.tolist(), "y": y.tolist(),
            "s": s.tolist(), "gx": gx.tolist(), "gw": gw.tolist(),
            "counts": dict(mesh.counts), "dtype": str(ints.dtype)}


def test_training_collectives_and_autograd(device, tmp_path):
    """int32 SUM and fp32 MAX over gloo (on the card: CUDA tensors, the
    ranks sharing it), and the backward of each collective: the sum's
    the identity, the gather's this rank's slice, enter's a sum over the
    axis, the shift's the reverse shift."""
    if device.type == "cuda" and torch.cuda.device_count() != 1:
        pytest.skip("the ranks must share one card")
    res = mesh_lib.spawn(_train_collectives_rank, 1, 2,
                         device=device.type, args=(device.type,),
                         timeout=120, tmpdir=str(tmp_path))
    for i, r in enumerate(res):
        assert r["dtype"] == "torch.int32"
        assert r["ints"] == [3, -7, 3 * 2 ** 29]
        assert r["max"] == [1.0, -1.0, 0.5]
        assert r["y"] == [[0.0, 5.0, 10.0]] * 2
        # rank 0's x * w shifted to rank 1; rank 0 gets zeros
        assert r["s"] == ([0.0] * 3 if i == 0 else [0.0, 2.0, 4.0])
        # loss = (1 + 10) (2 + 3) . x over the gather's slices, + rank 0's
        # w0 . x via the shift: d/dx sums the ranks' parts (enter)
        slice_w = 1.0 if i == 0 else 10.0
        assert r["gx"] == [slice_w * (2.0 + i) + 2.0] * 3
        assert r["gw"] == [slice_w * x + (x if i == 0 else 0.0)
                           for x in (0.0, 1.0, 2.0)]
        assert r["counts"] == {"grad_sum": 1, "grad_scale": 1,
                               "all_reduce": 1, "gather": 1, "shift": 1,
                               "backward": 2}
