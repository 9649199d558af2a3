"""Flash attention over fresh K/V: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention``):
causal, sliding-window or bidirectional GQA attention with a query offset
and an optional logit softcap; queries at ``q_offset + arange(Lq)``, keys
at ``arange(Lk)``.  q, k and v are all fp32 or all bf16 (the compute
dtype); as the Pallas kernel, a bf16 q, K and V are widened to fp32, the
attention runs in fp32 and the output is rounded once to q's dtype.
``flash_attention_cuda`` launches the kernel on CUDA tensors and nothing
else (products on the tensor cores in split TF32, at fp32 accuracy:
``torch.backends.cuda.matmul.allow_tf32`` has no bearing on it);
``flash_attention_ref`` is the plain version, with the kernel's rounding
points (``nn.attention.widened_attention``), not ``attention_core``'s.
The counted dispatching wrapper is ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.attention import make_attention_mask, widened_attention

# padded head dim -> (keys per K tile, blocks an SM, query rows a block):
# Cfg<D> in the source (BK, kMinBlocks, 64 * MT)
TILES = {32: (64, 2, 128), 64: (32, 2, 128), 128: (16, 2, 64),
         256: (16, 1, 64)}
SMS = 132               # an H100's SMs
DTYPES = (torch.float32, torch.bfloat16)    # q, k, v and the output


def padded_head_dim(dh: int) -> int:
    """The instantiation a head dim runs in: the next of 32, 64, 128, 256."""
    return next(d for d in TILES if dh <= d)


def splits(batch: int, lq: int, lk: int, heads: int,
           dh: int) -> tuple[int, int]:
    """(number of key splits, key tiles per split): split the key tiles
    over blocks where (query tiles x heads x rows) would leave SMs idle,
    each split a whole number of tiles and none empty."""
    bk, per_sm, bq = TILES[padded_head_dim(dh)]
    tiles = -(-lk // bk)
    blocks = -(-lq // bq) * heads * batch
    want = max(1, -(-SMS * per_sm // blocks))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        logit_softcap=None):
    """q (B, Lq, H, Dh); k, v (B, Lk, Hkv, Dh) -> (B, Lq, H, Dh) in q's
    dtype, rounded once."""
    lq, lk = q.shape[1], k.shape[1]
    mask = None
    if causal or window is not None:
        mask = make_attention_mask(
            q_offset + torch.arange(lq, device=q.device),
            torch.arange(lk, device=q.device), causal=causal,
            window=window)[None]
    return widened_attention(q, k, v, mask=mask, logit_softcap=logit_softcap)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, q_offset=0,
                         logit_softcap=None):
    """Launch ``flash_attention_kernel``; arguments as
    ``flash_attention_ref`` (``q_offset`` an int >= 0); q, k and v all
    fp32 or all bf16."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise ValueError(f"{name}: need q's dtype, fp32 or bf16, got "
                             f"{x.dtype} (q {q.dtype})")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name}: need {dev}, got {x.device}")
    b, lq, h, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if (k.shape != (b, lk, hkv, dh) or v.shape != k.shape or h % hkv
            or lq < 1 or lk < 1):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    vec = 16 // q.element_size()          # elements a 16-byte copy moves
    if dh % vec or dh > 256:
        raise ValueError(f"head_dim {dh}: the kernel takes multiples of "
                         f"{vec} ({q.dtype}) up to 256")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if int(q_offset) < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0 or None, got "
                         f"{logit_softcap}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    # the kernel copies rows in 16-byte chunks
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    nsplit, per = splits(b, lq, lk, h, dh)
    part_o = part_ml = None
    if nsplit > 1:
        # the splits' partials stay fp32; only the combine rounds
        scratch = torch.empty(nsplit * b * lq * h * (dh + 2), device=dev,
                              dtype=torch.float32)
        part_o = scratch[:nsplit * b * lq * h * dh]
        part_ml = scratch[nsplit * b * lq * h * dh:]
    err = build.load("flash_attention").flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, lq, lk, h, hkv,
        dh, int(causal), 0 if window is None else int(window),
        int(q_offset), nsplit, per, int(q.dtype == torch.bfloat16),
        0.0 if logit_softcap is None else float(logit_softcap),
        float(dh ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "flash_attention_kernel")
    return out
