"""Flash attention over fresh K/V: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention``):
causal, sliding-window or bidirectional GQA attention with a query offset
and an optional logit softcap; queries at ``q_offset + arange(Lq)``, keys
at ``arange(Lk)``.  ``flash_attention_cuda`` launches the kernel on CUDA
tensors and nothing else; ``flash_attention_ref`` is the plain version
(naive attention, mirroring ``repro/kernels/ref.py``).  The counted
dispatching wrapper is ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.nn.attention import attention_core, make_attention_mask


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                        logit_softcap=None):
    """q (B, Lq, H, Dh); k, v (B, Lk, Hkv, Dh) -> (B, Lq, H, Dh)."""
    lq, lk = q.shape[1], k.shape[1]
    mask = None
    if causal or window is not None:
        mask = make_attention_mask(
            q_offset + torch.arange(lq, device=q.device),
            torch.arange(lk, device=q.device), causal=causal,
            window=window)[None]
    return attention_core(q, k, v, mask=mask, logit_softcap=logit_softcap)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, q_offset=0,
                         logit_softcap=None):
    """Launch ``flash_attention_kernel``; arguments as
    ``flash_attention_ref`` (``q_offset`` an int >= 0)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name}: need fp32 on {dev}, got {x.dtype} "
                             f"on {x.device}")
    b, lq, h, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if (k.shape != (b, lk, hkv, dh) or v.shape != k.shape or h % hkv
            or lq < 1 or lk < 1):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if dh % 4 or dh > 256:
        raise ValueError(f"head_dim {dh}: the kernel takes multiples of 4 "
                         "up to 256")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if int(q_offset) < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0 or None, got "
                         f"{logit_softcap}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = build.load("flash_attention").flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk,
        h, hkv, dh, int(causal), 0 if window is None else int(window),
        int(q_offset), 0.0 if logit_softcap is None else float(logit_softcap),
        float(dh ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "flash_attention_kernel")
    return out
