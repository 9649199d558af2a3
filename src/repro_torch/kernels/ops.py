"""Public kernel wrappers (counterpart of ``repro/kernels/ops.py``).

Each wrapper dispatches on the device of its tensors: on the CPU it runs
the kernel's plain PyTorch version; on a CUDA tensor it launches the
hand-written kernel or raises — there is no fallback.  Each wrapper keeps
two plain integer counts as attributes: ``calls`` (every call) and
``launches`` (kernel launches only, added right after the launch).  The
two paged wrappers also count their launches per page storage kind
(``by_storage``: 'fp32' / 'bf16' / 'int8' / 'fp8').  The shard-local
``sharded_paged_attention`` / ``sharded_paged_prefill_attention`` (the
reference's ``shard_map`` wrappers, one data shard's part on its rank)
call the paged wrappers and keep counts of their own (``SHARDED``).

No kernel has a backward (nor has any Pallas kernel of the reference):
under autograd, a wrapper given a tensor that requires grad raises on
either device, before it counts the call, so a training path that
reaches a kernel fails on the CPU as on the card.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core.quant import KV_DTYPES

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import demux_rsa as _demux
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mux_combine as _combine
from repro_torch.kernels import mux_embed as _mux
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rwkv6 as _rwkv


def _on_cpu(x) -> bool:
    return x.device.type == "cpu"


def _refuse_autograd(wrapper, *tensors):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"kernels.ops.{wrapper.__name__}: an input requires grad and the "
            "kernel has no backward; train on the plain model path "
            "(use_kernels=False, the reference's training path) or call it "
            "under torch.no_grad()")


def _launched(wrapper, pages):
    """Count one launch of a paged kernel over ``pages``' storage."""
    wrapper.launches += 1
    wrapper.by_storage[KV_DTYPES[_paged.STORAGE_KINDS[pages.dtype]]] += 1


def mux_embed_combine(tokens, emb, v, *, scale: float = 1.0,
                      out_dtype=torch.float32):
    """Fused embed + embedding scale + Gaussian mux-combine:
    tokens (N, T), emb (V, D), v (N, D) fp32 or bf16 -> (T, D) in
    ``out_dtype`` (fp32 or bf16)."""
    _refuse_autograd(mux_embed_combine, tokens, emb, v)
    mux_embed_combine.calls += 1
    if _on_cpu(emb):
        return _mux.mux_embed_ref(tokens, emb, v, scale=scale,
                                  out_dtype=out_dtype)
    out = _mux.mux_embed_combine_cuda(tokens, emb, v, scale=scale,
                                      out_dtype=out_dtype)
    mux_embed_combine.launches += 1
    return out


def mux_combine(x, v):
    """Gaussian mux-combine of precomputed embeddings: x (N, T, D),
    v (N, D) -> (T, D) = mean_i x_i ⊙ v_i in x's dtype."""
    _refuse_autograd(mux_combine, x, v)
    mux_combine.calls += 1
    if _on_cpu(x):
        return _combine.mux_combine_ref(x, v)
    out = _combine.mux_combine_cuda(x, v)
    mux_combine.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, page_pos, q_pos, *,
                    k_scales=None, v_scales=None, window=None,
                    causal: bool = True):
    """Decode attention over the paged pool: q (B, 1, H, Dh); pages fp32,
    bf16, or int8/fp8 with their (P, BS, Hkv) fp32 scales."""
    _refuse_autograd(paged_attention, q, k_pages, v_pages, k_scales,
                     v_scales)
    paged_attention.calls += 1
    if _on_cpu(q):
        _paged.storage_kind(k_pages, v_pages, k_scales, v_scales)
        if k_scales is not None:
            return _paged.paged_attention_quant_ref(
                q, k_pages, v_pages, k_scales, v_scales, block_tables,
                page_pos, q_pos, window=window, causal=causal)
        return _paged.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                          page_pos, q_pos, window=window,
                                          causal=causal)
    out = _paged.paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                      page_pos, q_pos, k_scales=k_scales,
                                      v_scales=v_scales, window=window,
                                      causal=causal)
    _launched(paged_attention, k_pages)
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, page_pos,
                            q_start, q_len, *, k_scales=None, v_scales=None,
                            window=None, causal: bool = True):
    """Chunked-prefill attention over the paged pool: q (B, Lq, H, Dh);
    pages as ``paged_attention``."""
    _refuse_autograd(paged_prefill_attention, q, k_pages, v_pages, k_scales,
                     v_scales)
    paged_prefill_attention.calls += 1
    if _on_cpu(q):
        _paged.storage_kind(k_pages, v_pages, k_scales, v_scales)
        if k_scales is not None:
            return _paged.paged_prefill_attention_quant_ref(
                q, k_pages, v_pages, k_scales, v_scales, block_tables,
                page_pos, q_start, q_len, window=window, causal=causal)
        return _paged.paged_prefill_attention_ref(
            q, k_pages, v_pages, block_tables, page_pos, q_start, q_len,
            window=window, causal=causal)
    out = _paged.paged_prefill_attention_cuda(
        q, k_pages, v_pages, block_tables, page_pos, q_start, q_len,
        k_scales=k_scales, v_scales=v_scales, window=window, causal=causal)
    _launched(paged_prefill_attention, k_pages)
    return out


def sharded_paged_attention(mesh, q, k_pages, v_pages, block_tables,
                            page_pos, q_pos, *, k_scales=None, v_scales=None,
                            window=None, causal: bool = True,
                            axis: str = "data"):
    """One data shard's part of the reference's ``shard_map``'d decode
    kernel, on this rank: q, block_tables and q_pos hold the shard's rows,
    the pages, page_pos and scales its page segment (and its head group
    where ``_head_axis`` splits heads over ``model``), the tables GLOBAL
    block ids, which are rebased to the segment before
    ``paged_attention`` runs.  Collective-free, as in the reference:
    ``ShardedKVPool`` gives a row blocks of its own segment only.
    ``mesh``: anything with ``coords`` ({axis: index})."""
    sharded_paged_attention.calls += 1
    local = _paged._local_tables(block_tables, mesh.coords[axis],
                                 k_pages.shape[0])
    out = paged_attention(q, k_pages, v_pages, local, page_pos, q_pos,
                          k_scales=k_scales, v_scales=v_scales,
                          window=window, causal=causal)
    if not _on_cpu(q):
        sharded_paged_attention.launches += 1
    return out


def sharded_paged_prefill_attention(mesh, q, k_pages, v_pages, block_tables,
                                    page_pos, q_start, q_len, *,
                                    k_scales=None, v_scales=None,
                                    window=None, causal: bool = True,
                                    axis: str = "data"):
    """``sharded_paged_attention``'s contract for the chunk kernel
    (``paged_prefill_attention``)."""
    sharded_paged_prefill_attention.calls += 1
    local = _paged._local_tables(block_tables, mesh.coords[axis],
                                 k_pages.shape[0])
    out = paged_prefill_attention(q, k_pages, v_pages, local, page_pos,
                                  q_start, q_len, k_scales=k_scales,
                                  v_scales=v_scales, window=window,
                                  causal=causal)
    if not _on_cpu(q):
        sharded_paged_prefill_attention.launches += 1
    return out


def demux_rsa(h, k, w1h, w1k, b1, w2, b2, **norms):
    """Fused demux exit; h may be (B, L, D) or (T, D) -> (N, [B, L,] D).
    ``norms``: entry_kind / entry_scale / entry_bias / exit_scale /
    exit_bias, as ``kernels.demux_rsa.demux_rsa_fused_ref``."""
    _refuse_autograd(demux_rsa, h, k, w1h, w1k, b1, w2, b2, *norms.values())
    demux_rsa.calls += 1
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if _on_cpu(h):
        out = _demux.demux_rsa_fused_ref(h2, k, w1h, w1k, b1, w2, b2,
                                         **norms)
    else:
        out = _demux.demux_rsa_cuda(h2, k, w1h, w1k, b1, w2, b2, **norms)
        demux_rsa.launches += 1
    return out.reshape(out.shape[0], *lead, h.shape[-1])


def decode_attention(q, k_cache, v_cache, slot_pos, *, q_pos,
                     window=None, causal: bool = True):
    """Flash-decode over a contiguous ring cache: q (B, 1, H, Dh); cache
    (B, C, Hkv, Dh); slot_pos (C,) (-1 = empty); q_pos an int or a 0-d
    integer tensor on q's device (the kernel reads it there, so a
    captured call replays at the position the tensor holds)."""
    _refuse_autograd(decode_attention, q, k_cache, v_cache)
    decode_attention.calls += 1
    if _on_cpu(q):
        return _dec.decode_attention_ref(q, k_cache, v_cache, slot_pos,
                                         q_pos=q_pos, window=window,
                                         causal=causal)
    out = _dec.decode_attention_cuda(q, k_cache, v_cache, slot_pos,
                                     q_pos=q_pos, window=window,
                                     causal=causal)
    decode_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, logit_softcap=None):
    """Attention over fresh K/V: q (B, Lq, H, Dh); k, v (B, Lk, Hkv, Dh),
    all fp32 or all bf16; queries at q_offset + arange(Lq), keys at
    arange(Lk).  Returns q's dtype."""
    _refuse_autograd(flash_attention, q, k, v)
    flash_attention.calls += 1
    if _on_cpu(q):
        return _flash.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset,
                                          logit_softcap=logit_softcap)
    out = _flash.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset,
                                      logit_softcap=logit_softcap)
    flash_attention.launches += 1
    return out


def rwkv6_chunked(r, k, v, logw, u, s0, *, chunk: int):
    """The RWKV6 recurrence: r, k, v (B, L, H, hd) fp32 or bf16, logw
    (B, L, H, hd), u (H, hd), s0 (B, H, hd, hd) fp32 -> (out in r's dtype,
    sT fp32).  ``chunk`` is the plain version's
    (chunkwise, the reference's rule); the kernel scans token by token
    and takes any L."""
    _refuse_autograd(rwkv6_chunked, r, k, v, logw, u, s0)
    rwkv6_chunked.calls += 1
    if _on_cpu(r):
        return _rwkv.rwkv_chunked(r, k, v, logw, u, s0, chunk)
    out = _rwkv.rwkv6_cuda(r, k, v, logw, u, s0)
    rwkv6_chunked.launches += 1
    return out


WRAPPERS = (mux_embed_combine, paged_attention, paged_prefill_attention,
            demux_rsa, decode_attention, flash_attention, rwkv6_chunked,
            mux_combine)
PAGED = (paged_attention, paged_prefill_attention)
# shard-local wrappers over the two paged kernels (their launches count in
# ``paged_attention`` / ``paged_prefill_attention`` too); not in ``counts``
SHARDED = (sharded_paged_attention, sharded_paged_prefill_attention)


def reset_counts():
    for w in WRAPPERS + SHARDED:
        w.calls = 0
        w.launches = 0
    for w in PAGED:
        w.by_storage = collections.Counter()


def counts(kind: str = "launches") -> dict:
    """{wrapper name: count} for ``kind`` 'launches' or 'calls'."""
    return {w.__name__: getattr(w, kind) for w in WRAPPERS}


reset_counts()
