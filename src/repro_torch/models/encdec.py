"""Encoder-decoder LM (counterpart of ``repro.models.encdec``): whisper's
backbone with its audio frontend stubbed, as in the reference — the
caller hands in precomputed frame embeddings (N*B, frames, D_enc).

The encoder is a bidirectional ``TransformerLM`` over frames, run without
a cache; the decoder a causal ``TransformerLM`` of cross-attention blocks
(``models.blocks.apply_xattn``).  Multiplexing: the encoder muxes the N
frame streams with its own mux (``enc_mux``, of the spec's kind), the
decoder muxes the N token streams; cross-attention runs in the
multiplexed domain, and one demux after the decoder recovers the N logit
streams.  Both stacks compute in ``dtype``, bf16 by default as the
reference's ``encode`` / ``apply`` / ``init_cache``, or fp32.
"""
from __future__ import annotations

import torch

from repro_torch.core import MuxEngine, MuxSpec
from repro_torch.core.mux import init_mux
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM


class EncDecLM:
    FRONTEND = "frame embeddings"   # what the stub frontend hands in

    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig,
             mux: MuxSpec = MuxSpec()):
        """The port's own seeded init on ``generator.device`` (the
        reference's tree: ``encoder``, ``decoder``, ``enc_mux``)."""
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder config needs "
                             "cfg.encoder")
        params = {"encoder": TransformerLM.init(generator, cfg.encoder),
                  "decoder": TransformerLM.init(generator, cfg, mux)}
        if mux.enabled:
            params["enc_mux"] = {"mux": init_mux(generator, mux,
                                                 cfg.encoder.d_model)}
        return params

    @staticmethod
    def frontend_shape(cfg: ModelConfig):
        """One request's stub-frontend input: (frames, D_enc) frame
        embeddings."""
        return (cfg.encoder.frontend_len, cfg.encoder.d_model)

    @staticmethod
    def encode(params, cfg: ModelConfig, enc_embeds, *,
               mux: MuxSpec = MuxSpec(), dtype=torch.bfloat16,
               use_kernels: bool = True):
        """enc_embeds (N*B, frames, D_enc) -> the muxed encoder hidden
        (B, frames, D_enc) in ``dtype``: the frames are cast to it before
        the mux, as the reference's.  use_kernels: the mux-combine kernel
        of the encoder's entry and the layers' kernels (the attention
        follows ``cfg.encoder.attn_impl``)."""
        dev = params["encoder"]["embed"]["table"].device
        x = torch.as_tensor(enc_embeds, device=dev).to(dtype)
        if mux.enabled:
            x = MuxEngine.combine(params["enc_mux"], mux, x,
                                  use_kernels=use_kernels)
        return TransformerLM.apply(params["encoder"], cfg.encoder, embeds=x,
                                   dtype=dtype, logits_out=False,
                                   use_kernels=use_kernels,
                                   demux=False)["hidden"]

    @staticmethod
    def apply(params, cfg: ModelConfig, dec_tokens, enc_embeds=None, *,
              enc_out=None, mux: MuxSpec = MuxSpec(), cache=None,
              q_offset=0, dtype=torch.bfloat16, logits_out: bool = True,
              use_kernels: bool = True, fuse_io: bool = True, extra_ctx=None):
        """A full forward or a prefill: pass ``enc_embeds`` (runs the
        encoder) or ``enc_out``; a decode step: pass the cache, whose
        cross-K/V the prefill filled (the encoder does not run again).
        Both stacks compute in ``dtype``.  Other arguments as
        ``TransformerLM.apply``."""
        if enc_out is None and enc_embeds is not None:
            enc_out = EncDecLM.encode(params, cfg, enc_embeds, mux=mux,
                                      dtype=dtype, use_kernels=use_kernels)
        ectx = dict(extra_ctx or {})
        if enc_out is not None:
            ectx["enc_out"] = enc_out
        return TransformerLM.apply(
            params["decoder"], cfg, dec_tokens, mux=mux, cache=cache,
            q_offset=q_offset, dtype=dtype, logits_out=logits_out,
            use_kernels=use_kernels,
            fuse_io=fuse_io, extra_ctx=ectx)

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, capacity: int,
                   dtype=torch.bfloat16, *, device):
        """The decoder's ring cache for ``batch`` backbone rows in
        ``dtype``: per layer a self-attention ring and the cross-K/V of
        ``cfg.encoder.frontend_len`` frames."""
        return TransformerLM.init_cache(cfg, batch, capacity, dtype,
                                        device=device)
