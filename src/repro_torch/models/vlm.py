"""VLM (counterpart of ``repro.models.vlm``): llava-next-mistral's text
backbone behind a multimodal projector, with the vision tower stubbed as
in the reference — the caller hands in precomputed patch embeddings
(N*B, P, ``D_VISION``).

The projector is the reference's two-layer MLP, ``proj2(gelu(proj1(x)))``
with the tanh GELU (``jax.nn.gelu``'s default), run in the compute dtype;
its output goes in front of the token embeddings, and the backbone
(``TransformerLM``, data multiplexing included) runs over the P + L row
through its plain entry, whose Gaussian mux takes the mux-combine kernel
under ``use_kernels``.  Decode steps take text tokens only, through the
fused entry and exit.  The cache is the backbone's ring.
"""
from __future__ import annotations

import torch

from repro_torch.core import MuxSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import Embedding, Linear, gelu_tanh

D_VISION = 1024  # CLIP-L/14 feature width (the stub frontend emits this)


class VLM:
    FRONTEND = "patch embeddings"   # what the stub frontend hands in

    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig,
             mux: MuxSpec = MuxSpec()):
        """The port's own seeded init on ``generator.device`` with the
        reference's tree: ``backbone`` (a ``TransformerLM`` tree),
        ``proj1`` (D_VISION -> d) and ``proj2`` (d -> d), N(0, 0.02)
        weights and zero biases."""
        return {"backbone": TransformerLM.init(generator, cfg, mux),
                "proj1": Linear.init(generator, D_VISION, cfg.d_model),
                "proj2": Linear.init(generator, cfg.d_model, cfg.d_model)}

    @staticmethod
    def frontend_shape(cfg: ModelConfig):
        """One request's stub-frontend input: (P, D_VISION) patch
        embeddings."""
        return (cfg.frontend_len, D_VISION)

    @staticmethod
    def project(params, patch_embeds, dtype=torch.bfloat16):
        """The multimodal projector: patch_embeds (N*B, P, D_VISION) ->
        (N*B, P, d) in ``dtype``, proj2(gelu_tanh(proj1(x)))."""
        dev = params["proj1"]["w"].device
        x = torch.as_tensor(patch_embeds, device=dev).to(dtype)
        return Linear.apply(params["proj2"],
                            gelu_tanh(Linear.apply(params["proj1"], x)))

    @staticmethod
    def embed_multimodal(params, cfg: ModelConfig, tokens, patch_embeds,
                         dtype=torch.bfloat16):
        """tokens (N*B, L), patch_embeds (N*B, P, D_VISION) -> (N*B, P + L,
        d) in ``dtype``: the projected patches, then the token
        embeddings."""
        pe = VLM.project(params, patch_embeds, dtype)
        te = Embedding.apply(params["backbone"]["embed"],
                             torch.as_tensor(tokens, device=pe.device),
                             dtype=dtype)
        return torch.cat([pe, te], dim=1)

    @staticmethod
    def apply(params, cfg: ModelConfig, tokens=None, patch_embeds=None, *,
              mux: MuxSpec = MuxSpec(), cache=None, q_offset=0,
              dtype=torch.bfloat16, use_kernels: bool = True,
              fuse_io: bool = True, extra_ctx=None):
        """A prefill or full forward: pass ``patch_embeds``, and the
        backbone runs over the patches and then the tokens (its logits
        (N*B, P + L, V)); a decode step: text tokens only.  Other arguments
        as ``TransformerLM.apply``."""
        embeds = None
        if patch_embeds is not None:
            embeds = VLM.embed_multimodal(params, cfg, tokens, patch_embeds,
                                          dtype)
            tokens = None
        return TransformerLM.apply(
            params["backbone"], cfg, tokens, embeds=embeds, mux=mux,
            cache=cache, q_offset=q_offset, dtype=dtype,
            use_kernels=use_kernels, fuse_io=fuse_io, extra_ctx=extra_ctx)

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, capacity: int,
                   dtype=torch.float32, *, device):
        """The backbone's ring cache."""
        return TransformerLM.init_cache(cfg, batch, capacity, dtype,
                                        device=device)
