"""MUX-BERT / MUX-ELECTRA, the paper's own models (counterpart of
``repro.models.bert``): a bidirectional pre-LN encoder with learned
positions and tanh-GELU MLPs (a ``TransformerLM`` with ``causal=False``),
run without a cache, and its heads:

  * MLM: transform -> GELU -> LN -> tied-embedding logits + bias;
  * RTD (ELECTRA): dense -> GELU -> one logit per position;
  * sequence classification: tanh pooler on position 0, then logits;
  * token classification: logits per position.

Every head reads ``hidden``, the demuxed (N*B, L, D) hidden state, and
computes in ``dtype``, the backbone too: fp32 by default, as the
reference's, or bf16 (the weights cast per op, the norms in fp32 rounded
to it, the MLM bias cast to the logits' dtype).  ``use_kernels``
(default True) runs the backbone's kernel path: the fused Gaussian entry
or the mux-combine kernel, the flash kernel under ``attn_impl='flash'``,
the fused RSA exit (their plain versions on CPU tensors); False runs the
plain model path.
The heads themselves are plain matmuls.
"""
from __future__ import annotations

import torch

from repro_torch.core import MuxSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import Embedding, LayerNorm, Linear, gelu_tanh

SIZES = {
    "small": dict(n_layers=4, d_model=512, n_heads=8, d_ff=2048),
    "base": dict(n_layers=12, d_model=768, n_heads=12, d_ff=3072),
    "large": dict(n_layers=24, d_model=1024, n_heads=16, d_ff=4096),
}


def bert_config(size: str = "base", **kw) -> ModelConfig:
    """The reference's ``bert_config``: BERT-``size`` widths, vocab 30522,
    512 positions, no remat; ``kw`` overrides fields (heads derive from
    the final ``n_heads`` and ``d_model``)."""
    base = dict(
        name=f"mux-bert-{size}", family="encoder", vocab_size=30522,
        activation="gelu_tanh", glu=False, qkv_bias=True, norm="ln",
        positions="learned", max_seq_len=512, causal=False,
        tie_embeddings=True, remat=False)
    base.update(SIZES[size])
    base.update(kw)
    return ModelConfig(**base)


class MuxBERT:
    @staticmethod
    def init(generator: torch.Generator, cfg: ModelConfig,
             mux: MuxSpec = MuxSpec(), *, electra: bool = False):
        """The port's own seeded init on ``generator.device`` with the
        reference's tree: ``backbone`` (a ``TransformerLM`` tree), ``mlm``
        and, with ``electra``, ``rtd``."""
        d, dev = cfg.d_model, generator.device
        params = {"backbone": TransformerLM.init(generator, cfg, mux),
                  "mlm": {"transform": Linear.init(generator, d, d),
                          "ln": LayerNorm.init(dev, d),
                          "bias": torch.zeros(cfg.vocab_size, device=dev)}}
        if electra:
            params["rtd"] = {"dense": Linear.init(generator, d, d),
                             "out": Linear.init(generator, d, 1)}
        return params

    @staticmethod
    def hidden(params, cfg: ModelConfig, tokens, *, mux: MuxSpec = MuxSpec(),
               dtype=torch.float32, use_kernels: bool = True):
        """tokens (N*B, L) -> the demuxed hidden state (N*B, L, D) in
        ``dtype``."""
        return TransformerLM.apply(params["backbone"], cfg, tokens, mux=mux,
                                   dtype=dtype, logits_out=False,
                                   use_kernels=use_kernels)["hidden"]

    @staticmethod
    def mlm_logits(params, cfg: ModelConfig, tokens, *,
                   mux: MuxSpec = MuxSpec(), dtype=torch.float32,
                   use_kernels: bool = True):
        """(N*B, L, V) masked-LM logits."""
        h = MuxBERT.hidden(params, cfg, tokens, mux=mux, dtype=dtype,
                           use_kernels=use_kernels)
        m = params["mlm"]
        t = LayerNorm.apply(m["ln"], gelu_tanh(Linear.apply(m["transform"],
                                                             h)))
        logits = Embedding.attend(params["backbone"]["embed"], t)
        return logits + m["bias"].to(logits.dtype)

    @staticmethod
    def rtd_logits(params, cfg: ModelConfig, tokens, *,
                   mux: MuxSpec = MuxSpec(), dtype=torch.float32,
                   use_kernels: bool = True):
        """ELECTRA replaced-token detection: (N*B, L) binary logits."""
        h = MuxBERT.hidden(params, cfg, tokens, mux=mux, dtype=dtype,
                           use_kernels=use_kernels)
        t = gelu_tanh(Linear.apply(params["rtd"]["dense"], h))
        return Linear.apply(params["rtd"]["out"], t)[..., 0]

    # --- fine-tuning heads -------------------------------------------------
    @staticmethod
    def init_classifier(generator: torch.Generator, cfg: ModelConfig,
                        n_classes: int):
        return {"pool": Linear.init(generator, cfg.d_model, cfg.d_model),
                "out": Linear.init(generator, cfg.d_model, n_classes)}

    @staticmethod
    def classify(params, head, cfg: ModelConfig, tokens, *,
                 mux: MuxSpec = MuxSpec(), dtype=torch.float32,
                 use_kernels: bool = True):
        """(N*B, n_classes) logits from the tanh pooler on position 0."""
        h = MuxBERT.hidden(params, cfg, tokens, mux=mux, dtype=dtype,
                           use_kernels=use_kernels)
        cls = torch.tanh(Linear.apply(head["pool"], h[:, 0]))
        return Linear.apply(head["out"], cls)

    @staticmethod
    def init_token_classifier(generator: torch.Generator, cfg: ModelConfig,
                              n_tags: int):
        return {"out": Linear.init(generator, cfg.d_model, n_tags)}

    @staticmethod
    def classify_tokens(params, head, cfg: ModelConfig, tokens, *,
                        mux: MuxSpec = MuxSpec(), dtype=torch.float32,
                        use_kernels: bool = True):
        """(N*B, L, n_tags) logits per position."""
        h = MuxBERT.hidden(params, cfg, tokens, mux=mux, dtype=dtype,
                           use_kernels=use_kernels)
        return Linear.apply(head["out"], h)
