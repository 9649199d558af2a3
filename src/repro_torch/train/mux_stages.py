"""The paper's three-stage MUX-PLM training (counterpart of
``repro.train.mux_stages``, Fig. 1):

  stage 1 — token-retrieval warm-up: auto-encode all N×L tokens from the
            multiplexed representation (primes mux and demux);
  stage 2 — multiplexed pre-training: MLM (MUX-BERT) or replaced-token
            detection with a uniform-random generator (MUX-ELECTRA);
  stage 3 — multiplexed fine-tuning: sequence or token classification.

Each stage function returns loss_fn(params, batch, generator) ->
(loss, metrics) for ``train.step.make_train_step``.  Every stage runs the model's plain
path (``use_kernels=False``), as the reference's training does: the
kernels have no backward.
"""
from __future__ import annotations

import torch

from repro_torch.core import MuxSpec, retrieval_accuracy, retrieval_loss
from repro_torch.data.synthetic import electra_corrupt, mlm_mask
from repro_torch.models.bert import MuxBERT
from repro_torch.train.losses import sigmoid_bce, softmax_xent


def retrieval_stage(cfg, mux: MuxSpec, dtype=torch.float32):
    def loss_fn(params, batch, generator):
        tokens = batch["tokens"]
        logits = MuxBERT.mlm_logits(params, cfg, tokens, mux=mux,
                                    dtype=dtype, use_kernels=False)
        loss = retrieval_loss(logits, tokens)
        return loss, {"retrieval_acc": retrieval_accuracy(logits, tokens)}
    return loss_fn


def mlm_stage(cfg, mux: MuxSpec, *, mask_rate: float = 0.15,
              retrieval_rate: float = 0.0, dtype=torch.float32):
    """Masked-LM pre-training; optional auxiliary retrieval objective on
    the unmasked tokens (the paper's Table 12 ablation, weight
    ``retrieval_rate``)."""
    def loss_fn(params, batch, generator):
        tokens = batch["tokens"]
        inputs, labels, weights = mlm_mask(generator, tokens,
                                           vocab=cfg.vocab_size,
                                           rate=mask_rate)
        logits = MuxBERT.mlm_logits(params, cfg, inputs, mux=mux,
                                    dtype=dtype, use_kernels=False)
        loss = softmax_xent(logits, labels, weights)
        metrics = {"mlm_loss": loss}
        if retrieval_rate > 0:
            r = retrieval_loss(logits, tokens, valid_mask=1.0 - weights)
            loss = loss + retrieval_rate * r
            metrics["retrieval_aux"] = r
        return loss, metrics
    return loss_fn


def electra_stage(cfg, mux: MuxSpec, *, replace_rate: float = 0.15,
                  dtype=torch.float32):
    """Replaced-token detection with the uniform-random generator."""
    def loss_fn(params, batch, generator):
        tokens = batch["tokens"]
        inputs, is_replaced = electra_corrupt(generator, tokens,
                                              vocab=cfg.vocab_size,
                                              rate=replace_rate)
        logits = MuxBERT.rtd_logits(params, cfg, inputs, mux=mux,
                                    dtype=dtype, use_kernels=False)
        loss = sigmoid_bce(logits, is_replaced)
        acc = ((logits > 0) == (is_replaced > 0.5)).float().mean()
        return loss, {"rtd_acc": acc}
    return loss_fn


def classification_stage(cfg, mux: MuxSpec, dtype=torch.float32):
    """Fine-tuning: params = {'model': …, 'head': …}; the batch has
    labels."""
    def loss_fn(params, batch, generator):
        logits = MuxBERT.classify(params["model"], params["head"], cfg,
                                  batch["tokens"], mux=mux, dtype=dtype,
                                  use_kernels=False)
        loss = softmax_xent(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return loss, {"accuracy": acc}
    return loss_fn


def token_classification_stage(cfg, mux: MuxSpec, dtype=torch.float32):
    def loss_fn(params, batch, generator):
        logits = MuxBERT.classify_tokens(params["model"], params["head"],
                                         cfg, batch["tokens"], mux=mux,
                                         dtype=dtype, use_kernels=False)
        loss = softmax_xent(logits, batch["tags"])
        acc = (logits.argmax(-1) == batch["tags"]).float().mean()
        return loss, {"accuracy": acc}
    return loss_fn
