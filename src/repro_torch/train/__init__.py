"""Training of the port (counterpart of ``repro.train``): the losses, the
train-step factory and the paper's three MUX stages."""
from repro_torch.train.losses import (
    softmax_xent, causal_lm_loss, sigmoid_bce, chunked_vocab_xent,
)
from repro_torch.train.step import make_train_step, jit_step
from repro_torch.train import mux_stages

__all__ = ["softmax_xent", "causal_lm_loss", "sigmoid_bce",
           "chunked_vocab_xent", "make_train_step", "jit_step", "mux_stages"]
