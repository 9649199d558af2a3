"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865 —
encoder-decoder; conv frontend stubbed (the caller provides precomputed
frame embeddings, 1500 frames).  [arXiv:2212.04356]
(Same values as ``repro/configs/whisper_small.py``.)
"""
from repro_torch.models.config import ModelConfig

_ENCODER = ModelConfig(
    name="whisper-small-encoder", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865, activation="gelu_tanh", glu=False, qkv_bias=True,
    norm="ln", positions="learned", max_seq_len=1500, causal=False,
    frontend="audio", frontend_len=1500, tie_embeddings=True,
)

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865, activation="gelu_tanh", glu=False, qkv_bias=True,
    norm="ln", positions="learned", max_seq_len=32768, causal=True,
    block_pattern=("xattn",), encoder=_ENCODER, tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, max_seq_len=128, remat=False,
    encoder=_ENCODER.replace(n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=4, d_ff=128, vocab_size=512,
                             max_seq_len=24, frontend_len=24,
                             remat=False),
)

MODEL_KIND = "encdec"
