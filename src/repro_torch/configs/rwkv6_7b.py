"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch: data-dependent decay linear attention.
[arXiv:2404.05892]
(Same values as ``repro/configs/rwkv6_7b.py``.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, d_ff=14336,
    vocab_size=65536, norm="ln", positions="none",
    block_pattern=("rwkv",), rwkv_heads=64,      # head_dim 64
    tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=128, vocab_size=512, max_seq_len=128,
    rwkv_heads=2, remat=False,
)

MODEL_KIND = "lm"
