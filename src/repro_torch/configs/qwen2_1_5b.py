"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias.  [arXiv:2407.10671]
(Same values as ``repro/configs/qwen2_1_5b.py``.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, activation="silu", glu=True, qkv_bias=True,
    norm="rms", positions="rope", rope_theta=1_000_000.0, max_seq_len=32768,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, max_seq_len=128, remat=False,
)

MODEL_KIND = "lm"
