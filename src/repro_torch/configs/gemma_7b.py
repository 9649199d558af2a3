"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256.  [arXiv:2403.08295]
(Same values as ``repro/configs/gemma_7b.py``.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, activation="gelu_tanh", glu=True,
    norm="rms", positions="rope", rope_theta=10000.0, max_seq_len=8192,
    embedding_scale=True, tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512, max_seq_len=128, remat=False,
)

MODEL_KIND = "lm"
