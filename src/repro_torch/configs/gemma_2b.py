"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256, MQA.  [arXiv:2403.08295]
(Same values as ``repro/configs/gemma_2b.py``.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, activation="gelu_tanh", glu=True,
    norm="rms", positions="rope", rope_theta=10000.0, max_seq_len=8192,
    embedding_scale=True, tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=512, max_seq_len=128, remat=False,
)

MODEL_KIND = "lm"
