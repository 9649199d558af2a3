"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]
(Same values as ``repro/configs/h2o_danube_1_8b.py``.  No ``head_dim``
field: the full config's is 2560 / 32 = 80, and ``replace`` keeps it, so
the reduced config has head_dim 80 at d 64, as the reference's has.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab_size=32000, activation="silu", glu=True,
    norm="rms", positions="rope", rope_theta=10000.0, max_seq_len=16384,
    window=4096, tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, max_seq_len=128, window=16,
    remat=False,
)

MODEL_KIND = "lm"
