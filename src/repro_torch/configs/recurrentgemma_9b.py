"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 2:1 pattern
(two recurrent blocks then one windowed-attention block, window 2048).
[arXiv:2402.19427]
(Same values as ``repro/configs/recurrentgemma_9b.py``.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, activation="gelu_tanh", glu=True,
    norm="rms", positions="rope", rope_theta=10000.0, max_seq_len=8192,
    embedding_scale=True, tie_embeddings=True,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
)

REDUCED = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, max_seq_len=128, local_window=16,
    remat=False,
)

MODEL_KIND = "lm"
