"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 4 shared + 60 routed experts top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
(Same values as ``repro/configs/qwen2_moe_a2_7b.py``.)

As the reference's: the top-4 gate values are renormalised to sum to 1,
and the shared experts (one GLU 4 x 1408 = 5632 wide) are added with no
sigmoid gate.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936, activation="silu", glu=True, qkv_bias=True,
    norm="rms", positions="rope", rope_theta=1_000_000.0, max_seq_len=32768,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=1408),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab_size=512, max_seq_len=128, remat=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, n_shared=2,
                  d_shared=48, capacity_factor=2.0),
)

MODEL_KIND = "lm"
