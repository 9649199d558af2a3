"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-*-base; hf]
(Same values as ``repro/configs/granite_moe_3b_a800m.py``.)

``d_ff=512`` is the per-expert hidden width (granite's fine-grained
experts); there is no dense FFN.  As the reference's, the config has none
of granite's embedding, attention, residual or logit multipliers.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, activation="silu", glu=True,
    norm="rms", positions="rope", rope_theta=10000.0, max_seq_len=4096,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=512, max_seq_len=128, remat=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=2.0),
)

MODEL_KIND = "lm"
