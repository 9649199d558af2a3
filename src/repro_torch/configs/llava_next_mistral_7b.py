"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — the mistral-7b text backbone behind a two-layer
multimodal projector; the vision tower is a stub, as in the reference:
the caller hands in precomputed patch embeddings (``frontend_len`` of
width ``models.vlm.D_VISION``).  [hf:llava-hf/llava-v1.6-mistral-7b-hf]
(Same values as ``repro/configs/llava_next_mistral_7b.py``.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, activation="silu", glu=True,
    norm="rms", positions="rope", rope_theta=1_000_000.0, max_seq_len=32768,
    tie_embeddings=False,
    frontend="vision", frontend_len=576,   # base-resolution CLIP grid 24x24
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, max_seq_len=128, frontend_len=8, remat=False,
)

MODEL_KIND = "vlm"
