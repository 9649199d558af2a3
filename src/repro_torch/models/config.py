"""ModelConfig (counterpart of ``repro.models.config``).

The same frozen dataclass as the reference, so a reference config and its
port compare field by field.  The port runs every block kind of the
reference: the dense attention blocks ('attn' / 'local'), with a dense
or a mixture-of-experts FFN (``moe`` set: ``MoEConfig``), the RG-LRU
recurrent block ('rglru'), RWKV6 ('rwkv') and the cross-attention
decoder block ('xattn', with ``encoder`` set: whisper).  ``attn_impl`` picks the attention of a blocking
(whole-prompt) forward: 'naive', 'chunked' (online softmax over
``attn_chunk``-key chunks), 'flash' (the flash-attention kernel) or
'auto' (chunked above 2048 tokens, else naive), as the reference's field
does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE FFN settings, the same 8 fields and defaults."""
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts (qwen2-moe)
    d_shared: int = 0             # shared-expert hidden dim (0 -> d_expert)
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    # dispatch: 'global_sort' (one sort over the B*L tokens) or
    # 'local_group' (per-row routing, sort and capacity)
    impl: str = "global_sort"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|hybrid|ssm|vlm|audio|encoder
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0           # 0 -> n_heads (MHA)
    head_dim: int = 0             # 0 -> d_model // n_heads
    activation: str = "silu"      # FFN activation (gate act when glu)
    glu: bool = True
    qkv_bias: bool = False
    norm: str = "rms"             # rms|ln
    positions: str = "rope"       # rope|learned|none
    rope_theta: float = 10000.0
    max_seq_len: int = 8192
    window: int | None = None     # sliding window (all attention blocks)
    logit_softcap: float | None = None
    embedding_scale: bool = False  # gemma: embeds *= sqrt(d_model)
    tie_embeddings: bool = True
    causal: bool = True
    block_pattern: tuple = ("attn",)
    local_window: int = 2048
    moe: MoEConfig | None = None  # the attention blocks' FFN is MoE
    attn_impl: str = "auto"       # auto|naive|chunked|flash
    attn_chunk: int = 1024
    # rwkv6
    rwkv_heads: int = 0           # 0 -> d_model // 64
    rwkv_chunk: int = 32          # chunk of the plain chunkwise recurrence
    rwkv_intra_dtype: str = "f32"  # 'bf16': plain path only
    # frontends are stubs, as in the reference: the caller hands in
    # precomputed frame embeddings (frontend_len of them)
    frontend: str | None = None   # vision|audio
    frontend_len: int = 0
    encoder: "ModelConfig | None" = None   # enc-dec models (whisper)
    # training: checkpoint each period of the no-cache forward under
    # autograd (its activations recomputed for the backward)
    remat: bool = True

    def __post_init__(self):
        if self.n_kv_heads == 0:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def pattern_layers(self):
        """Per-layer block types, the pattern cycled to n_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True if per-token decode cost and state are O(1) or O(window):
        no global attention block, or a window on every attention block."""
        return all(b != "attn" for b in self.block_pattern) or (
            self.window is not None)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the LM without the mux engine (embeddings once if
    tied; learned positions and the encoder included), as the
    reference's ``param_count``."""
    d = cfg.d_model
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.positions == "learned":
        n += cfg.max_seq_len * d
    n += sum(_block_params(cfg, blk) for blk in cfg.pattern_layers)
    n += d * (2 if cfg.norm == "ln" else 1)
    if cfg.encoder is not None:
        n += param_count(cfg.encoder)
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: the top_k routed experts and the
    shared ones), as the reference's."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    per_expert = (3 if cfg.glu else 2) * cfg.d_model * m.d_expert
    return param_count(cfg) - (m.n_experts - m.top_k) * per_expert \
        * cfg.n_layers


def _ffn_params(cfg: ModelConfig) -> int:
    d, ff = cfg.d_model, 3 if cfg.glu else 2
    if cfg.moe is None:
        return ff * d * cfg.d_ff
    m = cfg.moe
    n = m.n_experts * ff * d * m.d_expert + d * m.n_experts   # + router
    if m.n_shared:
        n += ff * d * (m.d_shared or m.d_expert) * m.n_shared
    return n


def _block_params(cfg: ModelConfig, blk: str) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    n = 2 * d * (2 if cfg.norm == "ln" else 1)    # two norms (LN has bias)
    if blk == "rglru":
        w = d                                     # lru width = d_model
        n += 3 * d * w                            # w_in, w_gate, w_out
        n += 4 * w + w                            # conv taps + bias
        n += 2 * (w * w + w) + w                  # w_a, w_i, lam
        return n + _ffn_params(cfg)
    if blk == "rwkv":
        lora = 64
        n += 4 * d + 4 * d * d                    # mu; w_r, w_k, w_v, w_g
        n += d + 2 * d * lora                     # decay w0 + LoRA
        n += 3 * d + d * d                        # u, groupnorm; w_o
        return n + d + 2 * d * cfg.d_ff           # mu_cm; cm_k, cm_v
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    attn += cfg.n_heads * hd * d
    if cfg.qkv_bias:
        attn += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    ffn = _ffn_params(cfg)
    if blk == "xattn":                            # third norm, cross-attn
        return n + d * (2 if cfg.norm == "ln" else 1) + 2 * attn + ffn
    return n + attn + ffn
