"""Architecture registry of the port (counterpart of
``repro.configs.registry``).  The port serves the dense LMs
``qwen2-1.5b``, ``gemma-2b``, ``gemma-7b`` and ``h2o-danube-1.8b``, the
MoE LMs ``granite-moe-3b-a800m`` and ``qwen2-moe-a2.7b``, the hybrid
``recurrentgemma-9b`` (RG-LRU and local attention), ``rwkv6-7b``,
``whisper-small`` (kind 'encdec') and ``llava-next-mistral-7b`` (kind
'vlm'), each in full and reduced form: all ten of the reference's.  The
paper's models (``PAPER_MODELS``, kind 'bert': ``models.bert.MuxBERT``)
run as encoders, not through the serving stack."""
from __future__ import annotations

from repro_torch.configs import (gemma_2b, gemma_7b, granite_moe_3b_a800m,
                                 h2o_danube_1_8b, llava_next_mistral_7b,
                                 qwen2_1_5b, qwen2_moe_a2_7b,
                                 recurrentgemma_9b, rwkv6_7b, whisper_small)
from repro_torch.models.bert import bert_config

_ARCH_MODULES = {"qwen2-1.5b": qwen2_1_5b, "gemma-2b": gemma_2b,
                 "gemma-7b": gemma_7b, "h2o-danube-1.8b": h2o_danube_1_8b,
                 "granite-moe-3b-a800m": granite_moe_3b_a800m,
                 "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
                 "recurrentgemma-9b": recurrentgemma_9b,
                 "rwkv6-7b": rwkv6_7b, "whisper-small": whisper_small,
                 "llava-next-mistral-7b": llava_next_mistral_7b}
ARCHS = tuple(_ARCH_MODULES)

PAPER_MODELS = ("mux-bert-small", "mux-bert-base", "mux-bert-large",
                "mux-electra-base")


def _paper_config(arch: str, reduced: bool):
    """The reference's config (``mux-electra-base`` is BERT-base's);
    reduced: 2 layers, d 64, 4 heads, d_ff 128, vocab 512, 64 positions,
    passed to ``bert_config`` so the heads derive from them (the
    reference's ``replace`` of the full config keeps base's 12 KV heads
    of 64: ROADMAP §3)."""
    size = arch.split("-")[-1]
    if reduced:
        return bert_config(size, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                           vocab_size=512, max_seq_len=64)
    return bert_config(size)


def get_config(arch: str, *, reduced: bool = False):
    if arch in PAPER_MODELS:
        return _paper_config(arch, reduced)
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r}: the port serves {ARCHS} so far, and runs the "
            f"paper's models {PAPER_MODELS}")
    m = _ARCH_MODULES[arch]
    return m.REDUCED if reduced else m.CONFIG


def model_kind(arch: str) -> str:
    get_config(arch)
    if arch in PAPER_MODELS:
        return "bert"
    return _ARCH_MODULES[arch].MODEL_KIND
