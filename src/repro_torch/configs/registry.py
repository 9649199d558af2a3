"""Architecture registry of the port (counterpart of
``repro.configs.registry``).  The port serves the dense LMs
``qwen2-1.5b``, ``gemma-2b``, ``gemma-7b`` and ``h2o-danube-1.8b``, the
MoE LMs ``granite-moe-3b-a800m`` and ``qwen2-moe-a2.7b``, the hybrid
``recurrentgemma-9b`` (RG-LRU and local attention), ``rwkv6-7b``,
``whisper-small`` (kind 'encdec') and ``llava-next-mistral-7b`` (kind
'vlm'), each in full and reduced form: all ten of the reference's.  The
paper's models (``PAPER_MODELS``, kind 'bert': ``models.bert.MuxBERT``)
run as encoders, not through the serving stack.

The dry-run grid (``launch.dryrun``): ``SHAPES``, the reference's four
input shapes, and ``cell_status``, ok or skip with its reason per (arch,
shape) cell; ``grid`` lists the 40.  ``set_overrides`` (``dryrun
--set``) and ``set_reduced_mode`` change what ``get_config`` returns, as
the reference's do; an override of a field the port's ``ModelConfig``
lacks raises."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.configs import (gemma_2b, gemma_7b, granite_moe_3b_a800m,
                                 h2o_danube_1_8b, llava_next_mistral_7b,
                                 qwen2_1_5b, qwen2_moe_a2_7b,
                                 recurrentgemma_9b, rwkv6_7b, whisper_small)
from repro_torch.models.bert import bert_config

# the reference's order, which the dry-run grid follows
_ARCH_MODULES = {"granite-moe-3b-a800m": granite_moe_3b_a800m,
                 "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
                 "recurrentgemma-9b": recurrentgemma_9b,
                 "llava-next-mistral-7b": llava_next_mistral_7b,
                 "gemma-7b": gemma_7b, "gemma-2b": gemma_2b,
                 "qwen2-1.5b": qwen2_1_5b, "h2o-danube-1.8b": h2o_danube_1_8b,
                 "rwkv6-7b": rwkv6_7b, "whisper-small": whisper_small}
ARCHS = tuple(_ARCH_MODULES)

PAPER_MODELS = ("mux-bert-small", "mux-bert-base", "mux-bert-large",
                "mux-electra-base")


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# config overrides for perf experiments (dryrun --set ...), applied on top
# of the registered config by get_config
_OVERRIDES: dict = {}

# every get_config returns the reduced variant (the dry run of the whole
# path at laptop scale)
_REDUCED_MODE = False


def set_reduced_mode(on: bool):
    global _REDUCED_MODE
    _REDUCED_MODE = on


def set_overrides(arch: str, **kw):
    _OVERRIDES[arch] = {**_OVERRIDES.get(arch, {}), **kw}


def clear_overrides():
    _OVERRIDES.clear()


def _apply_overrides(arch: str, cfg):
    """``cfg`` with ``arch``'s overrides; ``moe_<field>`` sets a field of
    ``cfg.moe`` (ignored on a config without MoE, as the reference's, so
    one ``--set`` serves every arch of a run).  A field the port's config
    lacks raises ``ValueError``."""
    kw = dict(_OVERRIDES.get(arch, {}))
    if not kw:
        return cfg
    moe_kw = {k[4:]: v for k, v in kw.items() if k.startswith("moe_")}
    kw = {k: v for k, v in kw.items() if not k.startswith("moe_")}
    for obj, keys in ((cfg, kw), (cfg.moe, moe_kw)):
        if obj is None:
            continue
        have = {f.name for f in dataclasses.fields(obj)}
        unknown = sorted(set(keys) - have)
        if unknown:
            raise ValueError(f"override of {unknown} on {arch}: the port's "
                             f"{type(obj).__name__} has no such field")
    if moe_kw and cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe_kw)
    return cfg.replace(**kw)


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
    reduced = reduced or _REDUCED_MODE
    if arch in PAPER_MODELS:
        return _apply_overrides(arch, _paper_config(arch, reduced))
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r}: the port serves {ARCHS} so far, and runs the "
            f"paper's models {PAPER_MODELS}")
    m = _ARCH_MODULES[arch]
    return _apply_overrides(arch, m.REDUCED if reduced else m.CONFIG)


def model_kind(arch: str) -> str:
    get_config(arch)
    if arch in PAPER_MODELS:
        return "bert"
    return _ARCH_MODULES[arch].MODEL_KIND


def cell_status(arch: str, shape_name: str) -> str:
    """'ok' or 'skip: <reason>' (the reference's reasons, word for word)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if shape.name == "long_500k":
        if arch == "whisper-small":
            return ("skip: whisper sources cap at 1500 frames / 448 decode "
                    "positions; 500k is out of family")
        if not cfg.sub_quadratic:
            return ("skip: pure full-attention arch — 500k dense KV cache "
                    "is out of memory/latency budget; sub-quadratic archs "
                    "only (DESIGN.md §6)")
    return "ok"


def grid():
    """All 40 (arch, shape) cells with their status."""
    return [(a, s, cell_status(a, s)) for a in ARCHS for s in SHAPES]
