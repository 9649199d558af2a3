"""Architecture registry of the port (counterpart of
``repro.configs.registry``).  The port serves ``qwen2-1.5b``,
``rwkv6-7b`` and ``whisper-small`` (kind 'encdec'), each in full and
reduced form; the other architectures are later slices."""
from __future__ import annotations

from repro_torch.configs import qwen2_1_5b, rwkv6_7b, whisper_small

_ARCH_MODULES = {"qwen2-1.5b": qwen2_1_5b, "rwkv6-7b": rwkv6_7b,
                 "whisper-small": whisper_small}
ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str, *, reduced: bool = False):
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r}: the port serves {ARCHS} so far")
    m = _ARCH_MODULES[arch]
    return m.REDUCED if reduced else m.CONFIG


def model_kind(arch: str) -> str:
    get_config(arch)
    return _ARCH_MODULES[arch].MODEL_KIND
