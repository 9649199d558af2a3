"""Plain PyTorch versions of every ported kernel, under the names of
``repro/kernels/ref.py`` (the oracles the CPU tests and ``chip_smoke.py``
hold the kernels against).  Each is defined beside its kernel."""
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.demux_rsa import demux_rsa_fused_ref, demux_rsa_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.mux_combine import mux_combine_ref
from repro_torch.kernels.mux_embed import mux_embed_ref
from repro_torch.kernels.paged_attention import (
    paged_attention_quant_ref, paged_attention_ref,
    paged_prefill_attention_quant_ref, paged_prefill_attention_ref)
from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv_chunked

__all__ = ["decode_attention_ref", "demux_rsa_ref", "demux_rsa_fused_ref",
           "flash_attention_ref", "mux_combine_ref", "mux_embed_ref",
           "paged_attention_ref", "paged_prefill_attention_ref",
           "paged_attention_quant_ref",
           "paged_prefill_attention_quant_ref", "rwkv6_ref", "rwkv_chunked"]
