"""Symmetric quantization (counterpart of ``repro.core.quant``): per-tensor
int8, the payload of the data-parallel gradient compression
(``optim.compression``), and per-vector KV-page quantization.

Each (slot, kv-head) head-vector of a K/V page is quantized against its
own abs-max with one fp32 scale, stored beside the payload in the pool's
``ksc``/``vsc`` arrays.  Per-vector scales keep page writes append-only:
a new token's write never requantizes a neighbour slot.  The paged
attention kernels fuse the dequantize (``payload.float() * scale``) into
their page loads.  The expressions below are the reference's, op for op
(``torch.round`` and ``jnp.round`` both round half to even; both fp8
casts round to nearest even), so payloads and scales are bit-identical to
the reference's on the same fp32 inputs.  So are ``quantize_int8`` /
``dequantize_int8``'s.

The error-bound helpers give the parity tests their tolerances
analytically from the stored scales.
"""
from __future__ import annotations

import torch

INT8_LEVELS = 127.0
FP8_MAX = 448.0          # float8_e4m3fn largest finite value
FP8_REL = 2.0 ** -4      # e4m3 half-ulp relative rounding error (3-bit mantissa)
EPS = 1e-12

_KV_ALIASES = {
    "fp32": "fp32", "f32": "fp32", "float32": "fp32",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8",
    "fp8": "fp8", "f8": "fp8", "float8": "fp8", "e4m3": "fp8",
}
KV_DTYPES = ("fp32", "bf16", "int8", "fp8")
KV_QUANT_KINDS = ("int8", "fp8")
_STORE = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}


def int8_scale(x):
    """The per-tensor int8 scale of fp32 ``x``: max|x| / 127 (a 0-d
    tensor, at least EPS / 127)."""
    return x.abs().max().clamp_min(EPS) / INT8_LEVELS


def quantize_int8(x):
    """x fp32 -> (int8 payload, fp32 0-d scale).  Symmetric per-tensor."""
    scale = int8_scale(x)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def resolve_kv_dtype(name):
    """Canonicalize a ``--kv-dtype`` spelling to one of ``KV_DTYPES``
    (None passes through: fp32 pages, unquantized).  Raises for unknown
    names."""
    if name is None:
        return None
    canon = _KV_ALIASES.get(str(name).lower())
    if canon is None:
        raise ValueError(f"unknown kv dtype {name!r} "
                         f"(choose from {sorted(set(_KV_ALIASES))})")
    return canon


def kv_store_dtype(kind):
    """torch storage dtype for a canonical kv-dtype kind."""
    return _STORE[kind]


def kv_quant_kind(dtype) -> str | None:
    """Quantization kind implied by a page tensor's dtype (None for plain
    floating-point pages)."""
    if dtype == torch.int8:
        return "int8"
    if dtype == torch.float8_e4m3fn:
        return "fp8"
    return None


def quantize_kv(x, kind: str):
    """x: (..., Dh) -> (payload (..., Dh) in the store dtype, fp32 scales
    (...)).  Symmetric per-vector scaling over the last axis."""
    if kind not in KV_QUANT_KINDS:
        raise ValueError(f"unknown kv quant kind {kind!r}")
    xf = x.float()
    amax = xf.abs().amax(-1)
    if kind == "int8":
        scale = amax.clamp_min(EPS) / INT8_LEVELS
        q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    else:
        scale = amax.clamp_min(EPS) / FP8_MAX
        q = (xf / scale[..., None]).to(torch.float8_e4m3fn)
    return q, scale


def dequantize_kv(q, scale):
    """Inverse of ``quantize_kv``: payload (..., Dh) × scales (...) ->
    fp32 (..., Dh).  The expression the kernels fuse into their page
    loads."""
    return q.float() * scale.float()[..., None]


# ---------------------------------------------------- analytic error bounds

def kv_error_bound(scale, kind: str):
    """Worst-case |x - dequantize(quantize(x))| per element, given the
    per-vector scales: s/2 for int8 (round to nearest; |x| <= 127 s by
    construction, so clipping adds nothing), 448 * 2^-4 * s = 28 s for fp8
    e4m3 (relative half-ulp rounding of |x/s| <= 448)."""
    s = torch.as_tensor(scale, dtype=torch.float32)
    if kind == "int8":
        return 0.5 * s
    if kind == "fp8":
        return FP8_MAX * FP8_REL * s
    raise ValueError(f"unknown kv quant kind {kind!r}")


def kv_value_bound(scale, kind: str):
    """Upper bound on |dequantized value| per element: levels_max * s."""
    s = torch.as_tensor(scale, dtype=torch.float32)
    return (INT8_LEVELS if kind == "int8" else FP8_MAX) * s


def paged_attention_error_bound(q, k_scales, v_scales, kind: str):
    """Analytic bound on |attention over dequantized pages - attention over
    the pristine fp32 pages|, from the stored scales.

    Each logit q.k/sqrt(d) moves by at most ||q||_1 e_k / sqrt(d); softmax
    is 2-Lipschitz in total variation w.r.t. the l_inf logit perturbation;
    the output sum_i p_i v_i then moves by at most ||p - p'||_1 v_max +
    max_i |dv_i|.  So E <= 2 ||q||_1 e_k / sqrt(d) * v_max + e_v, with
    the max over rows, heads and the whole pool's scales.  Returns a 0-d
    fp32 tensor."""
    qf = q.float()
    dh = qf.shape[-1]
    q_l1 = qf.abs().sum(-1).max()
    s_k = k_scales.float().max()
    s_v = v_scales.float().max()
    e_k = kv_error_bound(s_k, kind)
    e_v = kv_error_bound(s_v, kind)
    v_max = kv_value_bound(s_v, kind)
    return 2.0 * q_l1 * e_k * dh ** -0.5 * v_max + e_v
