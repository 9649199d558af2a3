"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``; ``csrc/*.cuh`` holds device helpers
they share.  Libraries land in ``build/repro_torch/<hash>/`` at the
repository root, keyed by a hash of all the sources and headers, and are
built at first use: every source at once, one ``nvcc`` process each,
started together.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD = REPO / "build" / "repro_torch"
SOURCES = ("paged_attention", "demux_rsa", "decode_attention",
           "flash_attention", "rwkv6", "mux_entry")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not pathlib.Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):       # shared device helpers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / h.hexdigest()[:16]


@functools.cache
def build_all() -> dict:
    """Compile every source that is not built yet, in parallel.  Returns
    {"seconds": wall time, "log": nvcc's output (ptxas register and shared
    memory report)}.  Raises if any compile fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    log, failed = [], []
    for name, (proc, tmp, lib) in procs.items():
        text, _ = proc.communicate()
        log.append(f"== {name}.cu\n{text}")
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return {"seconds": time.perf_counter() - t0, "log": "\n".join(log)}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_attention": {
        # q, kp, vp, ksc, vsc, bt, ppos, q_pos, out, part_o, part_ml; kind,
        # q_bf16, B, H, Hkv, Dh, BS, MB, causal, window, nsplit, split_len;
        # scale; stream
        "paged_attention_decode": [_P] * 11 + [_I] * 12 + [_F, _P],
        # ... q_start, q_len, out, part_o, part_ml; kind, q_bf16, B, Lq, ...
        "paged_attention_prefill": [_P] * 12 + [_I] * 13 + [_F, _P],
    },
    "demux_rsa": {
        # h, k, entry_scale, entry_bias, w1h, w1k, b1, w2, b2, exit_scale,
        # exit_bias, zp, st, g, yp, out, counter; entry_kind, T, N, D, F,
        # s1, len1, s2, len2, bf16; stream
        "demux_rsa_forward": [_P] * 17 + [_I] * 10 + [_P],
    },
    "decode_attention": {
        # q, k, v, slot_pos, q_pos_ptr, out; B, C, H, Hkv, Dh, q_pos,
        # causal, window, nsplit, split_len, bf16; scale; stream
        "decode_attention_forward": [_P] * 6 + [_I] * 11 + [_F, _P],
    },
    "flash_attention": {
        # q, k, v, out, part_o, part_ml; B, Lq, Lk, H, Hkv, Dh, causal,
        # window, q_offset, nsplit, split_tiles, bf16; softcap, scale;
        # stream
        "flash_attention_forward": [_P] * 6 + [_I] * 12 + [_F, _F, _P],
    },
    "rwkv6": {
        # r, k, v, logw, u, s0, out, sT; B, L, H, hd, bf16; stream
        "rwkv6_forward": [_P] * 8 + [_I] * 5 + [_P],
    },
    "mux_entry": {
        # tok, emb, v, out; N, T, D, cols, threads, vec, emb_bf16, v_bf16,
        # out_bf16; coef; stream
        "mux_embed_forward": [_P] * 4 + [_I] * 9 + [_F, _P],
        # x, v, out; N, T, D, cols, rows, slices, grid, threads, vec,
        # x_bf16, v_bf16; coef; stream
        "mux_combine_forward": [_P] * 3 + [_I] * 11 + [_F, _P],
    },
}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call),
    with ``argtypes``/``restype`` declared for every entry point."""
    build_all()
    lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
