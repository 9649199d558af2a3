"""Time the flash-decode and RWKV6 kernels over their design choices on
one NVIDIA GPU.

    python -m repro_torch.launch.kernel_sweep [--json PATH]

* ``decode_attention``: split plans (splits x slots a split) at the ring
  decode shape (B=4, C=124, 12 heads over 2, head_dim 128) and at
  whisper-small's cross-attention decode (B=4, C=1500, 12 over 12,
  head_dim 64), with a ring of 2 and of 3 stages (``kStages``).
* ``rwkv6_chunked``: thread-tile layouts at head dim 64 (B=4, H=64; L = 1,
  100, 200): columns a block, row groups, columns a thread, tokens a
  stage (``Cfg<64>``) and the token loop's unroll; columns a block at
  head dim 128 (B=4, H=32).

Each variant is the shipped source with those constants replaced, built
with the port's nvcc flags into ``build/kernel_sweep/`` and checked
against the plain version before it is timed.  A time is the mean device
time of 20 calls, the L2 flushed and the stream held by a spin kernel
before each (``chip_smoke.py``'s method); the method's floor, a
one-element ``add_``, is printed first.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import types

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import rwkv6 as krw

OUT = build.REPO / "build" / "kernel_sweep"
STAGES = "constexpr int kStages = 3;"
CFG64 = ("template <> struct Cfg<64> { static constexpr int CB = 64, RG = 8, "
         "CPT = 4, TT = 16; };")
CFG128 = ("template <> struct Cfg<128> { static constexpr int CB = 64, "
          "RG = 16, CPT = 4, TT = 8; };")
UNROLL = "#pragma unroll 2\n    for (int t = 0; t < n; ++t) {"


def _cfg64(cb, rg, cpt, tt):
    return CFG64.replace("CB = 64, RG = 8, CPT = 4, TT = 16",
                         f"CB = {cb}, RG = {rg}, CPT = {cpt}, TT = {tt}")


# name -> (source, [(shipped text, replacement)])
VARIANTS = {
    "decode kStages 3 (shipped)": ("decode_attention", []),
    "decode kStages 2": ("decode_attention",
                         [(STAGES, STAGES.replace("3", "2"))]),
    "rwkv hd64 CB 64 RG 8 CPT 4 TT 16 unroll 2 (shipped)": ("rwkv6", []),
    "rwkv hd64 TT 8": ("rwkv6", [(CFG64, _cfg64(64, 8, 4, 8))]),
    "rwkv hd64 unroll 1": ("rwkv6", [(UNROLL, UNROLL.split("\n")[1])]),
    "rwkv hd64 CB 32 (2 blocks a head)": ("rwkv6",
                                          [(CFG64, _cfg64(32, 8, 4, 16))]),
    "rwkv hd64 CB 32 RG 16": ("rwkv6", [(CFG64, _cfg64(32, 16, 4, 16))]),
    "rwkv hd64 RG 4 (16 rows a thread)": ("rwkv6",
                                          [(CFG64, _cfg64(64, 4, 4, 16))]),
    "rwkv hd64 CPT 8": ("rwkv6", [(CFG64, _cfg64(64, 8, 8, 16))]),
    "rwkv hd128 CB 32": ("rwkv6", [(CFG128, CFG128.replace("CB = 64",
                                                           "CB = 32"))]),
}
DECODE_PLANS = {"ring": [(8, 16), (4, 32), (2, 64), (1, 128)],
                "whisper": [(16, 96), (12, 128), (8, 192), (4, 384)]}


class Timer:
    """Mean device time of ``fn`` (chip_smoke.py's Timer, unchanged in
    method): L2 flushed and a spin kernel queued before each call."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(20_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def build_variants():
    """{name: loaded library} for every variant (built in parallel)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, subs)) in enumerate(VARIANTS.items()):
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {src}.cu")
            text = text.replace(old, new)
        cu, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (src, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        for fn, argtypes in build.SIGNATURES[src].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        libs[name] = dll
    return libs


def _using(module, lib):
    """``module`` launching from ``lib`` instead of the shipped build."""
    module.build = types.SimpleNamespace(load=lambda _name: lib,
                                         check=build.check)


def sweep(timer, libs, rng):
    dev = torch.device("cuda")

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s)
                               .astype(np.float32), device=dev)
    x = torch.zeros(1, device=dev)
    res = {"floor: one-element add_": timer(lambda: x.add_(1.0))}
    plan = kdec.plan
    for shape, (b, c, h, hkv, dh, causal) in {
            "ring": (4, 124, 12, 2, 128, True),
            "whisper": (4, 1500, 12, 12, 64, False)}.items():
        q, kc, vc = r(b, 1, h, dh), r(b, c, hkv, dh), r(b, c, hkv, dh)
        pos = torch.arange(c, dtype=torch.int32, device=dev)
        kw = dict(q_pos=c - 1, causal=causal)
        want = ref.decode_attention_ref(q, kc, vc, pos, **kw)
        for name in (n for n in libs if n.startswith("decode")):
            _using(kdec, libs[name])
            for p in DECODE_PLANS[shape]:
                kdec.plan = lambda *_a, p=p: p
                err = (kdec.decode_attention_cuda(q, kc, vc, pos, **kw)
                       - want).abs().max().item()
                if err > 1e-4:
                    raise RuntimeError(f"{name} {p}: max_abs_err {err}")
                res[f"decode_attention {shape} {name} plan {p}"] = timer(
                    lambda: kdec.decode_attention_cuda(q, kc, vc, pos, **kw))
        kdec.plan, kdec.build = plan, build
    for b, l, h, hd in [(4, 1, 64, 64), (4, 100, 64, 64), (4, 200, 64, 64),
                        (4, 1, 32, 128), (4, 100, 32, 128)]:
        a = (r(b, l, h, hd), r(b, l, h, hd, s=0.5), r(b, l, h, hd),
             -torch.exp(r(b, l, h, hd, s=0.5)), r(h, hd, s=0.1),
             r(b, h, hd, hd, s=0.1))
        want = krw.rwkv6_ref(*a)
        for name in (n for n in libs if n.startswith(f"rwkv hd{hd}")
                     or (n.startswith("rwkv") and "shipped" in n)):
            _using(krw, libs[name])
            got = krw.rwkv6_cuda(*a)
            for g, w in zip(got, want):
                if not torch.allclose(g, w, atol=5e-4, rtol=1e-3):
                    raise RuntimeError(f"{name} L={l}: disagrees with the "
                                       "sequential oracle")
            res[f"rwkv6_chunked hd {hd} L={l} {name}"] = timer(
                lambda: krw.rwkv6_cuda(*a))
        krw.build = build
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the times (ms) here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = sweep(Timer(), build_variants(), np.random.default_rng(0))
    for name, ms in res.items():
        print(f"{name}: {ms:.5f} ms")
    print(smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "ms": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
