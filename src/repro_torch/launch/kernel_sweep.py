"""Time the flash-decode, RWKV6 and mux-entry kernels over their design
choices on one NVIDIA GPU.

    python -m repro_torch.launch.kernel_sweep [--json PATH]
        [--kernels decode rwkv mux]

* ``decode_attention``: split plans (splits x slots a split) at the ring
  decode shape (B=4, C=124, 12 heads over 2, head_dim 128) and at
  whisper-small's cross-attention decode (B=4, C=1500, 12 over 12,
  head_dim 64), with a ring of 2 and of 3 stages (``kStages``).
* ``rwkv6_chunked``: thread-tile layouts at head dim 64 (B=4, H=64; L = 1,
  100, 200): columns a block, row groups, columns a thread, tokens a
  stage (``Cfg<64>``) and the token loop's unroll; columns a block at
  head dim 128 (B=4, H=32).
* ``mux_embed_combine`` and ``mux_combine`` (``csrc/mux_entry.cu``): the
  combine with 1, 2 and 4 fp32 rows a thread at once (``kUnroll``) and 1,
  2 and 4 bf16 rows (``kUnrollBf16``), one or both instances' rows loaded
  before the first FMA (``kGroup``, ``kGroupBf16``), the combine capped at
  64 registers, and N = 2 as a constant against N at run time
  (``kStaticN``); the entry's D-slices a token at
  qwen2-1.5b's decode and chunk (T=4 and 32, d 1536); the combine's block
  tiling (16-byte chunks a slice row, threads a block) at every phase-3
  entry shape; ``torch.add`` of two (6000, 768) rows in fp32 and in bf16,
  the same bytes as whisper's entry, as the rate a plain elementwise
  kernel reaches here.

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
import re
import subprocess
import sys
import types

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import mux_combine as kc
from repro_torch.kernels import mux_embed as km
from repro_torch.kernels import rwkv6 as krw

OUT = build.REPO / "build" / "kernel_sweep"
STAGES = "constexpr int kStages = 3;"
CFG64 = ("template <> struct Cfg<64> { static constexpr int CB = 64, RG = 8, "
         "CPT = 4, TT = 16; };")
CFG128 = ("template <> struct Cfg<128> { static constexpr int CB = 64, "
          "RG = 16, CPT = 4, TT = 8; };")
UNROLL = "#pragma unroll 2\n    for (int t = 0; t < n; ++t) {"
UNROLL_C = "constexpr int kUnroll = 2;"
UNROLL_BF16 = "constexpr int kUnrollBf16 = 2;"
STATIC_N = "constexpr int kStaticN = 2;"
GROUP = "constexpr int kGroup = 2;"
GROUP_BF16 = "constexpr int kGroupBf16 = 1;"
COMBINE_BOUNDS = "__launch_bounds__(256)\n    mux_combine_kernel"


def _set(line, value):
    """Replace the value of the source's ``constexpr int`` ``line``."""
    return line, f"{line.rsplit(' = ', 1)[0]} = {value};"


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
    "mux kUnroll 2 kGroupBf16 1 kUnrollBf16 2 (shipped)": ("mux_entry", []),
    "mux kUnroll 1": ("mux_entry", [_set(UNROLL_C, 1)]),
    "mux kUnroll 4": ("mux_entry", [_set(UNROLL_C, 4)]),
    "mux kGroup 1": ("mux_entry", [_set(GROUP, 1)]),
    "mux kUnrollBf16 1": ("mux_entry", [_set(UNROLL_BF16, 1)]),
    "mux kUnrollBf16 4": ("mux_entry", [_set(UNROLL_BF16, 4)]),
    "mux kGroupBf16 2": ("mux_entry", [_set(GROUP_BF16, 2)]),
    "mux kGroupBf16 2 kUnrollBf16 1": ("mux_entry", [
        _set(GROUP_BF16, 2), _set(UNROLL_BF16, 1)]),
    # at most 64 registers a thread in mux_combine (4 blocks of 256 an SM)
    "mux kGroupBf16 2 64 registers": ("mux_entry", [
        _set(GROUP_BF16, 2),
        (COMBINE_BOUNDS, COMBINE_BOUNDS.replace("256", "256, 4"))]),
    "mux N at run time": ("mux_entry", [_set(STATIC_N, 0)]),
}
KERNELS = ("decode", "rwkv", "mux")      # --kernels: the variants' first word
# the entry's D-slices a token at T=4, d 1536 (columns a block)
EMBED_COLS = [1536, 768, 512, 256, 128]
# the combine's block tiling: (16-byte chunks a slice row at most, threads
# a block); (None, 256) is kernels/mux_combine.py's plan, (32, 128) the
# tile of the Triton kernel it replaced (16 rows x 256 bf16 columns at
# kUnrollBf16 4, 4 warps)
COMBINE_TILINGS = [(None, 256), (None, 128), (64, 256), (64, 128),
                   (32, 256), (32, 128)]
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


REGISTERS = {}      # mux variant -> {kernel instantiation: registers}


def _registers(log):
    """{demangled-ish kernel name: registers} from ``ptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(mux_\w+?_kernel)I(\w+?)EEv", m.group(1))
            fn = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = int(m.group(1))
    return out


def build_variants(kernels):
    """{name: loaded library} for every variant of ``kernels`` (built in
    parallel)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, subs)) in enumerate(VARIANTS.items()):
        if name.split()[0] not in kernels:
            continue
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {src}.cu")
            text = text.replace(old, new)
        cu, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (src, lib, i, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, lib, i, proc) in procs.items():
        log, _ = proc.communicate()
        if src == "mux_entry":
            REGISTERS[name] = _registers(log)
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


def sweep(timer, libs, rng, kernels):
    dev = torch.device("cuda")

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s)
                               .astype(np.float32), device=dev)
    x = torch.zeros(1, device=dev)
    res = {"floor: one-element add_": timer(lambda: x.add_(1.0))}
    if "decode" in kernels:
        sweep_decode(timer, libs, r, res)
    if "rwkv" in kernels:
        sweep_rwkv(timer, libs, r, res)
    if "mux" in kernels:
        sweep_mux(timer, libs, rng, res)
    return res


def sweep_decode(timer, libs, r, res):
    dev = torch.device("cuda")
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


def sweep_rwkv(timer, libs, r, res):
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


def _check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    if err > tol:
        raise RuntimeError(f"{name}: max_abs_err {err} > {tol}")


def mux_unroll(name):
    """{element size: rows a thread at once} of mux variant ``name``: its
    ``kUnroll`` (fp32) and ``kUnrollBf16``."""
    src, subs = VARIANTS[name]
    text = (build.CSRC / f"{src}.cu").read_text()
    for old, new in subs:
        text = text.replace(old, new)

    def get(k):
        return int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
    return {4: get("kUnroll"), 2: get("kUnrollBf16")}


def combine_tiling(t, d, elt, unroll, chunks=None, threads=kc.THREADS):
    """``mux_combine.plan``'s vector branch with slice rows of at most
    ``chunks`` 16-byte chunks (default: ``threads``), ``threads`` threads
    a block and ``unroll`` rows a thread at once."""
    slices = -(-d * elt // (16 * (chunks or threads)))
    cols = 8 * -(-d // (8 * slices))
    slices = -(-d // cols)
    ch = -(-cols * elt // 16)
    groups = threads // ch
    rows = groups * unroll
    return kc.Plan(cols, rows, slices, slices * -(-t // rows), groups * ch,
                   True)


def sweep_mux(timer, libs, rng, res):
    """Both entry kernels under each mux variant at every phase-3 shape,
    then the plan's choices overridden: the entry's slices, the combine's
    tiling."""
    dev = torch.device("cuda")
    tables = {}

    def embed_case(vocab, d, t, dt=torch.float32):
        if (vocab, d) not in tables:
            tables[vocab, d] = torch.as_tensor(
                rng.standard_normal((vocab, d), np.float32) * 0.02,
                device=dev)
        emb = tables[vocab, d].to(dt)
        v = torch.as_tensor(rng.standard_normal((2, d), np.float32),
                            device=dev).to(dt)
        tok = torch.as_tensor(rng.integers(0, vocab, (2, t)),
                              dtype=torch.int32, device=dev)
        return tok, emb, v

    def combine_case(t, d, dt=torch.float32):
        x = torch.as_tensor(rng.standard_normal((2, t, d), np.float32),
                            device=dev).to(dt)
        v = torch.as_tensor(rng.standard_normal((2, d), np.float32),
                            device=dev).to(dt)
        return x, v

    bf = torch.bfloat16
    embeds = {"qwen2 T=4": embed_case(151936, 1536, 4),
              "qwen2 T=32": embed_case(151936, 1536, 32),
              "rwkv6-7b T=4": embed_case(65536, 4096, 4),
              "whisper T=4": embed_case(51865, 768, 4),
              "qwen2 T=4 bf16": embed_case(151936, 1536, 4, bf)}
    combines = {"whisper enc": combine_case(6000, 768),
                "qwen2 prefill": combine_case(400, 1536),
                "whisper enc bf16": combine_case(6000, 768, bf),
                "rwkv6-7b prefill": combine_case(436, 4096)}
    for case in ("whisper enc", "whisper enc bf16"):
        x, v = combines[case]
        out = torch.empty_like(x[0])
        res[f"mux_combine {case} yardstick: torch.add(x[0], x[1]), the "
            "same bytes"] = timer(lambda x=x, out=out:
                                  torch.add(x[0], x[1], out=out))
    eplan, cplan = km.plan, kc.plan
    for name in (n for n in libs if n.startswith("mux")):
        _using(km, libs[name])
        _using(kc, libs[name])
        unroll = mux_unroll(name)
        # the unroll variants change mux_combine only
        if all(old not in (UNROLL_C, UNROLL_BF16, GROUP_BF16,
                           COMBINE_BOUNDS)
               for old, _ in VARIANTS[name][1]):
            for case, (tok, emb, v) in embeds.items():
                od = emb.dtype
                want = ref.mux_embed_ref(tok, emb, v, scale=2.0)
                fn = (lambda tok=tok, emb=emb, v=v, od=od:
                      km.mux_embed_combine_cuda(tok, emb, v, scale=2.0,
                                                out_dtype=od))
                _check(f"{name} {case}", fn(), want,
                       1e-5 if od != bf else 5e-2)
                res[f"mux_embed_combine {case} {name}"] = timer(fn)
            for case in ("qwen2 T=4", "qwen2 T=32"):
                tok, emb, v = embeds[case]
                want = ref.mux_embed_ref(tok, emb, v)
                for cols in EMBED_COLS:
                    p = eplan(2, 4, 1536, 4)._replace(
                        cols=cols, threads=min(256, 32 * -(-cols // 128)))
                    km.plan = lambda *_a, p=p, **_k: p
                    _check(f"{name} cols {cols}", km.mux_embed_combine_cuda(
                        tok, emb, v), want, 1e-5)
                    res[f"mux_embed_combine {case} {name} "
                        f"{-(-1536 // cols)} slices of {cols}"] = timer(
                        lambda: km.mux_embed_combine_cuda(tok, emb, v))
            km.plan = eplan
        for case, (x, v) in combines.items():
            want = ref.mux_combine_ref(x, v)
            tol = 2e-5 if x.dtype == torch.float32 else 5e-2
            _, t, d = x.shape
            elt = x.element_size()
            for chunks, threads in COMBINE_TILINGS:
                p = combine_tiling(t, d, elt, unroll[elt], chunks, threads)
                kc.plan = lambda *_a, p=p, **_k: p
                tiling = (f"chunks {chunks or 'row'} threads {threads} "
                          f"({p.rows} x {p.cols} tiles)")
                _check(f"{name} {case} {tiling}", kc.mux_combine_cuda(x, v),
                       want, tol)
                res[f"mux_combine {case} {name} {tiling}"] = timer(
                    lambda x=x, v=v: kc.mux_combine_cuda(x, v))
            kc.plan = cplan
    km.build = kc.build = build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the times (ms) here as JSON")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="which kernels to sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = sweep(Timer(), build_variants(args.kernels),
                np.random.default_rng(0), args.kernels)
    for name, ms in res.items():
        print(f"{name}: {ms:.5f} ms")
    for name, regs in REGISTERS.items():
        print(f"registers {name}: {regs}")
    print(smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "ms": res, "registers": REGISTERS}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
