"""Where the time of one serve step goes, on the card.

    python -m repro_torch.launch.profile_step [--no-use-kernels]
        [--dtype fp32|bf16] [--kv-dtype fp32|bf16|int8|fp8]

Builds full-width qwen2-1.5b (random seeded weights) at mux N=2 with 4
backbone rows holding ~100-token contexts, then runs ``torch.profiler``
(CPU + CUDA activities) over a few decode steps and a few 32-token
prefill chunks, each group ending in a synchronize.  From the Chrome
trace it reports, per step: host wall time, device busy time (the union
of kernel, memcpy and memset intervals), the device's idle share, the
number of kernels launched, and the device time by kernel name.  The
idle share is taken against the wall time of the same steps run without
the profiler, and the device time and kernel count by group
(``STEP_GROUPS``: paged attention, demux, mux entry, casts and copies —
a bf16 step's per-op weight casts — and matmuls).  ``--dtype`` sets the
compute dtype (default fp32), ``--kv-dtype`` the page storage (default:
the compute dtype).  Needs a GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.models import TransformerLM
from repro_torch.serve import engine
from repro_torch.serve.runtime import resolve_device

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# kernel groups of a serve step (lower-case name substrings); "casts and
# copies" holds the per-op weight casts of a bf16 step (a copy kernel each)
STEP_GROUPS = {"paged attention": ("paged_",), "demux": ("demux_",),
               "mux entry": ("mux_embed", "mux_combine"),
               "casts and copies": ("copy",),
               "matmul": ("gemm", "gemv", "cutlass", "sm90_", "cublas",
                          "nvjet")}


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarize(label, trace, steps, wall_s, prof_wall_s, top, groups=None):
    """Print per-step host wall time, device busy time, the idle share and
    the kernel count of ``trace``, then ``groups`` (a name: substrings map;
    a kernel falls in the first group one of whose substrings its lower-case
    name holds, else in "other") and the ``top`` kernels by device time."""
    evs = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not evs:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in evs)
    by_name = collections.Counter()
    for e in evs:
        by_name[e["name"]] += e["dur"]
    n_kernels = sum(e["cat"] == "kernel" for e in evs)
    wall_us = wall_s * 1e6
    print(f"{label}: wall {wall_us / steps / 1e3:.3f} ms/step "
          f"({prof_wall_s * 1e3 / steps:.3f} under the profiler), device "
          f"busy {busy / steps / 1e3:.3f} ms/step, idle share "
          f"{1 - busy / wall_us:.3f}, {n_kernels / steps:.0f} kernels/step")
    if groups:
        by_group, n_group = collections.Counter(), collections.Counter()
        for e in evs:
            low = e["name"].lower()
            g = next((g for g, subs in groups.items()
                      if any(s in low for s in subs)), "other")
            by_group[g] += e["dur"]
            n_group[g] += e["cat"] == "kernel"
        print("  by group: " + ", ".join(
            f"{g} {us / steps / 1e3:.3f} ms ({us / busy:.1%}, "
            f"{n_group[g] / steps:.0f} kernels)"
            for g, us in by_group.most_common()))
    for name, us in by_name.most_common(top):
        print(f"  {us / steps:10.1f} us/step  {us / busy:6.1%}  {name[:90]}")


def wall_time(fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_calls(fn, steps):
    """Run ``fn`` ``steps`` times under ``torch.profiler`` (CPU + CUDA),
    ending in a synchronize.  Returns (Chrome trace as a dict, wall s)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f), wall
    finally:
        os.unlink(path)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile_step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True, help="kernel path (default) or plain path")
    ap.add_argument("--dtype", default="fp32", choices=sorted(DTYPES),
                    help="compute dtype (ServeConfig.dtype; default fp32, "
                         "as the CLI serves)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["fp32", "bf16", "int8", "fp8"],
                    help="KV-page storage dtype (default: the compute "
                         "dtype)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config("qwen2-1.5b")
    mux = MuxSpec(n=2)
    params = TransformerLM.init(torch.Generator(device=dev).manual_seed(0),
                                cfg, mux)
    rows, ctx = 4, 96
    sc = engine.ServeConfig(cfg=cfg, mux=mux, capacity=124,
                            dtype=DTYPES[args.dtype], cache_layout="paged",
                            block_size=16, kv_dtype=args.kv_dtype)
    cache = engine.init_cache(sc, mux.n * rows, device=dev)
    pool = engine.make_pool(sc, mux.n * rows)
    for r in range(rows):
        pool.allocate(r, ctx + 8)
    engine.set_block_tables(cache, pool.table_array(range(rows)))
    gen = torch.Generator(device=dev).manual_seed(1)

    def toks(shape):
        return torch.randint(4, cfg.vocab_size, shape, generator=gen,
                             device=dev)
    for r in range(rows):
        for s in range(0, ctx, 32):
            engine.prefill_chunk(params, sc, cache, toks((mux.n, 32)),
                                 rows=[r], start=s, length=32,
                                 use_kernels=args.use_kernels)
    dtok = toks((mux.n * rows, 1))
    pos = torch.tensor([ctx] * rows, device=dev)
    ctok = toks((mux.n, 32))

    def decode():
        logits, _ = engine.decode_step(params, sc, cache, dtok, pos,
                                       use_kernels=args.use_kernels)
        return logits[:, 0].argmax(-1)

    def chunk():
        logits, _ = engine.prefill_chunk(params, sc, cache, ctok, rows=[0],
                                         start=64, length=32,
                                         use_kernels=args.use_kernels)
        return logits.argmax(-1)

    path = "kernel" if args.use_kernels else "plain"
    print(f"qwen2-1.5b full width, N=2, {rows} rows at context {ctx}, "
          f"{sc.dtype} compute, {sc.page_dtype} pages, {path} path, "
          f"{torch.cuda.get_device_name(dev)}")
    for label, fn in (("decode step", decode), ("prefill chunk (32)", chunk)):
        for _ in range(2):
            fn()
        wall = wall_time(fn, args.steps)
        trace, prof_wall = profile_calls(fn, args.steps)
        summarize(label, trace, args.steps, wall, prof_wall, args.top,
                  STEP_GROUPS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
