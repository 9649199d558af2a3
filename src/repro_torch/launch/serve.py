"""Serving launcher of the port: continuous paged serving with chunked
prefill (counterpart of ``repro.launch.serve``'s paged arm).

    python -m repro_torch.launch.serve --continuous --cache paged \
        --no-reduced --mux-n 2 --requests 8 --new-tokens 16

Runs on ``cuda`` unless ``--device cpu``; weights come from a seeded
init.  ``--kv-dtype fp32|bf16|int8|fp8`` sets the page storage (int8 and
fp8 pages carry per-slot scales; the kernels fuse the dequant).  The
reference's other modes (ring cache, blocking prefill, fill-drain, lanes,
recovery, mesh, telemetry output) are later slices: their flags are
rejected with an error that names the slice.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.configs import get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.models import TransformerLM
from repro_torch.serve import sampling
from repro_torch.serve.batcher import Request
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.runtime import ServeRuntime, resolve_device
from repro_torch.serve.telemetry import NULL_TELEMETRY


def run_continuous(params, sc: ServeConfig, backbone_rows: int, arrivals,
                   *, on_prefill=None, chunk: int = 32,
                   use_kernels: bool = True,
                   telemetry=None, device=None):
    """Continuous-batching serve loop over one paged ``ServeRuntime``.

    arrivals: iterable of (step, prompt_tokens, max_new[, SamplingParams]).
    Each engine step admits what it can, advances every mid-prefill row by
    one chunk and decodes one token over the grid.  device defaults to
    ``cuda`` and raises without a card.  Returns the runtime's stats dict
    plus ``wall``, ``generated_tokens`` and the runtime (``runtime``).

    Prefill accounting: ``prefill_tokens`` backbone token positions,
    ``prefill_compute_tokens`` the same after bucket padding,
    ``prefill_log`` (rows, per-row tokens) per event.
    """
    telemetry = NULL_TELEMETRY if telemetry is None else telemetry
    rt = ServeRuntime(params, sc, backbone_rows, chunk=chunk,
                      on_prefill=on_prefill, use_kernels=use_kernels,
                      device=device, telemetry=telemetry)
    arrivals = collections.deque(sorted(arrivals, key=lambda a: a[0]))
    uid = step = 0
    t0 = time.time()
    while arrivals or rt.has_work():
        while arrivals and arrivals[0][0] <= step:
            a = arrivals.popleft()
            rt.submit(Request(uid=uid, prompt=list(a[1]), max_new=a[2],
                              sampling=a[3] if len(a) > 3 else None))
            uid += 1
        rt.step()
        step += 1
    rt.check_compile_once()
    stats = rt.stats
    stats["wall"] = time.time() - t0
    stats["generated_tokens"] = sum(len(r.output) for r in stats["completed"])
    stats["runtime"] = rt
    return stats


# flag -> where its mode stands in ROADMAP §1 (the reference still runs it)
_LATER = {
    "--lanes": "width lanes, ROADMAP §1 item 10",
    "--lane-rows": "width lanes, ROADMAP §1 item 10",
    "--slo-mix": "width lanes, ROADMAP §1 item 10",
    "--pool-budget": "width lanes, ROADMAP §1 item 10",
    "--route": "width lanes, ROADMAP §1 item 10",
    "--disagg": "disaggregation, ROADMAP §1 item 10",
    "--prefill-lanes": "disaggregation, ROADMAP §1 item 10",
    "--decode-lanes": "disaggregation, ROADMAP §1 item 10",
    "--shards": "recovery, ROADMAP §1 item 11",
    "--kill-shard": "recovery, ROADMAP §1 item 11",
    "--drain-lane": "recovery, ROADMAP §1 item 11",
    "--add-lane": "recovery, ROADMAP §1 item 11",
    "--restart-step": "recovery, ROADMAP §1 item 11",
    "--ckpt-dir": "recovery, ROADMAP §1 item 11",
    "--fence-stragglers": "recovery, ROADMAP §1 item 11",
    "--mesh": "sharding, ROADMAP §1 item 12",
    "--metrics-out": "the telemetry CLI, ROADMAP §1 item 8",
    "--trace-out": "the telemetry CLI, ROADMAP §1 item 8",
    "--metrics-interval": "the telemetry CLI, ROADMAP §1 item 8",
    "--trace-annotate": "the telemetry CLI, ROADMAP §1 item 8",
}


def _parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--mux-n", type=int, default=2)
    ap.add_argument("--backbone-batch", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (required: fill-drain is a "
                         "later slice)")
    ap.add_argument("--cache", choices=("ring", "paged"), default="paged")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill", choices=("chunked", "blocking"),
                    default="chunked")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--arrival-every", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--kv-dtype", default=None,
                    choices=["fp32", "bf16", "int8", "fp8"],
                    help="KV-page storage dtype (int8/fp8 store quantized "
                         "pages with per-slot scales; the paged kernels "
                         "fuse the dequant). Default: fp32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    for flag in _LATER:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, where in _LATER.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet ({where}); the JAX package "
                     "serves it: python -m repro.launch.serve")
    if args.kv_dtype and not (args.continuous and args.cache == "paged"):
        ap.error("--kv-dtype requires --continuous --cache paged")
    if not args.continuous:
        ap.error("fill-drain serving is a later slice of the port (ROADMAP "
                 "§1 item 8): pass --continuous --cache paged")
    if args.cache == "ring":
        ap.error("--cache ring is a later slice of the port (ROADMAP §1 "
                 "item 8): use --cache paged")
    if args.prefill == "blocking":
        ap.error("--prefill blocking is a later slice of the port (ROADMAP "
                 "§1 item 8): use --prefill chunked")
    if args.block_size < 1:
        ap.error(f"--block-size must be >= 1, got {args.block_size}")
    try:
        cfg = get_config(args.arch, reduced=args.reduced)
        model_kind(args.arch)
    except NotImplementedError as e:
        ap.error(str(e))
    dev = resolve_device(args.device)
    mux = MuxSpec(n=args.mux_n)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = TransformerLM.init(gen, cfg, mux)
    sc = ServeConfig(cfg=cfg, mux=mux,
                     capacity=args.prompt_len + args.new_tokens + 8,
                     block_size=args.block_size, kv_dtype=args.kv_dtype)
    rng = np.random.default_rng(args.seed)
    arrivals = []
    for i in range(args.requests):
        sp = None
        if args.temperature > 0:
            sp = sampling.SamplingParams(temperature=args.temperature,
                                         top_k=args.top_k, top_p=args.top_p,
                                         seed=i)
        arrivals.append((i * args.arrival_every,
                         rng.integers(4, cfg.vocab_size,
                                      size=(args.prompt_len,)),
                         args.new_tokens, sp))
    stats = run_continuous(params, sc, args.backbone_batch, arrivals,
                           chunk=args.chunk, device=dev)
    util = float(np.mean(stats["slot_util"])) if stats["slot_util"] else 0.0
    print(f"continuous[paged/chunked/{dev.type}] served "
          f"{len(stats['completed'])} requests "
          f"({stats['generated_tokens']} tokens) in {stats['wall']:.1f}s  "
          f"(mux N={mux.n}, rows {args.backbone_batch}; "
          f"{stats['generated_tokens'] / stats['wall']:.1f} tok/s, "
          f"prefill {stats['prefill_tokens']} backbone tokens "
          f"({stats['prefill_compute_tokens']} padded) in "
          f"{stats['prefill_events']} events, slot util {util:.2f})")
    print(f"kv pages {sc.page_dtype}: pool {stats['pool_bytes']} bytes, "
          f"{stats['kv_bytes_per_token']} bytes per token")
    compiled = ", ".join(f"{k}×{v}"
                         for k, v in sorted(stats["trace_counts"].items()))
    print(f"step signatures: {compiled}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
