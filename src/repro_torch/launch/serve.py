"""Serving launcher of the port (counterpart of ``repro.launch.serve``).

Three modes, as in the reference:

  * fill-drain (default): ``MuxBatcher`` packs requests into the N_mux x B
    grid of a ring cache; spare slots duplicate live requests and their
    averaged logits are the paper's ensembling mode;
  * continuous (``--continuous``): requests join and leave every step.
    ``--cache ring`` (default) re-prefills the whole grid whenever its
    composition changes; ``--cache paged`` runs ``serve.runtime.
    ServeRuntime``, prompts prefilled in fixed-size chunks interleaved
    with decode (``--prefill chunked``, default) or whole at admission
    (``--prefill blocking``).

    python -m repro_torch.launch.serve --continuous --cache paged \
        --no-reduced --mux-n 2 --requests 8 --new-tokens 16

Architectures: the dense LMs ``--arch qwen2-1.5b`` (default),
``gemma-2b``, ``gemma-7b`` and ``h2o-danube-1.8b`` (every arm),
``--arch rwkv6-7b`` (RWKV6, on the ring arm and in fill-drain: the
reference's paged arm fails on RWKV, so ``--cache paged`` with it is an
error) and ``--arch whisper-small`` (encoder-decoder, fill-drain only,
as the reference; its frame embeddings are zeros, as the reference
CLI's); the paper's encoders (``mux-bert-*``, ``mux-electra-base``) are
an error.  Runs on
``cuda`` unless ``--device cpu``; weights come from a seeded init.
``--use-kernels`` (default) runs the kernel path, ``--no-use-kernels``
the plain model path.
``--kv-dtype fp32|bf16|int8|fp8`` sets the page storage (int8 and fp8
pages carry per-slot scales; the kernels fuse the dequant).  The
reference's other modes (lanes, recovery, mesh, telemetry output) are
later slices: their flags are rejected with an error that names the
slice.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.configs import get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.models import EncDecLM, TransformerLM
from repro_torch.serve import sampling
from repro_torch.serve.batcher import MuxBatcher, Request
from repro_torch.serve.engine import (ServeConfig, decode_step, init_cache,
                                      prefill)
from repro_torch.serve.runtime import (PAD_ID, ServeRuntime, grid_sampling,
                                       params_to, resolve_device)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.telemetry import NULL_TELEMETRY


def run_continuous(params, sc: ServeConfig, backbone_rows: int, arrivals,
                   *, on_prefill=None, chunk: int = 32,
                   prefill_mode: str = "chunked", use_kernels: bool = True,
                   telemetry=None, device=None):
    """Continuous-batching serve loop for both cache layouts.

    arrivals: iterable of (step, prompt_tokens, max_new[, SamplingParams]).
    Each loop iteration admits what it can, then decodes one token over
    the grid.  device defaults to ``cuda`` and raises without a card.

    paged: one ``ServeRuntime``; a joining row's prompt advances one
    chunk per engine step (``prefill_mode='chunked'``) or is prefilled
    whole at admission (``'blocking'``).  The stats are the runtime's,
    plus the runtime itself (``runtime``).
    ring: admission re-prefills the WHOLE grid from every row's current
    tokens, right-padded with the pad token (the shared slot-position
    vector makes positions uniform across rows), and so does the write
    position reaching capacity.  use_kernels reaches the ring decode
    (``decode_attention`` or the RWKV6 kernel, and the fused entry and
    exit) — the reference's CLI decodes plain, its
    ``decode_step(use_kernels=True)`` takes this route — and the RWKV6
    kernel of the blocking prefill, whose entry and exit stay plain and
    whose attention follows ``attn_impl``.  An RWKV grid restarts from a
    zero state at each re-prefill and takes the pad tokens into it, as in
    the reference.

    Either way the stats hold ``wall`` and ``generated_tokens``, and the
    prefill accounting: ``prefill_tokens`` backbone token positions,
    ``prefill_compute_tokens`` the same after bucket padding,
    ``prefill_log`` (rows, per-row tokens) per event.
    """
    if sc.kind != "lm":
        raise NotImplementedError(
            "continuous serving supports decoder-only LM families")
    if prefill_mode not in ("chunked", "blocking"):
        raise ValueError(f"prefill_mode must be chunked|blocking, got "
                         f"{prefill_mode!r}")
    telemetry = NULL_TELEMETRY if telemetry is None else telemetry
    arrivals = collections.deque(sorted(arrivals, key=lambda a: a[0]))
    uid = 0

    def pop_arrivals(step, submit):
        nonlocal uid
        while arrivals and arrivals[0][0] <= step:
            a = arrivals.popleft()
            submit(Request(uid=uid, prompt=list(a[1]), max_new=a[2],
                           sampling=a[3] if len(a) > 3 else None))
            uid += 1

    t0 = time.time()
    if sc.cache_layout == "paged":
        rt = ServeRuntime(params, sc, backbone_rows,
                          chunk=None if prefill_mode == "blocking" else chunk,
                          on_prefill=on_prefill, use_kernels=use_kernels,
                          device=device, telemetry=telemetry)
        step = 0
        while arrivals or rt.has_work():
            pop_arrivals(step, rt.submit)
            rt.step()
            step += 1
        rt.check_compile_once()
        stats = rt.stats
        stats["runtime"] = rt
    else:
        stats = _run_ring(params, sc, backbone_rows, arrivals, pop_arrivals,
                          on_prefill=on_prefill, use_kernels=use_kernels,
                          telemetry=telemetry, device=device)
    stats["wall"] = time.time() - t0
    stats["generated_tokens"] = sum(len(r.output) for r in stats["completed"])
    return stats


def _sample_grid(sched, logits):
    """One token per grid slot (mux-major), each with its request's own
    sampling, on the host."""
    arr, steps = grid_sampling(sched)
    return sampling.sample(logits, arr["temperature"], arr["top_k"],
                           arr["top_p"], arr["seed"], steps).cpu().numpy()


def _run_ring(params, sc, backbone_rows, arrivals, pop_arrivals, *,
              on_prefill, use_kernels, telemetry, device):
    dev = resolve_device(device)
    params = params_to(params, dev)
    n_mux, nrows = max(sc.mux.n, 1), backbone_rows
    nb = n_mux * nrows
    sched = ContinuousScheduler(n_mux=n_mux, backbone_batch=nrows,
                                max_len=sc.capacity, telemetry=telemetry)
    stats = {"prefill_tokens": 0, "prefill_compute_tokens": 0,
             "prefill_events": 0, "decode_steps": 0, "prefill_log": [],
             "slot_util": [], "cache_util": [], "completed": sched.completed}
    next_tok = np.full((n_mux, nrows), PAD_ID, np.int64)
    cache, grid_pos, step = None, 0, 0
    while arrivals or sched.queue or sched.n_active:
        pop_arrivals(step, sched.submit)
        if sched.admit() or (sched.n_active and grid_pos >= sc.capacity):
            # any composition change, or the write position reaching
            # capacity (padding lets it outrun the live lengths), rebuilds
            # the grid from every row's tokens: the cost the paged layout
            # removes
            grids = [sched.row_prompts(j, PAD_ID) for j in range(nrows)]
            l_pad = max(g.shape[1] for g in grids)
            arr = np.full((n_mux, nrows, l_pad), PAD_ID, np.int64)
            for j, g in enumerate(grids):
                arr[:, j, :g.shape[1]] = g
            cache = init_cache(sc, nb, device=dev)
            with telemetry.span("prefill", tokens=l_pad * nrows):
                logits, _ = prefill(params, sc, cache, torch.from_numpy(
                    arr.reshape(nb, l_pad)).to(dev), use_kernels=use_kernels)
                toks = _sample_grid(sched, logits)
            grid_pos = l_pad
            stats["prefill_tokens"] += l_pad * nrows
            stats["prefill_compute_tokens"] += l_pad * nrows
            stats["prefill_events"] += 1
            stats["prefill_log"].append((tuple(range(nrows)), l_pad))
            if on_prefill is not None:
                on_prefill(tuple(range(nrows)), l_pad)
            sched.record_tokens(toks)
            next_tok = toks.reshape(n_mux, nrows)
        if sched.n_active:
            for i in range(n_mux):
                for j in range(nrows):
                    if sched.slots[j][i].request is None:
                        next_tok[i, j] = PAD_ID
            toks_in = torch.from_numpy(next_tok.reshape(-1, 1)).to(dev)
            with telemetry.span("decode", metric="decode_step_s"):
                logits, _ = decode_step(params, sc, cache, toks_in, grid_pos,
                                        use_kernels=use_kernels)
                out = _sample_grid(sched, logits[:, 0])
            sched.record_tokens(out)
            next_tok = out.reshape(n_mux, nrows)
            stats["decode_steps"] += 1
            stats["slot_util"].append(sched.utilization())
            grid_pos += 1
            stats["max_grid_pos"] = max(stats.get("max_grid_pos", 0),
                                        grid_pos)
            stats["cache_util"].append(min(grid_pos, sc.capacity)
                                       / sc.capacity if sched.n_active
                                       else 0.0)
        step += 1
    return stats


def fill_drain(params, sc: ServeConfig, backbone_rows: int, prompts,
               new_tokens: int, *, samplings=None, frames=None,
               use_kernels: bool = True, telemetry=None, device=None):
    """Fill-drain serving over a ring cache: batches of up to N_mux x B
    requests, spare slots holding duplicates whose logits are averaged
    (ensembling).  prompts: equal-length token sequences; every request
    gets ``new_tokens`` tokens.  samplings: one ``SamplingParams`` (or
    None, greedy) per prompt.  frames (kind 'encdec'): one
    (frontend_len, d_enc) array of frame embeddings per prompt, stacked
    in slot order for each batch's prefill; None gives zeros, as the
    reference's CLI.  Each batch is one blocking prefill and
    ``new_tokens - 1`` decode steps, on the kernel path under use_kernels
    as in ``run_continuous``'s ring arm (the reference's CLI decodes
    plain); each step's tokens come to the host (the step's one device
    wait, as in the continuous arms), so the telemetry spans ``prefill``
    and ``decode`` time whole steps.  Returns stats: ``completed``
    requests, ``wall``, ``generated_tokens``, ``prefill_events``,
    ``decode_steps``."""
    telemetry = NULL_TELEMETRY if telemetry is None else telemetry
    dev = resolve_device(device)
    params = params_to(params, dev)
    batcher = MuxBatcher(n_mux=max(sc.mux.n, 1), backbone_batch=backbone_rows)
    frame_of = {}
    for i, p in enumerate(prompts):
        r = batcher.submit(np.asarray(p), max_new=new_tokens)
        r.sampling = samplings[i] if samplings else None
        if sc.kind == "encdec":
            enc = sc.cfg.encoder
            frame_of[r.uid] = (np.zeros((enc.frontend_len, enc.d_model),
                                        np.float32) if frames is None
                               else np.asarray(frames[i], np.float32))
    stats = {"completed": [], "prefill_events": 0, "decode_steps": 0}
    t0 = time.time()
    while True:
        slots, owners = batcher.next_batch()
        if slots is None:
            break
        uniq = list({id(s): s for s in slots}.values())
        arr = sampling.params_arrays([r.sampling for r in uniq])
        own = torch.as_tensor(owners, device=dev)

        def sample(logits, t):
            ens = MuxBatcher.combine_logits(logits, owners, len(uniq))
            tok = sampling.sample(ens, arr["temperature"], arr["top_k"],
                                  arr["top_p"], arr["seed"],
                                  np.full(len(uniq), t))
            return tok, tok[own][:, None]

        toks = torch.as_tensor(np.stack([np.asarray(s.prompt)
                                         for s in slots])).long().to(dev)
        cache = init_cache(sc, toks.shape[0], device=dev)
        extra = None
        if frame_of:
            extra = torch.from_numpy(np.stack([frame_of[s.uid]
                                               for s in slots])).to(dev)
        with telemetry.span("prefill", tokens=toks.numel()):
            logits, _ = prefill(params, sc, cache, toks, extra=extra,
                                use_kernels=use_kernels)
            tok, toks_in = sample(logits, 0)
            outs = [tok.cpu().numpy()]
        stats["prefill_events"] += 1
        for t in range(new_tokens - 1):
            with telemetry.span("decode", metric="decode_step_s"):
                lg, _ = decode_step(params, sc, cache, toks_in,
                                    toks.shape[1] + t,
                                    use_kernels=use_kernels)
                tok, toks_in = sample(lg[:, 0], t + 1)
                outs.append(tok.cpu().numpy())
            stats["decode_steps"] += 1
        for j, r in enumerate(uniq):
            r.output = [int(o[j]) for o in outs]
            r.done = True
            stats["completed"].append(r)
    stats["wall"] = time.time() - t0
    stats["generated_tokens"] = sum(len(r.output) for r in stats["completed"])
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
                    help="continuous batching (requests join/leave every "
                         "step) instead of fill-drain")
    ap.add_argument("--cache", choices=("ring", "paged"), default="ring",
                    help="KV-cache layout for --continuous")
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
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the kernel path (default; the kernels' plain "
                         "versions on the CPU); --no-use-kernels runs the "
                         "plain model path")
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
    if args.block_size < 1:
        ap.error(f"--block-size must be >= 1, got {args.block_size}")
    try:
        cfg = get_config(args.arch, reduced=args.reduced)
        kind = model_kind(args.arch)
    except NotImplementedError as e:
        ap.error(str(e))
    if kind == "bert":
        ap.error(f"--arch {args.arch}: the paper's encoders have no decode "
                 "loop to serve; run them through models.bert.MuxBERT")
    if kind != "lm" and args.continuous:
        ap.error(f"--continuous with {args.arch}: continuous serving "
                 "supports decoder-only LM families, as the reference's "
                 "(repro/serve/runtime.py:128); serve it in fill-drain")
    if args.cache == "paged" and "rwkv" in cfg.block_pattern:
        ap.error(f"--cache paged with {args.arch}: the reference's paged arm "
                 "fails on RWKV (its blocking prefill of one row meets the "
                 "whole batch's token-shift state: 'Cannot concatenate "
                 "arrays'; ROADMAP.md §3); serve it with --cache ring or in "
                 "fill-drain")
    dev = resolve_device(args.device)
    mux = MuxSpec(n=args.mux_n)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = EncDecLM if kind == "encdec" else TransformerLM
    params = model.init(gen, cfg, mux)
    # fp32, as the reference's CLI serves (repro/launch/serve.py:906-911)
    sc = ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                     capacity=args.prompt_len + args.new_tokens + 8,
                     cache_layout=args.cache if args.continuous else "ring",
                     block_size=args.block_size, kv_dtype=args.kv_dtype,
                     kind=kind)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(4, cfg.vocab_size, size=(args.prompt_len,))
               for _ in range(args.requests)]
    samplings = [None] * args.requests
    if args.temperature > 0:
        samplings = [sampling.SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=i) for i in range(args.requests)]
    if not args.continuous:
        stats = fill_drain(params, sc, args.backbone_batch, prompts,
                           args.new_tokens, samplings=samplings,
                           use_kernels=args.use_kernels, device=dev)
        served, dt = len(stats["completed"]), stats["wall"]
        print(f"served {served} requests x {args.new_tokens} tokens in "
              f"{dt:.1f}s  (mux N={mux.n}, backbone batch "
              f"{args.backbone_batch}; throughput "
              f"{served * args.new_tokens / dt:.1f} tok/s)")
        return 0
    arrivals = [(i * args.arrival_every, p, args.new_tokens, sp)
                for i, (p, sp) in enumerate(zip(prompts, samplings))]
    stats = run_continuous(params, sc, args.backbone_batch, arrivals,
                           chunk=args.chunk, prefill_mode=args.prefill,
                           use_kernels=args.use_kernels, device=dev)
    util = float(np.mean(stats["slot_util"])) if stats["slot_util"] else 0.0
    mode = (f"paged/{stats['prefill_mode']}" if sc.cache_layout == "paged"
            else "ring")
    print(f"continuous[{mode}/{dev.type}] served "
          f"{len(stats['completed'])} requests "
          f"({stats['generated_tokens']} tokens) in {stats['wall']:.1f}s  "
          f"(mux N={mux.n}, rows {args.backbone_batch}; "
          f"{stats['generated_tokens'] / stats['wall']:.1f} tok/s, "
          f"prefill {stats['prefill_tokens']} backbone tokens "
          f"({stats['prefill_compute_tokens']} padded) in "
          f"{stats['prefill_events']} events, slot util {util:.2f})")
    if sc.cache_layout == "paged":
        print(f"kv pages {sc.page_dtype}: pool {stats['pool_bytes']} bytes, "
              f"{stats['kv_bytes_per_token']} bytes per token")
        compiled = ", ".join(f"{k}×{v}" for k, v in
                             sorted(stats["trace_counts"].items()))
        print(f"step signatures: {compiled}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
