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
``gemma-2b``, ``gemma-7b`` and ``h2o-danube-1.8b`` and the MoE LMs
``granite-moe-3b-a800m`` and ``qwen2-moe-a2.7b`` (every arm),
``--arch rwkv6-7b`` (RWKV6) and ``--arch recurrentgemma-9b`` (RG-LRU
with local attention), each on the ring arm and in fill-drain (the
reference's paged arm fails on recurrent blocks, so ``--cache paged``
with them is an error), ``--arch whisper-small`` (encoder-decoder) and
``--arch llava-next-mistral-7b`` (vision-language), both in fill-drain
only, as the reference, with zero frame or patch embeddings and (the
VLM) the reference CLI's decode positions (ROADMAP.md §3); the paper's
encoders (``mux-bert-*``, ``mux-electra-base``) are an error.  Runs on
``cuda`` unless ``--device cpu``; weights come from a seeded init.
``--use-kernels`` (default) runs the kernel path, ``--no-use-kernels``
the plain model path.
``--kv-dtype fp32|bf16|int8|fp8`` sets the page storage (int8 and fp8
pages carry per-slot scales; the kernels fuse the dequant).

Width lanes (``--lanes 1,2,4``): one paged runtime per mux width, each
request routed to a lane by its SLO class (``--slo-mix``) and live lane
load, optionally under a shared block budget (``--pool-budget``) that the
router rebalances; ``--drain-lane STEP:WIDTH`` / ``--add-lane
STEP:WIDTH[:ROWS]`` resize the lane set under traffic.  Disaggregated
serving (``--disagg --prefill-lanes 2 --decode-lanes 2``): prefill-only
lanes hand finished rows, KV pages and all, to same-width decode-only
lanes; ``--route goodput`` orders lanes by published goodput.

    python -m repro_torch.launch.serve --continuous --cache paged \
        --lanes 1,2 --slo-mix latency=1,throughput=1 --requests 8

Telemetry: ``--metrics-out PATH`` writes the metrics JSON and a
Prometheus ``.prom`` beside it, ``--trace-out PATH`` the Chrome trace
(one track per lane), ``--metrics-interval K`` snapshots the registry
every K steps, ``--trace-annotate`` adds ``torch.profiler`` ranges.

Fault injection (paged continuous): ``--shards N`` splits the rows and
the page pool into N logical data shards on the one device; ``--kill-shard
STEP:SHARD`` kills a shard at a step (its streams replay from their host
token logs onto the survivors; with ``--lanes`` / ``--disagg`` it kills
that shard of lane 0); ``--fence-stragglers`` fences a shard whose step
times leave its baseline alone; ``--restart-step STEP --ckpt-dir DIR``
snapshots the whole serving state (pages, block tables, scheduler) and
restores it into a rebuilt runtime, which re-prefills nothing:

    python -m repro_torch.launch.serve --continuous --cache paged \
        --shards 2 --kill-shard 6:1 --requests 8 --new-tokens 8

``--mesh DATA,MODEL`` serves paged continuous batching on a
``('data', 'model')`` mesh of DATA * MODEL ranks that the CLI starts on
this host (``launch.mesh.spawn``): rows and page segments over ``data``
(``--shards`` must equal it), heads, MLP width and experts over ``model``;
rank 0 prints (and writes the telemetry files), and the mode tag reads
``mesh(D, M)`` with the backend.  Every lane of ``--lanes`` / ``--disagg``
(resize, ``--kill-shard`` and ``--pool-budget`` included) is then a
runtime on the mesh, and a handoff between data shards moves its pages
between ranks:

    python -m repro_torch.launch.serve --device cpu --continuous \
        --cache paged --mesh 2,2 --requests 5 --new-tokens 4
    python -m repro_torch.launch.serve --device cpu --continuous \
        --cache paged --mesh 2,2 --disagg --prefill-lanes 2 \
        --decode-lanes 2 --requests 6
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import io
import math
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, model_kind
from repro_torch.core import MuxSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.blocks import RECURRENT
from repro_torch.serve import sampling
from repro_torch.serve.batcher import MuxBatcher, Request
from repro_torch.serve.engine import (MODELS, ServeConfig, decode_step,
                                      init_cache, lane_config, prefill)
from repro_torch.serve.recovery import RecoverySupervisor
from repro_torch.serve.router import LaneRouter, LaneSpec, SLO_CLASSES
from repro_torch.serve.runtime import (PAD_ID, ServeRuntime, grid_sampling,
                                       params_to, resolve_device)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry

# stats merged across a restart's runtime swap: counters sum, per-step
# traces concatenate (the old runtime's first)
_COUNTER_KEYS = ("prefill_tokens", "prefill_compute_tokens",
                 "prefill_events", "decode_steps")
_TRACE_KEYS = ("prefill_log", "slot_util", "cache_util")


def _lane_event(ev, router, sup, params_by_width, sc, backbone_rows, *,
                step, chunk, prefill_mode, on_prefill, use_kernels,
                telemetry, device, mesh=None):
    """Apply one failure or resize event to the lane set: ``kill_shard``
    fences a data shard of one lane's grid (``lane``, default 0),
    ``drain_lane`` starts removing the lane at a width (its streams finish
    in place, its queue re-routes), ``add_lane`` brings up a fresh runtime
    at a new width under traffic (on ``mesh``, on every rank at once)."""
    op = ev["op"]
    if op == "kill_shard":
        idx = router._index_of(ev.get("lane", 0))
        sup.kill_shard(router.runtimes[idx], ev["shard"])
    elif op == "drain_lane":
        width = ev["width"]
        lane = next((rt.lane for rt in router.runtimes
                     if rt.n_mux == width), None)
        if lane is None:
            raise ValueError(f"drain_lane: no lane at width {width}")
        sup.drain_lane(router, lane, step=step)
    elif op == "add_lane":
        width = ev["width"]
        if width not in params_by_width:
            raise ValueError(f"add_lane: no params for width {width}")
        lane_id = 1 + max(rt.lane for rt in
                          router.runtimes + router.retired)
        rt = ServeRuntime(
            params_by_width[width], lane_config(sc, width),
            ev.get("rows", backbone_rows),
            chunk=None if prefill_mode == "blocking"
            else ev.get("chunk", chunk),
            on_prefill=on_prefill, use_kernels=use_kernels, device=device,
            lane=lane_id, telemetry=telemetry, mesh=mesh)
        sup.add_lane(router, rt)
    else:
        raise ValueError(f"unknown serve event op {op!r}")


def _run_lanes(params_by_width, sc: ServeConfig, backbone_rows: int,
               arrivals, lanes, *, on_prefill, chunk, prefill_mode,
               use_kernels, pool_budget, spill_queue, telemetry, events,
               route, device, ckpt_dir=None, fence_stragglers=False,
               mesh=None):
    """Width-lane serve loop: one ``ServeRuntime`` per lane at its mux
    width, ``LaneRouter`` admitting each arrival by SLO class and live
    load, every lane stepping once per loop iteration (narrowest first).
    Each lane keeps the single-width guarantees lane-locally: its streams
    equal a fixed-width run at its N fed the same sub-schedule, its step
    signatures are one decode plus one per bucket (``check_compile_once``
    before returning), and its backpressure stays in its own pool.

    Disaggregated roles: after every step each prefill lane's finished
    rows migrate (pages and the sampled next token, no re-prefill) to a
    free row of a same-width decode lane from
    ``router.handoff_targets``; requests a decode lane bounced back into
    its queue (preemption, shard-loss replay) go through the router to a
    prefill lane.

    mesh: every lane is a ``ServeRuntime(mesh=)`` on this rank, and every
    rank runs this same loop (router, supervisor, events, handoffs) over
    the same host state, so all decide alike; a handoff between data
    shards moves its pages between ranks (``ServeRuntime.handoff_to``).
    The one host reading that differs between ranks, the wall clock,
    reaches a fencing decision as every rank's step times gathered
    (``_observe_shards``) and the returned stats as rank 0's
    (``_one_clock``, in ``run_continuous``)."""
    specs = [s if isinstance(s, LaneSpec)
             else LaneSpec(n_mux=int(s), rows=backbone_rows, chunk=chunk)
             for s in lanes]
    runtimes = []
    for idx, spec in enumerate(specs):
        if spec.n_mux not in params_by_width:
            raise ValueError(
                f"lanes mode needs params per width: missing width "
                f"{spec.n_mux} in {sorted(params_by_width)}")
        runtimes.append(ServeRuntime(
            params_by_width[spec.n_mux], lane_config(sc, spec.n_mux),
            spec.rows,
            chunk=None if prefill_mode == "blocking" else spec.chunk,
            on_prefill=on_prefill, use_kernels=use_kernels, device=device,
            lane=idx, telemetry=telemetry, role=spec.role, mesh=mesh))
    disagg = any(rt.role != "both" for rt in runtimes)
    for rt in runtimes:
        # a prefill lane with nowhere to hand off would park its finished
        # rows forever
        if rt.role == "prefill" and not any(
                d.role != "prefill" and d.n_mux == rt.n_mux
                for d in runtimes):
            raise ValueError(
                f"prefill lane at width {rt.n_mux} has no same-width "
                f"decode-capable lane to hand off to")
    router = LaneRouter(runtimes, budget=pool_budget,
                        spill_queue=spill_queue, telemetry=telemetry,
                        mode=route)
    sup = RecoverySupervisor(ckpt_dir=ckpt_dir, telemetry=telemetry)
    if fence_stragglers:
        sup.enable_straggler_fencing()
    pending = collections.deque(
        sorted(events or [], key=lambda e: e["step"]))
    arrivals = collections.deque(sorted(arrivals, key=lambda a: a[0]))
    uid, step = 0, 0
    t0 = time.time()
    while (arrivals or pending
           or any(rt.has_work() for rt in router.runtimes)):
        while pending and pending[0]["step"] <= step:
            _lane_event(pending.popleft(), router, sup, params_by_width, sc,
                        backbone_rows, step=step, chunk=chunk,
                        prefill_mode=prefill_mode, on_prefill=on_prefill,
                        use_kernels=use_kernels, telemetry=telemetry,
                        device=device, mesh=mesh)
        if disagg:
            # requests a decode lane bounced back cannot prefill there
            for rt in router.runtimes:
                if rt.role != "decode":
                    continue
                while rt.sched.queue:
                    r = rt.sched.queue.popleft()
                    i = router.route(r)
                    r.routed_step = step
                    router.runtimes[i].submit(r)
        while arrivals and arrivals[0][0] <= step:
            a = arrivals.popleft()
            r = Request(uid=uid, prompt=list(a[1]), max_new=a[2],
                        sampling=a[3] if len(a) > 3 else None,
                        slo=a[4] if len(a) > 4 else None)
            uid += 1
            i = router.route(r)
            r.routed_step = step
            router.runtimes[i].submit(r)
        router.rebalance()
        # narrow lanes first: the latency lane admits before wider lanes
        # draw on freshly rebalanced quota
        for rt in sorted(router.runtimes, key=lambda rt: rt.n_mux):
            t_step = time.time()
            rt.step()
            if sup.fencing_enabled and rt.sc.n_shards >= 2:
                _observe_shards(sup, rt, time.time() - t_step)
        if disagg:
            # handoff pass: each prefill lane's finished rows go to a free
            # row of a same-width decode lane; with none free the row
            # parks and retries next step (backpressure, not an error)
            for rt in router.runtimes:
                if rt.role != "prefill":
                    continue
                for j in rt.handoff_ready():
                    for i in router.handoff_targets(rt.n_mux):
                        dst = router.runtimes[i]
                        rows = dst.free_rows()
                        if not rows:
                            continue
                        before = rt.stats["migrated_bytes"]
                        plan = rt.handoff_to(dst, j, rows[0])
                        if plan is not None:
                            sup.note_handoff(
                                plan, rt.stats["migrated_bytes"] - before)
                            break
        sup.note_step()
        sup.pop_drained(router)
        step += 1
        telemetry.maybe_snapshot(step)
    # retired (drained) lanes keep their runtimes, so the step-signature
    # and stats contracts cover every lane that ever served
    all_lanes = sorted(router.runtimes + router.retired,
                       key=lambda rt: rt.lane)
    for rt in all_lanes:
        rt.check_compile_once()
    wall = time.time() - t0
    completed = [r for rt in all_lanes for r in rt.stats["completed"]]
    return {
        "router": router,       # run_continuous adds its lane_stats
        "lanes": [rt.stats for rt in all_lanes],
        "runtimes": all_lanes,
        "widths": [rt.n_mux for rt in all_lanes],
        "pools": [rt.pool for rt in all_lanes],
        "routing": router.counters,
        "completed": completed,
        "wall": wall,
        "generated_tokens": sum(len(r.output) for r in completed),
        "prefill_mode": all_lanes[0].stats["prefill_mode"],
        "recovery": sup.stats,
        # sums over lanes for counters, concatenations for per-step traces
        "prefill_tokens": sum(rt.stats["prefill_tokens"]
                              for rt in all_lanes),
        "prefill_compute_tokens": sum(rt.stats["prefill_compute_tokens"]
                                      for rt in all_lanes),
        "prefill_events": sum(rt.stats["prefill_events"]
                              for rt in all_lanes),
        "decode_steps": sum(rt.stats["decode_steps"] for rt in all_lanes),
        "slot_util": [u for rt in all_lanes for u in rt.stats["slot_util"]],
        "cache_util": [u for rt in all_lanes
                       for u in rt.stats["cache_util"]],
    }


def _observe_shards(sup, rt, dt):
    """Feed one step's time to every alive shard of ``rt``.  One device
    steps every shard at once, so they share the step's time; on a mesh
    each rank times its own step (``_shard_step_times``), so every rank
    fences alike and a slow rank's shard is the one that flags."""
    times = ([dt] * rt.sc.n_shards if rt.mesh is None
             else _shard_step_times(rt.mesh, rt.sc.n_shards, dt))
    sup.observe_shard_times(rt, {s: times[s] for s in range(rt.sc.n_shards)
                                 if s not in rt.sched.dead_shards})


def _shard_step_times(mesh, n_shards: int, dt: float) -> list:
    """Each data shard's step time on every rank of ``mesh``: the slowest
    of its ranks' own ``dt``, a max ``all_reduce`` of one slot per shard
    over each axis (times are >= 0, so the empty slots' zeros lose; it is
    exact, so every rank gets the same floats)."""
    buf = torch.zeros(n_shards, dtype=torch.float64, device=mesh.device)
    buf[mesh.coords["data"]] = dt
    for a in mesh.axes:
        mesh.all_reduce(buf, a, kind="step_times", op="max")
    return buf.tolist()


_STAMPS = ("t_submit", "t_admit", "t_first", "t_done")


def _one_clock(mesh, stats):
    """Rank 0's wall-clock readings of a mesh run's ``stats`` on every
    rank of ``mesh``, in place: the serve ``wall``, each completed
    request's stamps (uid order) and the supervisor's recovery latencies.
    Every rank then returns the same stats, goodput and TTFT attainment
    included."""
    reqs = sorted(stats["completed"], key=lambda r: r.uid)
    lat = stats["recovery"]["recovery_latency_s"]
    vals = mesh.agree([stats["wall"]]
                      + [math.nan if getattr(r, k) is None else getattr(r, k)
                         for r in reqs for k in _STAMPS] + lat)
    at = 1
    for r in reqs:
        for k in _STAMPS:
            setattr(r, k, None if math.isnan(vals[at]) else vals[at])
            at += 1
    lat[:] = vals[at:]
    stats["wall"] = vals[0]


def run_continuous(params, sc: ServeConfig, backbone_rows: int, arrivals,
                   *, on_prefill=None, chunk: int = 32,
                   prefill_mode: str = "chunked", use_kernels: bool = True,
                   telemetry=None, device=None, lanes=None, pool_budget=None,
                   spill_queue=None, events=None, route: str = "load",
                   ckpt_dir=None, fence_stragglers: bool = False, mesh=None):
    """Continuous-batching serve loop for both cache layouts.

    arrivals: iterable of (step, prompt_tokens, max_new[, SamplingParams
    [, slo_class]]).  Each loop iteration admits what it can, then
    decodes one token over the grid.  device defaults to ``cuda`` and
    raises without a card.  telemetry: a ``serve.telemetry.Telemetry``
    (metrics, the span trace and ``maybe_snapshot`` once a step); it
    changes neither tokens nor launches.

    lanes: width-lane serving (paged only): mux widths or
    ``serve.router.LaneSpec`` s (``role='prefill'`` / ``'decode'`` for
    disaggregated serving).  ``params`` is then {width: params} and ``sc``
    the base config (``engine.lane_config`` derives each lane's);
    pool_budget / spill_queue / route ('load' | 'goodput') go to the
    ``LaneRouter``.  The stats then hold per-lane ``lanes`` /
    ``runtimes`` / ``pools`` / ``lane_stats``, the router's ``routing``
    counters and sums over lanes.

    events (paged only): failure and resize dicts ``{"step": K, "op":
    ...}`` applied before step K's admissions by a
    ``serve.recovery.RecoverySupervisor``, whose accounting is
    ``stats["recovery"]``.  One runtime: ``kill_shard`` (``shard``; needs
    ``sc.n_shards >= 2``) and ``restart`` (snapshot, rebuild, restore;
    needs ``ckpt_dir``).  Lanes: ``kill_shard`` (``shard``, optional
    ``lane``), ``drain_lane`` and ``add_lane`` (``width``, optional
    ``rows``).  fence_stragglers: arm per-shard ``StragglerDetector`` s
    over the step times; a shard flagged alone is fenced through the
    kill-shard replay path.

    paged: one ``ServeRuntime``; a joining row's prompt advances one
    chunk per engine step (``prefill_mode='chunked'``) or is prefilled
    whole at admission (``'blocking'``).  The stats are the runtime's
    (the restored one's after a restart, the counters and traces of both
    merged), plus the runtime itself (``runtime``).
    ring: admission re-prefills the WHOLE grid from every row's current
    tokens, right-padded with the pad token (the shared slot-position
    vector makes positions uniform across rows), and so does the write
    position reaching capacity.  use_kernels reaches the ring decode
    (``decode_attention`` or the RWKV6 kernel, and the fused entry and
    exit) — the reference's CLI decodes plain, its
    ``decode_step(use_kernels=True)`` takes this route — and the RWKV6
    kernel of the blocking prefill, whose entry and exit stay plain and
    whose attention follows ``attn_impl``.  An RG-LRU or RWKV grid
    restarts from a zero state at each re-prefill and takes the pad
    tokens into it, as in the reference.

    Either way the stats hold ``wall`` and ``generated_tokens``, and the
    prefill accounting: ``prefill_tokens`` backbone token positions,
    ``prefill_compute_tokens`` the same after bucket padding,
    ``prefill_log`` (rows, per-row tokens) per event.

    mesh: this rank's ``launch.mesh.ServeMesh`` (paged; one runtime or
    lanes): every rank of the mesh calls ``run_continuous`` with the same
    arguments and gets the same stats; a restart's snapshot holds the
    whole cache, written by rank 0.
    """
    if mesh is not None and sc.cache_layout != "paged":
        raise ValueError("mesh serving requires the paged cache layout")
    if sc.kind != "lm":
        raise NotImplementedError(
            "continuous serving supports decoder-only LM families")
    if prefill_mode not in ("chunked", "blocking"):
        raise ValueError(f"prefill_mode must be chunked|blocking, got "
                         f"{prefill_mode!r}")
    telemetry = NULL_TELEMETRY if telemetry is None else telemetry
    if lanes is not None:
        if sc.cache_layout != "paged":
            raise ValueError(
                "width-lane serving requires the paged cache layout")
        stats = _run_lanes(params, sc, backbone_rows, arrivals, lanes,
                           on_prefill=on_prefill, chunk=chunk,
                           prefill_mode=prefill_mode,
                           use_kernels=use_kernels, pool_budget=pool_budget,
                           spill_queue=spill_queue, telemetry=telemetry,
                           events=events, route=route, device=device,
                           ckpt_dir=ckpt_dir,
                           fence_stragglers=fence_stragglers, mesh=mesh)
        if mesh is not None:
            _one_clock(mesh, stats)
        stats["lane_stats"] = stats.pop("router").lane_stats(
            wall=stats["wall"])
        return stats
    if events and sc.cache_layout != "paged":
        raise ValueError("failure/resize events require the paged layout")
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
        stats = _run_paged(params, sc, backbone_rows, arrivals, pop_arrivals,
                           chunk=None if prefill_mode == "blocking" else chunk,
                           on_prefill=on_prefill, use_kernels=use_kernels,
                           device=device, telemetry=telemetry, events=events,
                           ckpt_dir=ckpt_dir,
                           fence_stragglers=fence_stragglers, mesh=mesh)
    else:
        stats = _run_ring(params, sc, backbone_rows, arrivals, pop_arrivals,
                          on_prefill=on_prefill, use_kernels=use_kernels,
                          telemetry=telemetry, device=device)
    stats["wall"] = time.time() - t0
    stats["generated_tokens"] = sum(len(r.output) for r in stats["completed"])
    if mesh is not None:
        _one_clock(mesh, stats)
    return stats


def _run_paged(params, sc, backbone_rows, arrivals, pop_arrivals, *, chunk,
               on_prefill, use_kernels, device, telemetry, events, ckpt_dir,
               fence_stragglers, mesh=None):
    """One ``ServeRuntime`` stepped until every request is served, with
    the failure events applied before their steps' admissions."""
    def make_rt():
        return ServeRuntime(params, sc, backbone_rows, chunk=chunk,
                            on_prefill=on_prefill, use_kernels=use_kernels,
                            device=device, telemetry=telemetry, mesh=mesh)

    rt = make_rt()
    sup = RecoverySupervisor(ckpt_dir=ckpt_dir, telemetry=telemetry)
    if fence_stragglers:
        sup.enable_straggler_fencing()
    pending = collections.deque(sorted(events or [], key=lambda e: e["step"]))
    step = 0
    while arrivals or pending or rt.has_work():
        while pending and pending[0]["step"] <= step:
            ev = pending.popleft()
            if ev["op"] == "kill_shard":
                sup.kill_shard(rt, ev["shard"])
            elif ev["op"] == "restart":
                # a process restart: snapshot, a fresh runtime, restore;
                # the old runtime's delivered results and counters carry
                sup.snapshot(rt, step)
                old, rt = rt, make_rt()
                sup.restore(rt)
                rt.sched.completed[:0] = old.sched.completed
                for k in _COUNTER_KEYS:
                    rt.stats[k] += old.stats[k]
                for k in _TRACE_KEYS:
                    rt.stats[k][:0] = old.stats[k]
            else:
                raise ValueError(f"unknown serve event op {ev['op']!r}")
        pop_arrivals(step, rt.submit)
        t_step = time.time()
        rt.step()
        if sup.fencing_enabled and sc.n_shards >= 2:
            _observe_shards(sup, rt, time.time() - t_step)
        sup.note_step()
        step += 1
        telemetry.maybe_snapshot(step)
    rt.check_compile_once()
    stats = rt.stats
    stats["runtime"] = rt
    stats["recovery"] = sup.stats
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
        telemetry.maybe_snapshot(step)
    return stats


def fill_drain(params, sc: ServeConfig, backbone_rows: int, prompts,
               new_tokens: int, *, samplings=None, frames=None,
               use_kernels: bool = True, telemetry=None, device=None):
    """Fill-drain serving over a ring cache: batches of up to N_mux x B
    requests, spare slots holding duplicates whose logits are averaged
    (ensembling).  prompts: equal-length token sequences; every request
    gets ``new_tokens`` tokens.  samplings: one ``SamplingParams`` (or
    None, greedy) per prompt.  frames: one array per prompt, stacked in
    slot order for each batch's prefill — for kind 'encdec' its
    (frontend_len, d_enc) frame embeddings, for kind 'vlm' its
    (frontend_len, D_VISION) patch embeddings; None gives zeros, as the
    reference's CLI.  Each batch is one blocking prefill and
    ``new_tokens - 1`` decode steps, decode step t at position L + t as
    the reference CLI's (for a VLM the prefill wrote P + L positions:
    ROADMAP.md §3), on the kernel path under use_kernels
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
        if sc.kind != "lm":
            shape = MODELS[sc.kind].frontend_shape(sc.cfg)
            frame_of[r.uid] = (np.zeros(shape, np.float32) if frames is None
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
        # a VLM's prefill runs the P patch positions before the prompt's
        n_pos = toks.numel() + (extra.shape[0] * extra.shape[1]
                                if sc.kind == "vlm" else 0)
        with telemetry.span("prefill", tokens=n_pos):
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
    ap.add_argument("--lanes", default=None, metavar="N1,N2,...",
                    help="width-lane serving: one paged runtime per mux "
                         "width, requests routed by SLO class and live "
                         "load; requires --continuous --cache paged")
    ap.add_argument("--lane-rows", default=None, metavar="R1,R2,...",
                    help="backbone rows per lane (default: "
                         "--backbone-batch for every lane)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: prefill-only lanes hand "
                         "finished rows (KV pages) to same-width "
                         "decode-only lanes (--prefill-lanes, "
                         "--decode-lanes)")
    ap.add_argument("--prefill-lanes", default=None, metavar="N1,N2,...",
                    help="--disagg: mux widths of the prefill-only lanes")
    ap.add_argument("--decode-lanes", default=None, metavar="N1,N2,...",
                    help="--disagg: mux widths of the decode-only lanes")
    ap.add_argument("--route", choices=("load", "goodput"), default="load",
                    help="lane routing signal: live load (default) or "
                         "published goodput (TTFT-SLO attainment x tok/s)")
    ap.add_argument("--slo-mix", default="balanced=1",
                    help="SLO-class mix of the trace, e.g. "
                         "latency=0.25,balanced=0.5,throughput=0.25")
    ap.add_argument("--pool-budget", type=int, default=None,
                    help="lanes: global KV block budget split into "
                         "per-lane quotas, rebalanced toward queued lanes")
    ap.add_argument("--drain-lane", action="append", default=None,
                    metavar="STEP:WIDTH",
                    help="live resize (repeatable, needs --lanes): at step "
                         "STEP start draining the lane at WIDTH")
    ap.add_argument("--add-lane", action="append", default=None,
                    metavar="STEP:WIDTH[:ROWS]",
                    help="live resize (repeatable, needs --lanes): at step "
                         "STEP add a lane at WIDTH")
    ap.add_argument("--shards", type=int, default=None, metavar="N",
                    help="paged continuous: split the rows and the page "
                         "pool into N logical data shards on the one "
                         "device (the substrate of --kill-shard)")
    ap.add_argument("--kill-shard", action="append", default=None,
                    metavar="STEP:SHARD",
                    help="fault injection (repeatable): at step STEP kill "
                         "data shard SHARD; its streams replay from their "
                         "host token logs onto the surviving shards "
                         "(needs --shards >= 2)")
    ap.add_argument("--fence-stragglers", action="store_true",
                    help="paged continuous: per-shard step-time straggler "
                         "detectors; a shard flagged alone is fenced "
                         "through the kill-shard replay path (needs >= 2 "
                         "data shards)")
    ap.add_argument("--restart-step", type=int, default=None,
                    metavar="STEP",
                    help="paged continuous: at step STEP snapshot the "
                         "whole serving state into --ckpt-dir, rebuild the "
                         "runtime and restore it (no re-prefill)")
    ap.add_argument("--ckpt-dir", default=None, metavar="PATH",
                    help="checkpoint directory of --restart-step's "
                         "snapshot")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="continuous: write telemetry metrics as JSON "
                         "(lane/shard labels, periodic snapshots) to PATH "
                         "and a Prometheus text dump beside it (.prom)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="continuous: write the step-span timeline as "
                         "Chrome trace-event JSON (open in Perfetto)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    metavar="STEPS",
                    help="snapshot the metrics every K engine steps into "
                         "the --metrics-out JSON (0 = final totals only)")
    ap.add_argument("--trace-annotate", action="store_true",
                    help="also wrap traced spans in "
                         "torch.profiler.record_function ranges")
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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="paged continuous serving on a (data, model) mesh "
                         "of DATA * MODEL ranks started on this host, e.g. "
                         "--mesh 2,2: rows and KV block segments over "
                         "'data', heads / MLP width / experts over 'model' "
                         "(gloo on the CPU; on GPUs NCCL with a GPU per "
                         "rank, else gloo over CUDA tensors)")
    return ap


def _parse_slo_mix(ap, spec: str):
    """'latency=0.25,balanced=0.5,throughput=0.25' as normalized class
    weights."""
    mix = {}
    for part in spec.split(","):
        k, eq, v = part.partition("=")
        k = k.strip()
        if k not in SLO_CLASSES or not eq:
            ap.error(f"--slo-mix: expected CLASS=WEIGHT with CLASS in "
                     f"{SLO_CLASSES}, got {part!r}")
        try:
            mix[k] = float(v)
        except ValueError:
            ap.error(f"--slo-mix: bad weight in {part!r}")
    total = sum(mix.values())
    if total <= 0:
        ap.error("--slo-mix weights must sum to > 0")
    return {k: v / total for k, v in mix.items()}


def _lane_args(ap, args):
    """The lane specs and resize events the flags ask for, with the
    reference CLI's refusals as argparse errors.  Returns (lanes or None,
    events, widths whose params the run needs)."""
    def ints(spec, flag, sep, want):
        try:
            vals = [int(x) for x in spec.split(sep)]
        except ValueError:
            vals = []
        if len(vals) not in want:
            ap.error(f"{flag} expects {sep.join(['N'] * min(want))} "
                     f"(got {spec!r})")
        return vals

    events, add_widths = [], []
    for spec in args.kill_shard or []:
        s, sh = ints(spec, "--kill-shard", ":", (2,))
        events.append({"step": s, "op": "kill_shard", "shard": sh})
    for spec in args.drain_lane or []:
        s, w = ints(spec, "--drain-lane", ":", (2,))
        events.append({"step": s, "op": "drain_lane", "width": w})
    for spec in args.add_lane or []:
        v = ints(spec, "--add-lane", ":", (2, 3))
        ev = {"step": v[0], "op": "add_lane", "width": v[1]}
        if len(v) == 3:
            ev["rows"] = v[2]
        events.append(ev)
        add_widths.append(v[1])
    if args.restart_step is not None:
        if not args.ckpt_dir:
            ap.error("--restart-step requires --ckpt-dir")
        if args.lanes is not None:
            ap.error("--restart-step supports the single-runtime "
                     "paged mode (drop --lanes)")
        events.append({"step": args.restart_step, "op": "restart"})
    if events and not (args.continuous and args.cache == "paged"):
        ap.error("failure/resize flags (--kill-shard/--drain-lane/"
                 "--add-lane/--restart-step) require --continuous "
                 "--cache paged")
    if (args.drain_lane or args.add_lane) and args.lanes is None:
        ap.error("--drain-lane/--add-lane require --lanes")
    if args.disagg:
        if args.lanes is not None:
            ap.error("--disagg replaces --lanes "
                     "(use --prefill-lanes/--decode-lanes)")
        if not (args.prefill_lanes and args.decode_lanes):
            ap.error("--disagg requires --prefill-lanes and --decode-lanes")
        if args.prefill == "blocking":
            ap.error("--disagg requires chunked prefill "
                     "(drop --prefill blocking)")
    elif args.prefill_lanes or args.decode_lanes:
        ap.error("--prefill-lanes/--decode-lanes require --disagg")
    if args.lanes is None and not args.disagg:
        if args.route == "goodput":
            ap.error("--route goodput requires --lanes or --disagg")
        return None, events, set()
    if not (args.continuous and args.cache == "paged"):
        ap.error("--lanes/--disagg require --continuous --cache paged")
    widths_of = lambda spec, flag: ints(spec, flag, ",", range(1, 64))
    if args.disagg:
        pw = widths_of(args.prefill_lanes, "--prefill-lanes")
        dw = widths_of(args.decode_lanes, "--decode-lanes")
        missing = sorted(set(pw) - set(dw))
        if missing:
            ap.error(f"--disagg: prefill widths {missing} have no "
                     f"same-width decode lane")
        widths, roles = pw + dw, ["prefill"] * len(pw) + ["decode"] * len(dw)
    else:
        widths = widths_of(args.lanes, "--lanes")
        roles = ["both"] * len(widths)
    rows = ([int(x) for x in args.lane_rows.split(",")] if args.lane_rows
            else [args.backbone_batch] * len(widths))
    if len(rows) != len(widths):
        ap.error(f"--lane-rows gives {len(rows)} entries for "
                 f"{len(widths)} lanes")
    lanes = [LaneSpec(n_mux=w, rows=r, chunk=args.chunk, role=ro)
             for w, r, ro in zip(widths, rows, roles)]
    return lanes, events, set(widths) | set(add_widths)


def _print_lanes(args, stats):
    """The per-lane, routing, handoff and goodput lines of a lanes run."""
    for ls in stats["lanes"]:
        toks = sum(len(r.output) for r in ls["completed"])
        lu = float(np.mean(ls["slot_util"])) if ls["slot_util"] else 0.0
        sigs = ", ".join(f"{k}×{v}"
                         for k, v in sorted(ls["trace_counts"].items()))
        print(f"  lane{ls['lane']} N={ls['n_mux']} rows={ls['rows']}: "
              f"{len(ls['completed'])} requests, {toks} tokens, slot util "
              f"{lu:.2f}; step signatures [{sigs}]")
    rc = stats["routing"]
    routed = ", ".join(f"{k}={v}" for k, v in rc["routed"].items())
    print(f"routing[{args.route}]: {routed}; demotions={rc['demotions']}, "
          f"promotions={rc['promotions']}, "
          f"rebalanced={rc['rebalanced_blocks']} blocks")
    rec = stats["recovery"]
    if args.disagg:
        print(f"disagg: {rec['handoffs']} handoffs "
              f"({rec['handoff_streams']} streams, "
              f"{rec['migrated_kv_bytes']} KV bytes migrated, "
              f"zero re-prefill)")
    if args.drain_lane or args.add_lane:
        print(f"resize: {rec['lane_drains']} drains / {rec['lane_adds']} "
              f"adds ({rec['lanes_retired']} lanes retired)")
    for ls in stats["lane_stats"]:
        print(f"  lane{ls['lane']} N={ls['n_mux']}: goodput "
              f"{ls['goodput_tok_s']:.1f} tok/s (TTFT-SLO attainment "
              f"{ls['slo_attainment']:.2f} × {ls['tok_s']:.1f} tok/s)")


def _print_recovery(args, rec, events):
    """The reference CLI's ``stragglers:`` and ``recovery:`` lines."""
    if args.fence_stragglers and rec:
        print(f"stragglers: {rec['stragglers_fenced']} fenced, "
              f"{rec['global_slow_steps']} global slow steps")
    if events and rec:
        lat = rec["recovery_latency_s"]
        line = (f"recovery: {rec['shards_killed']} shard kills, "
                f"{rec['requests_replayed']} streams replayed "
                f"({rec['replay_prefill_tokens']} re-prefill tokens), "
                f"{rec['lane_drains']} drains / {rec['lane_adds']} adds "
                f"({rec['lanes_retired']} lanes retired), "
                f"{rec['restarts']} restarts")
        if lat:
            line += f"; worst recovery latency {max(lat) * 1e3:.1f}ms"
        if rec["restore_latency_s"]:
            line += (f"; restore "
                     f"{max(rec['restore_latency_s']) * 1e3:.1f}ms")
        print(line)


def _mesh_rank(mesh, argv):
    """One rank of ``--mesh``: the CLI on this rank's mesh, printing on
    rank 0 only."""
    quiet = mesh.coords["data"] or mesh.coords["model"]
    with (contextlib.redirect_stdout(io.StringIO()) if quiet
          else contextlib.nullcontext()):
        return main(argv, mesh=mesh)


def main(argv=None, *, mesh=None):
    """The CLI.  mesh: this rank's mesh when ``--mesh`` started it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh is not None:
        if not (args.continuous and args.cache == "paged"):
            ap.error("--mesh requires --continuous --cache paged")
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.split(","))
            data, model = mesh_shape
        except ValueError:
            ap.error("--mesh expects DATA,MODEL, e.g. --mesh 2,4")
        if data < 1 or model < 1:
            ap.error(f"--mesh {args.mesh}: both axes must be >= 1")
        if args.shards is not None and args.shards != data:
            ap.error(f"--shards {args.shards} must match the --mesh data "
                     f"axis ({data})")
    if args.kv_dtype and not (args.continuous and args.cache == "paged"):
        ap.error("--kv-dtype requires --continuous --cache paged")
    if args.block_size < 1:
        ap.error(f"--block-size must be >= 1, got {args.block_size}")
    lanes, events, lane_widths = _lane_args(ap, args)
    slo_mix = _parse_slo_mix(ap, args.slo_mix) if lanes else None
    n_shards = 1 if mesh_shape is None else mesh_shape[0]
    if args.shards is not None:
        if not (args.continuous and args.cache == "paged"):
            ap.error("--shards requires --continuous --cache paged")
        if args.shards < 1:
            ap.error(f"--shards must be >= 1, got {args.shards}")
        n_shards = args.shards
    if args.kill_shard and n_shards < 2:
        ap.error("--kill-shard needs >= 2 data shards (set --shards N or "
                 "--mesh DATA,MODEL)")
    if args.fence_stragglers:
        if not (args.continuous and args.cache == "paged"):
            ap.error("--fence-stragglers requires --continuous "
                     "--cache paged")
        if n_shards < 2:
            ap.error("--fence-stragglers needs >= 2 data shards "
                     "(set --shards N)")
    if (args.metrics_out or args.trace_out) and not args.continuous:
        ap.error("--metrics-out/--trace-out require --continuous")
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
    recurrent = sorted(set(cfg.block_pattern) & set(RECURRENT))
    if args.cache == "paged" and recurrent:
        ap.error(f"--cache paged with {args.arch}: the reference's paged arm "
                 f"fails on {'/'.join(recurrent)} blocks (its blocking "
                 "prefill of one row meets the whole batch's recurrent "
                 "state: 'Cannot concatenate arrays'; ROADMAP.md §3); serve "
                 "it with --cache ring or in fill-drain")
    dev = resolve_device(args.device)
    if mesh_shape is not None and mesh is None:
        # start the ranks; each runs this CLI on its mesh, rank 0 prints
        mesh_lib.spawn(_mesh_rank, *mesh_shape, device=dev.type,
                       args=(argv,), timeout=3600)
        return 0
    mux = MuxSpec(n=args.mux_n)
    model = MODELS[kind]
    if lanes:
        # one model per mux width (MUX-PLMs are width-specific), widths
        # that join later through --add-lane included
        params = {w: model.init(torch.Generator(device=dev).manual_seed(
            args.seed * 1000 + w), cfg, MuxSpec(n=w))
            for w in sorted(lane_widths)}
    else:
        params = model.init(torch.Generator(device=dev).manual_seed(
            args.seed), cfg, mux)
    # fp32, as the reference's CLI serves (repro/launch/serve.py:906-911)
    sc = ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                     capacity=args.prompt_len + args.new_tokens + 8,
                     cache_layout=args.cache if args.continuous else "ring",
                     block_size=args.block_size, n_shards=n_shards,
                     kv_dtype=args.kv_dtype, kind=kind)
    rng = np.random.default_rng(args.seed)
    sampled = args.temperature > 0

    def sp(i):
        return (sampling.SamplingParams(temperature=args.temperature,
                                        top_k=args.top_k, top_p=args.top_p,
                                        seed=i) if sampled else None)

    if not args.continuous:
        prompts = [rng.integers(4, cfg.vocab_size, size=(args.prompt_len,))
                   for _ in range(args.requests)]
        stats = fill_drain(params, sc, args.backbone_batch, prompts,
                           args.new_tokens,
                           samplings=[sp(i) for i in range(args.requests)],
                           use_kernels=args.use_kernels, device=dev)
        served, dt = len(stats["completed"]), stats["wall"]
        print(f"served {served} requests x {args.new_tokens} tokens in "
              f"{dt:.1f}s  (mux N={mux.n}, backbone batch "
              f"{args.backbone_batch}; throughput "
              f"{served * args.new_tokens / dt:.1f} tok/s)")
        return 0
    telemetry = None
    if args.metrics_out or args.trace_out:
        telemetry = Telemetry(snapshot_every=args.metrics_interval,
                              annotate=args.trace_annotate)
    # the reference CLI's draws: each request's prompt, then (lanes) its
    # SLO class, so both CLIs serve the same trace
    arrivals = []
    for i in range(args.requests):
        arr = (i * args.arrival_every,
               rng.integers(4, cfg.vocab_size, size=(args.prompt_len,)),
               args.new_tokens, sp(i))
        if lanes:
            classes = sorted(slo_mix)
            arr += (str(rng.choice(classes,
                                   p=[slo_mix[c] for c in classes])),)
        arrivals.append(arr)
    stats = run_continuous(params, sc, args.backbone_batch, arrivals,
                           chunk=args.chunk, prefill_mode=args.prefill,
                           use_kernels=args.use_kernels, device=dev,
                           lanes=lanes, pool_budget=args.pool_budget,
                           telemetry=telemetry, events=events or None,
                           route=args.route, ckpt_dir=args.ckpt_dir,
                           fence_stragglers=args.fence_stragglers, mesh=mesh)
    util = float(np.mean(stats["slot_util"])) if stats["slot_util"] else 0.0
    mode = (f"paged/{stats['prefill_mode']}" if sc.cache_layout == "paged"
            else "ring")
    if mesh is not None:
        mode += f"/{mesh.tag}"
    width = f"mux N={mux.n}"
    if lanes:
        desc = (f"P:{args.prefill_lanes}>D:{args.decode_lanes}"
                if args.disagg else args.lanes)
        mode += f"/disagg[{desc}]" if args.disagg else f"/lanes[{desc}]"
        width = f"widths {desc}"
    print(f"continuous[{mode}/{dev.type}] served "
          f"{len(stats['completed'])} requests "
          f"({stats['generated_tokens']} tokens) in {stats['wall']:.1f}s  "
          f"({width}, rows {args.backbone_batch}; "
          f"{stats['generated_tokens'] / stats['wall']:.1f} tok/s, "
          f"prefill {stats['prefill_tokens']} backbone tokens "
          f"({stats['prefill_compute_tokens']} padded) in "
          f"{stats['prefill_events']} events, slot util {util:.2f})")
    if lanes:
        _print_lanes(args, stats)
    elif sc.cache_layout == "paged":
        print(f"kv pages {sc.page_dtype}: pool {stats['pool_bytes']} bytes, "
              f"{stats['kv_bytes_per_token']} bytes per token")
        compiled = ", ".join(f"{k}×{v}" for k, v in
                             sorted(stats["trace_counts"].items()))
        print(f"step signatures: {compiled}")
    if mesh is not None:
        print(f"{mesh.tag}: {mesh.shape['data'] * mesh.shape['model']} ranks "
              f"over {mesh.backend} ({mesh.backend_reason}); rank 0's "
              "collectives: " + ", ".join(
                  f"{k}×{v}" for k, v in sorted(mesh.counts.items())))
    _print_recovery(args, stats.get("recovery"), events)
    # on a mesh rank 0 writes the files, as it prints
    if telemetry is not None and (mesh is None
                                  or not any(mesh.coords.values())):
        if args.metrics_out:
            prom = telemetry.write_metrics(args.metrics_out)
            print(f"metrics written to {args.metrics_out} (+ {prom})")
        if args.trace_out:
            telemetry.write_trace(args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"(open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
