"""Serve runtime: chunked or blocking prefill interleaved with decode, on
one device or one rank of a serve mesh (counterpart of
``repro.serve.runtime``).

``ServeRuntime`` executes the scheduler's plans against the paged cache:

  * **decode step** — the whole N_mux × B grid advances one token: (NB, 1)
    tokens and a (B,) per-row position vector go in, the (NB,) sampled
    tokens come back to the host (the one device sync per step).
  * **prefill-chunk step** — a joining row's prompt advances one
    fixed-size chunk per engine step, padded to a power-of-two bucket
    (padded positions go to the trash block and are fully masked); under
    blocking prefill (``chunk=None``) the whole prompt is prefilled at
    once (``engine.prefill``, attending over its fresh K/V), unpadded.

PyTorch runs eagerly, so nothing is compiled per shape.  The reference's
compile-once contract keeps its meaning through ``trace_counts``: each
distinct step shape signature (``decode``, ``prefill_<bucket>``) is
counted the first time it runs, and ``check_compile_once`` asserts that
only the declared signatures ever ran.  Blocking prefill is eager in the
reference and declares no signature here either.  Every step updates the cache in
place.

Width lanes and disaggregation: a runtime is one serving lane (``lane``,
its own scheduler, pool and step signatures) and has a ``role`` —
``both`` (prefill and decode interleaved), ``prefill`` (admissions and
chunks only; finished rows park until ``handoff_to`` migrates their
pages into a decode lane) or ``decode`` (decode only; rows arrive by
``handoff_to``).  ``load()`` is the snapshot ``serve.router.LaneRouter``
routes on.

Logical shards (``ServeConfig.n_shards > 1``): rows and pool blocks
split into per-shard segments (``ShardedKVPool``), each shard's invalid
writes go to its own trash block (a per-row trash vector in the step
context), backpressure is shard-local (a rolled-back admission is
re-planned onto sibling shards) and ``kill_shard`` fences a lost shard,
replaying its streams onto the survivors from their host token logs.
The tables are installed in place, so a kill changes no device shape.

A serve mesh (``mesh``, a ``launch.mesh.ServeMesh``; ``sc.n_shards`` its
data axis) puts the logical shards on ranks: every rank runs this same
host loop — the same scheduler, ``ShardedKVPool`` (global block ids) and
tokens, so all admit, preempt and kill alike — while its device holds
only its data shard's rows and page segment and its shards of the params
(``runtime.sharding.shard_params``).  A decode step runs on every rank
over its rows, and the new tokens are gathered over ``data`` once a step
(the reference's one replicated token output); a prompt chunk runs on
its row's data shard, and its first tokens reach the others the same
way.  Each model rank's layers take their collectives from the mesh
(``models.blocks``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.blocks import RECURRENT, heads_split
from repro_torch.runtime.sharding import shard_params
from repro_torch.serve import sampling
from repro_torch.serve.engine import (ServeConfig, copy_cache_pages,
                                      decode_step, init_cache, make_pool,
                                      prefill, prefill_chunk, reset_blocks,
                                      set_block_tables)
from repro_torch.serve.kvpool import PoolExhausted
from repro_torch.serve.kvpool import _bits as _page_bits
from repro_torch.serve.router import LaneLoad
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.telemetry import NULL_TELEMETRY

MIN_BUCKET = 4
PAD_ID = 0           # token fed to empty slots and bucket padding


def chunk_buckets(chunk: int, min_bucket: int = MIN_BUCKET):
    """Powers of two below ``chunk``, then ``chunk`` itself."""
    b, out = min_bucket, []
    while b < chunk:
        out.append(b)
        b *= 2
    out.append(chunk)
    return out


def resolve_device(device=None) -> torch.device:
    """The serving device: ``cuda`` unless the caller names another.  A
    CUDA device with no card raises — serving never falls back to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to serve on "
                           "the CPU with the kernels' plain versions")
    if dev.type == "cuda":
        # fp32 matmuls in full fp32, as the reference's; TF32 would keep
        # ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def grid_sampling(sched):
    """The scheduler's grid as mux-major (NB,) sampling vectors (stream i
    of row j at i * B + j) and the generation index of each stream."""
    plist, steps = [], []
    for i in range(sched.n_mux):
        for j in range(sched.backbone_batch):
            r = sched.slots[j][i].request
            plist.append(r.sampling if r is not None else None)
            steps.append(len(r.output) if r is not None else 0)
    return sampling.params_arrays(plist), np.asarray(steps, np.int32)


def params_to(params, device):
    """The param tree with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


class ServeRuntime:
    """Plan-executing runtime over the paged KV pool.

    params/sc: model params and a ``ServeConfig`` with
    ``cache_layout='paged'`` (its ``kv_dtype`` sets the page storage;
    ``stats`` records the pool's bytes and bytes per token) of a
    decoder-only LM (kind 'lm', as the reference) over attention blocks
    only: recurrent (RG-LRU, RWKV) blocks raise ``NotImplementedError``,
    as the reference fails there.
    backbone_rows: B rows of the N_mux × B grid.  chunk: prefill chunk
    size in tokens; None is blocking prefill (a joining row's whole
    prompt in one call, ``stats['prefill_mode']`` says which ran).
    Requests carry their own ``SamplingParams`` (None = greedy).
    use_kernels: run the main path's kernels (the wrappers in
    ``kernels.ops`` launch them on CUDA and use their plain versions on
    the CPU); False runs the plain model path.  device: defaults to
    ``cuda`` and raises without a card.  telemetry: a
    ``serve.telemetry.Telemetry`` (None = disabled); its spans, counters
    and gauges carry ``lane`` (and ``shard``) labels.  ``sc.n_shards``
    logical shards need ``backbone_rows`` divisible by it.
    lane: the serving-lane id (tags plans, stats, telemetry and
    ``load()``).  role: 'both' | 'prefill' | 'decode' (module docstring);
    a prefill lane needs chunked prefill.  mesh: this rank's serve mesh
    (module docstring): ``sc.n_shards`` must equal its data axis and
    ``backbone_rows`` divide by it; whole ``params`` are cut to the rank's
    shards.  ``stats`` also counts
    ``handoffs_out``, ``handoffs_in`` and ``migrated_bytes``.  Params on
    the device already are used as they are, so lanes may share a
    backbone's tensors.
    """

    def __init__(self, params, sc: ServeConfig, backbone_rows: int, *,
                 chunk: int | None = 32, on_prefill=None,
                 use_kernels: bool = True, device=None, telemetry=None,
                 lane: int = 0, role: str = "both", mesh=None):
        if sc.cache_layout != "paged":
            raise ValueError("ServeRuntime requires cache_layout='paged'")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, got {role!r}")
        if role == "prefill" and chunk is None:
            # a prefill-only lane exists to overlap chunk cadence with a
            # sibling decode lane; blocking prefill would defeat it
            raise ValueError("a prefill-role lane requires chunked prefill")
        if sc.kind != "lm":
            raise NotImplementedError(
                "continuous serving supports decoder-only LM families")
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1 (or None for blocking "
                             f"prefill), got {chunk}")
        if mesh is not None:
            data = mesh.shape["data"]
            if sc.n_shards != data:
                raise ValueError(
                    f"ServeConfig.n_shards={sc.n_shards} must equal the "
                    f"mesh 'data' axis size {data}")
            if backbone_rows % data:
                raise ValueError(
                    f"backbone_rows={backbone_rows} not divisible by the "
                    f"mesh 'data' axis size {data}")
        if backbone_rows % sc.n_shards:
            raise ValueError(
                f"backbone_rows={backbone_rows} not divisible by "
                f"n_shards={sc.n_shards}")
        recurrent = sorted(set(sc.cfg.block_pattern) & set(RECURRENT))
        if recurrent:
            # The reference sends recurrent blocks to blocking prefill
            # (chunk=None: bucket padding would run pad tokens through
            # their state), and its blocking prefill fails on them: refuse.
            raise NotImplementedError(
                f"paged serving of {recurrent} blocks: the reference falls "
                "back to blocking prefill (repro/serve/runtime.py:155-161), "
                "whose prefill(rows=[j]) ignores the rows in apply_rwkv "
                "(its _token_shift) and apply_rglru (its "
                "_causal_depthwise_conv) and meets the whole batch's state "
                "with one row's prompt ('Cannot concatenate arrays'); the "
                "port serves these blocks on the ring arm and in fill-drain "
                "(ROADMAP.md §3)")
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.mesh = mesh
        if mesh is not None:
            self.params = shard_params(self.params, mesh,
                                       pattern=len(sc.cfg.block_pattern))
        self.sc = sc
        self.n_mux = max(sc.mux.n, 1)
        self.nrows = backbone_rows
        self.nb = self.n_mux * backbone_rows
        self.chunk = chunk
        self.buckets = chunk_buckets(chunk) if chunk is not None else []
        self.on_prefill = on_prefill
        self.use_kernels = use_kernels
        self.lane = lane
        self.role = role
        self.tele = telemetry if telemetry is not None else NULL_TELEMETRY
        if self.tele.enabled:
            tag = f" [{role}]" if role != "both" else ""
            self.tele.tracer.process_name(
                lane, f"lane {lane} (N={self.n_mux}){tag}")
        self.sched = ContinuousScheduler(n_mux=self.n_mux,
                                         backbone_batch=backbone_rows,
                                         max_len=sc.capacity,
                                         n_shards=sc.n_shards, lane=lane,
                                         telemetry=self.tele)
        self.pool = make_pool(sc, self.nb)
        self.cache = init_cache(sc, self.nb, device=self.device, mesh=mesh)
        # the rows this rank holds: its data shard's on a mesh
        rps = backbone_rows // sc.n_shards
        self._shard = 0 if mesh is None else mesh.coords["data"]
        self._rows = (range(backbone_rows) if mesh is None else
                      range(self._shard * rps, (self._shard + 1) * rps))
        # per-row trash routing: each shard's invalid writes stay in its
        # own segment (block 0 everywhere on one shard, and on a mesh,
        # whose rank holds one segment with its trash block first)
        self._trash = (torch.as_tensor(
            self.pool.trash_vector(range(backbone_rows)),
            dtype=torch.long, device=self.device)
            if sc.n_shards > 1 and mesh is None else None)
        self.row_len: dict[int, int] = {}      # rows holding blocks
        self.row_tokens: dict[int, np.ndarray] = {}
        self.next_tok = np.full((self.n_mux, backbone_rows), PAD_ID,
                                np.int32)
        self.engine_steps = 0
        self.trace_counts: dict[str, int] = {}
        self.stats = {"prefill_tokens": 0, "prefill_events": 0,
                      "prefill_compute_tokens": 0, "decode_steps": 0,
                      "prefill_log": [], "slot_util": [], "cache_util": [],
                      "completed": self.sched.completed, "pool": self.pool,
                      "trace_counts": self.trace_counts,
                      "n_mux": self.n_mux, "rows": backbone_rows,
                      "lane": lane, "role": role,
                      "handoffs_out": 0, "handoffs_in": 0,
                      "migrated_bytes": 0,
                      "pool_bytes": sc.pool_bytes(self.nb),
                      "kv_bytes_per_token": sc.kv_bytes_per_token(),
                      "prefill_mode": ("chunked" if chunk is not None
                                       else "blocking")}

    def _first_run(self, key: str):
        """Count a step signature the first time it runs."""
        if key not in self.trace_counts:
            self.trace_counts[key] = 1
            if self.tele.enabled:
                self.tele.inc("compiles", lane=self.lane, program=key)
                self.tele.instant("compile", lane=self.lane, program=key)

    def check_compile_once(self):
        """Assert that only the declared step signatures ran: one decode
        step and one per prefill bucket."""
        legal = {"decode"} | {f"prefill_{b}" for b in self.buckets}
        for k, v in self.trace_counts.items():
            if k not in legal or v != 1:
                raise AssertionError(
                    f"unexpected step signature {k!r}: {self.trace_counts} "
                    f"(declared buckets {self.buckets})")

    # -- per-stream sampling vectors --------------------------------------
    def _sampling_row(self, j: int):
        reqs = [self.sched.slots[j][i].request for i in range(self.n_mux)]
        arr = sampling.params_arrays(
            [r.sampling if r is not None else None for r in reqs])
        steps = np.asarray([len(r.output) if r is not None else 0
                            for r in reqs], np.int32)
        return arr, steps


    def _step_ctx(self, rows=None):
        """The layer context of a step: the mesh, and under logical shards
        the trash routing of the rows the step writes (all rows when
        ``rows`` is None)."""
        ctx = {}
        if self.mesh is not None:
            ctx["mesh"] = self.mesh
        if self._trash is not None:
            ctx["trash"] = self._trash if rows is None else self._trash[rows]
        return ctx or None

    def _sample(self, logits, arr, steps):
        return sampling.sample(logits, arr["temperature"], arr["top_k"],
                               arr["top_p"], arr["seed"], steps)

    # -- plan execution ----------------------------------------------------
    def submit(self, request):
        self.sched.submit(request)

    def has_work(self) -> bool:
        return bool(self.sched.queue) or self.sched.n_active > 0

    def load(self) -> LaneLoad:
        """Live-load snapshot for lane routing: slot use, admission-queue
        depth and quota-capped pool headroom, tagged with the lane."""
        return LaneLoad(lane=self.lane, n_mux=self.n_mux,
                        slots=self.n_mux * self.nrows,
                        active=self.sched.n_active,
                        queue_depth=self.sched.queue_depth,
                        headroom_blocks=self.pool.headroom,
                        mid_prefill=len(self.sched.prefill_progress))

    # -- disaggregated handoff --------------------------------------------
    def handoff_ready(self):
        """Rows whose prompt is prefilled and whose streams are live: what
        a prefill lane offers for handoff (their first tokens are
        recorded, so a decode lane continues them with no re-prefill)."""
        return [j for j in sorted(self.row_len)
                if j not in self.sched.prefill_progress
                and self.sched.row_active(j)]

    def free_rows(self):
        """Rows that can take a handoff: empty, holding no blocks, and on
        an alive shard."""
        return [j for j in range(self.nrows)
                if not self.sched.row_active(j) and j not in self.row_len
                and j not in self.sched.prefill_progress
                and self.sched.shard_of(j) not in self.sched.dead_shards]

    def kill_shard(self, shard: int):
        """Fence a lost data shard and replay its streams.

        The shard's pages are gone, but every stream's token log (prompt
        plus generated-so-far) lives on the host in its ``Request``: each
        of the shard's rows is preempted (its live requests requeued at
        the head of the queue) and re-admitted onto the surviving shards,
        where prefill of the token log rebuilds the KV that died.
        Surviving rows keep their slots, blocks and positions, so their
        streams equal an undisturbed run's.  The pool fences the shard
        (its quota goes to the survivors) and the scheduler's
        ``dead_shards`` keeps admission off its rows; the dead rows'
        tables go to all -1 in place.  Returns the replayed requests in
        requeue order.  Raises on one shard, on a dead shard and on the
        last one alive."""
        if self.sc.n_shards < 2:
            raise ValueError("kill_shard requires n_shards >= 2")
        if shard in self.sched.dead_shards:
            raise ValueError(f"shard {shard} is already dead")
        if len(self.sched.dead_shards) + 2 > self.sc.n_shards:
            raise ValueError("cannot kill the last surviving shard")
        rps = self.nrows // self.sc.n_shards
        rows = range(shard * rps, (shard + 1) * rps)
        replayed = [s.request for j in rows for s in self.sched.slots[j]
                    if s.request is not None]
        # preempt_row appendlefts: the last row first keeps ascending row
        # order at the queue head
        for j in reversed(rows):
            self.sched.preempt_row(j)
            if j in self.row_len:
                self.pool.free(j)
                del self.row_len[j]
                del self.row_tokens[j]
            self.next_tok[:, j] = PAD_ID
        self.sched.dead_shards.add(shard)
        reclaimed = self.pool.kill_shard(shard)
        self._install_tables()
        if self.tele.enabled:
            self.tele.inc("shards_lost", lane=self.lane, shard=shard)
            self.tele.inc("requests_replayed", len(replayed),
                          lane=self.lane)
            self.tele.instant("shard_lost", lane=self.lane, shard=shard,
                              rows=rps, requests=len(replayed),
                              reclaimed_quota=reclaimed)
        return replayed

    def handoff_to(self, dst, j: int, dst_row: int):
        """Migrate row ``j``'s finished-prefill mux group into runtime
        ``dst`` at ``dst_row``: the pool accounting moves
        (``KVPool.migrate_rows``), the pages follow on the device
        (``copy_cache_pages``: payload, scales and positions, bit for
        bit), both block tables are reinstalled and the streams' slots
        and host token state transfer.  Returns the executed
        ``HandoffPlan``, or None when ``dst``'s pool cannot take the row
        now (nothing changed; retry later).  The lanes must share the
        mux width, the page geometry and storage, and the mesh.  On a mesh
        every rank calls it with the same arguments: the pool accounting
        runs alike everywhere, and the pages move from row ``j``'s data
        shard to ``dst_row``'s, between ranks when those differ
        (``copy_cache_pages(mesh=)``)."""
        if dst is self:
            raise ValueError("handoff requires a distinct destination lane")
        if dst.mesh is not self.mesh:
            raise ValueError("handoff lanes must share one serve mesh "
                             "(or both have none)")
        if dst.n_mux != self.n_mux:
            raise ValueError(
                f"handoff across widths (N={self.n_mux} -> {dst.n_mux}): "
                "a muxed row cannot change composition")
        if (dst.sc.block_size != self.sc.block_size
                or dst.sc.kv_dtype != self.sc.kv_dtype
                or dst.sc.page_dtype != self.sc.page_dtype
                or dst.sc.capacity != self.sc.capacity):
            raise ValueError("handoff lanes must share page geometry "
                             "(block_size / capacity / kv_dtype / page "
                             "dtype)")
        plan = self.sched.plan_handoff(j, dst.lane, dst_row,
                                       self.pool.num_tokens(j))
        try:
            if hasattr(self.pool, "migrate_pages"):
                src_blocks, dst_blocks = self.pool.migrate_pages(
                    j, dst_row, dst=dst.pool)
            else:
                src_blocks, dst_blocks = self.pool.migrate_rows(
                    j, dst.pool, dst_row)
        except PoolExhausted:
            if self.tele.enabled:
                self.tele.inc("handoff_deferrals", lane=self.lane,
                              dst_lane=dst.lane)
            return None
        nbytes = (len(src_blocks) * self.sc.block_size
                  * self.sc.kv_bytes_per_token())
        with self.tele.span("handoff", lane=self.lane, dst_lane=dst.lane,
                            metric="handoff_s", row=j, dst_row=dst_row,
                            tokens=plan.tokens, blocks=len(src_blocks),
                            bytes=nbytes):
            if self.mesh is None:
                copy_cache_pages(self.cache, dst.cache, src_blocks,
                                 dst_blocks)
            else:
                # row j's shard holds the source pages, dst_row's the
                # destination's: a move between ranks when they differ
                a, b = self.sched.shard_of(j), dst.sched.shard_of(dst_row)
                copy_cache_pages(self.cache, dst.cache,
                                 self._segment_ids(src_blocks, a),
                                 dst._segment_ids(dst_blocks, b),
                                 mesh=self.mesh, src_shard=a, dst_shard=b)
            self._install_tables()
            dst._install_tables()
            slots = self.sched.retire_handoff(plan)
            dst.sched.admit_handoff(plan, slots)
            dst.row_len[dst_row] = self.row_len.pop(j)
            dst.row_tokens[dst_row] = self.row_tokens.pop(j)
            dst.next_tok[:, dst_row] = self.next_tok[:, j]
            self.next_tok[:, j] = PAD_ID
        self.stats["handoffs_out"] += 1
        self.stats["migrated_bytes"] += nbytes
        dst.stats["handoffs_in"] += 1
        if self.tele.enabled:
            self.tele.inc("handoffs", lane=self.lane, dst_lane=dst.lane)
            self.tele.inc("migration_bytes", nbytes, lane=self.lane,
                          dst_lane=dst.lane)
            self.tele.instant("handoff", lane=self.lane, dst_lane=dst.lane,
                              row=j, dst_row=dst_row, tokens=plan.tokens,
                              streams=len(plan.uids))
        return plan

    def step(self):
        """One engine step: admissions, one chunk per mid-prefill row,
        one decode over the grid, frees.  A prefill lane runs the first
        two and the frees (its finished rows park for a handoff); a
        decode lane only decodes and frees (rows arrive by handoff, and
        streams preempted there are re-routed by the serve loop)."""
        with self.tele.span("engine_step", lane=self.lane,
                            metric="step_latency_s"):
            if self.role != "decode":
                self._exec_admissions()
                for plan in self.sched.plan_chunks(self.chunk):
                    with self.tele.span("prefill_chunk", lane=self.lane,
                                        shard=self.sched.shard_of(plan.row),
                                        metric="prefill_chunk_s",
                                        row=plan.row, start=plan.start,
                                        length=plan.length, last=plan.last):
                        self._exec_chunk(plan)
                self._exec_frees()     # e.g. max_new=1 done at prefill
            if self.role != "prefill":
                rows = [j for j in self.sched.plan_decode().rows
                        if j in self.row_len]
                if rows:
                    self._exec_decode(rows)
                    self._exec_frees()
        self.engine_steps += 1
        if self.tele.enabled:
            self._record_pool_gauges()

    def _record_pool_gauges(self):
        """Publish pool occupancy, headroom and quota, keyed (lane,
        shard); host allocator state only."""
        for s, st in enumerate(self.pool.occupancy_stats()):
            self.tele.gauge("pool_occupancy", st["occupancy"],
                            lane=self.lane, shard=s)
            self.tele.gauge("pool_headroom_blocks", st["headroom"],
                            lane=self.lane, shard=s)
            if st["quota"] is not None:
                self.tele.gauge("pool_quota_blocks", st["quota"],
                                lane=self.lane, shard=s)

    def _install_tables(self):
        set_block_tables(self.cache, self.pool.table_array(self._rows))

    def _segment_ids(self, blocks, shard: int):
        """Global block ids of ``shard``'s segment as ids within it (a
        mesh rank's cache holds its segment alone); others dropped."""
        bps = self.pool.num_blocks // self.sc.n_shards
        off = shard * bps
        return [b - off for b in blocks if off <= b < off + bps]

    def _reset_blocks(self, blocks):
        """Mark fresh blocks empty: on a mesh only this rank's segment's,
        at their local ids."""
        if self.mesh is not None:
            blocks = self._segment_ids(blocks, self._shard)
        reset_blocks(self.cache, blocks)

    def _owns(self, j: int) -> bool:
        """Whether row ``j`` lives on this rank's data shard."""
        return self.mesh is None or self.sched.shard_of(j) == self._shard

    def _local(self, grid):
        """This rank's columns of a mux-major (n_mux * B,) or (n_mux, B)
        grid array, flattened mux-major."""
        g = np.asarray(grid).reshape(self.n_mux, self.nrows)
        return g[:, self._rows.start:self._rows.stop].reshape(-1)

    def whole_cache(self):
        """The paged cache as one device holds it.  On a mesh every rank
        calls this (it gathers): this rank's part summed into zero-filled
        whole tensors — the pages, scales and positions over ``data`` in
        segment order, the KV heads over ``model`` where they are split,
        the block tables over ``data``.  Without a mesh, the cache."""
        if self.mesh is None:
            return self.cache
        m, heads = self.mesh, heads_split(self.sc.cfg, self.mesh)
        bt = m.gather(self.cache["bt"], "data", 0)
        layers = []
        for c in self.cache["layers"]:
            out = {}
            for k, x in c.items():
                if k == "bt":
                    out[k] = bt
                    continue
                w = m.gather(_page_bits(x), "data", 0)
                if heads and k != "ppos":
                    w = m.gather(w, "model", 2)
                out[k] = w.view(x.dtype)
            layers.append(out)
        return {"layers": layers, "bt": bt}

    def place_cache(self, whole):
        """Install this mesh rank's part of a whole paged cache
        (``whole_cache``'s layout) into its own, in place: its segment's
        pages, scales and positions (its KV heads where they are split)
        and its rows' tables."""
        bps = whole["layers"][0]["ppos"].shape[0] // self.sc.n_shards
        seg = slice(self._shard * bps, (self._shard + 1) * bps)
        heads = slice(None)
        if heads_split(self.sc.cfg, self.mesh):
            n = self.cache["layers"][0]["kp"].shape[2]
            heads = slice(self.mesh.coords["model"] * n,
                          (self.mesh.coords["model"] + 1) * n)
        for c, w in zip(self.cache["layers"], whole["layers"], strict=True):
            for k, x in c.items():
                if k != "bt":
                    src = w[k][seg] if k == "ppos" else w[k][seg, :, heads]
                    _page_bits(x).copy_(_page_bits(src))
        self.cache["bt"].copy_(whole["bt"][self._rows.start:
                                           self._rows.stop])

    def _tokens_to_host(self, buf):
        """A token buffer on the host.  On a mesh ``buf`` is zero but for
        the part this rank's data shard computed, and is summed over
        ``data`` first (a gather: the step's one token exchange)."""
        if self.mesh is not None:
            buf = self.mesh.all_reduce(buf.long(), "data")
        return buf.cpu().numpy()

    def _shard_used_blocks(self, row: int) -> int:
        """Used blocks on ``row``'s shard (the whole pool on one shard)."""
        if hasattr(self.pool, "shard_used_blocks"):
            return self.pool.shard_used_blocks(row)
        return self.pool.n_used_blocks

    def _exec_admissions(self):
        """Execute this step's admission plans.  A plan whose shard has no
        blocks is rolled back and the queue re-planned with that shard
        skipped, so a group lands on a sibling shard with free blocks
        instead of waiting behind a busy one."""
        failed: set = set()
        admitted = False
        plans = self.sched.plan_admissions(PAD_ID)
        while plans:
            retry = False
            for plan in plans:
                with self.tele.span("admit", lane=self.lane,
                                    shard=plan.shard, row=plan.row,
                                    tokens=plan.total):
                    ok = self._exec_admit(plan)
                admitted |= ok
                if not ok:
                    failed.add(plan.shard)
                    retry = True
            alive = self.sc.n_shards - len(self.sched.dead_shards)
            if not retry or len(failed) >= alive or not self.sched.queue:
                break
            # each round adds a failed shard: at most n_shards rounds
            plans = self.sched.plan_admissions(PAD_ID, skip_shards=failed)
        if admitted:
            self._install_tables()

    def _exec_admit(self, plan) -> bool:
        try:
            blocks = self.pool.allocate(plan.row, plan.total)
        except PoolExhausted:
            # backpressure: roll the group back, retry after drains
            self.sched.cancel_admit(plan)
            if self.tele.enabled:
                self.tele.inc("admit_rollbacks", lane=self.lane,
                              shard=plan.shard)
                self.tele.instant("cancel", lane=self.lane,
                                  shard=plan.shard, row=plan.row,
                                  tokens=plan.total)
            if self._shard_used_blocks(plan.row) == 0:
                raise PoolExhausted(
                    f"request group of {plan.total} tokens cannot fit "
                    f"an empty pool shard (num_blocks="
                    f"{self.pool.num_blocks}, block_size="
                    f"{self.pool.block_size}, shards {self.sc.n_shards}, "
                    f"quota {self.pool.quota})")
            return False
        self.row_len[plan.row] = plan.total
        self.row_tokens[plan.row] = np.asarray(plan.tokens, np.int32)
        self._reset_blocks(blocks)
        return True

    def _bucket(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def _exec_chunk(self, plan):
        """One chunk (or, blocking, the whole prompt) of row ``plan.row``,
        run by the ranks of the row's data shard."""
        j = plan.row
        arr, steps = self._sampling_row(j)
        local = j - self._rows.start          # the row on this rank
        compute = (plan.length if self.chunk is None
                   else self._bucket(plan.length))
        if self.chunk is not None:
            self._first_run(f"prefill_{compute}")
        out = None
        if not self._owns(j):
            pass
        elif self.chunk is None:
            # blocking prefill: the whole prompt, unpadded, fresh-KV attention
            toks = self.row_tokens[j].astype(np.int64)
            logits, _ = prefill(self.params, self.sc, self.cache,
                                torch.from_numpy(toks).to(self.device),
                                rows=[local], use_kernels=self.use_kernels,
                                extra_ctx=self._step_ctx([j]))
            out = self._sample(logits, arr, steps)
        else:
            buf = np.full((self.n_mux, compute), PAD_ID, np.int64)
            buf[:, :plan.length] = self.row_tokens[j][
                :, plan.start:plan.start + plan.length]
            logits, _ = prefill_chunk(
                self.params, self.sc, self.cache,
                torch.from_numpy(buf).to(self.device), rows=[local],
                start=plan.start, length=plan.length,
                use_kernels=self.use_kernels, extra_ctx=self._step_ctx([j]))
            out = self._sample(logits, arr, steps)
        self.stats["prefill_tokens"] += plan.length
        self.stats["prefill_compute_tokens"] += compute
        self.stats["prefill_events"] += 1
        self.stats["prefill_log"].append(((j,), plan.length))
        if self.on_prefill is not None:
            self.on_prefill((j,), plan.length)
        done = self.sched.chunk_done(j, plan.length)
        if plan.last:
            assert done
            if self.mesh is not None and out is None:
                out = torch.zeros(self.n_mux, dtype=torch.long,
                                  device=self.device)
            first = self._tokens_to_host(out)  # the row's first tokens
            self.sched.record_row_tokens(j, first, now=time.time())
            self.next_tok[:, j] = first

    def _clear_dead_slots(self):
        for j in range(self.nrows):
            if j in self.sched.prefill_progress:
                self.next_tok[:, j] = PAD_ID
                continue
            for i in range(self.n_mux):
                if self.sched.slots[j][i].request is None:
                    self.next_tok[i, j] = PAD_ID

    def _shard_mates(self, j: int) -> int:
        """Rows holding blocks on ``j``'s shard (j included): the rows
        whose drains could unblock it."""
        s = self.sched.shard_of(j)
        return sum(1 for r in self.row_len if self.sched.shard_of(r) == s)

    def _exec_decode(self, rows):
        pos_vec = np.full((self.nrows,), -1, np.int64)
        fresh, preempt = [], []
        for j in rows:
            try:
                fresh += self.pool.append(j)    # reserve the new slot
            except PoolExhausted:
                preempt.append(j)
                continue
            pos_vec[j] = self.row_len[j]
        # a row that outgrows its shard while it is the shard's only user
        # can never be served; with shard-mates it retries after drains
        for j in preempt:
            if self._shard_mates(j) == 1:
                raise PoolExhausted(
                    f"a single row outgrew its whole pool shard (num_blocks="
                    f"{self.pool.num_blocks}, block_size="
                    f"{self.pool.block_size}, shards {self.sc.n_shards})"
                    " — it can never be served")
        for j in preempt:
            self.sched.preempt_row(j)
            self.pool.free(j)
            del self.row_len[j]
            del self.row_tokens[j]
            if self.tele.enabled:
                shard = self.sched.shard_of(j)
                self.tele.inc("preempts", lane=self.lane, shard=shard)
                self.tele.instant("preempt", lane=self.lane, shard=shard,
                                  row=j)
        self._reset_blocks(fresh)
        if fresh or preempt:
            self._install_tables()
        rows = [j for j in rows if j not in preempt]
        if not rows:
            return
        self._clear_dead_slots()
        arr, steps = grid_sampling(self.sched)
        if self.mesh is not None:            # this rank's rows
            arr = {k: self._local(v) for k, v in arr.items()}
            steps = self._local(steps)
        toks_in = torch.from_numpy(self._local(self.next_tok).reshape(
            -1, 1).astype(np.int64)).to(self.device)
        pos_in = torch.from_numpy(
            pos_vec[self._rows.start:self._rows.stop]).to(self.device)
        self._first_run("decode")
        with self.tele.span("decode", lane=self.lane, metric="decode_step_s",
                            rows=len(rows)):
            logits, _ = decode_step(self.params, self.sc, self.cache,
                                    toks_in, pos_in,
                                    use_kernels=self.use_kernels,
                                    extra_ctx=self._step_ctx())
            out = self._sample(logits[:, 0], arr, steps)
            if self.mesh is not None:
                buf = torch.zeros((self.n_mux, self.nrows), dtype=torch.long,
                                  device=self.device)
                buf[:, self._rows.start:self._rows.stop] = out.reshape(
                    self.n_mux, -1)
                out = buf
            grid = self._tokens_to_host(out).reshape(self.n_mux, self.nrows)
        now = time.time()
        for j in rows:
            self.sched.record_row_tokens(j, grid[:, j], now=now)
            self.row_len[j] += 1
        self.next_tok = grid.astype(np.int32)
        self.stats["decode_steps"] += 1
        self.stats["slot_util"].append(self.sched.utilization())
        self.stats["cache_util"].append(self.pool.utilization())

    def _exec_frees(self):
        for plan in self.sched.plan_frees():
            if plan.row in self.row_len:
                self.pool.free(plan.row)
                del self.row_len[plan.row]
                del self.row_tokens[plan.row]
                if self.tele.enabled:
                    self.tele.instant("free", lane=self.lane,
                                      shard=self.sched.shard_of(plan.row),
                                      row=plan.row)
