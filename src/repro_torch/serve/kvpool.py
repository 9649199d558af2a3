"""Paged KV-cache pool: host block allocator + device page ops
(counterpart of ``repro.serve.kvpool``).

  * ``KVPool``   — host-side allocator (numpy only): free list, per-client
                   block tables, allocate / append / free.  A client is one
                   backbone row of the serve grid (a mux group of N
                   streams sharing the row's muxed KV).
  * ``ShardedKVPool`` — logical data shards on one device: the global
                   block ids split into ``n_shards`` contiguous segments,
                   one per shard, each with its own free list and its own
                   trash block (its local block 0, global id ``s *
                   blocks_per_shard``).  Row j lives on shard ``j //
                   (n_rows // n_shards)`` and only ever holds blocks of
                   its own segment; ``kill_shard`` fences a lost shard.
  * page ops     — per attention layer, ``(num_blocks, block_size, Hkv,
                   Dh)`` K/V pages plus a per-slot absolute position map;
                   ``copy_pages`` moves whole pages between two layer
                   caches (disaggregated serving's KV migration);
                   ``paged_write`` scatters new entries IN PLACE (the
                   reference's functional ``.at[].set`` becomes an
                   in-place ``index_put_``; int8/fp8 pages quantize at
                   write with per-(slot, head) fp32 scales ``ksc``/``vsc``),
                   ``paged_view`` gathers a dequantized fp32 view for the
                   plain attention path.

Block 0 is the trash block: writes for invalid positions (bucket padding,
inactive rows) go there and its position entries stay -1, so they are
always masked out of attention.  Under ``ShardedKVPool`` each shard has
its own, and ``paged_write`` takes a per-row ``trash`` vector, so no
invalid write crosses shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import quant as quantlib


class PoolError(RuntimeError):
    """Misuse of the pool API (double alloc / double free / unknown client)."""


class PoolExhausted(PoolError):
    """No free blocks left (or a client hit its per-sequence block cap)."""


TRASH_BLOCK = 0


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``num_tokens`` entries."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return -(-max(num_tokens, 0) // block_size)


@dataclass
class KVPool:
    """Host-side block allocator with per-client block tables.
    ``num_blocks`` includes the reserved trash block 0.

    quota: optional soft cap on *live* blocks, below the device capacity.
    The device pages stay sized at ``num_blocks``; the quota only gates
    the host allocator.  Width-lane serving splits one global block
    budget into per-lane quotas this way, and ``serve.router.LaneRouter``
    moves *unused* quota between lanes.  A quota below the current usage
    is legal: nothing is reclaimed, new allocations are refused until
    rows drain."""
    num_blocks: int
    block_size: int
    max_blocks_per_seq: int
    quota: int | None = None
    _free: list = field(init=False, repr=False)
    _tables: dict = field(default_factory=dict, init=False, repr=False)
    _lens: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if self.block_size < 1 or self.max_blocks_per_seq < 1:
            raise ValueError("block_size / max_blocks_per_seq must be >= 1")
        if self.quota is not None and self.quota < 0:
            raise ValueError(f"quota must be >= 0, got {self.quota}")
        # LIFO free list over ids 1..num_blocks-1 (0 = trash)
        self._free = list(range(self.num_blocks - 1, 0, -1))

    @property
    def n_free_blocks(self) -> int:
        return len(self._free)

    @property
    def n_used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def headroom(self) -> int:
        """Blocks still allocatable: the free list, capped by the quota."""
        if self.quota is None:
            return len(self._free)
        return max(0, min(len(self._free), self.quota - self.n_used_blocks))

    @property
    def ceiling(self) -> int:
        """Device-side allocatable blocks (total minus the trash block)."""
        return self.num_blocks - 1

    def set_quota(self, quota: int | None):
        """Install a new soft cap (None = uncapped), effective at the next
        allocation; live blocks above a shrunken quota stay live."""
        if quota is not None and quota < 0:
            raise ValueError(f"quota must be >= 0, got {quota}")
        self.quota = quota

    def has(self, cid) -> bool:
        return cid in self._tables

    def num_tokens(self, cid) -> int:
        return self._lens[cid]

    def used_tokens(self) -> int:
        return sum(self._lens.values())

    def utilization(self) -> float:
        """Fraction of allocatable pool slots holding live tokens."""
        return self.used_tokens() / ((self.num_blocks - 1) * self.block_size)

    def occupancy_stats(self) -> list:
        """One entry (this unsharded pool): live / free blocks, the
        quota-capped headroom, the quota and the occupied fraction of the
        allocatable blocks; telemetry publishes them as gauges."""
        return [{"used": self.n_used_blocks, "free": self.n_free_blocks,
                 "headroom": self.headroom, "quota": self.quota,
                 "occupancy": self.n_used_blocks / (self.num_blocks - 1)}]

    def _take(self, n: int):
        if n > len(self._free):
            raise PoolExhausted(f"need {n} blocks, {len(self._free)} free")
        if self.quota is not None and self.n_used_blocks + n > self.quota:
            raise PoolExhausted(
                f"need {n} blocks, quota {self.quota} with "
                f"{self.n_used_blocks} in use")
        return [self._free.pop() for _ in range(n)]

    def allocate(self, cid, num_tokens: int = 0):
        """Register ``cid`` and reserve blocks for ``num_tokens``.  Blocks
        are reused without device-side clearing: reset their position
        entries (``engine.reset_blocks``) before the first write."""
        if cid in self._tables:
            raise PoolError(f"client {cid!r} already allocated")
        n = blocks_for(num_tokens, self.block_size)
        if n > self.max_blocks_per_seq:
            raise PoolExhausted(
                f"{num_tokens} tokens exceed per-seq cap "
                f"{self.max_blocks_per_seq * self.block_size}")
        blocks = self._take(n)
        self._tables[cid] = blocks
        self._lens[cid] = num_tokens
        return list(blocks)

    def append(self, cid, n: int = 1) -> list:
        """Grow ``cid`` by ``n`` tokens; returns the newly allocated block
        ids (reset them before writing)."""
        if cid not in self._tables:
            raise PoolError(f"client {cid!r} not allocated")
        new_len = self._lens[cid] + n
        need = blocks_for(new_len, self.block_size)
        if need > self.max_blocks_per_seq:
            raise PoolExhausted(
                f"client {cid!r}: {new_len} tokens exceed per-seq cap "
                f"{self.max_blocks_per_seq * self.block_size}")
        fresh = []
        if need > len(self._tables[cid]):
            fresh = self._take(need - len(self._tables[cid]))
            self._tables[cid].extend(fresh)
        self._lens[cid] = new_len
        return fresh

    def free(self, cid):
        if cid not in self._tables:
            raise PoolError(f"client {cid!r} not allocated (double free?)")
        self._free.extend(reversed(self._tables.pop(cid)))
        del self._lens[cid]

    def migrate_rows(self, cid, dst, dst_cid=None):
        """Move client ``cid`` out of this pool into ``dst`` (registered
        there as ``dst_cid``, default the same id): allocate the same block
        count in ``dst``, release the source blocks and return
        ``(src_blocks, dst_blocks)``, equal-length id lists for the device
        page copy (``engine.copy_cache_pages``).

        Atomic: the destination allocates through its normal allocator
        (quota and per-sequence cap apply), and on ``PoolExhausted``
        neither pool has changed."""
        if cid not in self._tables:
            raise PoolError(f"client {cid!r} not allocated")
        if dst_cid is None:
            dst_cid = cid
        if dst is self and dst_cid == cid:
            raise PoolError(f"client {cid!r}: migration onto itself")
        dst_blocks = dst.allocate(dst_cid, self._lens[cid])
        src_blocks = list(self._tables[cid])
        assert len(dst_blocks) == len(src_blocks), \
            "source table not minimal — allocator invariant broken"
        self.free(cid)
        return src_blocks, dst_blocks

    def block_table(self, cid) -> np.ndarray:
        """(max_blocks_per_seq,) int32, -1-padded."""
        if cid not in self._tables:
            raise PoolError(f"client {cid!r} not allocated")
        bt = np.full((self.max_blocks_per_seq,), -1, np.int32)
        blocks = self._tables[cid]
        bt[:len(blocks)] = blocks
        return bt

    def table_array(self, clients) -> np.ndarray:
        """(len(clients), max_blocks_per_seq) int32; None or unallocated
        clients give all -1 rows."""
        out = np.full((len(clients), self.max_blocks_per_seq), -1, np.int32)
        for i, cid in enumerate(clients):
            if cid is not None and cid in self._tables:
                out[i] = self.block_table(cid)
        return out

    def check_invariants(self):
        """Test hook: no block owned twice, free list disjoint, every
        table minimal-or-larger and under the per-sequence cap."""
        owned = [b for blks in self._tables.values() for b in blks]
        assert len(owned) == len(set(owned)), "block owned by two clients"
        assert not (set(owned) & set(self._free)), "owned block on free list"
        assert TRASH_BLOCK not in owned and TRASH_BLOCK not in self._free
        assert len(owned) + len(self._free) == self.num_blocks - 1
        for cid, blks in self._tables.items():
            assert len(blks) >= blocks_for(self._lens[cid], self.block_size)
            assert len(blks) <= self.max_blocks_per_seq

    def dump_state(self) -> dict:
        """JSON-able allocator snapshot (free list, tables, lengths,
        quota) with block ids local to this pool; ``ShardedKVPool`` nests
        one per shard.  Clients (backbone rows) are ints."""
        return {"free": [int(b) for b in self._free],
                "tables": {str(c): [int(b) for b in blks]
                           for c, blks in self._tables.items()},
                "lens": {str(c): int(n) for c, n in self._lens.items()},
                "quota": self.quota}

    def load_state(self, state: dict):
        """Install a ``dump_state`` snapshot into this freshly built pool
        of the same size."""
        self._free = [int(b) for b in state["free"]]
        self._tables = {int(c): [int(b) for b in blks]
                        for c, blks in state["tables"].items()}
        self._lens = {int(c): int(n) for c, n in state["lens"].items()}
        self.quota = state["quota"]
        self.check_invariants()


@dataclass
class ShardedKVPool:
    """Per-shard block allocator: ``KVPool``'s API over GLOBAL block ids.

    The id space [0, num_blocks) splits into ``n_shards`` segments of
    ``num_blocks // n_shards`` blocks; segment s belongs to shard s, whose
    local block 0 (global ``s * blocks_per_shard``) is its trash block.
    Clients are backbone rows in [0, n_rows); row j lives on shard
    ``j // (n_rows // n_shards)`` and receives blocks of its own segment
    only.  ``dead_shards``: shards fenced by ``kill_shard`` (quota 0,
    allocations refused, their pages dark)."""
    num_blocks: int
    block_size: int
    max_blocks_per_seq: int
    n_shards: int
    n_rows: int
    _shards: list = field(init=False, repr=False)
    dead_shards: set = field(default_factory=set, init=False, repr=False)

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.num_blocks % self.n_shards:
            raise ValueError(
                f"num_blocks={self.num_blocks} not divisible by "
                f"n_shards={self.n_shards}")
        if self.n_rows % self.n_shards:
            raise ValueError(
                f"n_rows={self.n_rows} not divisible by "
                f"n_shards={self.n_shards}")
        self._shards = [KVPool(num_blocks=self.blocks_per_shard,
                               block_size=self.block_size,
                               max_blocks_per_seq=self.max_blocks_per_seq)
                        for _ in range(self.n_shards)]

    @property
    def blocks_per_shard(self) -> int:
        return self.num_blocks // self.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.n_rows // self.n_shards

    @property
    def alive_shards(self) -> list:
        return [s for s in range(self.n_shards) if s not in self.dead_shards]

    def shard_of(self, cid) -> int:
        j = int(cid)
        if not 0 <= j < self.n_rows:
            raise PoolError(f"row {cid!r} outside [0, {self.n_rows})")
        return j // self.rows_per_shard

    def _offset(self, s: int) -> int:
        return s * self.blocks_per_shard

    def trash_for(self, cid) -> int:
        """Global id of the trash block of ``cid``'s shard."""
        return self._offset(self.shard_of(cid))

    def trash_vector(self, clients) -> np.ndarray:
        """(len(clients),) int32 per-row trash ids (``paged_write``'s
        ``trash``)."""
        return np.asarray([self.trash_for(c) for c in clients], np.int32)

    @property
    def n_free_blocks(self) -> int:
        return sum(p.n_free_blocks for p in self._shards)

    @property
    def n_used_blocks(self) -> int:
        return sum(p.n_used_blocks for p in self._shards)

    @property
    def headroom(self) -> int:
        """Allocatable blocks summed over shards (quota-capped per shard)."""
        return sum(p.headroom for p in self._shards)

    @property
    def quota(self) -> int | None:
        """Sum of the ALIVE shards' quotas (None = uncapped); a dead
        shard's quota 0 neither counts nor un-Nones the sum."""
        qs = [self._shards[s].quota for s in self.alive_shards]
        return None if any(q is None for q in qs) else sum(qs)

    @property
    def ceiling(self) -> int:
        """Device-side allocatable blocks over ALIVE shards (each segment
        minus its trash block): a killed shard's pages stop counting."""
        return sum(self._shards[s].ceiling for s in self.alive_shards)

    def set_quota(self, quota: int | None):
        """Split an aggregate soft cap over the ALIVE shards, each share
        floored at the shard's current usage (a donation never drops a
        hot shard below its live blocks); the spare above the floors
        splits evenly, remainder to the low shards.  A quota below the
        total usage splits evenly instead.  Dead shards keep quota 0."""
        alive = self.alive_shards
        for s in self.dead_shards:
            self._shards[s].set_quota(0)
        if quota is None:
            for s in alive:
                self._shards[s].set_quota(None)
            return
        used = [self._shards[s].n_used_blocks for s in alive]
        if quota >= sum(used):
            base, rem = divmod(quota - sum(used), len(alive))
            for k, s in enumerate(alive):
                self._shards[s].set_quota(used[k] + base
                                          + (1 if k < rem else 0))
        else:
            base, rem = divmod(quota, len(alive))
            for k, s in enumerate(alive):
                self._shards[s].set_quota(base + (1 if k < rem else 0))

    def kill_shard(self, s: int) -> int:
        """Fence shard ``s`` after its loss: its segment serves no more
        allocations and its quota goes to the survivors (evenly,
        remainder to the low shards).  The caller frees the shard's rows
        first: a table still addressing a dead segment would read pages
        that are gone.  Returns the quota handed over (0 when
        uncapped)."""
        if not 0 <= s < self.n_shards:
            raise PoolError(f"shard {s} outside [0, {self.n_shards})")
        if s in self.dead_shards:
            raise PoolError(f"shard {s} already dead")
        if len(self.alive_shards) <= 1:
            raise PoolError("cannot kill the last surviving shard")
        p = self._shards[s]
        if p._tables:
            raise PoolError(
                f"shard {s} still owns rows {sorted(p._tables)} — "
                "preempt/free them before kill_shard")
        reclaimed = p.quota or 0
        p.set_quota(0)
        self.dead_shards.add(s)
        survivors = self.alive_shards
        if reclaimed:
            base, rem = divmod(reclaimed, len(survivors))
            for k, t in enumerate(survivors):
                q = self._shards[t].quota
                if q is not None:
                    self._shards[t].set_quota(q + base
                                              + (1 if k < rem else 0))
        return reclaimed

    def shard_used_blocks(self, cid) -> int:
        """Used blocks on ``cid``'s own shard (backpressure is
        shard-local)."""
        return self._shards[self.shard_of(cid)].n_used_blocks

    def has(self, cid) -> bool:
        return self._shards[self.shard_of(cid)].has(cid)

    def num_tokens(self, cid) -> int:
        return self._shards[self.shard_of(cid)].num_tokens(cid)

    def used_tokens(self) -> int:
        return sum(p.used_tokens() for p in self._shards)

    def utilization(self) -> float:
        return self.used_tokens() / (
            (self.num_blocks - self.n_shards) * self.block_size)

    def occupancy_stats(self) -> list:
        """``KVPool.occupancy_stats`` per shard, index s for shard s."""
        return [st for p in self._shards for st in p.occupancy_stats()]

    def allocate(self, cid, num_tokens: int = 0):
        s = self.shard_of(cid)
        if s in self.dead_shards:
            raise PoolError(f"shard {s} is dead (row {cid!r} cannot be "
                            "placed there until the shard is repaired)")
        try:
            local = self._shards[s].allocate(cid, num_tokens)
        except PoolExhausted as e:
            raise PoolExhausted(f"shard {s}: {e}") from e
        return [b + self._offset(s) for b in local]

    def append(self, cid, n: int = 1) -> list:
        s = self.shard_of(cid)
        try:
            local = self._shards[s].append(cid, n)
        except PoolExhausted as e:
            raise PoolExhausted(f"shard {s}: {e}") from e
        return [b + self._offset(s) for b in local]

    def free(self, cid):
        self._shards[self.shard_of(cid)].free(cid)

    def migrate_pages(self, cid, dst_cid=None, dst=None):
        """``KVPool.migrate_rows`` over global ids: move row ``cid``'s
        pages into ``dst`` (another pool, or this one for a cross-shard
        move) as ``dst_cid``.  Returns ``(src_blocks, dst_blocks)``, each
        in its pool's own id space; the destination allocates through its
        normal allocator (segment, quota and dead-shard rules hold), and
        on ``PoolExhausted`` nothing moves."""
        if dst is None:
            dst = self
        if dst_cid is None:
            dst_cid = cid
        s = self.shard_of(cid)
        if not self._shards[s].has(cid):
            raise PoolError(f"row {cid!r} not allocated")
        if dst is self and dst_cid == cid:
            raise PoolError(f"row {cid!r}: migration onto itself")
        dst_blocks = dst.allocate(dst_cid, self._shards[s].num_tokens(cid))
        src_blocks = [b + self._offset(s)
                      for b in self._shards[s]._tables[cid]]
        assert len(dst_blocks) == len(src_blocks), \
            "source table not minimal — allocator invariant broken"
        self.free(cid)
        return src_blocks, dst_blocks

    def block_table(self, cid) -> np.ndarray:
        s = self.shard_of(cid)
        bt = self._shards[s].block_table(cid)
        return np.where(bt >= 0, bt + self._offset(s), bt).astype(np.int32)

    def table_array(self, clients) -> np.ndarray:
        out = np.full((len(clients), self.max_blocks_per_seq), -1, np.int32)
        for i, cid in enumerate(clients):
            if cid is not None and self.has(cid):
                out[i] = self.block_table(cid)
        return out

    def check_invariants(self):
        """Each shard's ``KVPool`` invariants; a dead shard owns nothing
        and has quota 0; a table holds blocks of its own segment only,
        never a trash block."""
        for s, p in enumerate(self._shards):
            p.check_invariants()
            if s in self.dead_shards:
                assert not p._tables, "dead shard still owns rows"
                assert p.quota == 0, "dead shard has non-zero quota"
            off = self._offset(s)
            for cid, blks in p._tables.items():
                assert self.shard_of(cid) == s, "row on the wrong shard"
                for b in blks:
                    g = b + off
                    assert off < g < off + self.blocks_per_shard, \
                        "block table crosses shard boundary"
                    assert g % self.blocks_per_shard != 0, \
                        "trash block referenced by a live table"

    def dump_state(self) -> dict:
        """Per-shard ``KVPool.dump_state`` (local ids) and the dead
        shards."""
        return {"shards": [p.dump_state() for p in self._shards],
                "dead_shards": sorted(self.dead_shards)}

    def load_state(self, state: dict):
        """Install a ``dump_state`` snapshot into this freshly built pool
        of the same shape."""
        if len(state["shards"]) != self.n_shards:
            raise PoolError(
                f"snapshot has {len(state['shards'])} shards, pool has "
                f"{self.n_shards}")
        for p, st in zip(self._shards, state["shards"]):
            p.load_state(st)
        self.dead_shards = set(int(s) for s in state["dead_shards"])
        self.check_invariants()


# ---------------------------------------------------------------- device

def _bits(x):
    """fp8 pages as their uint8 bytes (scatters and gathers move fp8
    payloads bit for bit without needing fp8 indexing kernels); other
    dtypes unchanged."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def _zeros(shape, dtype, device):
    if dtype == torch.float8_e4m3fn:      # 0x00 is +0.0 in e4m3
        return torch.zeros(shape, dtype=torch.uint8,
                           device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def init_pages(num_blocks: int, block_size: int, n_kv_heads: int,
               head_dim: int, dtype, quant: str | None = None, *, device):
    """Pages for ONE attention layer + its per-slot position map, on
    ``device``.

    quant: 'int8' / 'fp8' stores the pages in that dtype (``dtype`` is
    then ignored) with per-(slot, kv-head) fp32 scales alongside
    (``ksc``/``vsc``, shape (P, BS, Hkv)).  The presence of ``ksc`` marks
    a cache as quantized downstream: ``paged_write`` quantizes at write,
    the kernels fuse the dequant into their page loads."""
    shape = (num_blocks, block_size, n_kv_heads, head_dim)
    store = dtype if quant is None else quantlib.kv_store_dtype(quant)
    out = {"kp": _zeros(shape, store, device),
           "vp": _zeros(shape, store, device),
           "ppos": torch.full((num_blocks, block_size), -1,
                              dtype=torch.int32, device=device)}
    if quant is not None:
        out["ksc"] = torch.zeros(shape[:3], device=device)
        out["vsc"] = torch.zeros(shape[:3], device=device)
    return out


def paged_write(cache, k, v, positions, block_tables=None, trash=None):
    """Scatter L new KV entries per row into their pages, in place.

    k, v: (B, L, Hkv, Dh) in the compute dtype; positions: (B, L)
    absolute positions, entries < 0 (padding, inactive rows) go to the
    trash block and stay masked.  block_tables overrides ``cache['bt']``
    (a row subset).  trash: the trash block id, an int or a (B,) per-row
    tensor (logical shards route each row's invalid writes to its own
    shard's trash block); default block 0.  Rows own disjoint blocks, so scatters never collide
    across rows.
    Quantized caches (``ksc`` present) quantize at write time, per
    (slot, head) vector; bf16 pages store the rounded cast.  Returns
    ``cache``."""
    bt = (cache["bt"] if block_tables is None else block_tables).long()
    bs = cache["kp"].shape[1]
    positions = positions.long()
    blk = torch.div(positions, bs, rounding_mode="floor")
    in_range = (positions >= 0) & (blk < bt.shape[1])
    page = torch.gather(bt, 1, blk.clamp(0, bt.shape[1] - 1))
    valid = in_range & (page >= 0)
    if trash is None:
        trash = TRASH_BLOCK
    elif isinstance(trash, torch.Tensor):
        trash = trash.to(page.device, torch.long)
        if trash.ndim:
            trash = trash[:, None]
    page = torch.where(valid, page, trash)
    slot = torch.where(valid, positions % bs, 0)
    stored = torch.where(valid, positions, -1)
    idx = (page, slot)
    if "ksc" in cache:
        kind = quantlib.kv_quant_kind(cache["kp"].dtype)
        kq, ks = quantlib.quantize_kv(k, kind)
        vq, vs = quantlib.quantize_kv(v, kind)
        cache["ksc"].index_put_(idx, ks)
        cache["vsc"].index_put_(idx, vs)
    else:
        kq, vq = k.to(cache["kp"].dtype), v.to(cache["vp"].dtype)
    _bits(cache["kp"]).index_put_(idx, _bits(kq))
    _bits(cache["vp"]).index_put_(idx, _bits(vq))
    cache["ppos"].index_put_(idx, stored.to(torch.int32))
    return cache


PAGE_KEYS = ("kp", "vp", "ksc", "vsc", "ppos")


def copy_pages(src, dst, src_ids, dst_ids):
    """Copy whole pages between two layer caches, in place: pages
    ``src_ids`` of ``src`` land in slots ``dst_ids`` of ``dst``.  Moves the
    payload (``kp`` / ``vp``, fp8 as its bytes), the quant scales when
    present (``ksc`` / ``vsc``) and the per-slot position map (``ppos``,
    whose -1 entries keep a partly filled tail page masked), bit for bit:
    ``take_pages`` then ``put_pages``, an ``index_select`` and an
    ``index_copy_`` per tensor on the pages' device (the ids go there
    once; no value comes back to the host).  ``src`` and ``dst`` may be
    the same dict.  Page storage must match (``check_page_storage``):
    migration never re-quantizes.  Returns ``dst``."""
    if len(src_ids) != len(dst_ids):
        raise ValueError(
            f"page copy needs equal id lists, got {len(src_ids)} -> "
            f"{len(dst_ids)}")
    if len(src_ids) == 0:
        return dst
    check_page_storage([src], [dst])
    dev = dst["kp"].device
    return put_pages(dst, _ids(dst_ids, dev),
                     take_pages(src, _ids(src_ids, dev)))


def _ids(ids, device):
    return torch.as_tensor(ids, dtype=torch.long).to(device)


def check_page_storage(src_layers, dst_layers):
    """Raise unless two paged caches' layer caches hold the same page
    tensors: the same keys (``PAGE_KEYS``), dtypes and per-page shapes,
    layer by layer.  Reads shapes and dtypes only, so every rank of a
    mesh that holds both caches decides alike before a page move."""
    def specs(layers):
        return [[(k, c[k].dtype, tuple(c[k].shape[1:])) for k in PAGE_KEYS
                 if k in c] for c in layers]
    if specs(src_layers) != specs(dst_layers):
        raise ValueError("source/destination page storage differs — "
                         "cannot migrate pages across kv_dtype, dtype or "
                         "page shape")


def take_pages(cache, ids) -> list:
    """Pages ``ids`` of a layer cache: one tensor per page tensor present
    (``PAGE_KEYS`` order), fp8 as its bytes."""
    si = _ids(ids, cache["kp"].device)
    return [_bits(cache[k]).index_select(0, si) for k in PAGE_KEYS
            if k in cache]


def put_pages(cache, ids, pages):
    """Write ``take_pages``' tensors into slots ``ids`` of a layer cache,
    in place; returns the cache."""
    di = _ids(ids, cache["kp"].device)
    keys = [k for k in PAGE_KEYS if k in cache]
    if len(keys) != len(pages):
        raise ValueError("page tensors do not match the cache's storage")
    for k, x in zip(keys, pages):
        _bits(cache[k]).index_copy_(0, di, x)
    return cache


def pages_as_bytes(pages):
    """``take_pages``' tensors (of one layer or several) as one flat uint8
    tensor: what a move between ranks sends."""
    return torch.cat([x.reshape(-1).view(torch.uint8) for x in pages])


def _page_specs(like, n: int):
    """(layer, bits dtype, shape) of each tensor ``take_pages`` gives for
    ``n`` pages of each layer cache in ``like``, in order."""
    for i, cache in enumerate(like):
        for k in PAGE_KEYS:
            if k in cache:
                x = _bits(cache[k])
                yield i, x.dtype, (n, *x.shape[1:])


def pages_nbytes(like, n: int) -> int:
    """Bytes of ``n`` pages of each layer cache in ``like``, as
    ``pages_as_bytes`` lays them out."""
    return sum(dt.itemsize * math.prod(shape)
               for _, dt, shape in _page_specs(like, n))


def pages_from_bytes(buf, like, n: int) -> list:
    """``pages_as_bytes``' inverse for ``n`` pages of each layer cache in
    ``like`` (their shapes and storage): per layer, the tensors
    ``put_pages`` takes."""
    out, at = [[] for _ in like], 0
    for i, dt, shape in _page_specs(like, n):
        nb = dt.itemsize * math.prod(shape)
        chunk = buf.narrow(0, at, nb)
        if at % dt.itemsize:             # a view needs aligned bytes
            chunk = chunk.clone()
        out[i].append(chunk.view(dt).reshape(shape))
        at += nb
    return out


def paged_view(cache, block_tables=None):
    """Each row's pages gathered into a contiguous (B, MB*BS, Hkv, Dh)
    view plus per-row slot positions (B, MB*BS), -1 for empty or
    unallocated.  fp32 and bf16 pages come as stored, quantized pages
    dequantized to fp32, as the reference's ``paged_view``; the plain
    attention path promotes them against q as JAX does.  The kernels read
    the pages in place."""
    bt = (cache["bt"] if block_tables is None else block_tables).long()
    b = bt.shape[0]
    btc = bt.clamp(min=0)
    k = _bits(cache["kp"])[btc].view(cache["kp"].dtype)
    v = _bits(cache["vp"])[btc].view(cache["vp"].dtype)
    if "ksc" in cache:
        k = quantlib.dequantize_kv(k, cache["ksc"][btc])
        v = quantlib.dequantize_kv(v, cache["vsc"][btc])
    pos = torch.where(bt[..., None] >= 0, cache["ppos"][btc], -1)
    return (k.reshape(b, -1, *k.shape[3:]), v.reshape(b, -1, *v.shape[3:]),
            pos.reshape(b, -1))
