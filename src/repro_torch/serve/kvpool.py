"""Paged KV-cache pool: host block allocator + device page ops
(counterpart of ``repro.serve.kvpool``; one shard).

  * ``KVPool``   — host-side allocator (numpy only): free list, per-client
                   block tables, allocate / append / free.  A client is one
                   backbone row of the serve grid (a mux group of N
                   streams sharing the row's muxed KV).
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
always masked out of attention.
"""
from __future__ import annotations

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


def paged_write(cache, k, v, positions, block_tables=None):
    """Scatter L new KV entries per row into their pages, in place.

    k, v: (B, L, Hkv, Dh) in the compute dtype; positions: (B, L)
    absolute positions, entries < 0 (padding, inactive rows) go to the
    trash block and stay masked.  block_tables overrides ``cache['bt']``
    (a row subset).  Rows own disjoint blocks, so scatters never collide
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
    page = torch.where(valid, page, TRASH_BLOCK)
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
    whose -1 entries keep a partly filled tail page masked), bit for bit.
    An ``index_select`` then an ``index_copy_`` per tensor, on the pages'
    device (the ids go there once; no value comes back to the host).
    ``src`` and ``dst`` may be the same dict.  Page dtypes must match:
    migration never re-quantizes.  Returns ``dst``."""
    if len(src_ids) != len(dst_ids):
        raise ValueError(
            f"page copy needs equal id lists, got {len(src_ids)} -> "
            f"{len(dst_ids)}")
    if len(src_ids) == 0:
        return dst
    if src["kp"].dtype != dst["kp"].dtype or ("ksc" in src) != ("ksc" in dst):
        raise ValueError("source/destination page dtypes differ — "
                         "cannot migrate pages across kv_dtype")
    dev = dst["kp"].device
    si = torch.as_tensor(src_ids, dtype=torch.long).to(dev)
    di = torch.as_tensor(dst_ids, dtype=torch.long).to(dev)
    for key in PAGE_KEYS:
        if key in dst:
            _bits(dst[key]).index_copy_(
                0, di, _bits(src[key]).index_select(0, si))
    return dst


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
