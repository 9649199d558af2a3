"""Host-sharded data loader (counterpart of ``repro.data.loader``).

Each shard owns ``global_batch / n_shards`` rows; one process here is one
shard.  A batch is drawn with numpy from ``(seed, step, shard)``, as the
reference's, so it is restart-safe and shard-disjoint by construction,
and equal to the reference's batch bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np


@dataclass
class ShardedLoader:
    sample_fn: Callable            # (rng, batch, length) -> arrays
    global_batch: int
    seq_len: int
    shard_id: int = 0
    n_shards: int = 1
    seed: int = 0
    _step: int = field(default=0, init=False)

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"n_shards {self.n_shards}")
        self.local_batch = self.global_batch // self.n_shards

    def state_dict(self):
        return {"step": self._step, "seed": self.seed}

    def load_state_dict(self, s):
        self._step = int(s["step"])
        self.seed = int(s["seed"])

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        rng = np.random.default_rng((self.seed, self._step, self.shard_id))
        self._step += 1
        return self.sample_fn(rng, self.local_batch, self.seq_len)
