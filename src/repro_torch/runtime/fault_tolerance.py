"""Straggler detection (counterpart of ``StragglerDetector`` in
``repro.runtime.fault_tolerance``; its training supervisor is ROADMAP §1
item 13)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    """Step-time EWMA plus a z-score: a step more than ``z_threshold``
    standard deviations above the running mean is a straggler.  The first
    ``warmup_steps`` observations prime the mean and variance.  The
    standard deviation is floored at ``rel_floor`` of the mean (a stable
    step's variance is near 0, and the first ordinary jitter would score
    a huge z otherwise).  Straggler steps stay out of the baseline."""
    alpha: float = 0.1
    z_threshold: float = 3.0
    warmup_steps: int = 5
    rel_floor: float = 0.05
    _mean: float = field(default=0.0, init=False)
    _var: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    events: list = field(default_factory=list, init=False)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps:
            self._mean = dt if self._n == 1 else \
                (1 - self.alpha) * self._mean + self.alpha * dt
            self._var = max(self._var, (dt - self._mean) ** 2)
            return False
        floor = max(self.rel_floor * abs(self._mean), 1e-6)
        z = (dt - self._mean) / max(math.sqrt(self._var), floor)
        is_straggler = z > self.z_threshold
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "z": float(z)})
        else:
            d = dt - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        return is_straggler
