"""Fault tolerance (counterpart of ``repro.runtime.fault_tolerance``): a
supervised training loop with checkpoint / restart and bounded
exponential back-off, a seekable batch stream for the replay, and the
straggler detector.

The failure signals are ``DeviceFailure`` (raised by tests' fault hooks,
standing in for a lost device) and ``torch.AcceleratorError`` (a CUDA
fault surfacing from the step); a bare ``RuntimeError`` is a bug and is
not caught.
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.checkpoint.manager import AsyncCheckpointManager, _flatten


class DeviceFailure(RuntimeError):
    """Stand-in for a device failure."""


# what a step raises when its device fails
FAILURES = (DeviceFailure, torch.AcceleratorError)


class ReplayableIterator:
    """Seekable batch stream for ``Supervisor.run``: wraps a
    deterministic ``step -> batch`` function so that a restore rewinds
    the data to the checkpointed step.  Without the rewind a restored run
    trains its replayed steps on the batches that come after the
    failure: the same step numbers with other data, and no error."""

    def __init__(self, batch_fn: Callable, start: int = 0):
        self.batch_fn = batch_fn
        self._step = start

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.batch_fn(self._step)
        self._step += 1
        return batch

    def seek(self, step: int):
        self._step = step


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


def _state_device(state):
    for _, leaf in _flatten(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


@dataclass
class Supervisor:
    """Runs the training loop; on a device failure restores the last
    checkpoint onto the state's device and resumes, within a restart
    budget and with exponential back-off.  The data stream is rewound to
    the restored step where it can ``seek`` (a warning and an
    ``iter_not_replayable`` row where it cannot), and the history rows of
    the rolled-back steps are dropped."""
    step_fn: Callable             # (state, batch, step) -> (state, metrics)
    ckpt: AsyncCheckpointManager
    checkpoint_every: int = 50
    max_restarts: int = 3
    backoff_s: float = 0.01
    straggler: StragglerDetector = field(default_factory=StragglerDetector)
    on_straggler: Callable | None = None
    fault_hook: Callable | None = None     # (step) -> None | raise (tests)

    def run(self, state, data_iter, n_steps: int, *, start_step: int = 0):
        step = start_step
        restarts = 0
        history = []
        while step < n_steps:
            try:
                batch = next(data_iter)
                if self.fault_hook is not None:
                    self.fault_hook(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch, step)
                dt = time.perf_counter() - t0
                if self.straggler.observe(step, dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                # step-tagged so a restore can drop rolled-back rows
                history.append({**metrics, "step": step})
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state, metadata={"step": step})
            except FAILURES as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted ({self.max_restarts})"
                    ) from e
                time.sleep(self.backoff_s * 2 ** (restarts - 1))
                try:
                    state, step, _ = self.ckpt.restore(
                        state, device=_state_device(state))
                except FileNotFoundError:
                    step = start_step     # no checkpoint yet: cold restart
                if hasattr(data_iter, "seek"):
                    data_iter.seek(step)
                else:
                    warnings.warn(
                        "Supervisor restored a checkpoint but the data "
                        "iterator has no .seek(step): replayed steps will "
                        "see different batches than the fault-free run "
                        "(use ReplayableIterator)", stacklevel=2)
                    history.append({"event": "iter_not_replayable",
                                    "at_step": step})
                # event rows carry "at_step", not "step", and survive
                history[:] = [h for h in history
                              if "step" not in h or h["step"] < step]
                history.append({"event": "restart", "at_step": step,
                                "cause": repr(e)})
        self.ckpt.wait()
        return state, history
