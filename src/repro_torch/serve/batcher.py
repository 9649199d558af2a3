"""Request (counterpart of ``repro.serve.batcher.Request``; the fill-drain
``MuxBatcher`` is a later slice)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Request:
    """One generation request plus its wall-clock lifecycle stamps
    (``time.time()``): ``t_submit`` entered the queue (kept across
    preemption), ``t_admit`` placed into the grid, ``t_first`` first
    generated token on the host (TTFT = t_first - t_submit), ``t_done``
    retired (TPOT = (t_done - t_first) / (len(output) - 1))."""
    uid: int
    prompt: object                  # token list / array
    max_new: int = 16
    done: bool = False
    output: list = field(default_factory=list)
    sampling: object = None         # serve.sampling.SamplingParams | None
    t_submit: float = None
    t_admit: float = None
    t_first: float = None
    t_done: float = None
