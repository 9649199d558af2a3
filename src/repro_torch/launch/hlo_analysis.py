"""Per-rank cost of one step, read from the aten ops it dispatches on fake
tensors (counterpart of ``repro.launch.hlo_analysis``, which parses the
post-partitioning HLO; the name is kept so a reader finds the
counterpart, but nothing here reads HLO).

``analyze(fn, *args, mesh=)`` runs ``fn(*args)`` once, eagerly, under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode of its
own, and returns the reference's keys:

  * ``flops``: ``FlopCounterMode``'s count (2·M·N·K per matmul, the
    convolutions and attention products it knows).  Eager PyTorch runs
    no loop body once for many trips, so a Python loop of K layers counts
    K times, as the reference's trip-count walk does;
  * ``traffic_bytes``: per dispatched op, its tensor operands' bytes
    (an expanded view's: its storage's) plus its results' bytes (the
    reference's "each scheduled op reads its inputs and writes its
    outputs").  Views (``view``, ``narrow``,
    ``transpose``, ``expand``, ...) and metadata queries cost nothing;
    ``index_select``, ``gather``, ``embedding`` and indexing read what
    they write; an in-place update of part of a tensor (``index_put_``,
    ``copy_``, ``scatter_``, ...) reads and writes the update.  This is
    eager traffic, op by op: XLA's figure is after fusion, so the two
    do not agree, and a fused kernel of the port moves less than its
    plain version's ops count here;
  * ``collectives``: ``bytes``, ``counts`` and ``total_bytes`` by
    collective kind, read from ``mesh`` (a ``launch.mesh.RecordingMesh``
    or a ``ServeMesh``; its counters are reset first), each under that
    mesh's byte rule;
  * ``peak_bytes``: the high-water mark of live storage bytes during the
    step: the arguments' storages plus every storage the step's ops
    allocate, until it is freed;
  * ``argument_bytes`` / ``output_bytes``: the arguments' distinct
    storages, and the results' storages that are not arguments'.

``op_census`` counts the ops by kind, and the ``kernels.ops`` wrappers'
calls (``kernel:<name>``), the counterpart of the reference's
``custom-call``.  ``roofline_terms`` is the reference's arithmetic over
``launch.mesh.HW`` (NVLink in place of ICI).
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops that read only what they write (the reference's slice / gather rule)
_GATHERS = ("index_select", "gather", "embedding", "index")
# in-place updates of part of ``self``: read and write the update only (the
# reference's dynamic-update-slice rule)
_UPDATES = ("index_put_", "index_copy_", "index_add_", "scatter_",
            "scatter_add_", "copy_")
# no data moves: allocation without a fill, views the dispatcher does not
# mark as views
_FREE = ("empty", "empty_strided", "empty_like", "lift_fresh",
         "_unsafe_view", "_reshape_alias", "alias")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _moved(t) -> int:
    """An operand's bytes: its elements', or its storage's where that is
    smaller (an expanded view reads each stored element once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _storage_key(t):
    return t.untyped_storage()._cdata


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees``."""
    seen = {}
    for t in _tensors(trees):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Recorder(TorchDispatchMode):
    """Traffic, op counts and live storage bytes of what runs under it."""

    def __init__(self, args):
        super().__init__()
        self.traffic = 0
        self.ops = collections.Counter()
        self.live = {}
        for t in _tensors(args):        # held by the caller throughout
            st = t.untyped_storage()
            self.live[st._cdata] = st.nbytes()
        self.args = set(self.live)
        self.cur = self.peak = sum(self.live.values())

    def _freed(self, key):
        n = self.live.pop(key, None)
        if n is not None:
            self.cur -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        res = _tensors(out)
        if func.is_view or name in _FREE or not res:   # no tensor: metadata
            return out
        wrote = sum(_nbytes(t) for t in res)
        if name in _GATHERS:
            self.traffic += 2 * wrote
        elif name in _UPDATES:
            self.traffic += 2 * sum(
                _moved(t) for t in _tensors((args[1:], kwargs)))
        else:
            self.traffic += wrote + sum(
                _moved(t) for t in _tensors((args, kwargs)))
        for t in res:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live:
                self.live[key] = st.nbytes()
                self.cur += st.nbytes()
                weakref.finalize(st, self._freed, key)
        self.peak = max(self.peak, self.cur)
        return out


def analyze(fn, *args, mesh=None):
    """Run ``fn(*args)`` once and return the analysis dict of the module
    docstring.  Use fake tensors (``FakeTensorMode``) for a dry run:
    nothing is allocated and no kernel runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops as kops
    if mesh is not None:
        mesh.counts.clear()
        mesh.bytes.clear()
    calls = kops.counts("calls")
    rec = _Recorder(args)
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, rec:
        out = fn(*args)
    kernel_calls = {k: v - calls[k] for k, v in kops.counts("calls").items()
                    if v != calls[k]}
    out_keys = {_storage_key(t): t.untyped_storage().nbytes()
                for t in _tensors(out)}
    coll_bytes = dict(mesh.bytes) if mesh is not None else {}
    coll_counts = dict(mesh.counts) if mesh is not None else {}
    analysis = {
        "flops": float(flop_mode.get_total_flops()),
        "traffic_bytes": float(rec.traffic),
        "collectives": {"bytes": {k: float(v) for k, v in coll_bytes.items()},
                        "counts": {k: float(v) for k, v in
                                   coll_counts.items()},
                        "total_bytes": float(sum(coll_bytes.values()))},
        "peak_bytes": int(rec.peak),
        "argument_bytes": int(storage_bytes(args)),
        "output_bytes": int(sum(v for k, v in out_keys.items()
                                if k not in rec.args)),
        "ops": dict(rec.ops),
        "kernel_calls": kernel_calls,
    }
    return analysis


def op_census(analysis: dict, ops=("mm", "bmm", "addmm", "index_select",
                                   "index", "embedding", "scatter",
                                   "scatter_add", "index_add", "sort",
                                   "topk", "cat", "copy_")) -> dict:
    """Dispatched op counts of ``ops`` (0 where none ran), each
    ``kernels.ops`` wrapper's calls as ``kernel:<name>`` and the
    collectives' calls by kind as ``collective:<kind>``."""
    out = {op: analysis["ops"].get(op, 0) for op in ops}
    out.update({f"kernel:{k}": v
                for k, v in sorted(analysis["kernel_calls"].items())})
    out.update({f"collective:{k}": int(v) for k, v in
                sorted(analysis["collectives"]["counts"].items())})
    return out


def roofline_terms(analysis: dict, hw: dict) -> dict:
    """Three per-rank roofline terms in seconds and the bottleneck: the
    FLOPs at the bf16 tensor-core peak, the traffic at the HBM rate, the
    collective bytes at the NVLink rate."""
    flops = float(analysis.get("flops", 0.0))
    bytes_acc = float(analysis.get("traffic_bytes", 0.0))
    cbytes = float(analysis["collectives"].get("total_bytes", 0))
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = bytes_acc / hw["hbm_bw"]
    t_coll = cbytes / hw["nvlink_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    return {**terms, "bottleneck": dom.replace("_s", ""),
            "flops": flops, "bytes": bytes_acc,
            "collective_bytes": cbytes,
            "step_time_lb_s": bound,
            "compute_fraction_of_bound":
                (t_compute / bound if bound else 0.0)}
