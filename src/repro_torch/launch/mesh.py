"""Serve meshes over ``torch.distributed`` and the one place the port's
collectives run (counterpart of ``repro.launch.mesh``).

The reference is one program that GSPMD partitions over a ``('data',
'model')`` device mesh.  The port is SPMD: one process per mesh position,
``data * model`` ranks, each building the same ``ServeMesh`` over the
current process group (``make_serve_mesh``).  ``spawn`` starts the ranks
on this host.

Every collective of the mesh path goes through a ``ServeMesh`` method and
uses ``all_reduce`` or ``broadcast``: a gather is a zero-filled buffer
with this rank's part in place, summed over the axis (x + 0 is x, so it
is exact but for a float ``-0.0``, which comes back ``+0.0``); what must
arrive bit for bit (a handoff's pages) goes by ``broadcast``.
The same code then runs on gloo over CPU tensors, on gloo over CUDA
tensors (ranks sharing one card: gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` only) and on NCCL.  ``pick_backend``
chooses, and ``backend_reason`` says why: gloo on the CPU; NCCL when each
rank has a GPU of its own; gloo over CUDA tensors when ranks share a GPU
(NCCL refuses two ranks on one GPU).  Nothing swaps one for another after the choice; the mesh carries
it (``backend``, ``backend_reason``).

``ServeMesh.counts`` counts the collectives by kind: ``all_reduce``
(partial sums of a row-parallel product, the MoE combine, the vocab- or
d-sharded embedding), ``gather`` (activation gathers: tokens over
``data``, an L-sharded attention output, the fallback axes) and
``weight_gather`` (a weight stored on an axis its layer cannot use
locally, gathered to full before use), ``page_move`` (a handoff's KV
pages between data shards: a ``broadcast`` from the source shard, which
moves bytes and sums nothing), ``agree`` (rank 0's host readings) and
``step_times`` (each shard's slowest rank's step time, for straggler
fencing); a caller may name other kinds.
``ServeMesh.bytes`` counts the bytes each kind hands to its collectives
on this rank.

Training runs the same collectives under autograd (Megatron's
conventions: the loss, and every tensor replicated over an axis, is the
same on each of its ranks and counted once).  Where autograd is on and
the input requires grad, each collective runs out of place through a
``torch.autograd.Function`` with the backward its forward needs:

  * ``all_reduce`` (a sum of partial results that replicated work then
    uses): the identity;
  * ``gather`` (replicated work then uses the whole): this rank's slice;
  * ``enter`` (the identity on a replicated tensor that each rank then
    uses a part of: a head or feature slice, its experts, a pipeline
    stage): each rank's gradient is only its part's, so the backward
    sums it over the axis;
  * ``shift`` (each rank's tensor to the next rank, a pipeline's step):
    the reverse shift.

The backward's collectives count as ``backward``.  Without autograd (or
on a tensor that requires no grad) every call is the serving path: in
place where it was, ``enter`` the identity.  ``torch.distributed.nn``'s
collectives are not used: their backward sums, which counts replicated
work once per rank.

A mesh's axes are ``('data', 'model')`` for serving and training, or any
others a caller names (``make_mesh``: ``('pipe',)`` for the pipeline).

``RecordingMesh`` stands for rank (0, ..., 0) of a mesh that is not
there (a ``make_production_mesh`` shape: the counterpart of the
reference dry run's 512 placeholder host devices).  It has
``ServeMesh``'s interface and its autograd Functions, never calls
``torch.distributed``, returns tensors of the shapes the real rank would
get, and counts each collective kind's calls and max(operand, result)
bytes.
"""
from __future__ import annotations

import collections
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import traceback

import torch
import torch.distributed as dist

AXES = ("data", "model")

# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (nvidia-smi), the card the
# port's figures are taken on; rates from NVIDIA's H100 SXM data sheet
HW = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "peak_flops_bf16": 989e12,     # FLOP/s, dense tensor cores
    "peak_flops_fp32": 67e12,      # FLOP/s, outside the tensor cores
    "hbm_bw": 3.35e12,             # B/s
    "nvlink_bw": 450e9,            # B/s each way to the host's other cards
    "hbm_bytes": 80e9,
}


def pick_backend(device, world: int) -> str:
    """The backend for ``world`` ranks on ``device`` ('cpu' or 'cuda'):
    gloo on the CPU, NCCL when every rank has a GPU of its own, else gloo
    over CUDA tensors."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def backend_reason(backend: str, device) -> str:
    """Why ``backend`` serves ranks on ``device`` (the mode line's note)."""
    if backend == "nccl":
        return "NCCL: a GPU per rank"
    if torch.device(device).type == "cpu":
        return "gloo: CPU tensors"
    return ("gloo over CUDA tensors: the ranks share a GPU, which NCCL "
            "refuses")


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _needs_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class ServeMesh:
    """This rank's view of a mesh (``('data', 'model')`` unless made with
    other axes): ``axes``, ``shape`` ({axis: size}, what the sharding
    rules read), ``coords`` ({axis: index}), the torch ``DeviceMesh`` and
    one process group per axis, the backend, and the collectives."""

    def __init__(self, device_mesh, device, backend: str):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.backend = backend
        self.backend_reason = backend_reason(backend, device)
        self.axes = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axes, device_mesh.mesh.shape))
        self.coords = dict(zip(self.axes, device_mesh.get_coordinate()))
        self.groups = {a: device_mesh.get_group(a) for a in self.axes}
        self.counts = collections.Counter()
        self.bytes = collections.Counter()

    def __repr__(self):
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"ServeMesh({sizes}, coords={self.coords}, {self.backend})"

    @property
    def tag(self) -> str:
        """The mode tag: ``mesh(D, M)``."""
        return f"mesh{tuple(self.shape.values())}"

    def _all_reduce(self, x, axis: str, kind: str, op: str = "sum"):
        if not x.is_contiguous():     # gloo would reduce the wrong memory
            raise ValueError("all_reduce of a non-contiguous tensor")
        dist.all_reduce(x, op=_OPS[op], group=self.groups[axis])
        self.counts[kind] += 1
        self.bytes[kind] += x.numel() * x.element_size()
        return x

    def all_reduce(self, x, axis: str, *, kind: str = "all_reduce",
                   op: str = "sum"):
        """Sum ``x`` over ``axis`` (op 'max': the largest element of each
        place) in place; returns it.  Under autograd, out of place with
        an identity backward (module docstring)."""
        if self.shape[axis] == 1:
            return x
        if _needs_grad(x):
            if op != "sum":
                raise ValueError(f"all_reduce {op!r} has no gradient")
            return _AllReduce.apply(x, self, axis, kind)
        return self._all_reduce(x, axis, kind, op)

    def mean(self, x, axis: str, *, kind: str = "mean"):
        """The mean of ``x`` over ``axis``: the sum ``all_reduce`` (in
        place on a contiguous ``x``, its gradient under autograd) over the
        axis size; returns it."""
        return self.all_reduce(x.contiguous(), axis,
                               kind=kind).div_(self.shape[axis])

    def _gather(self, x, axis: str, dim: int, kind: str):
        shape = list(x.shape)
        shape[dim] *= self.shape[axis]
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        step = x.shape[dim]
        out.narrow(dim, self.coords[axis] * step, step).copy_(x)
        return self._all_reduce(out, axis, kind)

    def gather(self, x, axis: str, dim: int, *, kind: str = "gather"):
        """Concatenate every rank's ``x`` along ``dim`` over ``axis``, in
        rank order (a zero-filled ``all_reduce``).  Under autograd the
        backward takes this rank's slice of the gradient."""
        if self.shape[axis] == 1:
            return x
        dim %= x.ndim
        if _needs_grad(x):
            return _Gather.apply(x, self, axis, dim, kind)
        return self._gather(x, axis, dim, kind)

    def enter(self, x, axis: str):
        """``x``, replicated over ``axis``, as each rank's part of the work
        that follows takes it: the identity; under autograd the backward
        sums the ranks' gradients over ``axis``."""
        if self.shape[axis] == 1 or not _needs_grad(x):
            return x
        return _Enter.apply(x, self, axis)

    def _shift(self, x, axis: str, step: int, kind: str):
        """Rank i's ``x`` to rank i + step (step +1 or -1) of ``axis``, a
        zero-filled ``all_reduce`` of n - 1 slots (slot j between ranks j
        and j + 1); a rank with no sender gets zeros."""
        n, i = self.shape[axis], self.coords[axis]
        out = torch.zeros_like(x)
        if n == 1:
            return out
        buf = torch.zeros((n - 1, *x.shape), dtype=x.dtype, device=x.device)
        send, recv = (i, i - 1) if step == 1 else (i - 1, i)
        if 0 <= send < n - 1:
            buf[send].copy_(x)
        self._all_reduce(buf, axis, kind)
        if 0 <= recv < n - 1:
            out.copy_(buf[recv])
        return out

    def shift(self, x, axis: str, *, kind: str = "shift"):
        """Each rank's ``x`` to the next rank of ``axis``: rank 0 gets
        zeros and the last rank's goes nowhere (a point-to-point send as
        a zero-filled ``all_reduce``).  Its backward is the reverse
        shift."""
        if _needs_grad(x):
            return _Shift.apply(x, self, axis, kind)
        return self._shift(x, axis, 1, kind)

    def broadcast(self, x, axis: str, *, src: int = 0,
                  kind: str = "broadcast"):
        """Rank ``src`` of ``axis``'s ``x`` on every rank of it, in place,
        byte for byte (no arithmetic: a page move's ``-0.0`` stays);
        returns it."""
        if self.shape[axis] > 1:
            if not x.is_contiguous():
                raise ValueError("broadcast of a non-contiguous tensor")
            group = self.groups[axis]
            dist.broadcast(x, src=dist.get_global_rank(group, src),
                           group=group)
            self.counts[kind] += 1
            self.bytes[kind] += x.numel() * x.element_size()
        return x

    def agree(self, values, *, kind: str = "agree") -> list:
        """Rank (0, ..., 0)'s ``values`` (floats) on every rank: a float64
        broadcast over each axis in turn.  Host readings that differ
        between ranks (a wall clock) pass through it before a decision or
        a result reads them."""
        buf = torch.tensor([float(v) for v in values], dtype=torch.float64,
                           device=self.device)
        if buf.numel():
            for a in self.axes:
                self.broadcast(buf, a, kind=kind)
        return buf.tolist()

    def barrier(self):
        """Wait for every rank (an ``all_reduce`` of one element)."""
        one = torch.ones(1, device=self.device)
        for a in self.axes:
            if self.shape[a] > 1:
                dist.all_reduce(one, group=self.groups[a])


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        out = x.clone(memory_format=torch.contiguous_format)
        return mesh._all_reduce(out, axis, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, kind):
        ctx.at = (dim, mesh.coords[axis] * x.shape[dim], x.shape[dim])
        return mesh._gather(x, axis, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.at).contiguous(), None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh._all_reduce(g, ctx.axis, "backward"), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, kind):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._shift(x, axis, 1, kind)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._shift(g.contiguous(), ctx.axis, -1, "backward"),
                None, None, None)


class RecordingMesh(ServeMesh):
    """Rank (0, ..., 0) of a mesh of ``shape`` ({axis: size}) with no
    process group: the collectives run no communication and leave their
    values as this rank's (a sum or a gather of one rank's part), so only
    shapes are right.  ``counts`` / ``bytes``: each kind's calls and
    max(operand, result) bytes (the reference's HLO rule), the autograd
    Functions' backward collectives under ``backward`` as ``ServeMesh``
    counts them.  Used with fake tensors by ``launch.dryrun``."""

    def __init__(self, shape: dict, device="cpu"):
        self.device_mesh = None
        self.device = torch.device(device)
        self.backend = "recording"
        self.backend_reason = "recording: no process group"
        self.axes = tuple(shape)
        self.shape = dict(shape)
        self.coords = dict.fromkeys(self.axes, 0)
        self.groups = {}
        self.counts = collections.Counter()
        self.bytes = collections.Counter()

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def _record(self, kind: str, nbytes: int):
        self.counts[kind] += 1
        self.bytes[kind] += nbytes

    def _all_reduce(self, x, axis: str, kind: str, op: str = "sum"):
        if not x.is_contiguous():
            raise ValueError("all_reduce of a non-contiguous tensor")
        self._record(kind, x.numel() * x.element_size())
        return x

    def _shift(self, x, axis: str, step: int, kind: str):
        out = torch.zeros_like(x)
        if self.shape[axis] > 1:
            self._record(kind, x.numel() * x.element_size())
        return out

    def broadcast(self, x, axis: str, *, src: int = 0,
                  kind: str = "broadcast"):
        if self.shape[axis] > 1:
            if not x.is_contiguous():
                raise ValueError("broadcast of a non-contiguous tensor")
            self._record(kind, x.numel() * x.element_size())
        return x

    def barrier(self):
        pass


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: dict, *, device=None):
    """A mesh of the named axes ``shape`` ({axis: size}, in order) over
    the current process group: ranks 0 .. prod(sizes) - 1 in row-major
    order.  Every rank of the group calls it, and a rank past them gets
    None.  device: the ranks' device type ('cuda' unless the caller
    names another)."""
    need = 1
    for n in shape.values():
        need *= n
    have = _world()
    if need > have:
        raise ValueError(
            f"mesh {tuple(shape.values())} needs {need} devices (ranks), "
            f"have {have}: start the ranks with launch.mesh.spawn")
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device("cuda" if device is None else device)
    dm = DeviceMesh(dev.type, torch.arange(need).reshape(*shape.values()),
                    mesh_dim_names=tuple(shape))
    if dm.get_coordinate() is None:
        return None
    return ServeMesh(dm, dev, dist.get_backend())


def make_serve_mesh(data: int = 1, model: int = 1, *, device=None):
    """The serve mesh over the current process group: rows, their block
    tables and the paged pool's pages partition over ``data`` (one
    ``ShardedKVPool`` segment per data shard), heads and MLP width over
    ``model`` by the sharding rules (``make_mesh`` with the axes
    ``AXES``)."""
    return make_mesh(dict(zip(AXES, (data, model))), device=device)


def make_test_mesh(data: int = 1, model: int = 1, *, device="cpu"):
    """A small mesh over the current process group (tests; the CPU by
    default)."""
    return make_serve_mesh(data, model, device=device)


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's production meshes, as shapes only ({axis: size}):
    one pod (data=16, model=16) or two (pod=2, data=16, model=16)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def _rank_main(rank, world, init, backend, data, model, device, work,
               results):
    try:
        with open(work, "rb") as f:        # this program's own pickle
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_serve_mesh(data, model, device=dev.type)
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:      # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, data: int, model: int, *, device="cuda", args=(),
          timeout: float = 600.0, tmpdir=None):
    """Run ``fn(mesh, *args)`` on ``data * model`` new processes of this
    host, one per mesh position, and return their results in rank order.

    The ranks rendezvous through a ``file://`` store in a new temporary
    directory (under ``tmpdir`` when given), so no port is chosen and two
    spawns never meet.  ``fn`` and ``args`` must pickle (``fn`` by import
    path).  A rank that raises, or a run past ``timeout`` seconds, stops
    every rank and raises here."""
    world = data * model
    backend = pick_backend(device, world)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the work goes by file: a large pickle in a child's start pipe
        # would hold each start until that child had read it
        work = os.path.join(tmp, "work.pkl")
        with open(work, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, backend, data, model,
                                   device, work, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = (datetime.datetime.now()
                    + datetime.timedelta(seconds=timeout))
        try:
            while len(out) + len(errors) < world:
                left = (deadline - datetime.datetime.now()).total_seconds()
                if left <= 0:
                    raise TimeoutError(
                        f"mesh ({data}, {model}): {world - len(out)} of "
                        f"{world} ranks gave no result within {timeout} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:     # died before it could report
                        errors.append(f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode} and no "
                                      "result")
                        break
                    continue
                if ok:
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
                    break        # the others may wait on it forever
            if errors:
                raise RuntimeError(f"mesh ({data}, {model}) failed on "
                                   + "\n".join(errors))
        finally:
            for p in procs:
                p.join(timeout=30 if not errors and len(out) == world
                       else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(10)
    return [out[r] for r in range(world)]
