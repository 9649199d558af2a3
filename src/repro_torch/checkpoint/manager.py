"""Atomic checkpoint save / restore of a tree of tensors, in the
reference's on-disk layout byte for byte (counterpart of
``repro.checkpoint.manager``), so either package restores the other's::

    <dir>/step_000000123.tmp/     (written first)
        tree.json                 step, metadata, and per leaf its path,
                                  file, shape and dtype name
        <sha1(path)[:16]>.npy     one file per leaf
    <dir>/step_000000123/         (committed by os.rename)

A tree is nested dicts (keys sorted, as the reference's pytrees
flatten) and lists / tuples (by index); ``None`` holds no leaf; a leaf's
path joins the keys and indices with '/'.  Leaves are torch tensors,
numpy arrays or host ints in (an int is a 0-d int64 array on disk, as
the reference's ``np.asarray`` of one), torch tensors out on the
caller's ``device``, or ints where the restore target holds an int.

bf16 and fp8 leaves: numpy has no such dtype, and the reference's
``np.save`` of an ml_dtypes array writes a void header ('<V2' / '<V1')
with the dtype's name in ``tree.json`` only.  The port writes the same
header over the raw bits, so a plain ``np.load`` reads void (and the
reference fails loudly rather than reading integers), and reads such a
leaf by its ``tree.json`` dtype, reinterpreting the bits whatever the
void header's byte-order mark.

``AsyncCheckpointManager`` copies to the host, then writes in a
background thread; ``wait()`` joins it and re-raises its failure.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

# dtype name in tree.json -> (numpy view of the bits, torch dtype)
_BIT_DTYPES = {"bfloat16": (np.int16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
# torch dtype -> (its tree.json name, the torch view of its bits)
_TORCH_BITS = {torch.bfloat16: ("bfloat16", torch.int16),
               torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8)}


def _leaf_file(path: str) -> str:
    return f"{hashlib.sha1(path.encode()).hexdigest()[:16]}.npy"


def _flatten(tree, prefix=()):
    """[(path, leaf)] in the reference's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves, prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def _host(leaf):
    """(numpy array to write, dtype name): torch tensors come to the host;
    a bf16 / fp8 leaf as its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _TORCH_BITS:
            name, bits = _TORCH_BITS[t.dtype]
            return t.view(bits).numpy().copy(), name
        a = t.numpy().copy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    return a, a.dtype.name


def _save_npy(fname, arr, name):
    if name not in _BIT_DTYPES:
        np.save(fname, arr)
        return
    # the header ml_dtypes' np.save writes, over the raw bits
    arr = np.ascontiguousarray(arr)
    with open(fname, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": f"<V{arr.itemsize}", "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _load_leaf(fname, name, device):
    arr = np.load(fname)
    if name in _BIT_DTYPES:
        bits, dt = _BIT_DTYPES[name]
        if arr.dtype.kind != "V" or arr.dtype.itemsize != np.dtype(
                bits).itemsize:
            raise ValueError(f"{fname}: a {name} leaf stored as "
                             f"{arr.dtype.str}")
        return torch.from_numpy(arr.view(bits).copy()).view(dt).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def save_checkpoint(directory: str, step: int, tree, *, metadata=None,
                    keep_k: int | None = None):
    """Blocking atomic save of a tree of tensors.  Returns the step's
    directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = {"step": step, "metadata": metadata or {}, "leaves": []}
    for path, leaf in _flatten(tree):
        arr, name = _host(leaf)
        fname = _leaf_file(path)
        _save_npy(os.path.join(tmp, fname), arr, name)
        index["leaves"].append({"path": path, "file": fname,
                                "shape": list(arr.shape), "dtype": name})
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    if keep_k:
        prune(directory, keep_k)
    return final


def available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def prune(directory: str, keep_k: int):
    for s in available_steps(directory)[:-keep_k]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"))


def restore_checkpoint(directory: str, target_tree, *, step: int | None = None,
                       device="cpu"):
    """Restore into the structure of ``target_tree`` (tensor leaves, or
    host ints such as an optimizer's ``count``; only their paths and
    shapes are read) on ``device``; an int leaf comes back an int.
    Returns (tree, step, metadata)."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "tree.json")) as f:
        index = json.load(f)
    by_path = {e["path"]: e for e in index["leaves"]}
    out = {}
    for path, leaf in _flatten(target_tree):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        e = by_path[path]
        if tuple(e["shape"]) != np.shape(leaf):
            raise ValueError(
                f"shape mismatch for {path!r}: ckpt {e['shape']} vs "
                f"target {list(np.shape(leaf))}")
        t = _load_leaf(os.path.join(d, e["file"]), e["dtype"], device)
        out[path] = int(t) if isinstance(leaf, int) else t
    return _unflatten(target_tree, out), step, index["metadata"]


class AsyncCheckpointManager:
    """Copy to the host, then write in a background thread; at most one
    write in flight.  ``save`` / ``wait`` / ``restore`` serialize on a
    lock; a background failure re-raises (chained) from the next
    ``wait()`` — never swallowed, or a later ``restore`` would return an
    older step than the caller believes committed — and ``restore``
    joins the in-flight write first (read-your-own-writes)."""

    def __init__(self, directory: str, keep_k: int = 3):
        self.directory = directory
        self.keep_k = keep_k
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self.last_committed: int | None = None

    def save(self, step: int, tree, metadata=None):
        self.wait()
        host = _unflatten(tree, {p: (x.detach().cpu().clone()
                                     if isinstance(x, torch.Tensor)
                                     else np.array(x))
                                 for p, x in _flatten(tree)})

        def work():
            try:
                save_checkpoint(self.directory, step, host,
                                metadata=metadata, keep_k=self.keep_k)
                self.last_committed = step
            except BaseException as e:     # surfaced by the next wait()
                self._error = e

        with self._lock:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from error

    def restore(self, target_tree, *, step=None, device="cpu"):
        self.wait()
        return restore_checkpoint(self.directory, target_tree, step=step,
                                  device=device)
