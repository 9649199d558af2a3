"""Dry run of the port (counterpart of ``repro.launch.dryrun``): trace
every (architecture x input shape x mesh) cell once on fake tensors, as
rank (0, ..., 0) of a production mesh, and record its FLOPs, traffic,
collectives, memory and roofline terms.

The reference lowers and compiles each cell for 256 or 512 placeholder
host devices.  The port is SPMD (one process a rank), so one rank's step
is the whole story: ``launch.mesh.RecordingMesh`` stands for the mesh,
``launch.specs`` builds the rank's fake shards and the step, and
``launch.hlo_analysis.analyze`` reads the aten ops the step dispatches.
Nothing is allocated and nothing runs on any device; no environment
variable is needed, since nothing locks a device count.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun_torch.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b \\
        --shape long_500k --mux-n 4

A record's ``memory``: ``argument_bytes``, the rank's params, optimizer
state, cache and batch exactly as the traced step holds them (the
port's AdamW moments are its param shards', replicated over ``data``:
not ``opt_state_specs``' ZeRO split; params the port's mesh path reads
whole stay whole, ``specs.rank_params``), ``output_bytes`` and
``peak_bytes``, the high-water mark of live storage during the step.
Eager PyTorch has no temp or generated-code bytes.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs import (ARCHS, SHAPES, cell_status, get_config,
                                 model_kind)
from repro_torch.core import MuxSpec
from repro_torch.launch import specs as S
from repro_torch.launch.hlo_analysis import analyze, op_census, roofline_terms
from repro_torch.launch.mesh import HW, RecordingMesh, make_production_mesh
from repro_torch.models.config import active_param_count, param_count


def lower_cell(arch: str, shape_name: str, mesh, *, mux_n: int = 1,
               vocab_chunk: int = 0, use_kernels: bool = False):
    """Build one cell on ``mesh`` (a ``RecordingMesh``, or any mesh of this
    rank): the abstract state, this rank's shards of it and the step.
    Returns (step, its arguments, notes)."""
    sh = SHAPES[shape_name]
    mux = MuxSpec(n=mux_n)
    params = S.rank_params(S.abstract_params(arch, mux), arch, mesh)
    batch = S.input_specs(arch, shape_name, mux_n=mux_n)
    local = S.rank_batch(batch, mesh, n_mux=mux_n)
    notes = {"batch_rows": int(local["tokens"].shape[0]),
             "batch_split": local["tokens"].shape[0]
             != batch["tokens"].shape[0]}
    if sh.kind == "train":
        cfg = get_config(arch)
        opt = S.make_optimizer(pattern=len(cfg.block_pattern))
        opt_state = S.abstract_opt_state(params, opt)
        step = S.build_train_step(arch, mux=mux, optimizer=opt,
                                  vocab_chunk=vocab_chunk, mesh=mesh)
        return step, (params, opt_state, local), notes
    cache = S.rank_cache(S.abstract_cache(arch, shape_name, mux), arch, mesh)
    if sh.kind == "prefill":
        step = S.build_prefill(arch, mux=mux, use_kernels=use_kernels,
                               mesh=mesh)
    else:
        step = S.build_decode_step(arch, mux=mux, seq_len=sh.seq_len,
                                   mesh=mesh)
    return step, (params, cache, local), notes


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", *,
             mux_n: int = 1, vocab_chunk: int = 0, mesh_shape=None,
             use_kernels: bool = False) -> dict:
    """Trace one cell once under ``analyze`` and return its record.
    mesh_shape: {axis: size} in place of the production mesh of
    ``mesh_kind`` (a smaller recording mesh)."""
    status = cell_status(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mux_n": mux_n, "status": status}
    if status != "ok":
        return rec
    shape = mesh_shape or make_production_mesh(
        multi_pod=(mesh_kind == "multi"))
    mesh = RecordingMesh(shape)
    cfg = get_config(arch)
    t0 = time.time()
    try:
        step, args, notes = lower_cell(arch, shape_name, mesh, mux_n=mux_n,
                                       vocab_chunk=vocab_chunk,
                                       use_kernels=use_kernels)
        t_build = time.time() - t0
        with S.fake_mode():
            analysis = analyze(step, *args, mesh=mesh)
        t_trace = time.time() - t0 - t_build
        rl = roofline_terms(analysis, HW)
        n = param_count(cfg)
        na = active_param_count(cfg)
        sh = SHAPES[shape_name]
        tokens = sh.global_batch * (sh.seq_len if sh.kind in
                                    ("train", "prefill") else 1)
        mult = 6 if sh.kind == "train" else 2
        model_flops = mult * na * tokens          # global useful FLOPs
        flops_global = rl["flops"] * mesh.size    # per rank -> global
        rec.update({
            "t_build_s": round(t_build, 1),
            "t_trace_s": round(t_trace, 1),
            "chips": mesh.size,
            "mesh_shape": dict(shape),
            "kind": model_kind(arch),
            "params": n, "active_params": na,
            "cost": {"flops": analysis["flops"],
                     "bytes accessed": analysis["traffic_bytes"]},
            "memory": {k: analysis[k] for k in
                       ("argument_bytes", "output_bytes", "peak_bytes")},
            "batch": notes,
            "collectives": analysis["collectives"],
            "op_census": op_census(analysis),
            "roofline": rl,
            "model_flops": model_flops,
            "useful_flops_ratio": (model_flops / flops_global
                                   if flops_global else None),
        })
    except Exception as e:
        rec["status"] = f"error: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def fmt_row(r: dict) -> str:
    if not r["status"].startswith("ok"):
        return (f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
                f"{r['status'][:80]}")
    rl = r["roofline"]
    mem = r["memory"].get("peak_bytes") or 0
    return (f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
            f"N={r['mux_n']:<2d} "
            f"compute={rl['compute_s']*1e3:9.2f}ms "
            f"memory={rl['memory_s']*1e3:9.2f}ms "
            f"coll={rl['collective_s']*1e3:9.2f}ms "
            f"bound={rl['bottleneck']:10s} "
            f"peak={mem/1e9:6.2f}GB "
            f"useful={100*(r['useful_flops_ratio'] or 0):5.1f}% "
            f"[build {r['t_build_s']}s trace {r['t_trace_s']}s]")


def _parse_sets(items):
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="trace each cell once on fake tensors as one rank of "
                    "a production mesh (host only: no device is used)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mux-n", type=int, default=1)
    ap.add_argument("--vocab-chunk", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="jsonl output path")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override applied to every arch in this "
                         "run, e.g. --set moe_impl=local_group "
                         "--set rwkv_chunk=16 (a field the port's config "
                         "lacks is an error)")
    args = ap.parse_args(argv)
    overrides = _parse_sets(args.set)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if overrides:
        from repro_torch.configs.registry import set_overrides
        for arch in archs:
            set_overrides(arch, **overrides)

    recs = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                r = run_cell(arch, shape, mk, mux_n=args.mux_n,
                             vocab_chunk=args.vocab_chunk)
                recs.append(r)
                print(fmt_row(r), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")
    bad = [r for r in recs if r["status"].startswith("error")]
    print(f"\n{len(recs) - len(bad)}/{len(recs)} cells passed "
          f"({sum(1 for r in recs if r['status'].startswith('skip'))} "
          f"skipped by design)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
