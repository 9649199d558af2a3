"""Roofline report of the port's dry run (counterpart of
``repro.launch.roofline``): read ``launch.dryrun`` jsonl records and emit
the per-cell three-term table, the bottleneck, the useful-FLOPs ratio
and what would move it.  Host only: no device is used.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        results/dryrun_torch.jsonl [--md results/roofline_torch.md]

The terms are one rank's on an NVIDIA H100 (``launch.mesh.HW``): FLOPs
at the bf16 tensor-core peak, eager op traffic at the HBM rate,
collective bytes at the NVLink rate.
"""
from __future__ import annotations

import argparse
import json


_SUGGEST = {
    "compute": ("compute-bound — already near the good regime; next savings"
                " come from cutting remat recompute or casting more matmuls"
                " to bf16"),
    "memory": ("memory-bound — cut HBM traffic: fuse the eager ops the "
               "step dispatches one by one (the port's hand-written "
               "kernels cover the serve path's entry, exit and attention), "
               "bf16 activations end to end, lower optimizer-state traffic "
               "(split the AdamW moments over data, as opt_state_specs' "
               "ZeRO layout does and the port's train step does not yet), "
               "or more work per step on each card (a bigger microbatch)"),
    "collective": ("collective-bound — change the sharding so the dominant"
                   " all_reduce / gather disappears: locality-aware MoE "
                   "dispatch, heads split where the model axis divides "
                   "them, fewer weight gathers, or collectives overlapped "
                   "with compute on their own stream"),
}


def load(path: str):
    recs = []
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    return recs


def row(r: dict) -> dict | None:
    if not r["status"].startswith("ok"):
        return None
    rl = r["roofline"]
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "mux_n": r.get("mux_n", 1),
        "compute_ms": rl["compute_s"] * 1e3,
        "memory_ms": rl["memory_s"] * 1e3,
        "collective_ms": rl["collective_s"] * 1e3,
        "bottleneck": rl["bottleneck"],
        "model_flops": r.get("model_flops"),
        "useful_ratio": r.get("useful_flops_ratio"),
        "peak_gb": (r["memory"].get("peak_bytes") or 0) / 1e9,
        "suggest": _SUGGEST[rl["bottleneck"]],
    }


def format_md(recs) -> str:
    lines = [
        "| arch | shape | mesh | N | compute | memory | collective | "
        "bound | useful FLOPs | peak/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        d = row(r)
        if d is None:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - |"
                f" - | {r['status'][:60]} | - | - |")
            continue
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['mux_n']} "
            f"| {d['compute_ms']:.1f}ms | {d['memory_ms']:.1f}ms "
            f"| {d['collective_ms']:.1f}ms | **{d['bottleneck']}** "
            f"| {100 * (d['useful_ratio'] or 0):.0f}% "
            f"| {d['peak_gb']:.2f}GB |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    recs = load(args.jsonl)
    md = format_md(recs)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")
    # summary of bottlenecks
    from collections import Counter
    c = Counter(r["roofline"]["bottleneck"] for r in recs
                if r["status"].startswith("ok"))
    print("\nbottleneck census:", dict(c))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
