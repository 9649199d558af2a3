"""Serve a small model through the PyTorch port's ServeRuntime, on an
NVIDIA GPU (or the CPU with ``--device cpu``).

Builds a reduced mux'd LM, submits a handful of requests with mixed
per-stream sampling policies (greedy next to nucleus sampling), and
drives the runtime step by step: prompts prefill in fixed-size chunks
interleaved with decode over the paged KV pool, and every request's
tokens come back.

    PYTHONPATH=src python examples/torch_serve_mux.py [--device cpu]

Any other argument switches to the full launcher CLI
(``repro_torch.launch.serve``) instead, e.g. the ring baseline or larger
sweeps; ``--paged`` is shorthand for ``--continuous --cache paged`` (with
``--block-size 4`` unless given):

    PYTHONPATH=src python examples/torch_serve_mux.py --continuous \\
        --cache ring --requests 8
    PYTHONPATH=src python examples/torch_serve_mux.py --paged --requests 6

Width lanes (one paged runtime per mux width, requests routed by SLO
class and lane load):

    PYTHONPATH=src python examples/torch_serve_mux.py --paged \\
        --lanes 1,4,8 --slo-mix latency=0.25,balanced=0.5,throughput=0.25 \\
        --requests 9
"""
import sys

import numpy as np
import torch


def runtime_demo(device="cuda"):
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.models import TransformerLM
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.runtime import ServeRuntime
    from repro_torch.serve.sampling import SamplingParams

    arch, mux_n, rows = "gemma-2b", 2, 2
    cfg = get_config(arch, reduced=True)
    mux = MuxSpec(n=mux_n)
    params = TransformerLM.init(
        torch.Generator(device=device).manual_seed(0), cfg, mux)
    sc = ServeConfig(cfg=cfg, kind="lm", mux=mux, capacity=32,
                     dtype=torch.float32, cache_layout="paged", block_size=4)

    rt = ServeRuntime(params, sc, rows, chunk=8, device=device)
    rng = np.random.default_rng(0)
    policies = [None,                                       # greedy
                SamplingParams(temperature=0.8, top_k=16, seed=1),
                SamplingParams(temperature=1.0, top_p=0.9, seed=2),
                None]
    for uid, sp in enumerate(policies):
        prompt = rng.integers(4, cfg.vocab_size,
                              size=(int(rng.integers(5, 14)),))
        rt.submit(Request(uid=uid, prompt=[int(t) for t in prompt],
                          max_new=6, sampling=sp))

    while rt.has_work():
        rt.step()

    for r in sorted(rt.stats["completed"], key=lambda r: r.uid):
        mode = ("greedy" if r.sampling is None else
                f"T={r.sampling.temperature} k={r.sampling.top_k} "
                f"p={r.sampling.top_p}")
        print(f"request {r.uid} [{mode}] prompt[:4]={r.prompt[:4]} "
              f"-> {r.output}")
    s = rt.stats
    print(f"prefill {s['prefill_tokens']} tokens "
          f"({s['prefill_compute_tokens']} padded) in "
          f"{s['prefill_events']} chunks; {s['decode_steps']} decode steps")
    print("step signatures:",
          ", ".join(f"{k}×{v}" for k, v in sorted(s["trace_counts"].items())))
    return 0


def launcher_argv(argv):
    """``argv`` with ``--paged`` expanded (composable with other flags)."""
    if "--paged" in argv:
        i = argv.index("--paged")
        expansion = ["--continuous", "--cache", "paged"]
        if "--block-size" not in argv:
            expansion += ["--block-size", "4"]
        argv = argv[:i] + expansion + argv[i + 1:]
    return argv


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    demo = [a for a in argv if a not in ("--device", "cpu", "cuda")]
    if not demo:                  # the demo, on the card unless told
        device = argv[argv.index("--device") + 1] if "--device" in argv \
            else "cuda"
        if device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        return runtime_demo(device)
    from repro_torch.launch.serve import main as serve_main
    return serve_main(launcher_argv(argv))


if __name__ == "__main__":
    raise SystemExit(main())
