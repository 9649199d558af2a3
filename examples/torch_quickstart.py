"""Quickstart of the PyTorch port: attach data multiplexing (MUX-PLM) to
a model of the zoo, on an NVIDIA GPU (or the CPU with ``--device cpu``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card the throughput line's times are CUDA-event times of the
forward; on the CPU they are the host clock's.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import MuxSpec
from repro_torch.models import TransformerLM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    # 1. pick an architecture (any of the ten ids) + a mux level
    cfg = get_config("qwen2-1.5b", reduced=True)   # reduced fits anywhere
    mux = MuxSpec(n=4, mux_kind="gaussian", demux_kind="rsa")

    # 2. init: the MuxEngine params live alongside the backbone
    gen = torch.Generator(device=dev).manual_seed(0)
    params = TransformerLM.init(gen, cfg, mux)

    # 3. forward: N*B instances in, N*B logit streams out, but the backbone
    #    only runs B sequences (the throughput win)
    tokens = torch.randint(4, cfg.vocab_size, (8, 32), generator=gen,
                           device=dev)                     # 8 = 4 x 2

    def fwd(p, spec):
        with torch.no_grad():
            return TransformerLM.apply(p, cfg, tokens, mux=spec,
                                       dtype=torch.float32)["logits"]

    out = fwd(params, mux)
    print(f"in : {tuple(tokens.shape)}  (N={mux.n} instances x backbone "
          f"batch {tokens.shape[0] // mux.n})")
    print(f"out: {tuple(out.shape)}  (one logit stream per instance)")

    # 4. throughput: same instance count, mux vs vanilla
    vanilla = TransformerLM.init(torch.Generator(device=dev).manual_seed(0),
                                 cfg)

    def timed(p, spec, iters=10):
        fwd(p, spec)                                       # warm-up
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fwd(p, spec)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            fwd(p, spec)
        return time.perf_counter() - t0

    t_mux = timed(params, mux)
    t_van = timed(vanilla, MuxSpec())
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"throughput: mux N={mux.n} is {t_van / t_mux:.2f}x vanilla "
          f"(same {tokens.shape[0]} instances per call; {clock})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
