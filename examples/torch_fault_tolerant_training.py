"""Fault tolerance on the PyTorch port: inject a device failure
mid-training and watch the supervisor restore the last checkpoint and
finish the run; then plan an elastic shrink onto fewer devices.  On an
NVIDIA GPU, or the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/torch_fault_tolerant_training.py \\
        [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import AsyncCheckpointManager
from repro_torch.core import MuxSpec
from repro_torch.data import MarkovCorpus, ShardedLoader
from repro_torch.models.bert import MuxBERT, bert_config
from repro_torch.optim import AdamW
from repro_torch.runtime import DeviceFailure, Supervisor, plan_elastic
from repro_torch.train import jit_step, make_train_step
from repro_torch.train.mux_stages import mlm_stage


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = bert_config("small", n_layers=2, d_model=64, n_heads=4, d_ff=128,
                      vocab_size=256, max_seq_len=32)
    mux = MuxSpec(n=2)
    params = MuxBERT.init(torch.Generator(device=dev).manual_seed(0), cfg,
                          mux)
    opt = AdamW(lr=1e-3)
    opt_state = opt.init(params)

    corpus = MarkovCorpus(vocab_size=256, seed=0)
    loader = ShardedLoader(
        lambda rng, b, l: {"tokens": corpus.sample(rng, b, l)}, 16, 32)
    step = jit_step(make_train_step(mlm_stage(cfg, mux), opt))

    def step_fn(state, batch, i):
        p, o = state
        gen = torch.Generator(device=dev).manual_seed(i)
        p, o, m = step(p, o, {k: torch.as_tensor(v, device=dev)
                              for k, v in batch.items()}, gen)
        return (p, o), m

    armed = {"on": True}

    def fault(step_i):
        if step_i == 25 and armed["on"]:
            armed["on"] = False
            print(f"!!! injected device failure at step {step_i}")
            raise DeviceFailure("slice 2 heartbeat lost")

    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(step_fn=step_fn, ckpt=AsyncCheckpointManager(d),
                         checkpoint_every=10, fault_hook=fault)
        state, hist = sup.run((params, opt_state), iter(loader), 40)
        restarts = [h for h in hist if h.get("event") == "restart"]
        print(f"finished 40 steps with {len(restarts)} restart(s); "
              f"restored from step {restarts[0]['at_step']}")

    # elastic: plan a shrink from 512 -> 384 surviving devices
    plan = plan_elastic(384, model_parallel=16, old_global_batch=256)
    print(f"elastic plan after losing 128 devices: mesh={plan.mesh_shape}, "
          f"batch {256} -> {plan.global_batch}, dropped={plan.dropped}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
