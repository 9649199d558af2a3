"""Training launcher of the port (counterpart of ``repro.launch.train``):
the paper's MUX-BERT training, or a causal LM, end to end on one device.

    # MUX-BERT-base on the synthetic corpus: retrieval warm-up, then MLM
    python -m repro_torch.launch.train --model mux-bert-base --mux-n 2 \\
        --steps 300 --batch 32 --seq 128 --ckpt build/ckpt

    # a reduced served architecture as a causal LM
    python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 50

The flags and defaults are the reference's, plus ``--device`` (``cuda``
unless the caller names the CPU; no card raises).  ``--model
mux-bert-{small,base,large}`` or ``mux-electra-base`` trains
``MuxBERT`` at the launcher's synthetic vocabulary (``--vocab``, 512);
``--arch`` trains one of the served decoder-only LMs (the MoE ones with
their routers' aux loss, weighted by ``router_aux_weight``; for
``llava-next-mistral-7b`` its text backbone, a ``TransformerLM`` on the
VLM's config, as the reference's) on ``MarkovCorpus`` at the config's
vocabulary, whose (V - 4)² float64 CDF is refused above 8 GiB (every
full config but the two at vocabulary 32000, h2o-danube-1.8b and
llava-next-mistral-7b: 8.2 GB).  Both run through
``Supervisor`` with async checkpoints and straggler detection, on the
plain model path (``use_kernels=False``: the kernels have no backward),
in fp32 with TF32 off, and print the reference's stage lines and
``done.``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import MuxSpec
from repro_torch.data import MarkovCorpus, ShardedLoader
from repro_torch.models import MuxBERT, TransformerLM, bert_config
from repro_torch.models.config import param_count
from repro_torch.optim import AdamW, linear_warmup_cosine_decay
from repro_torch.runtime import StragglerDetector, Supervisor
from repro_torch.serve.runtime import resolve_device
from repro_torch.train import causal_lm_loss, make_train_step
from repro_torch.train.mux_stages import mlm_stage, retrieval_stage

MODELS = ("mux-bert-small", "mux-bert-base", "mux-bert-large",
          "mux-electra-base")
CORPUS_CDF_LIMIT = 8 << 30      # bytes of MarkovCorpus's float64 CDF


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """The generator of step ``i`` (the reference folds i into its key)."""
    s = int(np.random.SeedSequence((seed, i)).generate_state(1)[0])
    return torch.Generator(device).manual_seed(s)


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train MUX-BERT (three-stage) or a causal LM.")
    ap.add_argument("--model", default=None,
                    help="mux-bert-{small,base,large} | mux-electra-base")
    ap.add_argument("--arch", default=None, help="served arch id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mux-n", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--xla-async", action="store_true",
                    help="the reference's TPU runtime flag; nothing here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card raises) or cpu")
    return ap


def _check(ap, args):
    if args.arch is None:
        if (args.model or "mux-bert-base") not in MODELS:
            ap.error(f"--model {args.model!r}: one of {MODELS}")
        return
    if args.arch == "whisper-small":
        ap.error("--arch whisper-small: an encoder-decoder; the causal-LM "
                 "trainer takes decoder-only LMs (the reference's builds a "
                 "TransformerLM for it and fails)")
    if args.arch in MODELS:
        ap.error(f"--arch {args.arch}: a paper model; use --model")
    if args.arch not in ARCHS:
        ap.error(f"--arch {args.arch!r}: the port trains {ARCHS}")
    v = get_config(args.arch, reduced=args.reduced).vocab_size - 4
    if 8 * v * v > CORPUS_CDF_LIMIT:
        ap.error(f"--arch {args.arch} at vocab {v + 4}: MarkovCorpus's "
                 f"(V - 4)² float64 CDF is {8 * v * v / 1e9:.0f} GB; pass "
                 "--reduced")


def main(argv=None, *, out: dict | None = None) -> int:
    """Run the launcher.  ``out``: a dict that receives ``stages`` (one
    dict per stage: name, steps, history, host seconds and ``step_ms``,
    each step's time between CUDA events on a card, by the host clock
    elsewhere) and the trained ``params``, ``opt_state``, ``cfg`` and
    ``mux``."""
    ap = _parser()
    args = ap.parse_args(argv)
    _check(ap, args)
    dev = resolve_device(args.device)

    mux = MuxSpec(n=args.mux_n)
    gen = torch.Generator(dev).manual_seed(args.seed)
    if args.arch:
        cfg = get_config(args.arch, reduced=args.reduced)
        params = TransformerLM.init(gen, cfg, mux)

        def loss_fn(p, batch, generator):
            out = TransformerLM.apply(p, cfg, batch["tokens"], mux=mux,
                                      dtype=torch.float32, use_kernels=False)
            loss = causal_lm_loss(out["logits"], batch["tokens"])
            if cfg.moe is not None:      # the routers' load-balancing loss
                loss = loss + cfg.moe.router_aux_weight * out["aux"]
            return loss, {}
        stages = [("lm", loss_fn, args.steps)]
    else:
        name = args.model or "mux-bert-base"
        cfg = bert_config(name.split("-")[-1], vocab_size=args.vocab,
                          max_seq_len=args.seq)
        params = MuxBERT.init(gen, cfg, mux, electra="electra" in name)
        stages = [
            ("retrieval-warmup", retrieval_stage(cfg, mux),
             args.warmup_steps),
            ("mlm-pretrain", mlm_stage(cfg, mux), args.steps),
        ]

    print(f"model: {cfg.name}  params={param_count(cfg)/1e6:.1f}M  "
          f"mux N={mux.n}  devices=1 ({dev.type})")

    opt = AdamW(lr=linear_warmup_cosine_decay(
        args.lr, max(args.steps // 10, 10), args.steps),
        pattern=len(cfg.block_pattern))
    opt_state = opt.init(params)

    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=args.seed)
    loader = ShardedLoader(
        lambda rng, b, l: {"tokens": corpus.sample(rng, b, l)},
        args.batch, args.seq, seed=args.seed)

    ckpt = AsyncCheckpointManager(
        args.ckpt or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
        keep_k=3)
    on_card = dev.type == "cuda"

    def mark():
        """A step boundary: a recorded CUDA event on a card, the host clock
        elsewhere."""
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def between(a, b):
        return a.elapsed_time(b) if on_card else 1000 * (b - a)

    for stage_name, loss_fn, n_steps in stages:
        print(f"--- stage: {stage_name} ({n_steps} steps) ---")
        step = make_train_step(loss_fn, opt)
        marks = [mark()]

        def step_wrap(state, batch, i, step=step, marks=marks):
            p, o = state
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            p, o, m = step(p, o, batch, step_generator(args.seed, i, dev))
            marks.append(mark())
            return (p, o), m

        sup = Supervisor(step_fn=step_wrap, ckpt=ckpt,
                         checkpoint_every=max(n_steps // 3, 20),
                         straggler=StragglerDetector())
        t0 = time.time()
        (params, opt_state), hist = sup.run((params, opt_state),
                                            iter(loader), n_steps)
        metrics = [h for h in hist if "loss" in h]
        if metrics:
            float(metrics[-1]["loss"])          # waits for the device
        dt = time.time() - t0
        if metrics:
            print(f"    steps={len(metrics)}  "
                  f"loss {float(metrics[0]['loss']):.4f} -> "
                  f"{float(metrics[-1]['loss']):.4f}  "
                  f"({dt:.0f}s, {1000*dt/max(len(metrics),1):.0f} ms/step,"
                  f" stragglers={len(sup.straggler.events)})")
        if out is not None:
            out.setdefault("stages", []).append({
                "stage": stage_name, "steps": n_steps, "history": hist,
                "seconds": dt,
                "step_ms": [between(a, b) for a, b in zip(marks, marks[1:])]})
    ckpt.wait()
    if out is not None:
        out.update(params=params, opt_state=opt_state, cfg=cfg, mux=mux)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
