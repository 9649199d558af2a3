"""End-to-end driver of the PyTorch port: three-stage MUX-BERT training
(retrieval warm-up, multiplexed MLM pre-training, fine-tuning), the
paper's Figure 1 pipeline, on an NVIDIA GPU (``--device cpu`` for the
CPU).

    PYTHONPATH=src python examples/torch_train_mux_bert.py   # fast demo
    PYTHONPATH=src python examples/torch_train_mux_bert.py --steps 300
    PYTHONPATH=src python examples/torch_train_mux_bert.py --device cpu \\
        --warmup-steps 3 --steps 3

Any flag of ``repro_torch.launch.train`` may be given; the demo's
defaults fill in those not given.
"""
import sys

from repro_torch.launch.train import main

DEMO = {"--model": "mux-bert-small", "--mux-n": "2", "--warmup-steps": "60",
        "--steps": "120", "--batch": "16", "--seq": "32", "--vocab": "256"}


def demo_argv(argv):
    """``argv`` with each demo flag it does not set appended."""
    given = {a.split("=", 1)[0] for a in argv if a.startswith("--")}
    out = list(argv)
    for flag, value in DEMO.items():
        if flag not in given:
            out += [flag, value]
    return out


if __name__ == "__main__":
    raise SystemExit(main(demo_argv(sys.argv[1:])))
