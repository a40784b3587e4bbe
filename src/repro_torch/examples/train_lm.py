"""Train a reduced-config LM on synthetic tokens and watch the loss fall,
with a checkpoint and a resume from it (the fault-tolerance path).

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--arch h2o-danube-1.8b] [--steps 120] [--device cpu]

The counterpart of the reference's ``examples/train_lm.py``: the first
run trains ``--steps`` steps, checkpointing every 40; the second, as
after a preemption, resumes from the last checkpoint and trains 30 more.
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        common = ["--arch", args.arch, "--smoke", "--batch", "8",
                  "--seq", "256", "--lr", "1e-3", "--ckpt-dir", d,
                  "--ckpt-every", "40", "--device", args.device]
        print(f"== training {args.arch} (reduced config) for "
              f"{args.steps} steps ==")
        train_main(common + ["--steps", str(args.steps)])
        print("\n== simulated preemption: resuming from the checkpoint ==")
        train_main(common + ["--steps", str(args.steps + 30)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
