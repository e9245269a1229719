"""Train a ~100M-param LM for a few hundred steps (an end-to-end example).

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--small]

Uses the production launcher code path (train-step construction, grad
accumulation, deterministic data, checkpointing, straggler log) on the
card, or on the CPU with ``--device cpu``. `--small` (the default)
trains a down-scaled model so the example finishes in minutes; `--full`
trains the ~100M config.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch import train as train_launcher
from repro_torch.launch.measure_profile import smi_line
from repro_torch.models.layers import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--small", action="store_true", default=True)
ap.add_argument("--full", dest="small", action="store_false",
                help="~100M params (slow on the CPU)")
ap.add_argument("--checkpoint-dir",
                default=os.path.join(tempfile.gettempdir(),
                                     "repro_torch_train_lm"))
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# qwen2-1.5b reduced is the small config; the full ~100M variant scales
# width/depth up but stays CPU-feasible for a few hundred steps.
argv = ["--arch", "qwen2-1.5b", "--steps", str(args.steps),
        "--checkpoint-dir", args.checkpoint_dir, "--log-every", "10",
        "--device", args.device]
if args.small:
    argv += ["--reduced"]
else:
    argv += ["--seq-len", "512", "--global-batch", "8"]

if resolve_device(args.device).type == "cuda":
    # the card that the step times of the launcher's log lines are for
    print(smi_line(), flush=True)
sys.exit(train_launcher.main(argv))
