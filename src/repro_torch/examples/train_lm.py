"""End-to-end driver: train a small LM for a few hundred steps on the
synthetic-structured stream, with checkpointing and an injected failure
mid-run (the supervisor restarts from the latest checkpoint and the loss
curve continues).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--steps 200] [--device cpu]

A shim over ``repro_torch.launch.train.main`` with the JAX package's
``examples/train_lm.py`` arguments (stablelm-3b reduced to width 256
and 6 layers, batch 8 x 128, a failure injected at step 110); any
argument given here overrides them.  Without ``--device`` it needs the
CUDA card.
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main

ARGS = ["--arch", "stablelm-3b", "--reduced",
        "--width", "256", "--layers", "6",
        "--steps", "220", "--batch", "8", "--seq", "128",
        "--lr", "1e-3",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_train_lm"),
        "--ckpt-every", "50", "--fail-at", "110",
        "--log-every", "20"]

if __name__ == "__main__":
    main(ARGS + sys.argv[1:])
