"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --steps 200 --batch 8 --seq 256 [--device cpu]

The port's counterpart of the JAX package's ``launch/train.py``, with
the same flags plus ``--device`` (default: the CUDA card).  The model is
``--arch`` (gemma-2b by default; ``--reduced`` cuts it to ``--width`` /
``--layers`` and a 4096-token vocab), with float32 master weights drawn
from a seeded generator on the device, remat "full", chunked attention
in tiles of ``min(512, seq)`` and the dense MoE, as the JAX launcher's
``ParallelConfig`` sets them; AdamW over the synthetic-structured
stream (``data/pipeline.SyntheticLM``), checkpoints every
``--ckpt-every`` steps and a ``Supervisor`` that restarts from the
latest one after an injected failure (``--fail-at``).

One device and no mesh: ``--data-axis`` above 1 is refused (data
parallelism and ``compressed_grad_sync`` come with tensor-parallel
serving, ROADMAP Queue 1 item 13).  ``main(argv)`` returns the printed
summary with the loss of every step run (``losses``, by step).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import (ARCHS, OptimizerConfig, ParallelConfig,
                                 ShapeConfig, reduced)
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count
from repro_torch.runtime.fault_tolerance import FailureInjector, Supervisor
from repro_torch.training.train_step import make_train_step


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject node failures at these steps (FT demo)")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="data-parallel size (0 or 1: the one device)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.data_axis > 1:
        ap.error(f"--data-axis {args.data_axis}: data parallelism is not "
                 "ported yet (ROADMAP Queue 1, item 13); the port trains "
                 "on one device")

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg, d_model=args.width, num_layers=args.layers,
                      d_ff=args.width * 4, vocab_size=4096)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    pcfg = ParallelConfig(remat="full", attention_impl="chunked",
                          attention_chunk=min(512, args.seq),
                          moe_impl="dense")
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps)

    defs = T.model_defs(cfg)
    print(f"arch={cfg.name} params={param_count(defs):,} device={dev}")
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.float32)
    init_state, step_fn = make_train_step(cfg, pcfg, ocfg)
    state = init_state(params)

    data = SyntheticLM(cfg, shape, PipelineConfig(seed=1))
    ckpt_dir = args.ckpt_dir
    if not args.resume and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        # fresh run: never resume from a stale (possibly different-
        # config) checkpoint tree
        n = 1
        while os.path.isdir(f"{ckpt_dir}.run{n}"):
            n += 1
        ckpt_dir = f"{ckpt_dir}.run{n}"
        print(f"checkpoint dir in use; starting fresh at {ckpt_dir}")
    ckpt = Checkpointer(ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.load(state)
        print(f"resumed from step {start}")

    sup = Supervisor(ckpt, ckpt_every=args.ckpt_every,
                     injector=FailureInjector(fail_at=args.fail_at))
    t0 = time.time()
    losses = []

    def wrapped_step(st, batch):
        st, metrics = step_fn(st, {k: torch.from_numpy(v).to(dev)
                                   for k, v in batch.items()})
        metrics = {k: float(v) for k, v in metrics.items()}
        losses.append(metrics["loss"])
        n = len(losses)
        if n % args.log_every == 0:
            tps = n * shape.tokens / (time.time() - t0)
            print(f"step {n:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.2f} tok/s {tps:,.0f}")
        return st, metrics

    state, report = sup.run(state, wrapped_step, data.batch, args.steps,
                            start_step=start)
    summary = {
        "steps_run": report.steps_run, "restarts": report.restarts,
        "resumed_from": report.resumed_from,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
    }
    print(json.dumps(summary, indent=1))
    return dict(summary, losses=report.losses)


if __name__ == "__main__":
    main()
