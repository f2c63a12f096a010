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

Data parallelism (``--data-axis N`` with ``--backend gloo|nccl``):
``launch.mesh.run_ranks`` starts N ranks on this host under a time
limit (``--rank-timeout``), one process each, over the named backend
(NCCL takes one card a rank and refuses more ranks than cards; gloo
runs on the CPU, or shares the card).  As the JAX launcher does, every
rank trains under ``sharding_env(mesh, fsdp=True)``: the ZeRO-3 layout,
each leaf of the parameters and of the optimizer state this rank's
slice of its FSDP dim (drawn whole from the same seed, then cut), the
forward gathering each leaf where it is used and the backward
reduce-scattering its gradient (``training/train_step``).  Each rank
takes its contiguous block of ``SyntheticLM``'s global batch, and the
ranks' gradients are summed in float32 weighted by their token counts
before the clip, so the losses are those of the global batch.  Every
rank joins a checkpoint's gathers, one leaf at a time, and rank 0
writes it in the one-device layout; a restart reads it back into each
rank's slices.  Rank 0 prints; the ``Supervisor`` runs on every rank,
so an injected failure restarts every rank from the checkpoint.
``compressed_grad_sync`` (``distributed/compression``) is a library
function, as in the JAX package, which the launcher does not call.
``main(argv)`` returns the printed summary with the loss of every step
run (``losses``, by step; rank 0's under ``--data-axis``).
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
from repro_torch.distributed.sharding import sharding_env
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count
from repro_torch.runtime.fault_tolerance import FailureInjector, Supervisor
from repro_torch.training.train_step import make_train_step, state_shards


class _RankCheckpointer:
    """A rank's view of the one checkpoint directory: rank 0 writes
    (every rank joins the gathers of a ZeRO-3 state's ``shards``),
    every rank reads, and :meth:`wait` (the ``Supervisor`` calls it
    before a restart reads the latest step, and at the end) lets no
    rank past until rank 0's writes have landed."""

    def __init__(self, ckpt: Checkpointer, mesh, shards=None) -> None:
        self.ckpt = ckpt
        self.mesh = mesh
        self.shards = shards

    def save(self, step: int, state) -> None:
        if self.shards is not None:
            self.ckpt.save(step, state, shards=self.shards)
        elif self.mesh.rank == 0:
            self.ckpt.save(step, state)

    def wait(self) -> None:
        self.ckpt.wait()
        self.mesh.barrier()

    def latest_step(self):
        return self.ckpt.latest_step()

    def load(self, state):
        return self.ckpt.load(state, shards=self.shards)


def _parser() -> argparse.ArgumentParser:
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
                    help="data-parallel ranks (0 or 1: one process)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend of --data-axis > 1")
    ap.add_argument("--rank-timeout", type=float, default=3600.0,
                    help="seconds the ranks of --data-axis > 1 may run")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = _parser()
    args = ap.parse_args(argv)
    world = max(args.data_axis, 1)
    if world > 1:
        if args.backend is None:
            ap.error("--data-axis above 1 needs --backend gloo or nccl")
        if args.batch % world:
            ap.error(f"--batch {args.batch} does not split over "
                     f"--data-axis {world}")
    ckpt_dir = args.ckpt_dir
    if not args.resume and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        # fresh run: never resume from a stale (possibly different-
        # config) checkpoint tree
        n = 1
        while os.path.isdir(f"{ckpt_dir}.run{n}"):
            n += 1
        ckpt_dir = f"{ckpt_dir}.run{n}"
        print(f"checkpoint dir in use; starting fresh at {ckpt_dir}")
    if world == 1:
        return _train(args, ckpt_dir)
    return run_ranks(_train_rank, world, backend=args.backend,
                     args=(args, ckpt_dir), timeout=args.rank_timeout)[0]


def _train_rank(rank: int, world: int, args, ckpt_dir: str) -> Dict:
    return _train(args, ckpt_dir, mesh=make_local_mesh(data=world))


def _train(args, ckpt_dir: str, mesh=None) -> Dict:
    """The training run of one process (one rank of ``mesh``, under the
    ZeRO-3 layout)."""
    if mesh is None:
        return _run(args, ckpt_dir)
    with sharding_env(mesh, fsdp=True):
        return _run(args, ckpt_dir, mesh)


def _run(args, ckpt_dir: str, mesh=None) -> Dict:
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = (mesh.rank, mesh.shape["data"]) if mesh else (0, 1)
    say = print if rank == 0 else (lambda *a, **k: None)
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
    say(f"arch={cfg.name} params={param_count(defs):,} device={dev} "
        f"ranks={world}")
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.float32, mesh=mesh)
    init_state, step_fn = make_train_step(cfg, pcfg, ocfg, mesh=mesh)
    state = init_state(params)
    del params
    shards = (state_shards(state, step_fn.layout)
              if step_fn.layout is not None else None)

    data = SyntheticLM(cfg, shape, PipelineConfig(seed=1))
    per = args.batch // world

    def batch_fn(step):
        # this rank's contiguous block of the global batch
        return {k: v[rank * per:(rank + 1) * per]
                for k, v in data.batch(step).items()}

    ckpt = Checkpointer(ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.load(state, shards=shards)
        say(f"resumed from step {start}")
    if mesh is not None:
        ckpt = _RankCheckpointer(ckpt, mesh, shards)

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
            say(f"step {n:5d} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.2f} tok/s {tps:,.0f}")
        return st, metrics

    state, report = sup.run(state, wrapped_step, batch_fn, args.steps,
                            start_step=start)
    summary = {
        "steps_run": report.steps_run, "restarts": report.restarts,
        "resumed_from": report.resumed_from,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
    }
    say(json.dumps(summary, indent=1))
    return dict(summary, losses=report.losses)


if __name__ == "__main__":
    main()
