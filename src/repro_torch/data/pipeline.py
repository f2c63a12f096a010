"""Deterministic sharded synthetic-token pipeline with background prefetch.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy
only; batches equal the reference's bit for bit for the same (seed,
step)), with ``IGNORE`` from the port's ``training/train_step``.

Production framing without a dataset dependency: batches are generated
from a counter-based RNG keyed by (seed, step), so every restart/replay
reproduces the exact same stream — which is what makes the fault-
tolerance tests meaningful (loss curves continue bit-exactly after a
checkpoint restart).  The generator can also draw its seed material from
the D-RaNGe TRNG (pim entropy) for data-order randomization.

The LM task is synthetic-structured (not pure noise): token t+1 depends
on token t through a fixed random permutation plus noise, so models can
actually reduce loss — giving the end-to-end train example a learnable
signal.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.training.train_step import IGNORE


@dataclass
class PipelineConfig:
    seed: int = 0
    noise: float = 0.1          # fraction of random next-tokens
    prefetch: int = 2


class SyntheticLM:
    """Markov-ish synthetic LM stream."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 pipe: PipelineConfig = PipelineConfig()):
        self.cfg = cfg
        self.shape = shape
        self.pipe = pipe
        rng = np.random.default_rng(pipe.seed ^ 0xC0FFEE)
        self.vocab = min(cfg.vocab_size, 65536)
        self.perm = rng.permutation(self.vocab)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.pipe.seed, step))
        b, s = self.shape.global_batch, self.shape.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        noise_mask = rng.random((b, s)) < self.pipe.noise
        noise_tok = rng.integers(0, self.vocab, (b, s))
        for t in range(1, s):
            nxt = self.perm[toks[:, t - 1]]
            toks[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), IGNORE, np.int32)],
                                axis=1)
        batch = {"tokens": toks, "labels": labels}
        extra = modality_inputs(self.cfg, b, s, rng)
        batch.update(extra)
        if "patch_embeds" in extra:
            # patch positions are prepended by the model: shift labels
            npatch = extra["patch_embeds"].shape[1]
            batch["tokens"] = toks[:, : s - npatch]
            full_labels = np.full((b, s), IGNORE, np.int32)
            full_labels[:, npatch:] = labels[:, : s - npatch]
            batch["labels"] = full_labels
        if "frames" in extra:
            # encdec: seq budget split enc/dec (DESIGN.md SS6)
            batch["tokens"] = toks[:, : s // 2]
            batch["labels"] = labels[:, : s // 2]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def modality_inputs(cfg: ModelConfig, b: int, s: int,
                    rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """Stub frontend inputs (precomputed patch/frame embeddings)."""
    rng = rng or np.random.default_rng(0)
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "vlm" and cfg.num_patch_tokens:
        fd = cfg.frontend_dim or cfg.d_model
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patch_tokens, fd)).astype(np.float32)
    if cfg.family == "encdec":
        fd = cfg.frontend_dim or cfg.d_model
        out["frames"] = rng.standard_normal((b, s // 2, fd)).astype(np.float32)
    return out


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
