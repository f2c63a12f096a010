"""Fault tolerance: supervised training loop with checkpoint/restart,
failure injection, heartbeat/straggler detection and elastic restart.

The port's own copy of the JAX package's ``runtime/fault_tolerance.py``
(it touches no framework: ``step_fn`` and the checkpointer bring
their own).

Single-process embodiment of the multi-pod control plane:

* **Supervisor** — runs the step loop, checkpoints every N steps
  (async), catches worker failures (``FailureInjector`` simulates chip /
  host loss) and restarts from the latest checkpoint; the data pipeline
  is counter-keyed so replayed steps are bit-identical.
* **HeartbeatMonitor** — per-step wall-time heartbeats; a step slower
  than ``straggler_factor`` x rolling median flags a straggler (at pod
  scale this triggers requeue-on-spare; here it is recorded and
  surfaced in the step log).
* **Elastic restart** — checkpoints are device-agnostic (see
  `repro_torch.checkpoint`), so the supervisor can be re-launched on
  another device and resume; tested in tests/test_torch_train_loop.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise at given steps (once each) to simulate node loss."""

    fail_at: List[int] = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class HeartbeatMonitor:
    straggler_factor: float = 3.0
    window: int = 32
    durations: List[float] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    last_beat: float = field(default_factory=time.monotonic)

    def beat(self, step: int) -> bool:
        now = time.monotonic()
        dur = now - self.last_beat
        self.last_beat = now
        self.durations.append(dur)
        hist = self.durations[-self.window:]
        med = float(np.median(hist[:-1])) if len(hist) > 4 else None
        is_straggler = med is not None and dur > self.straggler_factor * med
        if is_straggler:
            self.stragglers.append(step)
        return is_straggler


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    resumed_from: List[int] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    losses: Dict[int, float] = field(default_factory=dict)


class Supervisor:
    """Run `num_steps` of `step_fn` with checkpoint/restart supervision.

    step_fn(state, batch) -> (state, metrics); batch_fn(step) -> batch.
    """

    def __init__(self, checkpointer, *, ckpt_every: int = 10,
                 max_restarts: int = 5,
                 injector: Optional[FailureInjector] = None):
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector or FailureInjector()
        self.monitor = HeartbeatMonitor()

    def run(self, state: Any, step_fn: Callable, batch_fn: Callable,
            num_steps: int, start_step: int = 0) -> (Any, SupervisorReport):
        report = SupervisorReport()
        step = start_step
        restarts = 0
        while step < num_steps:
            try:
                self.injector.check(step)
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                if self.monitor.beat(step):
                    report.stragglers.append(step)
                loss = metrics.get("loss")
                if loss is not None:
                    report.losses[step] = float(loss)
                report.steps_run += 1
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except InjectedFailure:
                restarts += 1
                report.restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step  # cold restart
                    continue
                state, step = self.ckpt.load(state)
                report.resumed_from.append(step)
        self.ckpt.wait()
        return state, report
