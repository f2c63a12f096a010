"""PiM Operations Controller (POC).

The POC is PiDRAM's hardware component ①: it exposes memory-mapped
*instruction*, *data* and *flag* registers to the CPU, decodes PiDRAM
instructions, and drives the memory controller.  The handshake protocol
(paper Fig. 2) is preserved exactly:

  1. CPU stores instruction word       -> instruction register
  2. CPU stores Start=1                -> flag register
  3. POC forwards op to memory ctrl, sets Start=0, Ack=1
  4. memory controller issues the (violated-timing) command sequence
  5. controller sets Fin=1 when the last command is issued
  6. CPU polls Ack (non-blocking start) or Fin (blocking completion)
  7. CPU loads result (if any)          <- data register

A copy of the JAX package's ``core/poc.py`` for the port (numpy and
the stdlib only; every latency is the simulated prototype's).  On the
card the same protocol fronts the asynchronous kernel launches (CUDA
launches are async; ``Blocking.FIN`` synchronises the card), so pimolib
code is identical across both substrates.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from . import op_registry
from .isa import Instruction, Opcode
from .memctrl import MemoryController, SequenceResult


@dataclass
class FlagRegister:
    start: bool = False
    ack: bool = False
    fin: bool = False


@dataclass
class PocStats:
    executed: Dict[str, int] = field(default_factory=lambda: collections.defaultdict(int))
    busy_ns: float = 0.0


class PimOpsController:
    """Decode/execute PiDRAM instructions against a memory controller."""

    def __init__(self, mc: MemoryController, data_buffer_words: int = 64) -> None:
        self.mc = mc
        self.instruction_reg: int = 0
        self.data_reg: int = 0
        self.flags = FlagRegister()
        self.stats = PocStats()
        # D-RaNGe random-number buffer (hardware component in the paper's
        # D-RaNGe extension): the scheduler deposits generated bits here.
        self.rng_buffer: Deque[int] = collections.deque(maxlen=data_buffer_words * 64)
        # Batched dispatch: pimolib can stage a whole instruction sequence
        # and trigger it with ONE Start (one handshake for the batch) —
        # the ComputeDRAM batched-command-sequence model.  None = no batch
        # staged (an EMPTY staged batch is a valid no-op, distinct from
        # falling back to the single instruction register).
        self.insn_buffer: Optional[List[int]] = None
        self._last_result: Optional[SequenceResult] = None

    # -------------------- CPU-visible register interface ---------------- #

    def store_instruction(self, word: int) -> None:
        self.instruction_reg = word

    def store_instruction_buffer(self, words: List[int]) -> None:
        """Stage a batch of instruction words; the next Start executes
        them all under a single Ack/Fin handshake."""
        self.insn_buffer = list(words)

    def store_start(self) -> None:
        """CPU sets Start; POC decodes + executes synchronously in the
        model (the timing model accounts latency; see memctrl).  If an
        instruction batch is staged, the whole batch runs before Fin."""
        self.flags.start = True
        if self.insn_buffer is not None:
            self._execute_batch()
        else:
            self._execute()

    def load_flags(self) -> FlagRegister:
        return self.flags

    def load_data(self) -> int:
        return self.data_reg

    # -------------------- execution ------------------------------------- #

    def _execute(self) -> None:
        insn = Instruction.decode(self.instruction_reg)
        self.flags.start = False
        self.flags.ack = True
        self.flags.fin = False

        t0 = self.mc.now_ns
        spec = op_registry.get_op(insn.opcode)
        if insn.opcode is Opcode.NOP:
            res = SequenceResult(0.0, [])
        elif insn.opcode is Opcode.READ_BUF:
            # Register-file op, not a command sequence: drain up to 64
            # bits into the data register.
            word = 0
            n = min(64, len(self.rng_buffer))
            for i in range(n):
                word |= self.rng_buffer.popleft() << i
            self.data_reg = word
            res = SequenceResult(0.0, [])
        elif spec is not None and spec.device_seq is not None:
            # Opcode-keyed registry dispatch: the spec names the memory
            # controller sequence; poc_post handles any result payload
            # (D-RaNGe deposits generated bits into the RNG buffer).
            res = self.mc.run_sequence(spec.device_seq, insn.operand0,
                                       insn.operand1)
            if spec.poc_post is not None:
                spec.poc_post(self, res)
        else:
            raise ValueError(
                f"opcode {insn.opcode!r} has no model-face executor "
                "(register_pim_op with device_seq to add one)")

        self._last_result = res
        self.stats.executed[insn.opcode.name] += 1
        self.stats.busy_ns += self.mc.now_ns - t0
        self.flags.fin = True

    def _execute_batch(self) -> None:
        """Run every staged instruction under one Ack/Fin pair.

        Batches whose opcodes all map (via the op registry) to the same
        memory-controller sequence, with no result-payload hook, route
        through the controller's batched dispatch (one scheduler entry);
        mixed batches fall back to per-instruction decode.  ``last_ok``
        is the conjunction over the batch."""
        words, self.insn_buffer = self.insn_buffer, None
        insns = [Instruction.decode(w) for w in words]
        self.flags.start = False
        self.flags.ack = True
        self.flags.fin = False

        t0 = self.mc.now_ns
        specs = [op_registry.get_op(i.opcode) for i in insns]
        seqs = {s.device_seq if s is not None and s.poc_post is None else None
                for s in specs}
        if not insns:
            # empty batch: acknowledged no-op (do NOT fall back to the
            # stale single-instruction register)
            self._last_result = SequenceResult(0.0, [])
        elif len(seqs) == 1 and None not in seqs:
            res = self.mc.run_sequence_batch(
                seqs.pop(), [(i.operand0, i.operand1) for i in insns])
            for i in insns:
                self.stats.executed[i.opcode.name] += 1
            self._last_result = res
            self.stats.busy_ns += self.mc.now_ns - t0
        else:
            ok = True
            for insn in insns:
                self.instruction_reg = insn.encode()
                self._execute()          # accounts its own busy_ns
                ok &= self.last_ok
            self._last_result = SequenceResult(self.mc.now_ns - t0, [], ok=ok)
        self.flags.fin = True

    # -------------------- convenience ------------------------------------ #

    @property
    def last_ok(self) -> bool:
        return bool(self._last_result and self._last_result.ok)

    def rng_bits_available(self) -> int:
        return len(self.rng_buffer)
