"""PiDRAM memory-controller model: a modular DDR3 command scheduler.

The hardware PiDRAM memory controller is a Verilog scheduler that (a)
implements conventional DRAM operation and (b) can be extended with ~60-200
lines to issue *violated-timing* command sequences for PiM techniques.  This
module is its software twin:

* a command-level timing model (every DDR3 command advances a bank-state
  machine and a cycle clock),
* a scheduler with pluggable **PiM sequence extensions** — RowClone and
  D-RaNGe register themselves as sequences, mirroring the paper's
  "easy-to-make modifications to the scheduler" design goal,
* end-to-end cost accounting used to reproduce the paper's Table-level
  results (speedups over memcpy/calloc, TRNG latency/throughput).

The model executes against a :class:`repro_torch.core.dram_model.SimulatedDRAM`
device so functional behaviour (did the copy actually happen? what bits did
the TRNG read return?) and timing are produced together.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dram_model import SimulatedDRAM
from .timing import (
    DDR3Timings,
    PrototypeParams,
    ViolatedTimings,
    DEFAULT_PROTOTYPE,
    DEFAULT_TIMINGS,
    DEFAULT_VIOLATIONS,
)


class Cmd(enum.Enum):
    ACT = "ACT"
    PRE = "PRE"
    RD = "RD"
    WR = "WR"
    REF = "REF"
    NOP = "NOP"


# Sentinel row ids for commands that do not target an addressable row:
# REF targets the whole bank; the Ambit B-group rows (T0/T1/T2, the
# dual-contact-cell row, and the C0/C1 control rows) live outside the
# allocator-visible address space.
ROW_REF = -1
ROW_T0 = -2
ROW_T1 = -3
ROW_T2 = -4
ROW_DCC = -5
ROW_CTRL = -6


@dataclass
class IssuedCmd:
    cmd: Cmd
    row: int
    at_ns: float
    note: str = ""


@dataclass
class SequenceResult:
    """Outcome of executing one (PiM or standard) command sequence."""

    elapsed_ns: float
    commands: List[IssuedCmd]
    ok: bool = True
    data: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        # Device predicates return numpy truth values; callers compare
        # ``ok`` with ``is True`` and JSON-serialize it, so normalize to
        # a Python bool here.
        self.ok = bool(self.ok)


PimSequence = Callable[["MemoryController", int, int], SequenceResult]


class MemoryController:
    """Command-level DDR3 scheduler with PiM sequence extensions."""

    def __init__(
        self,
        device: SimulatedDRAM,
        timings: DDR3Timings = DEFAULT_TIMINGS,
        violations: ViolatedTimings = DEFAULT_VIOLATIONS,
        proto: PrototypeParams = DEFAULT_PROTOTYPE,
    ) -> None:
        self.device = device
        self.t = timings
        self.v = violations
        self.proto = proto
        self.now_ns: float = 0.0
        self.open_row: Optional[int] = None
        # Bank state: when the most recent ACT was issued.  tRAS (ACT->PRE)
        # and tRC (ACT->ACT) are enforced against this timestamp.
        self._bank_act_ns: Optional[float] = None
        # Refresh schedule: one REF is due every tREFI; the bank is busy
        # for tRFC while it runs.
        self.next_ref_ns: float = timings.tREFI
        self.trace: List[IssuedCmd] = []
        self._sequences: Dict[str, PimSequence] = {}
        self.stats: Dict[str, float] = {"commands": 0, "pim_ops": 0,
                                        "pim_batches": 0, "refreshes": 0}

        # Built-in PiM extensions (the paper's two case studies, plus the
        # Ambit bulk-bitwise triple).
        self.register_sequence("rowclone_copy", _seq_rowclone_copy)
        self.register_sequence("drange_read", _seq_drange_read)
        self.register_sequence("ambit_and", _seq_ambit_and)
        self.register_sequence("ambit_or", _seq_ambit_or)
        self.register_sequence("ambit_not", _seq_ambit_not)

    # ------------------------------------------------------------------ #
    # Extension registry — the "60 additional lines of Verilog" analogue.
    # ------------------------------------------------------------------ #

    def register_sequence(self, name: str, fn: PimSequence) -> None:
        self._sequences[name] = fn

    def has_sequence(self, name: str) -> bool:
        return name in self._sequences

    def run_sequence(self, name: str, a: int, b: int) -> SequenceResult:
        if name not in self._sequences:
            raise KeyError(f"unknown PiM sequence {name!r}")
        self._refresh_if_due()
        self.stats["pim_ops"] += 1
        return self._sequences[name](self, a, b)

    def run_sequence_batch(self, name: str,
                           pairs: Sequence[Tuple[int, int]]) -> SequenceResult:
        """Execute one registered sequence per operand pair back-to-back
        as a single batched command sequence (ComputeDRAM-style batching:
        the POC dispatch handshake is paid once for the whole batch; the
        per-pair DRAM command timings still accrue individually).

        Returns one combined :class:`SequenceResult` whose ``commands``
        cover every pair, ``ok`` is the conjunction, and ``data`` the
        concatenation of any per-pair payloads."""
        if name not in self._sequences:
            raise KeyError(f"unknown PiM sequence {name!r}")
        t0 = self.now_ns
        cmds_start = len(self.trace)
        ok = True
        datas = []
        for a, b in pairs:
            self._refresh_if_due()
            res = self._sequences[name](self, a, b)
            ok = bool(ok and res.ok)
            if res.data is not None:
                datas.append(res.data)
        self.stats["pim_ops"] += len(pairs)
        self.stats["pim_batches"] += 1
        data = np.concatenate(datas) if datas else None
        return SequenceResult(self.now_ns - t0, self.trace[cmds_start:],
                              ok=ok, data=data)

    # ------------------------------------------------------------------ #
    # Primitive command issue (advances the clock per DDR3 timing rules)
    # ------------------------------------------------------------------ #

    def _issue(self, cmd: Cmd, row: int, gap_ns: float, note: str = "") -> None:
        self.now_ns += gap_ns
        self.trace.append(IssuedCmd(cmd, row, self.now_ns, note))
        self.stats["commands"] += 1
        if cmd is Cmd.ACT:
            self.open_row = row
            self._bank_act_ns = self.now_ns
        elif cmd is Cmd.PRE:
            self.open_row = None

    def _wait_until(self, t_ns: float) -> None:
        """Stall (no command issued) until the bank-state clock reaches t_ns."""
        if t_ns > self.now_ns:
            self.now_ns = t_ns

    def _refresh_if_due(self) -> None:
        """Catch up on the refresh schedule: one REF every tREFI, bank
        busy for tRFC.  Called between sequences / spec operations so PiM
        command sequences themselves stay atomic (a real controller
        defers REF across an in-flight sequence, then catches up)."""
        while self.now_ns >= self.next_ref_ns:
            if self.open_row is not None:
                self.precharge()  # banks must be precharged before REF
            self._issue(Cmd.REF, ROW_REF, self.t.tRFC, "refresh (tRFC busy)")
            self.stats["refreshes"] += 1
            self.next_ref_ns += self.t.tREFI

    # Standard (spec-compliant) operations ------------------------------ #
    #
    # Timing enforcement: ACT may not follow a previous ACT within tRC,
    # PRE may not follow the row's ACT within tRAS, and column commands
    # wait out tRCD.  A standard ACT -> PRE round-trip therefore takes
    # exactly tRAS + tRP = tRC (48.75 ns for DDR3-800), not tRCD + tRP.

    def activate(self, row: int) -> None:
        self._refresh_if_due()
        if self.open_row is not None:
            self.precharge()
        if self._bank_act_ns is not None:
            self._wait_until(self._bank_act_ns + self.t.tRC)
        self._issue(Cmd.ACT, row, 0.0, "spec")

    def read_burst(self, row: int) -> None:
        if self.open_row != row:
            self.activate(row)
        self._wait_until(self._bank_act_ns + self.t.tRCD)
        self._issue(Cmd.RD, row, self.t.tCL + self.t.tBL, "64B burst")

    def write_burst(self, row: int) -> None:
        if self.open_row != row:
            self.activate(row)
        self._wait_until(self._bank_act_ns + self.t.tRCD)
        self._issue(Cmd.WR, row, self.t.tCWL + self.t.tBL, "64B burst")

    def precharge(self) -> None:
        self._close_open_row("spec")

    def _close_open_row(self, note: str = "spec") -> None:
        if self.open_row is None:
            return
        if self._bank_act_ns is not None:
            self._wait_until(self._bank_act_ns + self.t.tRAS)
        self._issue(Cmd.PRE, self.open_row, self.t.tRP, note)

    # ------------------------------------------------------------------ #
    # Cost functions for CPU-side baselines (memcpy / calloc / CLFLUSH)
    # — forward-computed from PrototypeParams, see DESIGN.md SS5.
    # ------------------------------------------------------------------ #

    def memcpy_ns(self, nbytes: int) -> float:
        p = self.proto
        words = nbytes / p.word_bytes
        lines = nbytes / p.cacheline_bytes
        cycles = (
            words * p.memcpy_cycles_per_word
            + 2.0 * lines * p.miss_stall_cycles  # src read miss + dst allocate
        )
        return cycles * p.cycle_ns

    def memset_ns(self, nbytes: int) -> float:
        p = self.proto
        words = nbytes / p.word_bytes
        lines = nbytes / p.cacheline_bytes
        cycles = words * p.memset_cycles_per_word + lines * p.miss_stall_cycles
        return cycles * p.cycle_ns

    def clflush_ns(self, nbytes: int) -> float:
        """Flush dirty source-operand blocks (pipelined writebacks)."""
        return (nbytes / self.proto.cacheline_bytes) * self.proto.clflush_ns_per_block

    def clinval_ns(self, nbytes: int) -> float:
        """Invalidate destination-operand blocks (no writeback data)."""
        return (nbytes / self.proto.cacheline_bytes) * self.proto.clinval_ns_per_block

    def bitwise_ns(self, nbytes: int) -> float:
        """CPU bulk-bitwise baseline: read-modify-write loop (2 loads +
        op + store per word; src read miss + dst RMW miss per line)."""
        p = self.proto
        words = nbytes / p.word_bytes
        lines = nbytes / p.cacheline_bytes
        cycles = words * p.bitwise_cycles_per_word + 2.0 * lines * p.miss_stall_cycles
        return cycles * p.cycle_ns

    def scan_ns(self, nbytes: int) -> float:
        """CPU zero-compare baseline: load + compare + branch per word."""
        p = self.proto
        words = nbytes / p.word_bytes
        lines = nbytes / p.cacheline_bytes
        cycles = words * p.scan_cycles_per_word + lines * p.miss_stall_cycles
        return cycles * p.cycle_ns

    def poc_handshake_ns(self) -> float:
        """pimolib register protocol: 2 MMIO stores (insn, Start) +
        2 MMIO polls (Ack, Fin) + syscall/library overhead."""
        p = self.proto
        cycles = 2 * p.mmio_store_cycles + 2 * p.mmio_load_cycles + p.syscall_cycles
        return cycles * p.cycle_ns


# ---------------------------------------------------------------------- #
# PiM sequence extensions
# ---------------------------------------------------------------------- #


def _seq_rowclone_copy(mc: MemoryController, src: int, dst: int) -> SequenceResult:
    """ComputeDRAM-style RowClone: ACT(src) -o- PRE -o- ACT(dst).

    The two gaps violate tRAS and tRP; after the second ACT the controller
    waits a full spec tRAS+tRP to restore and close the destination row.
    """
    t0 = mc.now_ns
    cmds_start = len(mc.trace)
    mc._close_open_row("close before PiM")
    mc._issue(Cmd.ACT, src, 0.0, "rowclone ACT src")
    mc._issue(Cmd.PRE, src, mc.v.t1_act_pre, "violated tRAS")
    mc._issue(Cmd.ACT, dst, mc.v.t2_pre_act, "violated tRP")
    ok = mc.device.rowclone(src, dst)
    # restore + close destination row (spec timings)
    mc._issue(Cmd.PRE, dst, mc.t.tRAS, "restore dst")
    mc.now_ns += mc.t.tRP
    return SequenceResult(mc.now_ns - t0, mc.trace[cmds_start:], ok=ok)


def _aap(mc: MemoryController, src: int, dst: int, note: str) -> None:
    """Ambit AAP (ACT-ACT-PRE) primitive: a violated-timing row copy with
    the same command train and cost as one RowClone (ACT -o- PRE -o- ACT,
    then a spec restore+close of the destination)."""
    mc._issue(Cmd.ACT, src, 0.0, f"{note} ACT")
    mc._issue(Cmd.PRE, src, mc.v.t1_act_pre, f"{note} violated tRAS")
    mc._issue(Cmd.ACT, dst, mc.v.t2_pre_act, f"{note} violated tRP")
    mc._issue(Cmd.PRE, dst, mc.t.tRAS, f"{note} restore")
    mc.now_ns += mc.t.tRP


def _seq_ambit_bitwise(mc: MemoryController, src: int, dst: int,
                       op: str) -> SequenceResult:
    """Ambit AND/OR: stage operands + control row into the B-group with
    three AAPs, one triple-row activation (TRA) for the majority compute,
    then one AAP copying the result over dst (dst <- src OP dst)."""
    t0 = mc.now_ns
    cmds_start = len(mc.trace)
    mc._close_open_row("close before PiM")
    _aap(mc, src, ROW_T0, "ambit src->T0")
    _aap(mc, dst, ROW_T1, "ambit dst->T1")
    _aap(mc, ROW_CTRL, ROW_T2, f"ambit C{0 if op == 'and' else 1}->T2")
    ok = mc.device.ambit_bitwise(src, dst, op)
    # TRA: all three B-group wordlines raised at once; charge sharing
    # settles to MAJ(T0, T1, T2), restored over a full spec tRAS.
    mc._issue(Cmd.ACT, ROW_T0, 0.0, "ambit TRA T0/T1/T2")
    mc._issue(Cmd.PRE, ROW_T0, mc.t.tRAS, "ambit TRA restore")
    mc.now_ns += mc.t.tRP
    _aap(mc, ROW_T0, dst, "ambit T0->dst")
    return SequenceResult(mc.now_ns - t0, mc.trace[cmds_start:], ok=ok)


def _seq_ambit_and(mc: MemoryController, src: int, dst: int) -> SequenceResult:
    return _seq_ambit_bitwise(mc, src, dst, "and")


def _seq_ambit_or(mc: MemoryController, src: int, dst: int) -> SequenceResult:
    return _seq_ambit_bitwise(mc, src, dst, "or")


def _seq_ambit_not(mc: MemoryController, src: int, dst: int) -> SequenceResult:
    """Ambit NOT: activate src against the dual-contact cell (couples the
    negated value into the DCC row), then AAP the DCC row over dst."""
    t0 = mc.now_ns
    cmds_start = len(mc.trace)
    mc._close_open_row("close before PiM")
    _aap(mc, src, ROW_DCC, "ambit src->DCC")
    ok = mc.device.ambit_not(src, dst)
    _aap(mc, ROW_DCC, dst, "ambit DCC->dst")
    return SequenceResult(mc.now_ns - t0, mc.trace[cmds_start:], ok=ok)


def _seq_drange_read(mc: MemoryController, row: int, n_bits: int) -> SequenceResult:
    """D-RaNGe: ACT with violated tRCD, immediate RD, sample metastable cells."""
    t0 = mc.now_ns
    cmds_start = len(mc.trace)
    mc._close_open_row("close before PiM")
    mc._issue(Cmd.ACT, row, 0.0, "drange ACT")
    mc._issue(Cmd.RD, row, mc.v.tRCD_viol, "violated tRCD read")
    bits = mc.device.drange_read(row, n_bits)
    mc.now_ns += mc.t.tCL + mc.t.tBL          # data return
    mc._issue(Cmd.PRE, row, mc.t.tRAS, "restore row")
    mc.now_ns += mc.t.tRP
    return SequenceResult(mc.now_ns - t0, mc.trace[cmds_start:], ok=True, data=bits)


# ---------------------------------------------------------------------- #
# End-to-end analytical paths (used by benchmarks/paper_tables.py)
# ---------------------------------------------------------------------- #


@dataclass
class EndToEndCosts:
    """End-to-end latency model for the four paper comparisons (one row)."""

    mc: MemoryController

    def cpu_copy_ns(self) -> float:
        return self.mc.memcpy_ns(self.mc.proto.row_bytes)

    def cpu_init_ns(self) -> float:
        return self.mc.memset_ns(self.mc.proto.row_bytes)

    def rowclone_copy_ns(self, coherent: bool = False) -> float:
        seq = _sequence_time_only(self.mc, "rowclone_copy")
        total = self.mc.poc_handshake_ns() + seq
        if coherent:
            total += self.mc.clflush_ns(self.mc.proto.row_bytes)
        return total

    def rowclone_init_ns(self, coherent: bool = False) -> float:
        # Initialization = RowClone copy from a reserved all-zeros row.
        seq = _sequence_time_only(self.mc, "rowclone_copy")
        total = self.mc.poc_handshake_ns() + seq
        if coherent:
            total += self.mc.clinval_ns(self.mc.proto.row_bytes)
        return total

    def speedups(self) -> Dict[str, float]:
        return {
            "copy_no_coherence": self.cpu_copy_ns() / self.rowclone_copy_ns(False),
            "init_no_coherence": self.cpu_init_ns() / self.rowclone_init_ns(False),
            "copy_coherence": self.cpu_copy_ns() / self.rowclone_copy_ns(True),
            "init_coherence": self.cpu_init_ns() / self.rowclone_init_ns(True),
        }

    # Batched dispatch (one POC handshake amortized over n row ops) ------ #

    def rowclone_copy_batched_ns(self, n: int, coherent: bool = False) -> float:
        """End-to-end cost of an n-row batched RowClone copy: one POC
        handshake + n command sequences (+ per-row coherence flushes)."""
        seq = _sequence_time_only(self.mc, "rowclone_copy")
        total = self.mc.poc_handshake_ns() + n * seq
        if coherent:
            total += n * self.mc.clflush_ns(self.mc.proto.row_bytes)
        return total

    def rowclone_init_batched_ns(self, n: int, coherent: bool = False) -> float:
        seq = _sequence_time_only(self.mc, "rowclone_copy")
        total = self.mc.poc_handshake_ns() + n * seq
        if coherent:
            total += n * self.mc.clinval_ns(self.mc.proto.row_bytes)
        return total

    def batched_speedups(self, n: int) -> Dict[str, float]:
        """Per-row speedups for an n-row batch vs the CPU moving the same
        n rows.  At n=1 this matches :meth:`speedups`; as n grows the
        handshake amortizes toward the pure command-sequence bound."""
        cpu_copy = n * self.cpu_copy_ns()
        cpu_init = n * self.cpu_init_ns()
        return {
            "copy_no_coherence": cpu_copy / self.rowclone_copy_batched_ns(n, False),
            "init_no_coherence": cpu_init / self.rowclone_init_batched_ns(n, False),
            "copy_coherence": cpu_copy / self.rowclone_copy_batched_ns(n, True),
            "init_coherence": cpu_init / self.rowclone_init_batched_ns(n, True),
        }

    # Ambit bulk bitwise ------------------------------------------------ #

    def cpu_bitwise_ns(self) -> float:
        return self.mc.bitwise_ns(self.mc.proto.row_bytes)

    def cpu_scan_ns(self) -> float:
        return self.mc.scan_ns(self.mc.proto.row_bytes)

    def ambit_bitwise_ns(self, op: str = "and", coherent: bool = False) -> float:
        """One in-DRAM bitwise row op: POC handshake + the TRA command
        sequence (4 AAPs + 1 TRA for AND/OR, 2 AAPs for NOT)."""
        seq = _sequence_time_only(self.mc, f"ambit_{op}")
        total = self.mc.poc_handshake_ns() + seq
        if coherent:
            # both operand rows may hold dirty cache lines
            total += 2 * self.mc.clflush_ns(self.mc.proto.row_bytes)
        return total

    def ambit_bitwise_batched_ns(self, n: int, op: str = "and",
                                 coherent: bool = False) -> float:
        seq = _sequence_time_only(self.mc, f"ambit_{op}")
        total = self.mc.poc_handshake_ns() + n * seq
        if coherent:
            total += 2 * n * self.mc.clflush_ns(self.mc.proto.row_bytes)
        return total

    def zero_scan_batched_ns(self, n: int) -> float:
        """Zero-compare scan of n rows: OR-reduce the candidates into a
        B-group scratch row (n ambit_or sequences, one handshake), then
        one CPU pass over the single result row."""
        seq = _sequence_time_only(self.mc, "ambit_or")
        return (self.mc.poc_handshake_ns() + n * seq
                + self.mc.scan_ns(self.mc.proto.row_bytes))

    # D-RaNGe ----------------------------------------------------------- #

    def drange_latency_ns(self) -> float:
        return self.mc.proto.drange_latency_ns

    def drange_throughput_mbps(self) -> float:
        bits = self.mc.proto.drange_bits_per_read
        return bits / self.mc.proto.drange_sustained_ns * 1e3  # ns -> Mb/s


def _sequence_time_only(mc: MemoryController, name: str) -> float:
    """Run a sequence on a scratch clock to get its isolated duration."""
    probe = MemoryController(mc.device, mc.t, mc.v, mc.proto)
    # Rows 0 -> 0; timing is row-independent.  Most sequences are a data
    # no-op on src == dst (copy, AND, OR), but e.g. ambit_not is not —
    # restore the probe row so costing never perturbs device contents.
    saved = mc.device.read_row(0)
    res = probe.run_sequence(name, 0, 0)
    mc.device.write_row(0, saved)
    return res.elapsed_ns
