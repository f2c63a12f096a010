"""pimolib for the port — PiDRAM's PiM operations library, one protocol
with two faces.

The port's counterpart of the JAX package's ``core/pimolib.py``:

* **model face** (:class:`DeviceLib`, ``face="device"``): ops against the
  simulated DDR3 prototype through the POC register protocol, with
  end-to-end latency accounting from the memory-controller timing model
  (a copy of the JAX package's; numpy only, every latency the simulated
  prototype's, never the card's);
* **torch face** (:class:`TorchLib`, ``face="torch"``, where the JAX
  package has ``TpuLib``): the same ops over torch arenas, routed
  through the batched op queue
  (:class:`repro_torch.core.pim_queue.PimOpQueue`) onto the RowClone
  and Ambit kernels; ``Blocking.FIN`` synchronises the card; ``rand``
  and ``rand_u32`` draw from the D-RaNGe generator kernel.

Both return :class:`OpReceipt`: ``latency_ns`` is the model face's
account, ``launches`` the torch face's kernel launches.  Op behaviour
resolves through the opcode-keyed registry
(:mod:`repro_torch.core.op_registry`); :meth:`PimLib.supports` is the
capability flag.
"""

from __future__ import annotations

import abc
import enum
import warnings
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.drange import ops as dr_ops
from . import op_registry
from .allocator import Allocation, SubarrayAllocator, arena_groups
from .coherence import CoherenceModel, CoherencePolicy
from .isa import Instruction, Opcode
from .op_registry import FACE_DEVICE, FACE_TORCH
from .pim_queue import PimOpQueue
from .poc import PimOpsController


class Blocking(enum.Enum):
    ACK = "ack"    # return once the op is dispatched
    FIN = "fin"    # block until the op's effects are committed


@dataclass
class OpReceipt:
    """What every pimolib mutation returns, on both faces:
    ``latency_ns`` is the model face's end-to-end account (POC handshake
    + command sequence + coherence maintenance, in the simulated
    prototype's nanoseconds), ``launches`` the kernel launches a torch
    face call issued (0 with a deferred lib until the coalescing flush
    pays it), ``n_ops`` the logical row/page ops either way."""

    ok: bool
    op: str
    face: str = FACE_DEVICE
    n_ops: int = 1
    latency_ns: float = 0.0
    launches: int = 0
    deferred: bool = False


class PimLib(abc.ABC):
    """The pimolib protocol: ``copy``/``init``/``bitwise``/``write``
    mutate pages named by :class:`Allocation` handles and return an
    :class:`OpReceipt`; ``read`` returns page contents (flushing
    deferred work first); ``flush`` drains the backlog; ``rand`` returns
    random bits.  ``Blocking.FIN`` is a full synchronisation point."""

    face: str = "?"

    @abc.abstractmethod
    def copy(self, src: Allocation, dst: Allocation,
             blocking: Blocking = Blocking.ACK) -> OpReceipt: ...

    @abc.abstractmethod
    def init(self, dst: Allocation, value: float = 0.0,
             blocking: Blocking = Blocking.ACK) -> OpReceipt: ...

    @abc.abstractmethod
    def read(self, alloc: Allocation): ...

    @abc.abstractmethod
    def write(self, alloc: Allocation, values) -> OpReceipt: ...

    @abc.abstractmethod
    def flush(self, blocking: Blocking = Blocking.ACK) -> OpReceipt: ...

    @abc.abstractmethod
    def rand(self, n_bits: int, seed=None) -> Tuple[np.ndarray, OpReceipt]:
        ...

    def supports(self, opcode: Opcode) -> bool:
        """Capability flag: does this face implement ``opcode``?"""
        return op_registry.supports(opcode, self.face)


# ---------------------------------------------------------------------- #
# Model face — drives the simulated prototype
# ---------------------------------------------------------------------- #


class DeviceLib(PimLib):
    """pimolib over the simulated DDR3 prototype (a copy of the JAX
    package's, numpy only)."""

    face = FACE_DEVICE

    def __init__(
        self,
        poc: PimOpsController,
        allocator: SubarrayAllocator,
        coherence: CoherencePolicy = CoherencePolicy.PRECISE,
        trng=None,
    ) -> None:
        self.poc = poc
        self.allocator = allocator
        self.coherence = CoherenceModel(coherence, poc.mc)
        self.trng = trng    # DRangeTRNG; required for rand()
        self.zero_rows: Dict[int, int] = {}  # group -> reserved all-zeros row
        self.stats = {"copies": 0, "inits": 0, "bitwises": 0, "reads": 0,
                      "writes": 0, "rand_bits": 0}

    def supports(self, opcode: Opcode) -> bool:
        if opcode is Opcode.DR_GEN and self.trng is None:
            return False    # needs a characterized TRNG attached
        return super().supports(opcode)

    # -- supervisor-software services ----------------------------------- #

    def attach_trng(self, trng) -> None:
        """Attach a characterized D-RaNGe TRNG; enables :meth:`rand`."""
        self.trng = trng

    def reserve_zero_row(self, group: int) -> int:
        """RowClone-Init copies from a reserved all-zeros row per subarray."""
        if group not in self.zero_rows:
            alloc = self.allocator.alloc(1, group=group, tag="zero-row")
            row = alloc.rows[0]
            geo = self.poc.mc.device.geometry
            self.poc.mc.device.write_row(row, np.zeros(geo.row_bytes, np.uint8))
            self.zero_rows[group] = row
        return self.zero_rows[group]

    # -- the four-step pimolib protocol ---------------------------------- #

    def _start_and_poll(self, blocking: Blocking) -> None:
        self.poc.store_start()                      # (ii) set Start flag
        flags = self.poc.load_flags()               # (iii) poll Ack / Fin
        want = flags.ack if blocking is Blocking.ACK else flags.fin
        if not want:
            raise RuntimeError("POC handshake failed")

    def _issue(self, insn: Instruction, blocking: Blocking) -> None:
        self.poc.store_instruction(insn.encode())   # (i) write instruction reg
        self._start_and_poll(blocking)

    def _dispatch(self, insns: list, blocking: Blocking,
                  batch: bool) -> Tuple[bool, float]:
        """Issue an instruction sequence; returns (ok, handshake_ns).
        ``batch=True`` stages the whole sequence in the POC instruction
        buffer and pays one register handshake; ``batch=False`` pays one
        per instruction (the looped baseline)."""
        ok = True
        if batch:
            self.poc.store_instruction_buffer([i.encode() for i in insns])
            self._start_and_poll(blocking)
            return self.poc.last_ok, self.poc.mc.poc_handshake_ns()
        for insn in insns:
            self._issue(insn, blocking)
            ok &= self.poc.last_ok
        return ok, len(insns) * self.poc.mc.poc_handshake_ns()

    def _run_op(self, opcode: Opcode, src: Optional[Allocation],
                dst: Allocation, blocking: Blocking, batch: bool,
                *, write_back: bool, coherence_on: Allocation) -> OpReceipt:
        """Registry-driven dispatch: coherence maintenance + the spec's
        Instruction sequence through the POC, timed end to end."""
        spec = op_registry.get_op(opcode)
        if spec is None or spec.device_insns is None:
            raise NotImplementedError(
                f"{opcode!r} has no model-face executor (supports()=False)")
        t0 = self.poc.mc.now_ns
        latency = self.coherence.flush_cost_ns(coherence_on, self.allocator,
                                               write_back=write_back)
        insns = spec.device_insns(self, src, dst)
        ok, handshakes = self._dispatch(insns, blocking, batch)
        latency += handshakes + self.poc.mc.now_ns - t0
        return OpReceipt(ok, spec.name, face=self.face, n_ops=dst.nrows,
                         latency_ns=latency)

    # -- PimLib protocol ------------------------------------------------- #

    def copy(self, src: Allocation, dst: Allocation,
             blocking: Blocking = Blocking.ACK, batch: bool = True) -> OpReceipt:
        """RowClone-Copy src -> dst (row lists must be same-subarray),
        one POC handshake per batch by default."""
        if src.group != dst.group or src.nrows != dst.nrows:
            raise ValueError("copy operands must be same-subarray, same size")
        self.stats["copies"] += src.nrows
        return self._run_op(Opcode.RC_COPY, src, dst, blocking, batch,
                            write_back=True, coherence_on=src)

    def init(self, dst: Allocation, value: float = 0.0,
             blocking: Blocking = Blocking.ACK, batch: bool = True) -> OpReceipt:
        """RowClone-Init: copy the reserved zero row over each dst row.
        A nonzero fill has no RowClone sequence and falls back to the
        CPU memset path.  The device stores bytes, so only integer fills
        in [0, 255] are taken; anything else raises."""
        if isinstance(value, Blocking):   # v1 signature: init(dst, blocking)
            raise TypeError("pimolib v2 moved `value` before `blocking`: "
                            "call init(dst, value=0.0, blocking=...)")
        if value != 0.0:
            if not (float(value).is_integer() and 0 <= value <= 255):
                raise ValueError(
                    f"model-face init fill must be a byte value, got {value!r}")
            rec = self.cpu_init(dst, value)
            self.stats["inits"] += dst.nrows
            return rec
        rec = self._run_op(Opcode.RC_INIT, None, dst, blocking, batch,
                           write_back=False, coherence_on=dst)
        self.stats["inits"] += dst.nrows
        return rec

    _BITWISE_OPC = {"and": Opcode.AMB_AND, "or": Opcode.AMB_OR,
                    "not": Opcode.AMB_NOT}

    def bitwise(self, op: str, src: Allocation, dst: Allocation,
                blocking: Blocking = Blocking.ACK,
                batch: bool = True) -> OpReceipt:
        """Ambit ``dst <- src OP dst`` (or ``~src`` for "not") through
        the POC, each row pair priced as its TRA command sequence.  A
        cross-subarray pair makes the sequence report ``ok=False``."""
        if op not in self._BITWISE_OPC:
            raise ValueError(f"unknown bitwise op {op!r}")
        if src.group != dst.group or src.nrows != dst.nrows:
            raise ValueError(
                "bitwise operands must be same-subarray, same size")
        self.stats["bitwises"] += src.nrows
        return self._run_op(self._BITWISE_OPC[op], src, dst, blocking, batch,
                            write_back=True, coherence_on=src)

    def cpu_bitwise(self, op: str, src: Allocation,
                    dst: Allocation) -> OpReceipt:
        """CPU read-modify-write baseline for the same op (the fallback
        the serving-trace replay prices when operands span subarrays)."""
        mc = self.poc.mc
        nbytes = src.nrows * mc.proto.row_bytes
        for s, d in zip(src.rows, dst.rows):
            a = mc.device.read_row(s)
            if op == "not":
                out = np.bitwise_not(a)
            elif op == "and":
                out = a & mc.device.read_row(d)
            else:
                out = a | mc.device.read_row(d)
            mc.device.write_row(d, out)
        self.allocator.touch_cpu_write(dst)
        return OpReceipt(True, "cpu_bitwise", face=self.face, n_ops=src.nrows,
                         latency_ns=mc.bitwise_ns(nbytes))

    def rand(self, n_bits: int, seed=None) -> Tuple[np.ndarray, OpReceipt]:
        """The paper's rand_dram(): drain the POC random-number buffer.
        Needs an attached characterized TRNG (``supports(DR_GEN)``)."""
        if self.trng is None:
            raise NotImplementedError(
                "rand() needs a characterized DRangeTRNG: "
                "DeviceLib(..., trng=...) or attach_trng()")
        bits = self.trng.random_bits(n_bits)
        chunks = -(-n_bits // self.poc.mc.proto.drange_bits_per_read)
        latency = (self.poc.mc.proto.drange_latency_ns
                   + (chunks - 1) * self.poc.mc.proto.drange_sustained_ns)
        self.stats["rand_bits"] += n_bits
        return bits, OpReceipt(True, "drange_rand", face=self.face,
                               n_ops=n_bits, latency_ns=latency)

    def read(self, alloc: Allocation) -> np.ndarray:
        """Page contents as (nrows, row_bytes) uint8 (CPU read path)."""
        mc = self.poc.mc
        out = np.stack([mc.device.read_row(r) for r in alloc.rows])
        self.allocator.touch_cpu_read(alloc)
        self.stats["reads"] += alloc.nrows
        return out

    def write(self, alloc: Allocation, values) -> OpReceipt:
        """CPU write path: store ``values`` (castable to (nrows,
        row_bytes) uint8) into the allocation's rows, accounted as a CPU
        memcpy (there is no PiM sequence for host-data ingress)."""
        mc = self.poc.mc
        geo = mc.device.geometry
        raw = np.asarray(values)
        vals = raw.astype(np.uint8).reshape(alloc.nrows, geo.row_bytes)
        if not np.array_equal(vals.astype(raw.dtype).reshape(raw.shape), raw):
            raise ValueError(
                "model-face write payload must be byte values in [0, 255] "
                "(the device stores bytes)")
        for r, row in zip(alloc.rows, vals):
            mc.device.write_row(r, row)
        self.allocator.touch_cpu_write(alloc)
        self.stats["writes"] += alloc.nrows
        nbytes = alloc.nrows * mc.proto.row_bytes
        return OpReceipt(True, "cpu_write", face=self.face,
                         n_ops=alloc.nrows, latency_ns=mc.memcpy_ns(nbytes))

    def flush(self, blocking: Blocking = Blocking.ACK) -> OpReceipt:
        """The model face executes synchronously: nothing is deferred."""
        return OpReceipt(True, "flush", face=self.face, n_ops=0)

    # -- CPU baselines (memcpy / calloc through the core) ----------------- #

    def cpu_copy(self, src: Allocation, dst: Allocation) -> OpReceipt:
        mc = self.poc.mc
        nbytes = src.nrows * mc.proto.row_bytes
        for s, d in zip(src.rows, dst.rows):
            mc.device.write_row(d, mc.device.read_row(s))
        self.allocator.touch_cpu_write(dst)
        return OpReceipt(True, "cpu_memcpy", face=self.face, n_ops=src.nrows,
                         latency_ns=mc.memcpy_ns(nbytes))

    def cpu_init(self, dst: Allocation, value: float = 0.0) -> OpReceipt:
        mc = self.poc.mc
        nbytes = dst.nrows * mc.proto.row_bytes
        geo = mc.device.geometry
        fill = np.full(geo.row_bytes, int(value), np.uint8)
        for d in dst.rows:
            mc.device.write_row(d, fill)
        self.allocator.touch_cpu_write(dst)
        return OpReceipt(True, "cpu_calloc", face=self.face, n_ops=dst.nrows,
                         latency_ns=mc.memset_ns(nbytes))

    def rand_dram(self, n_bits: int, trng) -> Tuple[np.ndarray, OpReceipt]:
        """The deprecated v1 spelling of ``attach_trng(trng); rand(n)``."""
        warnings.warn("rand_dram(n, trng) is deprecated: attach_trng(trng) "
                      "then rand(n)", DeprecationWarning, stacklevel=2)
        self.attach_trng(trng)
        return self.rand(n_bits)


# ---------------------------------------------------------------------- #
# Torch face — the same ops over torch arenas
# ---------------------------------------------------------------------- #


@dataclass
class TorchArena:
    """A paged device arena: (num_pages, page_elems) + its allocator
    (the counterpart of ``TpuArena``)."""

    buffer: torch.Tensor
    allocator: SubarrayAllocator

    @property
    def num_pages(self) -> int:
        return self.buffer.shape[0]

    @property
    def page_elems(self) -> int:
        return self.buffer.shape[1]


class TorchLib(PimLib):
    """pimolib over torch arena tensors (the counterpart of ``TpuLib``).

    Mutations route through a :class:`PimOpQueue`; by default each call
    flushes at once, and with ``deferred=True`` ops collect across
    calls and pay one coalesced launch per op kind at :meth:`flush`
    (``admit`` keeps program order).  The lib binds either one
    :class:`TorchArena` (pages on axis 0) or a list of layered
    ``(L, P, ...)`` buffers (the KV cache's (k, v) pair, pages on axis
    1).  Flushes update the buffers in place, so every holder of a
    buffer sees them.  ``rand``/``rand_u32`` draw on the bound buffers'
    device, or on ``device`` (None: the card) while none is bound.

    Sharded serving (one process per shard): with ``shard_axis`` and
    ``mesh``, each rank's bound buffers are its slice of mesh-wide
    arenas split on that axis over ``mesh``'s ``axis_name`` dimension;
    page ids, the queue and its flushes are the same on every rank.
    ``tag`` names the lib in the queue's per-owner breakdown, and
    :meth:`owner_tags` names one owner a shard (``tag/shard0`` ...),
    every one of which each dispatch serves.
    """

    face = FACE_TORCH

    def __init__(self, arena: Optional[TorchArena] = None, *,
                 buffers: Optional[Sequence[torch.Tensor]] = None,
                 layered: Optional[bool] = None,
                 allocator: Optional[SubarrayAllocator] = None,
                 deferred: bool = False,
                 queue: Optional[PimOpQueue] = None,
                 device: DeviceLike = None, tag: str = "lib",
                 shard_axis: Optional[int] = None, mesh=None,
                 axis_name: str = "model") -> None:
        if arena is not None and buffers is not None:
            raise ValueError("pass either arena= or buffers=, not both")
        self.arena = arena
        self.deferred = deferred
        self.tag = tag
        self.shard_axis = shard_axis
        self.mesh = mesh
        self.axis_name = axis_name
        self.queue = queue if queue is not None else PimOpQueue()
        if self.queue.owner is not None and self.queue.owner() is not None:
            raise ValueError(
                "PimOpQueue is already driven by another lib; share ONE lib "
                "across clients for joint accounting instead")
        # held weakly: the lib holds its queue, and a dropped lib (with
        # the arenas it drives) is freed at once, not by a cyclic collection
        self.queue.owner = weakref.ref(self)
        self.stats = {"copies": 0, "inits": 0, "bitwises": 0, "reads": 0,
                      "writes": 0, "rand_bits": 0}
        self._rand_ctr = 0   # advances the default rand() seed per call
        self._device = device
        if arena is not None:
            self.buffers: List[torch.Tensor] = [arena.buffer]
            self.allocator = arena.allocator
            self.layered = False if layered is None else layered
        else:
            self.buffers = list(buffers) if buffers is not None else []
            self.allocator = allocator
            self.layered = True if layered is None else layered

    def adopt_buffers(self, buffers: Sequence[torch.Tensor], *,
                      layered: bool = True,
                      allocator: Optional[SubarrayAllocator] = None,
                      shard_axis: Optional[int] = None, mesh=None,
                      axis_name: str = "model") -> None:
        """Bind the buffers this lib flushes against (how the paged KV
        cache plugs its (k, v) pair into a caller's lib); a lib already
        bound refuses to rebind.  ``shard_axis``/``mesh`` record that
        the buffers are this rank's slices (see the class docstring)."""
        if self.queue.pending_ops:
            raise RuntimeError("cannot adopt buffers with pending ops")
        if self.buffers or self.arena is not None:
            raise RuntimeError("lib is already bound to arenas")
        self.buffers = list(buffers)
        self.layered = layered
        if shard_axis is not None:
            self.shard_axis = shard_axis
            self.mesh = mesh
            self.axis_name = axis_name
        if allocator is not None:
            self.allocator = allocator

    @property
    def n_shards(self) -> int:
        """Mesh extent of the shard axis (1 for a host-local lib)."""
        if self.shard_axis is None or self.mesh is None:
            return 1
        return self.mesh.shape[self.axis_name]

    def owner_tags(self) -> Tuple[str, ...]:
        """The queue's owner tags for this lib's launches: one a shard
        for a sharded lib, else the lib's own tag."""
        n = self.n_shards
        if n == 1:
            return (self.tag,)
        return tuple(f"{self.tag}/shard{i}" for i in range(n))

    def shard_views(self, buffer: int = 0) -> List[torch.Tensor]:
        """Each shard's slice of ``buffers[buffer]`` as CPU tensors, in
        order along the shard axis (shard 0 = heads [0, H/N), ...), after
        the pending work lands; a host-local lib gives its whole buffer
        as one view.  Sharded, this is a collective (it gathers every
        rank's slice): every rank of the mesh axis must call it."""
        self.flush()
        buf = self.buffers[buffer]
        if self.n_shards == 1:
            return [buf.detach().cpu()]
        views = self.mesh.all_gather(buf.detach(), self.axis_name)
        return [v.cpu() for v in views.unbind(0)]

    def _receipt(self, op: str, n_ops: int, blocking: Blocking) -> OpReceipt:
        if self.deferred and blocking is not Blocking.FIN:
            return OpReceipt(True, op, face=self.face, n_ops=n_ops,
                             deferred=True)
        before = self.queue.stats["launches"]
        self.flush(blocking)
        return OpReceipt(True, op, face=self.face, n_ops=n_ops,
                         launches=self.queue.stats["launches"] - before)

    # -- PimLib protocol ------------------------------------------------- #

    def copy(self, src: Allocation, dst: Allocation,
             blocking: Blocking = Blocking.ACK) -> OpReceipt:
        if src.group != dst.group or src.nrows != dst.nrows:
            raise ValueError("copy operands must be same-slab, same size")
        self.queue.admit("page_copy", dst.rows, self.flush, reads=src.rows)
        for s, d in zip(src.rows, dst.rows):
            self.queue.enqueue_copy(s, d)
        self.stats["copies"] += src.nrows
        return self._receipt("rowclone_copy", src.nrows, blocking)

    def init(self, dst: Allocation, value: float = 0.0,
             blocking: Blocking = Blocking.ACK) -> OpReceipt:
        self.queue.admit("page_init", dst.rows, self.flush)
        for d in dst.rows:
            self.queue.enqueue_init(d, value)
        self.stats["inits"] += dst.nrows
        return self._receipt("rowclone_init", dst.nrows, blocking)

    _BITWISE_KIND = {"and": "page_and", "or": "page_or", "not": "page_not"}

    def bitwise(self, op: str, src: Allocation, dst: Allocation,
                blocking: Blocking = Blocking.ACK) -> OpReceipt:
        """Ambit ``dst <- src OP dst`` (or ``~src`` for "not") on pages:
        one coalesced bitwise launch at flush over a bound (K, V) pair,
        else one per bound arena (the queue counts one per arena, as the
        JAX package does).  ``admit``
        registers the source pages as reads, so a pending op that wrote
        either operand flushes first."""
        kind = self._BITWISE_KIND.get(op)
        if kind is None:
            raise ValueError(f"unknown bitwise op {op!r}")
        if src.group != dst.group or src.nrows != dst.nrows:
            raise ValueError(
                "bitwise operands must be same-slab, same size")
        self.queue.admit(kind, dst.rows, self.flush, reads=src.rows)
        for s, d in zip(src.rows, dst.rows):
            self.queue.enqueue(kind, (s, d))
        self.stats["bitwises"] += src.nrows
        return self._receipt(f"ambit_{op}", src.nrows, blocking)

    def flush(self, blocking: Blocking = Blocking.ACK) -> OpReceipt:
        """Drain pending ops: one coalesced launch per op kind across
        all bound buffers (an unlayered arena flushes as a one-layer
        view of itself)."""
        before = self.queue.stats["launches"]
        if self.queue.pending_ops:
            if not self.buffers:
                raise RuntimeError("flush with pending ops but no buffers "
                                   "bound (adopt_buffers first)")
            views = [b if self.layered else b[None] for b in self.buffers]
            self.queue.flush(*views)
        if blocking is Blocking.FIN:
            for b in self.buffers:
                synchronize(b.device)
        return OpReceipt(True, "flush", face=self.face, n_ops=0,
                         launches=self.queue.stats["launches"] - before)

    def _rand_device(self) -> torch.device:
        if self.buffers:
            return self.buffers[0].device
        return resolve_device(self._device)

    def rand(self, n_bits: int, seed=None) -> Tuple[np.ndarray, OpReceipt]:
        """Random bits from the D-RaNGe kernel (one launch).  With no
        explicit seed the stream advances per call; pass ``seed`` (two
        uint32 words) for a reproducible draw."""
        if seed is None:
            self._rand_ctr += 1
            seed = (0x9E3779B9 + self._rand_ctr, 0x85EBCA6B ^ self._rand_ctr)
        words = dr_ops.pim_random_u32(seed, 1, -(-n_bits // 32),
                                      self._rand_device())
        self.stats["rand_bits"] += n_bits   # logical bits
        self.queue.count_external("drange_rand")
        bits = np.unpackbits(words.cpu().numpy().view(np.uint8),
                             bitorder="little")[:n_bits]
        return bits, OpReceipt(True, "drange_rand", face=self.face,
                               n_ops=n_bits, launches=1)

    def rand_u32(self, seed, n_rows: int, n_cols: int) -> torch.Tensor:
        """Raw (n_rows, n_cols) uint32 words from ``seed``."""
        self.stats["rand_bits"] += n_rows * n_cols * 32
        self.queue.count_external("drange_rand")
        return dr_ops.pim_random_u32(seed, n_rows, n_cols,
                                     self._rand_device())

    def read(self, alloc: Allocation, buffer: int = 0) -> torch.Tensor:
        """Page contents of ``buffers[buffer]`` after deferred work
        lands.  Unlayered: (nrows, elems); layered: (layers, nrows, ...)."""
        self.flush()
        self.stats["reads"] += alloc.nrows
        buf = self.buffers[buffer]
        rows = torch.tensor(alloc.rows, dtype=torch.long, device=buf.device)
        return buf[rows] if not self.layered else buf[:, rows]

    def write(self, alloc: Allocation, values, buffer: int = 0) -> OpReceipt:
        """Host-data ingress into ``buffers[buffer]`` (flushes first to
        keep enqueue order against direct writes)."""
        self.flush()
        buf = self.buffers[buffer]
        rows = torch.tensor(alloc.rows, dtype=torch.long, device=buf.device)
        vals = torch.as_tensor(values).to(device=buf.device, dtype=buf.dtype)
        if self.layered:
            buf[:, rows] = vals
        else:
            buf[rows] = vals
        self.stats["writes"] += alloc.nrows
        self.queue.count_external("host_write")
        return OpReceipt(True, "host_write", face=self.face,
                         n_ops=alloc.nrows, launches=1)


def make_torch_arena(num_slabs: int, pages_per_slab: int, page_elems: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> TorchArena:
    """A zeroed (num_slabs * pages_per_slab, page_elems) arena on
    ``device`` (None: the card) with a slab-grouped allocator."""
    buf = torch.zeros((num_slabs * pages_per_slab, page_elems), dtype=dtype,
                      device=resolve_device(device))
    alloc = SubarrayAllocator(arena_groups(num_slabs, pages_per_slab))
    return TorchArena(buffer=buf, allocator=alloc)
