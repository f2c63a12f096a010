"""pimolib for the port — PiDRAM's PiM operations library over torch
arenas.

The port's counterpart of the JAX face of the JAX package's
``core/pimolib.py``: :class:`PimLib`, :class:`OpReceipt` and
:class:`Blocking` keep their names and meaning, and
:class:`TorchArena` / :class:`TorchLib` / :func:`make_torch_arena` stand
where ``TpuArena`` / ``TpuLib`` / ``make_tpu_arena`` stood.  Arena
mutations route through the batched op queue
(:class:`repro_torch.core.pim_queue.PimOpQueue`) onto the RowClone
kernels; ``Blocking.FIN`` synchronises the card.  The model face
(``DeviceLib`` over the simulated DDR3 device) and the Ambit
``bitwise`` ops come with later slices.  ``rand`` and ``rand_u32`` draw
from the D-RaNGe generator kernel.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.drange import ops as dr_ops
from .allocator import Allocation, SubarrayAllocator, arena_groups
from .pim_queue import PimOpQueue

FACE_TORCH = "torch"


class Blocking(enum.Enum):
    ACK = "ack"    # return once the op is dispatched
    FIN = "fin"    # block until the op's effects are committed


@dataclass
class OpReceipt:
    """What every pimolib mutation returns: ``launches`` is the kernel
    launch count this call issued (0 with a deferred lib until the
    coalescing flush pays it), ``n_ops`` the logical row/page ops."""

    ok: bool
    op: str
    face: str = FACE_TORCH
    n_ops: int = 1
    launches: int = 0
    deferred: bool = False


class PimLib(abc.ABC):
    """The pimolib protocol: ``copy``/``init``/``write`` mutate pages
    named by :class:`Allocation` handles and return an
    :class:`OpReceipt`; ``read`` returns page contents (flushing
    deferred work first); ``flush`` drains the backlog; ``rand`` returns
    random bits.  ``Blocking.FIN`` is a full synchronisation point.
    (``bitwise`` joins the protocol with the Ambit slice.)"""

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
    """

    face = FACE_TORCH

    def __init__(self, arena: Optional[TorchArena] = None, *,
                 buffers: Optional[Sequence[torch.Tensor]] = None,
                 layered: Optional[bool] = None,
                 allocator: Optional[SubarrayAllocator] = None,
                 deferred: bool = False,
                 queue: Optional[PimOpQueue] = None,
                 device: DeviceLike = None) -> None:
        if arena is not None and buffers is not None:
            raise ValueError("pass either arena= or buffers=, not both")
        self.arena = arena
        self.deferred = deferred
        self.queue = queue if queue is not None else PimOpQueue()
        if self.queue.owner is not None:
            raise ValueError(
                "PimOpQueue is already driven by another lib; share ONE lib "
                "across clients for joint accounting instead")
        self.queue.owner = self
        self.stats = {"copies": 0, "inits": 0, "reads": 0, "writes": 0,
                      "rand_bits": 0}
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
                      allocator: Optional[SubarrayAllocator] = None) -> None:
        """Bind the buffers this lib flushes against (how the paged KV
        cache plugs its (k, v) pair into a caller's lib); a lib already
        bound refuses to rebind."""
        if self.queue.pending_ops:
            raise RuntimeError("cannot adopt buffers with pending ops")
        if self.buffers or self.arena is not None:
            raise RuntimeError("lib is already bound to arenas")
        self.buffers = list(buffers)
        self.layered = layered
        if allocator is not None:
            self.allocator = allocator

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
