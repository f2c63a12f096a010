"""Opcode-keyed PiM op registry — pimolib's single extension point.

The port's counterpart of the JAX package's ``core/op_registry.py``.
Every PiM operation is one :class:`PimOpSpec` keyed by its
:class:`repro_torch.core.isa.Opcode`, carrying per-face executors:

* **model face** (``"device"``): ``device_seq`` names the
  :class:`repro_torch.core.memctrl.MemoryController` command sequence the
  POC runs when it decodes the opcode, ``device_insns`` builds the
  :class:`Instruction` list a :class:`repro_torch.core.pimolib.DeviceLib`
  call stages in the POC instruction buffer, and ``poc_post`` (optional)
  runs on the POC after the sequence (D-RaNGe deposits its bits);
* **torch face** (``"torch"``): ``torch_kind`` + ``torch_flush`` register
  a deferred op kind on every new
  :class:`repro_torch.core.pim_queue.PimOpQueue`, flushed as one
  coalesced kernel launch per kind per arena; ``torch_direct`` marks an
  op the face dispatches itself, with no queue kind (D-RaNGe).

Registering a new op is one :func:`register_pim_op` call plus its
executors on the faces that support it; :func:`supports` answers per
face, so callers fall back where a face lacks an op (``KV_WRITE`` has
no DDR3 sequence: the model face accounts it as a CPU write).

The torch-face flush executors below cover the built-in kinds:

* ``page_copy`` — RowClone copy (CoW forks), one batched launch for
  the whole pending batch over an arena pair (else one per arena),
  accounted per arena;
* ``page_init`` — RowClone-Init (init-on-free), one launch per arena per
  distinct fill value;
* ``page_and`` / ``page_or`` / ``page_not`` — Ambit bulk bitwise ops
  (``dst <- src OP dst``, ``dst <- ~src``), one launch a kind for the
  whole pending batch over an arena pair (else one per arena),
  accounted per arena;
* ``kv_write`` — token KV slot writes, one scatter launch per arena;
* ``ssm_state_write`` — SSM recurrent-state row writes.  The state lives
  in a state arena of its own, not in the (k, v) pair a generic queue
  flushes, so the default executor refuses; a serving cache's
  ``PagedStateArena`` rebinds the kind (and its ``state_copy`` /
  ``state_init`` siblings) with ``queue.register_kind``.

A flush executor is ``(queue, arenas, ops) -> arenas``: it updates the
arenas in place and counts its launches on the queue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ambit import ops as amb_ops
from repro_torch.kernels.rowclone import ops as rc_ops

from .isa import Instruction, Opcode

FACE_DEVICE = "device"
FACE_TORCH = "torch"


@dataclass(frozen=True)
class PimOpSpec:
    """One PiM op: opcode + per-face executors (None: the face does not
    support it)."""

    opcode: Opcode
    name: str                                  # OpReceipt.op on every face
    device_seq: Optional[str] = None           # MemoryController sequence
    device_insns: Optional[Callable] = None    # (lib, src, dst) -> [Instruction]
    poc_post: Optional[Callable] = None        # (poc, SequenceResult) -> None
    torch_kind: Optional[str] = None           # PimOpQueue kind name
    torch_flush: Optional[Callable] = None     # flush executor
    torch_direct: bool = False                 # dispatched by the face itself

    def supports(self, face: str) -> bool:
        if face == FACE_DEVICE:
            return self.device_seq is not None
        if face == FACE_TORCH:
            return self.torch_kind is not None or self.torch_direct
        raise ValueError(f"unknown face {face!r}")


_REGISTRY: Dict[Opcode, PimOpSpec] = {}


def register_pim_op(spec: PimOpSpec, *, override: bool = False) -> PimOpSpec:
    """Register ``spec`` as the implementation of its opcode.  Queues
    built afterwards pick up its torch kind; ``override=True`` replaces
    an existing registration, otherwise a duplicate opcode raises."""
    if spec.opcode in _REGISTRY and not override:
        raise ValueError(f"opcode {spec.opcode!r} already registered "
                         f"as {_REGISTRY[spec.opcode].name!r}")
    if (spec.torch_kind is None) != (spec.torch_flush is None):
        raise ValueError("torch_kind and torch_flush must be given together")
    _REGISTRY[spec.opcode] = spec
    return spec


def unregister_pim_op(opcode: Opcode) -> Optional[PimOpSpec]:
    """Remove and return the spec of ``opcode`` (None if none).  Queues
    built while it was registered keep the kind; later queues do not
    see it."""
    return _REGISTRY.pop(opcode, None)


def get_op(opcode: Opcode) -> Optional[PimOpSpec]:
    return _REGISTRY.get(opcode)


def ops_for_face(face: str) -> List[PimOpSpec]:
    return [s for s in _REGISTRY.values() if s.supports(face)]


def supports(opcode: Opcode, face: str) -> bool:
    spec = _REGISTRY.get(opcode)
    return spec is not None and spec.supports(face)


def queue_kinds() -> List[Tuple[str, Callable]]:
    """(kind, flush_fn) pairs every new PimOpQueue registers at birth,
    in registry insertion order."""
    return [(s.torch_kind, s.torch_flush) for s in _REGISTRY.values()
            if s.torch_kind is not None]


# ---------------------------------------------------------------------- #
# Model-face executors: Instruction builders + POC post hooks
# ---------------------------------------------------------------------- #


def _insns_rc_copy(lib, src, dst) -> List[Instruction]:
    return [Instruction(Opcode.RC_COPY, s, d)
            for s, d in zip(src.rows, dst.rows)]


def _insns_bulk_copy(lib, src, dst) -> List[Instruction]:
    return [Instruction(Opcode.BULK_COPY, s, d)
            for s, d in zip(src.rows, dst.rows)]


def _insns_rc_init(lib, src, dst) -> List[Instruction]:
    # src is unused: RowClone-Init copies the reserved all-zeros row of
    # the destination's subarray over each destination row.
    zero = lib.reserve_zero_row(dst.group)
    return [Instruction(Opcode.RC_INIT, zero, d) for d in dst.rows]


def _make_insns_ambit(opcode: Opcode) -> Callable:
    """Instruction builder for the two-operand Ambit ops
    (operand0 = src row, operand1 = dst row; dst <- src OP dst)."""
    def _build(lib, src, dst) -> List[Instruction]:
        return [Instruction(opcode, s, d) for s, d in zip(src.rows, dst.rows)]
    return _build


def _poc_deposit_rng(poc, res) -> None:
    """D-RaNGe post hook: sampled bits land in the POC RNG buffer."""
    if res.data is not None:
        for b in res.data:
            poc.rng_buffer.append(int(b))


# ---------------------------------------------------------------------- #
# Torch-face executors: PimOpQueue flush functions
# ---------------------------------------------------------------------- #


@dataclass
class KVWriteBatch:
    """Pending slot writes: full-depth K/V for a batch of tokens, kept
    stacked as (layers, batch, ...) so enqueue and flush do O(1) host
    work in the batch size."""

    pages: List[int]
    slots: List[int]
    k: torch.Tensor      # (layers, batch, kvh, hd)
    v: torch.Tensor

    @property
    def n(self) -> int:
        return len(self.pages)


@dataclass
class StateWriteBatch:
    """Pending SSM recurrent-state writes: full-depth conv window and SSD
    state for a batch of sequences, stacked as (groups,
    mamba_sublayers, batch, ...) so enqueue and flush do O(1) host work
    in the batch size."""

    rows: List[int]      # state-arena rows, one per batch entry
    conv: torch.Tensor   # (G, M, B, conv_width - 1, channels)
    ssm: torch.Tensor    # (G, M, B, nheads, head_dim, state_dim)

    @property
    def n(self) -> int:
        return len(self.rows)


def _flush_ssm_state_write(q, arenas, ops: List[StateWriteBatch]):
    """Registry default: refuse, since no state arena is bound."""
    raise RuntimeError(
        "ssm_state_write ops were enqueued on a queue with no bound "
        "state arena; rebind the kind via queue.register_kind(...)")


def _flush_page_copy(q, arenas, ops):
    """One launch for an arena pair (the (K, V) pages of a CoW fork),
    else one per arena; accounted as ``len(arenas)`` launches, as the
    JAX package counts them."""
    src = [s for s, _ in ops]
    dst = [d for _, d in ops]
    if len(arenas) == 2:
        rc_ops.pim_page_copy_batched_pair(arenas[0], arenas[1], src, dst)
    else:
        for a in arenas:
            rc_ops.pim_page_copy_batched(a, src, dst)
    q._count_launch("page_copy", len(arenas))
    return arenas


def group_inits_by_value(ops) -> Dict[float, List[int]]:
    """(page, value) records -> {value: pages}: one launch per distinct
    fill value."""
    by_value: Dict[float, List[int]] = {}
    for page, value in ops:
        by_value.setdefault(value, []).append(page)
    return by_value


def _flush_page_init(q, arenas, ops):
    """One launch per fill value for a (K, V) pair of one shape (both
    arenas' pages in one grid, one upload of the page list), else one
    per arena; accounted as ``len(arenas)`` launches per value, as the
    JAX package counts them."""
    pair = (len(arenas) == 2 and arenas[0].shape == arenas[1].shape
            and arenas[0].dtype == arenas[1].dtype)
    for value, pages in group_inits_by_value(ops).items():
        if pair:
            rc_ops.pim_page_init_batched_pair(arenas[0], arenas[1], pages,
                                              value)
        else:
            for a in arenas:
                rc_ops.pim_page_init_batched(a, pages, value)
        q._count_launch("page_init", len(arenas))
    return arenas


def _make_flush_bitwise(op: str, kind: str) -> Callable:
    """Flush executor of an Ambit kind: the whole pending (src, dst)
    batch, on bit patterns, in one layer-batched launch for an arena
    pair (the (K, V) pages), else one per arena; accounted as
    ``len(arenas)`` launches, as the JAX package counts them."""
    def _flush(q, arenas, ops):
        src = [s for s, _ in ops]
        dst = [d for _, d in ops]
        if len(arenas) == 2:
            amb_ops.pim_page_bitwise_batched_pair(arenas[0], arenas[1], src,
                                                  dst, op=op)
        else:
            for a in arenas:
                amb_ops.pim_page_bitwise_batched(a, src, dst, op=op)
        q._count_launch(kind, len(arenas))
        return arenas
    return _flush


def last_writer(pages: List[int], slots: List[int]) -> np.ndarray:
    """Indices of the writes that survive when duplicate (page, slot)
    destinations resolve to the last one enqueued, in enqueue order."""
    seen = set()
    keep = []
    for i in range(len(pages) - 1, -1, -1):
        key = (pages[i], slots[i])
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return np.asarray(keep[::-1], np.int64)


def _flush_kv_write(q, arenas, ops: List[KVWriteBatch]):
    if len(arenas) != 2:
        raise ValueError("kv_write flushes a (k, v) arena pair")
    k_arena, v_arena = arenas
    pages = [p for o in ops for p in o.pages]
    slots = [s for o in ops for s in o.slots]
    if len(ops) == 1:              # the common case: already stacked
        k_new, v_new = ops[0].k, ops[0].v
    else:
        k_new = torch.cat([o.k for o in ops], dim=1)   # (L, B, ...)
        v_new = torch.cat([o.v for o in ops], dim=1)
    # the queue promises that the last enqueued write to a slot wins; a
    # parallel scatter does not, so resolve duplicates here
    keep = last_writer(pages, slots)
    if keep.size != len(pages):
        pages = [pages[i] for i in keep]
        slots = [slots[i] for i in keep]
        idx = rc_ops.upload(keep, k_new.device)
        k_new, v_new = k_new[:, idx], v_new[:, idx]
    dev = k_arena.device
    P = k_arena.shape[1]
    # one pair launch; accounted as two, one per arena, as the JAX
    # package counts them
    rc_ops.kv_scatter_pair_inline(
        k_arena, v_arena, rc_ops.upload_index(pages, P, "page", dev),
        rc_ops.upload_index(slots, k_arena.shape[2], "slot", dev),
        k_new.to(device=dev, dtype=k_arena.dtype).contiguous(),
        v_new.to(device=dev, dtype=v_arena.dtype).contiguous())
    q._count_launch("kv_write", 2)
    return arenas


# ---------------------------------------------------------------------- #
# Built-in ops (the paper's case studies + the serving scatters), in the
# JAX package's registration order
# ---------------------------------------------------------------------- #

register_pim_op(PimOpSpec(
    opcode=Opcode.RC_COPY, name="rowclone_copy",
    device_seq="rowclone_copy", device_insns=_insns_rc_copy,
    torch_kind="page_copy", torch_flush=_flush_page_copy))

register_pim_op(PimOpSpec(
    opcode=Opcode.RC_INIT, name="rowclone_init",
    device_seq="rowclone_copy", device_insns=_insns_rc_init,
    torch_kind="page_init", torch_flush=_flush_page_init))

register_pim_op(PimOpSpec(
    opcode=Opcode.BULK_COPY, name="rowclone_bulk_copy",
    device_seq="rowclone_copy", device_insns=_insns_bulk_copy))

# TorchLib.rand launches the D-RaNGe kernel itself
register_pim_op(PimOpSpec(
    opcode=Opcode.DR_GEN, name="drange_rand",
    device_seq="drange_read", poc_post=_poc_deposit_rng,
    torch_direct=True))

# torch face only: slot-granular writes have no violated-timing DDR3
# sequence, so the model face reports them unsupported (trace replay
# prices them as CPU writes)
register_pim_op(PimOpSpec(
    opcode=Opcode.KV_WRITE, name="kv_write",
    torch_kind="kv_write", torch_flush=_flush_kv_write))

register_pim_op(PimOpSpec(
    opcode=Opcode.SSM_STATE_WRITE, name="ssm_state_write",
    torch_kind="ssm_state_write", torch_flush=_flush_ssm_state_write))

# Ambit bulk bitwise (Seshadri et al., MICRO'17): TRA command sequences
# on the model face, the layer-batched bitwise kernels on the torch face
register_pim_op(PimOpSpec(
    opcode=Opcode.AMB_AND, name="ambit_and",
    device_seq="ambit_and", device_insns=_make_insns_ambit(Opcode.AMB_AND),
    torch_kind="page_and", torch_flush=_make_flush_bitwise("and", "page_and")))

register_pim_op(PimOpSpec(
    opcode=Opcode.AMB_OR, name="ambit_or",
    device_seq="ambit_or", device_insns=_make_insns_ambit(Opcode.AMB_OR),
    torch_kind="page_or", torch_flush=_make_flush_bitwise("or", "page_or")))

register_pim_op(PimOpSpec(
    opcode=Opcode.AMB_NOT, name="ambit_not",
    device_seq="ambit_not", device_insns=_make_insns_ambit(Opcode.AMB_NOT),
    torch_kind="page_not", torch_flush=_make_flush_bitwise("not", "page_not")))
