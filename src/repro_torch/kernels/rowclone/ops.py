"""Wrappers for the RowClone kernels (``csrc/rowclone.cu``).

The port's counterpart of the JAX package's ``kernels/rowclone/ops.py``:
the public RowClone API (``pim_copy``, ``pim_init``, ``pim_page_copy``,
``pim_page_init``), the layer-batched ``pim_page_copy_batched`` and
``pim_page_init_batched`` (and ``pim_page_copy_batched_pair`` /
``pim_page_init_batched_pair``, one launch for an arena pair), and
``kv_scatter_inline`` /
``kv_scatter_pair_inline`` / ``kv_gather_inline``.  The JAX versions
donate the arena and return the new one; these update the arena in
place and return it.  On a CPU
tensor (or ``device="cpu"`` for ``pim_init``) each runs its plain
version in :mod:`.ref`; on a CUDA tensor it launches the kernel or
raises.  Arenas may carry any trailing dims: ``(P, ...)`` for the page
ops, ``(L, P, ...)`` for their batched forms and ``(L, P, S, ...)`` for
slot scatters.  An empty op batch launches nothing.

Host page lists reach the card through :func:`upload_index`: checked on
the host, staged in pinned memory and copied without a synchronise, so
no wrapper waits for the card (and a CUDA-graph capture can run beside
them).  The init and copy launches skip even that for lists of up to
:data:`INLINE_ROWS` pages and :data:`INLINE_PAIRS` (src, dst) pairs,
which travel in the launch's parameters.
The slot scatters take int32 indices already on the device and convert
nothing: a wrong dtype, device or layout raises.
"""

from __future__ import annotations

import functools
import math
from array import array
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build, count_launch
from . import ref

Index = Union[Sequence[int], np.ndarray, torch.Tensor]


def _host_index(idx: Index) -> np.ndarray:
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(idx, np.int32).reshape(-1))


def _row_bytes(arena: torch.Tensor, lead: int) -> int:
    return math.prod(arena.shape[lead:]) * arena.element_size()


def _check_arena(arena: torch.Tensor) -> None:
    if not arena.is_contiguous():
        raise ValueError("arena must be contiguous")


def _check_rows(idx: np.ndarray, limit: int, what: str) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= limit):
        raise IndexError(f"{what} out of range [0, {limit})")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a synchronise: the copy goes
    through pinned memory with ``non_blocking=True``, so it queues
    behind the work already enqueued instead of waiting for it to finish
    (a copy from pageable memory would).  The caching host allocator
    records the copy on the pinned block and hands the block out again
    only after the copy ran.  On the CPU the array itself, as a
    tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def upload_index(idx: Index, limit: int, what: str,
                 device: torch.device) -> torch.Tensor:
    """Host indices as an int32 tensor on ``device``, each checked to lie
    in ``[0, limit)`` on the host first (``IndexError`` otherwise), then
    uploaded by :func:`upload`."""
    a = _host_index(idx)
    _check_rows(a, limit, what)
    return upload(a, device)


#: (src, dst) pairs up to this many travel in a copy launch's parameters
#: (``kInlinePairs`` in ``csrc/rowclone.cu``); longer lists are uploaded
INLINE_PAIRS = 256
#: the bytes of a row one block of the copy moves (``kChunk``)
COPY_CHUNK = 16 * 1024


def _int_list(idx: Index) -> List[int]:
    if isinstance(idx, (list, tuple)):
        return list(map(int, idx))
    if isinstance(idx, torch.Tensor):
        return idx.reshape(-1).tolist()
    return np.asarray(idx).reshape(-1).tolist()


def _copy_ops(src_pages: Index, dst_pages: Index,
              limit: int) -> Tuple[List[int], List[int]]:
    """A copy batch's page lists as host ints, each checked to lie in
    ``[0, limit)`` (``IndexError`` otherwise), with every op but the last
    of each destination dropped (the last wins, as in the reference)."""
    src, dst = _int_list(src_pages), _int_list(dst_pages)
    if len(src) != len(dst):
        raise ValueError("src and dst page lists differ in length")
    if not src:
        return src, dst
    for what, rows in (("src page", src), ("dst page", dst)):
        if min(rows) < 0 or max(rows) >= limit:
            raise IndexError(f"{what} out of range [0, {limit})")
    if len(set(dst)) != len(dst):
        keep = ref.last_op_per_dst(dst)
        src, dst = [src[i] for i in keep], [dst[i] for i in keep]
    return src, dst


def _reads_a_write(src: List[int], dst: List[int]) -> bool:
    """Whether some op reads a row that another op writes (a row copied
    onto itself keeps its bytes, so it is no hazard)."""
    if set(src).isdisjoint(dst):
        return False
    writer = {d: i for i, d in enumerate(dst)}
    return any(writer.get(s, i) != i for i, s in enumerate(src))


@functools.lru_cache(maxsize=None)
def cluster_chunks() -> int:
    """The most ``COPY_CHUNK`` pieces of one layer's batch that the
    cluster route stages in shared memory (``rc_copy_cluster_chunks``:
    the card's largest cluster at the route's shared memory a block)."""
    return _build.load("rowclone").rc_copy_cluster_chunks()


def copy_route(row_bytes: Sequence[int], n: int, aligned: bool,
               capacity: Optional[int] = None) -> str:
    """How a batch of ``n`` ops over arenas of ``row_bytes`` rows runs when
    an op reads another's destination (without one it runs direct, one
    launch): ``"cluster"`` (one launch, each layer's batch staged in a
    cluster's shared memory), or ``"staged"`` (a layer's batch past the
    cluster's ``capacity`` in ``COPY_CHUNK`` pieces, by default
    :func:`cluster_chunks`, or rows not 16-byte aligned: two launches
    through a scratch buffer)."""
    chunks = max(n * -(-r // COPY_CHUNK) for r in row_bytes)
    if capacity is None:
        capacity = cluster_chunks()
    if aligned and chunks <= capacity:
        return "cluster"
    return "staged"


def launch_rows(arenas, lead: int, src: List[int], dst: List[int],
                name: str, launch: Callable[..., int],
                capacity: Callable[[], int]) -> str:
    """One page-row op (``csrc/page_rows.cuh``) of ops ``(src[i],
    dst[i])`` on every layer of each arena (``lead`` 2: ``(L, P, ...)``;
    1: one layer ``(P, ...)``), the ops already checked and free of
    duplicate destinations, in one launch (two on the staged route),
    counted under ``name``.  ``launch(desc, arenas, dev_idx, host_idx, n,
    identity, route, gather)`` issues one kernel launch and returns its
    cudaError_t; ``gather`` marks the staged route's first launch, a
    plain copy of the sources into scratch rows.  The op list travels in
    the launch's parameters when it is short, else it is uploaded by
    :func:`upload`.  The route is direct unless an op reads another's
    destination, then :func:`copy_route` against ``capacity()``.
    Returns the route."""
    n = len(src)
    geo = []                   # (base, layers, rows a layer, row bytes)
    for a in arenas:
        L, P = (a.shape[0], a.shape[1]) if lead == 2 else (1, a.shape[0])
        geo.append((a.data_ptr(), L, P, _row_bytes(a, lead)))
    dev_idx, host_idx = None, None
    if n > INLINE_PAIRS:
        # freed after the launch; the allocator reuses it only for work
        # queued behind the launch on the same stream
        uploaded = upload(np.asarray(src + dst, np.int32), arenas[0].device)
        dev_idx = uploaded.data_ptr()
    else:
        host_idx = array("i", src + dst).tobytes()

    def run(desc, identity: int, route: int, what: str,
            gather: bool = False) -> None:
        _build.check(launch(
            array("q", [v for d in desc for v in d]).tobytes(), len(desc),
            dev_idx, host_idx, n, identity, route, gather), what)

    route = "direct"
    if _reads_a_write(src, dst):
        route = copy_route([g[3] for g in geo], n,
                           all((b | r) % 16 == 0 for b, _, _, r in geo),
                           capacity())
    if route != "staged":
        run([(b, b, P, P, r, L) for b, L, P, r in geo], 0,
            0 if route == "direct" else 1, name)
        count_launch(name)
        return route
    # every source of every layer into scratch, then the op from scratch
    # into the destinations: two direct launches
    offs, total = [], 0
    for _, L, _, r in geo:
        offs.append(total)
        total += -(-(L * n * r) // 256) * 256
    scratch = torch.empty(total, dtype=torch.uint8, device=arenas[0].device)
    base = scratch.data_ptr()
    run([(b, base + o, P, n, r, L) for (b, L, P, r), o in zip(geo, offs)],
        2, 0, f"{name} (gather)", gather=True)
    run([(base + o, b, n, P, r, L) for (b, L, P, r), o in zip(geo, offs)],
        1, 0, f"{name} (scatter)")
    count_launch(name, 2)
    return route


def _launch_copy(arenas, lead: int, src: List[int], dst: List[int],
                 name: str) -> None:
    """``arena[l, dst[i]] <- arena[l, src[i]]`` for every layer ``l`` of
    each arena: :func:`launch_rows` on ``rc_copy_pages``."""
    lib = _build.load("rowclone")
    stream = _stream(arenas[0])
    launch_rows(arenas, lead, src, dst, name,
                lambda *args: lib.rc_copy_pages(*args[:-1], stream),
                cluster_chunks)


def pim_page_copy_batched(arena: torch.Tensor, src_pages: Index,
                          dst_pages: Index) -> torch.Tensor:
    """``arena[:, dst[i]] <- arena[:, src[i]]`` across every layer, in
    place.  Every copy reads the arena as it was before the batch, and
    of several ops with one destination the last wins: the wrapper drops
    the earlier ones on the host.  The page lists are host data (the op
    queue's records), so the wrapper also sees on the host whether a
    destination is another op's source, and picks the kernel's route
    (direct, or :func:`copy_route`)."""
    L, P = arena.shape[:2]
    src, dst = _copy_ops(src_pages, dst_pages, P)
    if not src:
        return arena
    if arena.device.type == "cpu":
        return ref.page_copy_batched(arena, torch.tensor(src),
                                     torch.tensor(dst))
    _check_cuda(arena, "pim_page_copy_batched")
    _launch_copy((arena,), 2, src, dst, "page_copy_batched")
    return arena


def pim_page_copy_batched_pair(a0: torch.Tensor, a1: torch.Tensor,
                               src_pages: Index, dst_pages: Index) -> None:
    """:func:`pim_page_copy_batched` with one op list on both arenas of a
    pair, in one launch (grid z picks the arena): a (K, V) pair of one
    shape, or the conv and SSD state arenas, whose rows differ in size
    and dtype.  Each arena is ``(L, P, ...)``; the pages must lie in
    both."""
    if a0.device != a1.device:
        raise ValueError("the pair's arenas lie on different devices")
    src, dst = _copy_ops(src_pages, dst_pages, min(a0.shape[1], a1.shape[1]))
    if not src:
        return
    if a0.device.type == "cpu":
        ref.page_copy_batched_pair(a0, a1, torch.tensor(src),
                                   torch.tensor(dst))
        return
    _check_cuda(a0, "pim_page_copy_batched_pair")
    _check_cuda(a1, "pim_page_copy_batched_pair")
    _launch_copy((a0, a1), 2, src, dst, "page_copy_batched")


def fill_pattern(value, dtype: torch.dtype) -> int:
    """The 32-bit word that repeats ``value``'s bit pattern in ``dtype``
    (the init kernels write whole words; byte k of a row or buffer is
    byte k % 4 of the word).  ``value`` rounds and casts as
    ``torch.tensor([value], dtype=dtype)`` does (bf16 0.1 is 0.100098,
    int32 1.5 is 1).  Cached: the key carries ``repr(value)``, since
    ``-0.0 == 0.0`` but their bits differ."""
    return _fill_pattern(repr(value), value, dtype)


@functools.lru_cache(maxsize=256)
def _fill_pattern(key: str, value, dtype: torch.dtype) -> int:
    raw = torch.tensor([value], dtype=dtype).view(torch.uint8).numpy()
    if raw.size not in (1, 2, 4):
        raise TypeError(f"the fill kernels support 1-, 2- and 4-byte dtypes, "
                        f"not {dtype}")
    word = np.tile(raw, 4 // raw.size)
    return int(word.view(np.uint32)[0])


#: page lists up to this long travel in an init launch's parameters
#: (``kInlineRows`` in ``csrc/rowclone.cu``); longer ones are uploaded
INLINE_ROWS = 512


def _launch_init(arenas, dst: np.ndarray, rows: int, layers: int,
                 row_bytes: int, value, name: str) -> None:
    """One ``rc_init_rows`` launch over one arena or two of one shape:
    ``arena[l, dst[i]] <- value`` for every layer ``l`` of each arena,
    the page list in the launch's parameters when it is short, else
    uploaded by :func:`upload`."""
    a0 = arenas[0]
    dev_idx, host_idx = None, dst.tobytes()
    if dst.size > INLINE_ROWS:
        # freed after the launch; the allocator reuses it only for work
        # queued behind the launch on the same stream
        staged = upload(dst, a0.device)
        dev_idx, host_idx = staged.data_ptr(), None
    _build.check(_build.load("rowclone").rc_init_rows(
        a0.data_ptr(), arenas[-1].data_ptr(), len(arenas), dev_idx,
        host_idx, rows, int(dst.size), layers, row_bytes,
        fill_pattern(value, a0.dtype), _stream(a0)), name)
    count_launch(name)


def pim_page_init_batched(arena: torch.Tensor, dst_pages: Index,
                          value) -> torch.Tensor:
    """``arena[:, dst[i]] <- value`` across every layer, in place."""
    dst = _host_index(dst_pages)
    if dst.size == 0:
        return arena
    L, P = arena.shape[:2]
    _check_rows(dst, P, "dst page")
    if arena.device.type == "cpu":
        return ref.page_init_batched(arena, torch.from_numpy(dst), value)
    _check_arena(arena)
    _launch_init((arena,), dst, P, L, _row_bytes(arena, 2), value,
                 "page_init_batched")
    return arena


def pim_page_init_batched_pair(k_arena: torch.Tensor, v_arena: torch.Tensor,
                               dst_pages: Index, value) -> None:
    """``pim_page_init_batched`` on both arenas of a (K, V) pair of one
    shape and dtype, in one launch (grid z picks the arena)."""
    if k_arena.shape != v_arena.shape or k_arena.dtype != v_arena.dtype \
            or k_arena.device != v_arena.device:
        raise ValueError("the pair's arenas differ in shape, dtype or "
                         "device")
    dst = _host_index(dst_pages)
    if dst.size == 0:
        return
    L, P = k_arena.shape[:2]
    _check_rows(dst, P, "dst page")
    if k_arena.device.type == "cpu":
        ref.page_init_batched_pair(k_arena, v_arena, torch.from_numpy(dst),
                                   value)
        return
    _check_arena(k_arena)
    _check_arena(v_arena)
    _launch_init((k_arena, v_arena), dst, P, L, _row_bytes(k_arena, 2),
                 value, "page_init_batched")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: no kernel for a tensor on {t.device}")
    _check_arena(t)


def pim_copy(src: torch.Tensor) -> torch.Tensor:
    """A fresh copy of ``src`` (any shape and dtype): one streamed pass
    that reads ``src`` once and writes the copy once.  The JAX package
    reshapes other ranks to ``(shape[0], -1)`` for its 2D kernel; the
    kernel here moves the contiguous bytes, so every rank is one flat
    copy."""
    if src.device.type == "cpu":
        return ref.copy_2d(src)
    _check_cuda(src, "pim_copy")
    out = torch.empty_like(src, memory_format=torch.contiguous_format)
    nbytes = src.numel() * src.element_size()
    if nbytes == 0:
        return out
    lib = _build.load("rowclone")
    _build.check(lib.rc_copy_flat(src.data_ptr(), out.data_ptr(), nbytes,
                                  _stream(src)), "copy_2d")
    count_launch("copy_2d")
    return out


def pim_init(shape, value, dtype: torch.dtype = torch.float32, *,
             device: DeviceLike = None) -> torch.Tensor:
    """A fresh ``shape`` buffer of ``value`` in ``dtype`` on ``device``
    (None: the card): one write-only pass with no read of the old
    contents (the calloc-vs-RowClone-Init point).  1-, 2- and 4-byte
    dtypes; an 8-byte one raises ``TypeError``."""
    dev = resolve_device(device)
    shape = tuple(int(d) for d in shape)
    pattern = fill_pattern(value, dtype)
    if dev.type == "cpu":
        return ref.init_2d(shape, value, dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    nbytes = out.numel() * out.element_size()
    if nbytes == 0:
        return out
    lib = _build.load("rowclone")
    _build.check(lib.rc_fill_flat(out.data_ptr(), nbytes, pattern,
                                  _stream(out)), "init_2d")
    count_launch("init_2d")
    return out


def pim_page_copy(arena: torch.Tensor, src_pages: Index,
                  dst_pages: Index) -> torch.Tensor:
    """``arena[dst[i]] <- arena[src[i]]`` on a ``(pages, ...)`` arena, in
    place: :func:`pim_page_copy_batched`'s semantics and kernel on one
    layer."""
    src, dst = _copy_ops(src_pages, dst_pages, arena.shape[0])
    if not src:
        return arena
    if arena.device.type == "cpu":
        return ref.page_copy(arena, torch.tensor(src), torch.tensor(dst))
    _check_cuda(arena, "pim_page_copy")
    _launch_copy((arena,), 1, src, dst, "page_copy")
    return arena


def pim_page_init(arena: torch.Tensor, dst_pages: Index,
                  value) -> torch.Tensor:
    """``arena[dst[i]] <- value`` on a ``(pages, ...)`` arena, in place;
    the arena is never read.  Pages of any byte length (a row that is
    not a multiple of 4 bytes is written byte by byte)."""
    dst = _host_index(dst_pages)
    if dst.size == 0:
        return arena
    P = arena.shape[0]
    _check_rows(dst, P, "dst page")
    if arena.device.type == "cpu":
        return ref.page_init(arena, torch.from_numpy(dst), value)
    _check_cuda(arena, "pim_page_init")
    _launch_init((arena,), dst, P, 1, _row_bytes(arena, 1), value,
                 "page_init")
    return arena


def _check_scatter(arena: torch.Tensor, pages: torch.Tensor,
                   slots: torch.Tensor, new: torch.Tensor) -> None:
    """A slot scatter's operands as the kernel takes them, or raise:
    arena (L, P, S, ...) and new (L, B, ...) of one dtype with equal
    slot rows, pages/slots (B,) int32, all contiguous on one device."""
    L, B = arena.shape[0], pages.shape[0]
    if new.shape[:2] != (L, B) or slots.shape != pages.shape \
            or new.numel() != L * B * arena.stride(2):
        raise ValueError(f"new {tuple(new.shape)} does not match arena "
                         f"{tuple(arena.shape)} and {B} slots")
    if new.dtype != arena.dtype or pages.dtype != torch.int32 \
            or slots.dtype != torch.int32:
        raise TypeError("new must have the arena's dtype and pages/slots "
                        "must be int32")
    if not (arena.is_contiguous() and new.is_contiguous()
            and pages.is_contiguous() and slots.is_contiguous()):
        raise ValueError("arena, new, pages and slots must be contiguous")
    dev = arena.get_device()
    if new.get_device() != dev or pages.get_device() != dev \
            or slots.get_device() != dev:
        raise ValueError("arena, new, pages and slots must share a device")


def kv_scatter_inline(arena: torch.Tensor, pages: torch.Tensor,
                      slots: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]] <- new[:, b]`` across every layer in
    one launch, in place.  arena: (L, P, S, ...); new: (L, B, ...) of the
    arena's dtype; pages/slots: (B,) int32 on the arena's device; all
    contiguous (see :func:`_check_scatter`; nothing is converted).
    Duplicate (page, slot) pairs must carry identical payloads (batch
    pad rows); the op queue resolves real duplicates before it calls
    this."""
    B = pages.shape[0]
    if B == 0:
        return arena
    _check_scatter(arena, pages, slots, new)
    L, P, S = arena.shape[:3]
    if arena.device.type == "cpu":
        ref.kv_scatter(arena.view(L, P, S, -1), pages, slots,
                       new.view(L, B, -1))
        return arena
    _launch_scatter((arena,), (new,), pages, slots)
    return arena


def kv_scatter_pair_inline(k_arena: torch.Tensor, v_arena: torch.Tensor,
                           pages: torch.Tensor, slots: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """:func:`kv_scatter_inline` on a (K, V) arena pair of one shape with
    one index list, in one launch (counted once as ``kv_scatter``)."""
    B = pages.shape[0]
    if B == 0:
        return
    if k_arena.shape != v_arena.shape:
        raise ValueError("the pair's arenas differ in shape")
    _check_scatter(k_arena, pages, slots, k_new)
    _check_scatter(v_arena, pages, slots, v_new)
    L, P, S = k_arena.shape[:3]
    if k_arena.device.type == "cpu":
        ref.kv_scatter_pair(k_arena.view(L, P, S, -1),
                            v_arena.view(L, P, S, -1), pages, slots,
                            k_new.view(L, B, -1), v_new.view(L, B, -1))
        return
    _launch_scatter((k_arena, v_arena), (k_new, v_new), pages, slots)


def _launch_scatter(arenas, news, pages: torch.Tensor,
                    slots: torch.Tensor) -> None:
    """One ``rc_kv_scatter`` launch over one arena or two of one shape
    (operands checked by :func:`_check_scatter`)."""
    a0 = arenas[0]
    L, P, S = a0.shape[:3]
    _build.check(_build.load("rowclone").rc_kv_scatter(
        a0.data_ptr(), arenas[-1].data_ptr(), news[0].data_ptr(),
        news[-1].data_ptr(), len(arenas), pages.data_ptr(), slots.data_ptr(),
        L, pages.shape[0], P, S, a0.stride(2) * a0.element_size(),
        _stream(a0)), "kv_scatter")
    count_launch("kv_scatter")


def kv_gather_inline(arena: torch.Tensor, pages: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """``arena[:, pages[b], slots[b]]`` -> (L, B, ...).  Reads have no
    kernel of their own (the JAX package has none either)."""
    return ref.kv_gather(arena, pages, slots)
