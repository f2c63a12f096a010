"""Logical-axis sharding rules and parameter-spec inference.

The port's copy of the JAX package's ``distributed/sharding.py``: models
annotate tensors with *logical* axis names, and :func:`resolve_spec`
turns them into a per-dim tuple of mesh axes (the port's
``PartitionSpec``: ``None``, an axis name, or a tuple of names for a dim
split over several axes), with the same divisibility fallback (a
logical axis whose dim does not divide the mesh axes' product stays
replicated) and the same FSDP hint (parameters get the largest
unsharded, divisible dim split over the batch axes).

The port runs one process per shard, so nothing is placed by a spec:
:func:`local_slice` cuts a full tensor to this rank's block of it,
exactly the block ``jax.device_put`` gives the device at this rank's
mesh coordinates, and :func:`shard` (a sharding constraint in JAX) is
the identity.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


def default_rules(multi_pod: bool) -> Dict[str, Tuple[str, ...]]:
    """Logical axis name -> tuple of mesh axis names (tried together)."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch_axes,
        "expert_batch": batch_axes,     # MoE token axis
        "seq": ("model",),              # sequence parallelism (activations/KV)
        "heads": ("model",),            # TP: attention heads
        "kv_heads": ("model",),         # TP: kv heads (GQA may fall back)
        "ff": ("model",),               # TP: MLP hidden
        "experts": ("model",),          # EP: expert dim
        "vocab": ("model",),            # TP: embedding/logits vocab
        "embed": (),                    # d_model: replicated (TP-wise)
        "dmodel_rp": (),                # row-parallel attn (off by default)
        "layers": (),                   # layer dim: never sharded
        "kv_lora": (),                  # MLA latent: replicated
        "state": (),                    # SSM state dim
    }


@dataclass
class ShardingEnv:
    mesh: Optional[object] = None
    rules: Dict[str, Tuple[str, ...]] = field(
        default_factory=lambda: default_rules(False))
    fsdp: bool = True
    batch_axes: Tuple[str, ...] = ("data",)


_tls = threading.local()


def env() -> ShardingEnv:
    return getattr(_tls, "env", None) or ShardingEnv(mesh=None)


@contextlib.contextmanager
def sharding_env(mesh, *, multi_pod: bool = False, fsdp: bool = True,
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Make ``mesh`` (anything with a ``shape`` dict; a
    :class:`repro_torch.launch.mesh.Mesh`) the current mesh of the
    ``with`` block, with the rule table and FSDP switch given."""
    prev = getattr(_tls, "env", None)
    _tls.env = ShardingEnv(
        mesh=mesh,
        rules=rules or default_rules(multi_pod),
        fsdp=fsdp,
        batch_axes=("pod", "data") if multi_pod else ("data",),
    )
    try:
        if mesh is not None:
            with mesh:
                yield _tls.env
        else:
            yield _tls.env
    finally:
        _tls.env = prev


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes],
                       dtype=np.int64)) if axes else 1


def resolve_spec(shape: Sequence[int], laxes: Sequence[Optional[str]],
                 *, fsdp_hint: bool = False) -> Spec:
    """Logical axes -> per-dim mesh axes with divisibility fallback
    (``()`` without a mesh, as JAX's ``P()``).  ``fsdp_hint``:
    additionally split the largest yet-unsharded dim over the batch
    axes (parameters only)."""
    e = env()
    if e.mesh is None:
        return ()
    assert len(shape) == len(laxes), (shape, laxes)
    spec: list = [None] * len(shape)
    used_mesh_axes: set = set()
    for i, name in enumerate(laxes):
        if name is None:
            continue
        axes = e.rules.get(name, ())
        if not axes:
            continue
        if any(a in used_mesh_axes for a in axes):
            continue
        size = _axes_size(e.mesh, axes)
        if size > 1 and shape[i] % size == 0:
            spec[i] = axes if len(axes) > 1 else axes[0]
            used_mesh_axes.update(axes)
    if fsdp_hint and e.fsdp and not any(a in used_mesh_axes
                                        for a in e.batch_axes):
        fs = _axes_size(e.mesh, e.batch_axes)
        # the largest unsharded, divisible dim (never the layers dim)
        cands = [
            (shape[i], i) for i in range(len(shape))
            if spec[i] is None and laxes[i] != "layers"
            and shape[i] % fs == 0 and shape[i] >= fs
        ]
        if cands:
            _, i = max(cands)
            spec[i] = (e.batch_axes if len(e.batch_axes) > 1
                       else e.batch_axes[0])
    return tuple(spec)


def _dim_axes(entry: Axes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under
    ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(n) // _axes_size(mesh, _dim_axes(a))
                 for n, a in zip(shape, spec))


def local_slice(tensor: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full ``tensor`` under ``spec`` (a
    view).  A dim split over several axes is split major-to-minor in the
    order they are named, as JAX splits it."""
    out = tensor
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n = _axes_size(mesh, axes)
        # row-major coordinate over the named axes
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.index(a)
        size = tensor.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def shard(x: torch.Tensor, *laxes: Optional[str]) -> torch.Tensor:
    """The identity: a rank's code holds its block already, and SPMD
    code places nothing (JAX's version is a sharding constraint)."""
    del laxes
    return x
