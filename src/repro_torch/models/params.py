"""Parameter descriptors: one definition drives init and shape checks.

The port's counterpart of the JAX package's ``models/params.py``: a
model module builds a nested dict of :class:`ParamDef` (shape + logical
axes + initializer), and :func:`init_params` materialises it as torch
tensors.  :func:`from_jax_params` instead takes the JAX package's
parameters (as numpy arrays) so the two packages can be compared on
identical weights — torch cannot reproduce ``jax.random``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    laxes: Tuple[Optional[str], ...]
    init: str = "fan_in"     # fan_in | normal | zeros | ones | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.laxes):
            raise ValueError(f"shape {self.shape} vs axes {self.laxes}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict (a ParamDef or any
    non-dict value is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order — the order
    ``jax.tree.flatten`` visits a dict, so leaf ``i`` here is leaf ``i``
    of the JAX package's tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def stacked(defs: Any, n: int) -> Any:
    """Prepend a layer dim of length n to every ParamDef in a tree."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.laxes, d.init,
                           d.scale), defs)


def _std(d: ParamDef) -> float:
    if d.init == "normal":
        return 0.02 * d.scale
    if d.init == "small":
        return 0.006 * d.scale
    # fan_in: scaled by 1/sqrt(fan_in); fan_in is the second-to-last dim
    # for rank >= 2 (the JAX package's rule, kept as it is)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[0]
    return d.scale / float(np.sqrt(max(fan_in, 1)))


def init_params(defs: Any, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Any:
    """Materialise a ParamDef tree on ``device`` with the same schemes as
    the JAX package (normal / small / fan_in / zeros / ones), drawn from
    ``generator``, which must live on that device.  The values are drawn
    on the device itself, so a full-width model never passes through
    host memory.  The draws differ from ``jax.random``'s for the same
    seed; compare the packages through :func:`from_jax_params`."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, "
                         f"parameters on {dev}")

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        out = torch.randn(d.shape, generator=generator, dtype=dtype,
                          device=dev)
        return out.mul_(_std(d))

    # draw in the JAX package's leaf order so a seed fixes every leaf
    flat = {path: make(d) for path, d in tree_leaves(defs)}
    return _unflatten(defs, flat)


def _unflatten(tree: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return flat[prefix]


def numpy_to_torch(a: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """One numpy array to a tensor of its own (a copy: the port updates
    arenas in place).  ``torch.from_numpy`` refuses
    ``ml_dtypes.bfloat16``, so bf16 passes through an int16 view of the
    same bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`numpy_to_torch`; bf16 comes back as an
    int16 view of the bits (``.view(ml_dtypes.bfloat16)`` restores
    the dtype)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def from_jax_params(np_tree: Any, device: DeviceLike = None) -> Any:
    """The JAX package's parameters, given as a nested dict of numpy
    arrays (``jax.tree.map(np.asarray, params)``), as the port's nested
    dict of tensors on ``device`` — bit for bit."""
    return tree_map(lambda a: numpy_to_torch(np.asarray(a), device), np_tree)


def param_count(defs: Any) -> int:
    return sum(d.size for _, d in tree_leaves(defs))
