"""int8 chunked gradient compression over ``torch.distributed``.

The port's counterpart of the JAX package's ``distributed/compression.py``.
For data-parallel replicated-gradient sync, a float32 all-reduce moves 4
bytes an element twice across the wire; the compressed alternative:

  1. each rank splits the tensor into ``world`` equal segments,
  2. quantizes to int8 with one float32 scale per (segment, block),
  3. ``all_to_all`` so rank r receives segment r from everyone,
  4. dequantizes and sums its segment in float32 (exact accumulation),
  5. re-quantizes the reduced segment and ``all_gather``s it.

Wire bytes: about a quarter of a float32 ring all-reduce (int8 payload
and scales), for one quantization error on the way in and one on the
way out.  :func:`psum_compressed` is a drop-in for a sum over one mesh
axis.  Like the JAX version's ``jnp`` body these are plain PyTorch ops;
the collectives are the mesh's (:class:`repro_torch.launch.mesh.Mesh`).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import tree_map

BLOCK = 256  # elements per quantization block


def _quantize(x: torch.Tensor):
    """x: (..., n) float32 -> (int8 codes (..., n/B, B), float32 scales
    (..., n/B, 1))."""
    n = x.shape[-1]
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad))
    xb = xp.reshape(*x.shape[:-1], -1, BLOCK)
    # all-zero blocks (the padding psum_compressed appends to reach
    # world * seg elements) must dequantize to exact zeros: they take
    # scale 1.0, so their codes are 0 (no division by a zero absmax)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    # a true division, as JAX's eager divide: a tensor divided by a
    # Python scalar is multiplied by its reciprocal, which rounds
    # differently
    scale = torch.where(absmax > 0.0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def _dequantize(codes: torch.Tensor, scale: torch.Tensor,
                n: int) -> torch.Tensor:
    xb = codes.to(torch.float32) * scale
    return xb.reshape(*codes.shape[:-2], -1)[..., :n]


def psum_compressed(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Compressed sum of ``x`` over mesh axis ``axis`` (every rank of the
    axis calls it on its own ``x``); any shape, flattened inside.
    Returns a new tensor in ``x``'s dtype."""
    world = mesh.shape[axis]
    shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    seg = -(-n // world)
    flat = torch.nn.functional.pad(flat, (0, seg * world - n)).reshape(
        world, seg)

    codes, scale = _quantize(flat)                  # (world, seg/B, B)
    # block j of dim 0 goes to rank j; block i received came from rank i
    codes_t = mesh.all_to_all_single(codes, axis)
    scale_t = mesh.all_to_all_single(scale, axis)
    # codes_t: (world, seg/B, B) — peer p's copy of MY segment
    mine = torch.sum(_dequantize(codes_t, scale_t, seg), dim=0)

    codes_r, scale_r = _quantize(mine[None])
    codes_all = mesh.all_gather(codes_r[0], axis)   # (world, ...)
    scale_all = mesh.all_gather(scale_r[0], axis)
    full = _dequantize(codes_all, scale_all, seg).reshape(-1)[:n]
    return full.reshape(shape).to(x.dtype)


def compressed_grad_sync(grads: Any, mesh, axis_name: str = "data") -> Any:
    """Tree-wise compressed all-reduce (replicated-gradient DP mode): the
    sum over ``axis_name`` of every leaf, as the JAX version's
    ``shard_map`` of :func:`psum_compressed` gives it.  A collective:
    every rank of the axis calls it with the same tree structure."""
    return tree_map(lambda g: psum_compressed(g, mesh, axis_name), grads)
