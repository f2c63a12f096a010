"""Optimizers (AdamW, Adafactor) on trees of tensors.

The port's counterpart of the JAX package's ``training/optimizer.py``.
Trees are the nested dicts of ``models/params``.  The arithmetic is the
reference's, operation for operation: float32 math on every leaf, then
a cast to the parameter's or the state's dtype (``state_dtype``:
float32, or bfloat16 to halve the moments' memory).

The JAX functions return new trees; these update ``params`` and the
optimizer state in place, under ``torch.no_grad()``, and return them
(the JAX launcher donates its state to the jitted step for the same
reason: a 2.5 B-parameter model's master weights and moments take 30 GB,
and a second copy would not fit beside them on one card).  The step
count, learning rate and bias corrections stay 0-d tensors on the
parameters' device, so an update never waits for the card.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.params import tree_leaves, tree_map


def lr_schedule(ocfg: OptimizerConfig
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup + cosine decay to 10%."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = ocfg.lr * step / max(ocfg.warmup_steps, 1)
        frac = torch.clamp((step - ocfg.warmup_steps)
                           / max(ocfg.total_steps - ocfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = ocfg.lr * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < ocfg.warmup_steps, warm, cos)

    return fn


def global_norm(tree: Any, layout=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the
    leaves summed in the reference's order (sorted keys).  With a
    sharded state's ``layout`` (``distributed.sharding.StateShards``:
    ZeRO-3's, or the rule set's 2-D layout) each leaf's squares are
    summed over exactly the axes that split it, so a whole leaf is
    counted once."""
    if layout is None:
        return torch.sqrt(sum(x.float().square().sum()
                              for _, x in tree_leaves(tree)))
    groups: Dict[Tuple[str, ...], list] = {}
    whole = []
    for p, x in tree_leaves(tree):
        axes = layout.axes(p)
        (groups.setdefault(axes, []) if axes else whole).append(
            x.float().square().sum())
    total = 0.0
    for axes, sums in groups.items():
        total = total + layout.psum(torch.stack(sums).sum(), axes)
    return torch.sqrt(total + sum(whole))


def _write(dst: torch.Tensor, val32: torch.Tensor) -> None:
    """Store a float32 result in ``dst`` (cast to its dtype, as the
    reference's ``astype``), unless it was computed in ``dst`` itself."""
    if val32 is not dst:
        dst.copy_(val32)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float, layout=None
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping).  ``layout``:
    see :func:`global_norm`."""
    norm = global_norm(grads, layout)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for _, g in tree_leaves(grads):
        _write(g, g.float().mul_(scale))
    return grads, norm


# ------------------------------ AdamW ---------------------------------- #


def adamw_init(params: Any, state_dtype: torch.dtype = torch.float32
               ) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                  device=p.device)
    leaf = next(t for _, t in tree_leaves(params))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt: Dict[str, Any],
                 ocfg: OptimizerConfig):
    """One AdamW step; ``params`` and ``opt`` are updated in place and
    returned as (params, opt).  The moments keep the dtype
    ``adamw_init`` gave them (the reference's ``state_dtype``)."""
    step = opt["step"] + 1
    lr = lr_schedule(ocfg)(step)
    b1, b2, eps, wd = ocfg.b1, ocfg.b2, ocfg.eps, ocfg.weight_decay
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(opt["m"]),
            tree_leaves(opt["v"])):
        # ``x.float()`` is ``x`` itself for a float32 leaf, which is then
        # updated where it lies
        g32 = g.float()
        m32 = m.float().mul_(b1).add_((1 - b1) * g32)
        v32 = v.float().mul_(b2).add_((1 - b2) * g32 * g32)
        p32 = p.float()
        update = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(eps))
        update.add_(wd * p32)
        _write(p, p32.sub_(update.mul_(lr)))
        _write(m, m32)
        _write(v, v32)
    opt["step"] = step
    return params, opt


# ---------------------------- Adafactor -------------------------------- #


def adafactor_init(params: Any) -> Dict[str, Any]:
    """Factored second moments for >= 2-D params; full for 1-D."""

    def mk(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    leaf = next(t for _, t in tree_leaves(params))
    return {"fac": tree_map(mk, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _fac_of(fac: Any, path: str) -> Dict[str, torch.Tensor]:
    node = fac
    for k in path.split("/"):
        node = node[k]
    return node


@torch.no_grad()
def adafactor_update(params: Any, grads: Any, opt: Dict[str, Any],
                     ocfg: OptimizerConfig, layout=None):
    """One Adafactor step (update clipping d = 1); ``params`` and ``opt``
    are updated in place and returned as (params, opt).  With a sharded
    state's ``layout`` (``distributed.sharding.StateShards``) each leaf
    is this rank's block: a mean over a dim (a factored moment's, the
    update's RMS over every dim) sums over every axis that splits that
    dim, and the factors keep the dims that are not reduced
    (``train_step.state_shards`` names them)."""
    step = opt["step"] + 1
    lr = lr_schedule(ocfg)(step)
    beta2 = 1.0 - step.float() ** -0.8
    eps = 1e-30

    def mean(x, dim, axes, keepdim=False):
        """``x.mean(dim)``, over every rank's block of the dims ``axes``
        split."""
        if not axes:
            return x.mean(dim=dim, keepdim=keepdim)
        total = layout.psum(x.sum(dim=dim, keepdim=keepdim), axes)
        n = x.numel() if dim is None else x.shape[dim]
        return total / (n * layout.size(axes))

    def axes(path, dim=None):
        return () if layout is None else layout.axes(path, dim)

    for (path, p), (_, g) in zip(tree_leaves(params), tree_leaves(grads)):
        s = _fac_of(opt["fac"], path)
        g32 = g.float()
        g2 = g32 * g32 + eps
        if p.ndim >= 2:
            vr = beta2 * s["vr"] + (1 - beta2) * mean(g2, -1,
                                                      axes(path, -1))
            vc = beta2 * s["vc"] + (1 - beta2) * mean(g2, -2,
                                                      axes(path, -2))
            rms = (vr[..., None] * vc[..., None, :]) / (
                mean(vr, -1, axes(path, -2), keepdim=True)[..., None]
                + eps)
            update = g32 / (torch.sqrt(rms) + 1e-8)
            s["vr"], s["vc"] = vr, vc
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            update = g32 / (torch.sqrt(v) + 1e-8)
            s["v"] = v
        denom = torch.clamp(torch.sqrt(mean(update * update, None,
                                            axes(path))), min=1.0)
        p32 = p.float()
        _write(p, p32 - lr * update / denom - lr * ocfg.weight_decay * p32)
    opt["step"] = step
    return params, opt


def make_optimizer(ocfg: OptimizerConfig,
                   state_dtype: torch.dtype = torch.float32, layout=None):
    """(init(params), update(params, grads, opt)) for ``ocfg.name``, on
    a sharded state's blocks where a ``layout`` is given (AdamW is
    elementwise and needs nothing of it)."""
    if ocfg.name == "adamw":
        return (lambda p: adamw_init(p, state_dtype),
                lambda p, g, o: adamw_update(p, g, o, ocfg))
    if ocfg.name == "adafactor":
        return adafactor_init, lambda p, g, o: adafactor_update(
            p, g, o, ocfg, layout)
    raise ValueError(ocfg.name)
