"""Loss and train-step factories: microbatching, remat, clipping, the
optimizer.

The port's counterpart of the JAX package's ``training/train_step.py``.
``train_step(state, batch)`` runs on the device the state lives on; the
state is ``{"params": tree, "opt": optimizer state}`` and is updated in
place (see ``training/optimizer.py``).  Gradients are taken with
``torch.autograd.grad`` against aliases of the parameters (``detach()``
views that require grad), so the caller's tensors gain no ``.grad`` and
no ``requires_grad``.

Data parallel (``mesh=``, one process per rank, parameters and
optimizer state replicated): each rank takes the gradients of its
block of the global batch, and one float32 ``all_reduce`` over the
mesh's data axis, before the clip, sums them weighted by each block's
token count, together with the loss terms, so the loss, the gradient
norm and the update are those of the global batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig, \
    ParallelConfig
from repro_torch.models import transformer as T
from repro_torch.models.lm_head import fused_xent
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from .optimizer import clip_by_global_norm, make_optimizer

IGNORE = -100
AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean xent over non-ignored labels; returns (loss, token_count)."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits.float(), -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    count = torch.clamp(mask.sum().to(torch.int32), min=1)
    return nll.sum() / count, count


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig):
    """loss_fn(params, batch) -> (total, metrics): the final features
    through ``fused_xent`` over the output table (the tied token table
    where there is none), plus ``AUX_WEIGHT`` times the MoE aux loss."""

    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        feats, aux = T.forward(cfg, pcfg, params, batch, mode="features")
        embed = params["embed"]
        table = embed["out"] if "out" in embed else embed["tok"]
        nll, count = fused_xent(feats, table, batch["labels"])
        loss = nll / torch.clamp(count, min=1)
        total = loss + AUX_WEIGHT * aux
        return total, {"loss": loss, "aux": aux, "tokens": count.float()}

    return loss_fn


def _grads(loss_fn, params, batch):
    """(grads, metrics) of one batch: a tree of gradients shaped and
    typed as ``params``."""
    paths = [p for p, _ in tree_leaves(params)]
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = [t for _, t in tree_leaves(alias)]
    with torch.enable_grad():
        total, metrics = loss_fn(alias, batch)
        flat = torch.autograd.grad(total, leaves, allow_unused=True)
    flat = [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, flat)]
    grads = tree_unflatten(params, dict(zip(paths, flat)))
    return grads, {k: v.detach() for k, v in metrics.items()}


def _sync_grads(grads, metrics, mesh, axis: str):
    """The global batch's gradients and loss terms from every rank's
    (one float32 ``all_reduce``): each rank's gradients and loss
    weighted by its token count, summed and divided by the total; the
    aux loss averaged over the ranks.  The sum runs in one flat buffer,
    and the float32 gradients returned are views of it (one more copy of
    the gradients, not three)."""
    paths = [p for p, _ in tree_leaves(grads)]
    leaves = [g for _, g in tree_leaves(grads)]
    n = metrics["tokens"].float()
    size = sum(g.numel() for g in leaves)
    flat = torch.empty(size + 3, dtype=torch.float32, device=n.device)
    off = 0
    for g in leaves:
        torch.mul(g.reshape(-1), n, out=flat[off:off + g.numel()])
        off += g.numel()
    flat[size:] = torch.stack([metrics["loss"].float() * n,
                               metrics["aux"].float(), n])
    mesh.all_reduce(flat, axis)
    total = flat[-1].clone()
    flat[:size].div_(total)
    out, off = [], 0
    for g in leaves:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    metrics = dict(metrics, loss=flat[-3] / total,
                   aux=flat[-2] / mesh.shape[axis], tokens=total)
    return tree_unflatten(grads, dict(zip(paths, out))), metrics


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: OptimizerConfig,
                    state_dtype: torch.dtype = torch.float32, mesh=None,
                    data_axis: str = "data"):
    """(init_state(params), train_step(state, batch) -> (state,
    metrics)); metrics are 0-d tensors: loss, aux, tokens, grad_norm.
    With ``mesh`` the step is data parallel over ``data_axis`` (see the
    module docstring): ``batch`` is this rank's block."""
    loss_fn = make_loss_fn(cfg, pcfg)
    opt_init, opt_update = make_optimizer(ocfg, state_dtype)

    def init_state(params):
        return {"params": params, "opt": opt_init(params)}

    def grads_of(params, batch):
        mb = pcfg.microbatches
        if mb <= 1:
            return _grads(loss_fn, params, batch)
        b = batch["tokens"].shape[0]
        if b % mb:
            raise ValueError(f"batch {b} does not split into {mb} "
                             "microbatches")
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        m_acc = None
        for i in range(mb):
            part = {k: v.reshape(mb, b // mb, *v.shape[1:])[i]
                    for k, v in batch.items()}
            g, metrics = _grads(loss_fn, params, part)
            for (_, a), (_, x) in zip(tree_leaves(g_acc), tree_leaves(g)):
                a.add_(x.float() / mb)
            m_acc = {k: (0 if m_acc is None else m_acc[k]) + v / mb
                     for k, v in metrics.items()}
        return g_acc, m_acc

    def train_step(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        if mesh is not None:
            grads, metrics = _sync_grads(grads, metrics, mesh, data_axis)
        grads, gnorm = clip_by_global_norm(grads, ocfg.grad_clip)
        params, opt = opt_update(state["params"], grads, state["opt"])
        return {"params": params, "opt": opt}, dict(metrics, grad_norm=gnorm)

    return init_state, train_step


def make_eval_step(cfg: ModelConfig, pcfg: ParallelConfig):
    loss_fn = make_loss_fn(cfg, pcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step


# ----------------------- serve steps (dry-run units) -------------------- #


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig):
    @torch.no_grad()
    def prefill_step(params, batch, cache, lengths):
        logits, new_cache, _ = T.forward(cfg, pcfg, params, batch,
                                         mode="prefill", cache=cache,
                                         lengths=lengths)
        return logits, new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig):
    @torch.no_grad()
    def decode_step(params, batch, cache, write_pos, lengths):
        return T.forward(cfg, pcfg, params, batch, mode="decode",
                         cache=cache, write_pos=write_pos, lengths=lengths)

    return decode_step
