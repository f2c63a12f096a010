"""Loss and train-step factories: microbatching, remat, clipping, the
optimizer.

The port's counterpart of the JAX package's ``training/train_step.py``.
``train_step(state, batch)`` runs on the device the state lives on; the
state is ``{"params": tree, "opt": optimizer state}`` and is updated in
place (see ``training/optimizer.py``).  Gradients are taken with
``torch.autograd.grad`` against aliases of the parameters (``detach()``
views that require grad), so the caller's tensors gain no ``.grad`` and
no ``requires_grad``.

Data parallel (``mesh=``, one process per rank): each rank takes the
gradients of its block of the global batch, summed over the mesh's data
axis in float32 before the clip, weighted by each block's token count,
together with the loss terms, so the loss, the gradient norm and the
update are those of the global batch.  The layout is chosen as the JAX
package chooses it, by the active ``sharding_env``:

* replicated (no ``sharding_env``, or ``fsdp=False``): parameters and
  optimizer state whole on every rank, the gradients summed by one
  ``all_reduce``;
* ZeRO-3 (``sharding_env(mesh, fsdp=True)``, the JAX launcher's
  layout): each leaf of the parameters and of the optimizer state is
  this rank's slice of the dim the FSDP hint splits
  (``param_specs``), the others whole.  The forward gathers each leaf
  where it is used (``sharding.gathering``; a layer's inside its remat
  body), and the gather's backward reduce-scatters the gradient in
  float32, each rank's times its token count and the sum divided by
  the total, which one small ``all_reduce`` gives before the forward;
  the whole leaves' gradients and the loss terms take the replicated
  path's ``all_reduce``.  The clip's norm sums the slices' squares over
  the axis; AdamW runs on the slices as it is; Adafactor sums its
  factored means over the axis where they reduce the split dim.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig, \
    ParallelConfig
from repro_torch.distributed.sharding import (StateShards, ZeroLayout, env,
                                              fsdp_dim, gather_params,
                                              gathering)
from repro_torch.models import transformer as T
from repro_torch.models.lm_head import fused_xent
from repro_torch.models.params import (param_specs, tree_leaves, tree_map,
                                       tree_unflatten)
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
        key = "out" if "out" in params["embed"] else "tok"
        table = gather_params(params["embed"][key], f"embed/{key}")
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


def zero_layout(cfg: ModelConfig, mesh,
                axis: str = "data") -> Optional[ZeroLayout]:
    """The ZeRO-3 layout of ``cfg``'s parameters over ``mesh``'s
    ``axis`` when a ``sharding_env`` with ``fsdp=True`` is active (the
    JAX launcher's), else None (replicated)."""
    e = env()
    if mesh is None or e.mesh is None or not e.fsdp:
        return None
    dims = {path: fsdp_dim(spec, axis) for path, spec in
            tree_leaves(param_specs(T.model_defs(cfg)))}
    return ZeroLayout(mesh, dims, axis)


def state_shards(state, layout: ZeroLayout) -> StateShards:
    """Each leaf of a training state (``{"params", "opt"}``) by its
    split dim: a parameter's, AdamW's moments as their parameter,
    Adafactor's factored moments where they keep the split dim (a row
    or column mean over it is whole), the step count whole."""
    dims = {}
    for path, t in tree_leaves(state):
        parts = path.split("/")
        d = None
        if parts[0] == "params":
            d = layout.dims["/".join(parts[1:])]
        elif parts[1] in ("m", "v"):
            d = layout.dims["/".join(parts[2:])]
        elif parts[1] == "fac":
            pd = layout.dims["/".join(parts[2:-1])]
            nd = t.ndim + (parts[-1] != "v")    # the parameter's rank
            if pd is None or parts[-1] == "v":
                d = pd
            elif parts[-1] == "vr":
                d = pd if pd < nd - 1 else None
            else:                               # vc: dims [:-2] + [-1:]
                d = {nd - 1: nd - 2, nd - 2: None}.get(pd, pd)
        dims[path] = d
    return StateShards(layout, dims)


def _token_count(labels: torch.Tensor, microbatches: int) -> torch.Tensor:
    """The loss's token count of this rank's batch as the step's metrics
    carry it (the microbatches' mean): the labels that are not
    ``IGNORE``."""
    return (labels != IGNORE).sum().float() / max(microbatches, 1)


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: OptimizerConfig,
                    state_dtype: torch.dtype = torch.float32, mesh=None,
                    data_axis: str = "data"):
    """(init_state(params), train_step(state, batch) -> (state,
    metrics)); metrics are 0-d tensors: loss, aux, tokens, grad_norm.
    With ``mesh`` the step is data parallel over ``data_axis`` (see the
    module docstring): ``batch`` is this rank's block.  Under
    ``sharding_env(mesh, fsdp=True)`` the state is the ZeRO-3 layout's
    (``train_step.layout``, else None): ``init_state`` cuts whole
    parameters to this rank's slices (slices are kept as they are)."""
    loss_fn = make_loss_fn(cfg, pcfg)
    layout = zero_layout(cfg, mesh, data_axis)
    opt_init, opt_update = make_optimizer(ocfg, state_dtype, layout)
    shapes = {path: d.shape for path, d in tree_leaves(T.model_defs(cfg))}

    def init_state(params):
        if layout is not None:
            def cut(path, t):
                if tuple(t.shape) != tuple(shapes[path]):
                    return t
                return layout.local(t, layout.dims[path]).clone()

            params = tree_unflatten(params, {
                path: cut(path, t) for path, t in tree_leaves(params)})
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

    def zero_grads(params, batch):
        """The ZeRO-3 step's gradients: the split leaves' summed by the
        gathers' backward, the whole leaves' and the loss terms by
        ``_sync_grads``."""
        count = _token_count(batch["labels"], pcfg.microbatches)
        layout.weigh(count, layout.psum(count.clone()))
        try:
            with gathering(layout):
                grads, metrics = grads_of(params, batch)
        finally:
            layout.weigh(None, None)
        flat = dict(tree_leaves(grads))
        whole = {p: g for p, g in flat.items() if layout.dims[p] is None}
        whole, metrics = _sync_grads(whole, metrics, mesh, data_axis)
        flat.update(whole)
        return tree_unflatten(grads, flat), metrics

    def train_step(state, batch):
        if layout is not None:
            grads, metrics = zero_grads(state["params"], batch)
        else:
            grads, metrics = grads_of(state["params"], batch)
            if mesh is not None:
                grads, metrics = _sync_grads(grads, metrics, mesh, data_axis)
        grads, gnorm = clip_by_global_norm(grads, ocfg.grad_clip, layout)
        params, opt = opt_update(state["params"], grads, state["opt"])
        return {"params": params, "opt": opt}, dict(metrics, grad_norm=gnorm)

    train_step.layout = layout
    return init_state, train_step


def make_eval_step(cfg: ModelConfig, pcfg: ParallelConfig):
    loss_fn = make_loss_fn(cfg, pcfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step


# ----------------------- serve steps (dry-run units) -------------------- #


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, tp=None,
                      rules=None):
    """``tp``: the serving engine's tensor-parallel collectives;
    ``rules``: the rule set's serving layout (``transformer.rule_layout``;
    see ``transformer.forward``); ``params``, ``batch``, ``cache`` and
    ``lengths`` are then this rank's blocks."""
    @torch.no_grad()
    def prefill_step(params, batch, cache, lengths):
        logits, new_cache, _ = T.forward(cfg, pcfg, params, batch,
                                         mode="prefill", cache=cache,
                                         lengths=lengths, tp=tp, rules=rules)
        return logits, new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig, tp=None,
                     rules=None):
    """``tp``, ``rules``: as :func:`make_prefill_step`."""
    @torch.no_grad()
    def decode_step(params, batch, cache, write_pos, lengths):
        return T.forward(cfg, pcfg, params, batch, mode="decode",
                         cache=cache, write_pos=write_pos, lengths=lengths,
                         tp=tp, rules=rules)

    return decode_step
