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
* ZeRO-3 (``sharding_env(mesh, fsdp=True)`` on a mesh with one data
  axis and no model axis, the JAX launcher's layout): each leaf of the
  parameters and of the optimizer state is this rank's slice of the dim
  the FSDP hint splits (``param_specs``), the others whole.  The
  forward gathers each leaf where it is used (``sharding.gathering``; a
  layer's inside its remat body), and the gather's backward
  reduce-scatters the gradient in float32, each rank's times its token
  count and the sum divided by the total, which one small
  ``all_reduce`` gives before the forward; the whole leaves' gradients
  and the loss terms take the replicated path's ``all_reduce``.  The
  clip's norm sums the slices' squares over the axis; AdamW runs on the
  slices as it is; Adafactor sums its factored means over the axis
  where they reduce the split dim;
* the rule set's 2-D layout (``sharding_env(mesh, fsdp=True)`` on a
  mesh with a ``model`` axis or a pod axis, or ``rules=``: what
  ``jax.jit(step, in_shardings=...)`` runs in the JAX dryrun): every
  leaf of the parameters and of the optimizer state is the block
  ``param_specs`` gives this rank, tensor parallel over ``model`` (with
  the divisibility fallback) and FSDP over the batch axes, and the batch
  is split over the batch axes.  The forward is
  ``transformer.forward(rules=)``, whose model-axis collectives carry
  their backward (``sharding.RuleLayout``), and the loss's LM head runs
  over the rank's vocab block where the vocab is split
  (``lm_head.vocab_xent``).  The FSDP leaves' gradients are
  reduce-scattered over the batch axes as ZeRO-3's are, the other
  leaves' and the loss terms summed over the batch axes, never over
  ``model`` (every model rank holds the same batch block).  The clip and
  Adafactor sum over exactly the axes that split a leaf
  (``sharding.StateShards``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig, \
    ParallelConfig
from repro_torch.distributed.sharding import (RuleLayout, StateShards,
                                              ZeroLayout, batch_dim, env,
                                              gather_params, gathering)
from repro_torch.models import transformer as T
from repro_torch.models.lm_head import fused_xent, vocab_xent
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


def make_loss_fn(cfg: ModelConfig, pcfg: ParallelConfig,
                 rules: Optional[RuleLayout] = None):
    """loss_fn(params, batch) -> (total, metrics): the final features
    through ``fused_xent`` over the output table (the tied token table
    where there is none), plus ``AUX_WEIGHT`` times the MoE aux loss.
    With ``rules`` the forward runs on this rank's blocks
    (``transformer.forward(rules=)``) and a table split over ``model``
    by vocab takes ``vocab_xent``."""

    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        feats, aux = T.forward(cfg, pcfg, params, batch, mode="features",
                               rules=rules)
        key = "out" if "out" in params["embed"] else "tok"
        table = gather_params(params["embed"][key], f"embed/{key}")
        if rules is not None and table.shape[0] < cfg.vocab_size:
            nll, count = vocab_xent(feats, table, batch["labels"], rules)
        else:
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


def _sync_grads(grads, metrics, mesh, axis):
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
                   aux=flat[-2] / mesh.size(axis), tokens=total)
    return tree_unflatten(grads, dict(zip(paths, out))), metrics


def zero_layout(cfg: ModelConfig, mesh,
                axis: str = "data") -> Optional[ZeroLayout]:
    """The ZeRO-3 layout of ``cfg``'s parameters over ``mesh``'s
    ``axis`` when a ``sharding_env`` with ``fsdp=True`` is active (the
    JAX launcher's) on a mesh with neither a ``model`` axis nor a pod
    axis, else None (replicated, or the rule set's 2-D layout)."""
    e = env()
    if mesh is None or e.mesh is None or not e.fsdp or _two_d(mesh):
        return None
    dims = {path: batch_dim(spec, (axis,)) for path, spec in
            tree_leaves(param_specs(T.model_defs(cfg)))}
    return ZeroLayout(mesh, dims, axis)


def _two_d(mesh) -> bool:
    return mesh.shape.get("model", 1) > 1 or "pod" in mesh.shape


def train_rule_layout(cfg: ModelConfig, mesh) -> Optional[RuleLayout]:
    """The rule set's 2-D training layout of ``cfg`` on ``mesh`` when a
    ``sharding_env`` with ``fsdp=True`` is active on a mesh with a
    ``model`` axis or a pod axis, else None."""
    e = env()
    if mesh is None or e.mesh is None or not e.fsdp or not _two_d(mesh):
        return None
    return T.rule_layout(cfg, mesh)


def state_layout(cfg: ModelConfig, mesh, zero: Optional[ZeroLayout],
                 rules: Optional[RuleLayout]) -> Optional[StateShards]:
    """Where each parameter (and each AdamW moment) lives: the 2-D
    layout's specs, ZeRO-3's one data-axis dim, or None (whole)."""
    if rules is not None:
        return StateShards(mesh, rules.param_specs)
    if zero is None:
        return None
    specs = {}
    for path, d in tree_leaves(T.model_defs(cfg)):
        dim = zero.dims[path]
        specs[path] = tuple(zero.axis if i == dim else None
                            for i in range(len(d.shape)))
    return StateShards(mesh, specs)


def state_shards(state, layout: StateShards) -> StateShards:
    """Each leaf of a training state (``{"params", "opt"}``) by its
    spec: a parameter's (``layout``'s), AdamW's moments as their
    parameter, Adafactor's factored moments the dims they keep (a row or
    column mean over a split dim is whole over its axes), the step count
    whole."""
    specs = {}
    for path, t in tree_leaves(state):
        parts = path.split("/")
        if parts[0] == "params":
            sp = layout.specs["/".join(parts[1:])]
        elif parts[1] in ("m", "v"):
            sp = layout.specs["/".join(parts[2:])]
        elif parts[1] == "fac":
            pspec = layout.specs["/".join(parts[2:-1])]
            sp = {"v": pspec, "vr": pspec[:-1],
                  "vc": pspec[:-2] + pspec[-1:]}[parts[-1]]
        else:
            sp = ()
        specs[path] = sp
    return StateShards(layout.mesh, specs)


def _token_count(labels: torch.Tensor, microbatches: int) -> torch.Tensor:
    """The loss's token count of this rank's batch as the step's metrics
    carry it (the microbatches' mean): the labels that are not
    ``IGNORE``."""
    return (labels != IGNORE).sum().float() / max(microbatches, 1)


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: OptimizerConfig,
                    state_dtype: torch.dtype = torch.float32, mesh=None,
                    data_axis: str = "data",
                    rules: Optional[RuleLayout] = None):
    """(init_state(params), train_step(state, batch) -> (state,
    metrics)); metrics are 0-d tensors: loss, aux, tokens, grad_norm.
    With ``mesh`` the step is data parallel over ``data_axis`` (see the
    module docstring): ``batch`` is this rank's block.  Under
    ``sharding_env(mesh, fsdp=True)`` the state is the ZeRO-3 layout's,
    or on a mesh with a ``model`` or pod axis the rule set's 2-D
    layout's; ``rules`` (``transformer.rule_layout(cfg, mesh)``) asks
    for the 2-D layout outright.  ``train_step.layout`` (a
    ``StateShards``, else None) names where each parameter lives;
    ``init_state`` cuts whole parameters to this rank's blocks (blocks
    are kept as they are)."""
    if rules is None:
        rules = train_rule_layout(cfg, mesh)
    if rules is not None:
        mesh = rules.mesh
    zero = zero_layout(cfg, mesh, data_axis) if rules is None else None
    layout = state_layout(cfg, mesh, zero, rules)
    # the FSDP gather and the axes the loss terms sum over
    fsdp = zero if rules is None else rules.fsdp
    sync_axis = data_axis if rules is None else rules.batch_axes
    loss_fn = make_loss_fn(cfg, pcfg, rules)
    opt_init, opt_update = make_optimizer(ocfg, state_dtype, layout)
    shapes = {path: d.shape for path, d in tree_leaves(T.model_defs(cfg))}

    def init_state(params):
        if layout is not None:
            def cut(path, t):
                if tuple(t.shape) != tuple(shapes[path]):
                    return t
                return layout.part(path, t)

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

    def sharded_grads(params, batch):
        """The sharded step's gradients: the FSDP leaves' summed over the
        batch axes by the gathers' backward, the others' and the loss
        terms by ``_sync_grads`` (ZeRO-3: over its data axis)."""
        count = _token_count(batch["labels"], pcfg.microbatches)
        fsdp.weigh(count, fsdp.psum(count.clone()))
        try:
            with gathering(fsdp):
                grads, metrics = grads_of(params, batch)
        finally:
            fsdp.weigh(None, None)
        flat = dict(tree_leaves(grads))
        whole = {p: g for p, g in flat.items() if fsdp.dims[p] is None}
        whole, metrics = _sync_grads(whole, metrics, mesh, sync_axis)
        flat.update(whole)
        return tree_unflatten(grads, flat), metrics

    def train_step(state, batch):
        if fsdp is not None:
            grads, metrics = sharded_grads(state["params"], batch)
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
