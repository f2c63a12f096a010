"""Mixture-of-Experts layer: the dense form and expert parallelism.

The port's counterpart of the JAX package's ``models/moe.py``.  Without
a mesh (or with ``moe_impl="dense"``) ``moe_layer`` runs the exact dense
form (``_dense_moe``, every token through every expert, weighted by its
top-k router probabilities).  Under a ``sharding_env`` whose mesh has a
``model`` axis dividing the expert count, and ``moe_impl="shard_map"``
(the default), it runs the JAX package's expert-parallel body
(:func:`_local_moe`) on each rank, one process per shard: experts are
split over ``model``, every rank sees every token of its batch block,
routes them all (router replicated), builds a capacity-bounded dispatch
table for its own experts with a sort-free cumsum ranking, runs them as
one batched product over the expert dim, scatter-adds the weighted
outputs, and the ranks' partial outputs are summed over ``model``
(``all_reduce`` in ``ParallelConfig.moe_psum_dtype``).  Tokens past an
expert's capacity are dropped, as in JAX.  A mesh that does not divide
the expert count takes the dense form.

Routing ties break to the lower expert index, as ``jax.lax.top_k``
breaks them: the top-k is taken from a stable descending sort.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.distributed.sharding import env
from .layers import cast, gelu, silu
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.expert_d_ff, m.num_experts
    defs = {
        "router": ParamDef((d, E), ("embed", None), init="small"),
        "w_gate": ParamDef((E, d, ff), ("experts", "embed", "ff")),
        "w_up": ParamDef((E, d, ff), ("experts", "embed", "ff")),
        "w_down": ParamDef((E, ff, d), ("experts", "ff", "embed")),
    }
    if m.num_shared_experts:
        sff = m.expert_d_ff * m.num_shared_experts
        defs.update({
            "shared_gate": ParamDef((d, sff), ("embed", "ff")),
            "shared_up": ParamDef((d, sff), ("embed", "ff")),
            "shared_down": ParamDef((sff, d), ("ff", "embed")),
        })
    return defs


def _act(g: torch.Tensor, activation: str) -> torch.Tensor:
    return silu(g) if activation == "swiglu" else gelu(g)


def _expert_ffn(w_gate, w_up, w_down, x, activation: str) -> torch.Tensor:
    """x: (E, C, d) through each expert's gated FFN -> (E, C, d)."""
    g = torch.bmm(x, w_gate)
    u = torch.bmm(x, w_up)
    return torch.bmm(_act(g, activation) * u, w_down)


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """Router probabilities and the top-k choice of each token.
    xf: (t, d).  Returns (probs (t, E), top_p (t, k) renormalised,
    top_e (t, k)), in float32."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, cfg.moe.top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_e[:, :k]


def _local_moe(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               num_experts: int, capacity: int, activation: str,
               model_axis: Optional[str] = None,
               psum_dtype: torch.dtype = torch.float32,
               mesh=None, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's MoE body (the JAX ``_local_moe``; with ``model_axis``
    its ``shard_map`` body over ``mesh``).

    x: (b, s, d), this rank's tokens; the expert weights are this
    rank's slices (E_local, ...), experts ``[index * E_local, (index +
    1) * E_local)``.  Returns (output summed over ``model_axis`` in x's
    dtype, the aux load-balance loss of these tokens).

    ``rules`` (a ``sharding.RuleLayout``, in place of ``model_axis`` and
    ``mesh``) sums over its ``model`` axis with the backward a train
    step needs: the tokens and their router weights, replicated, enter
    the rank's experts (their gradients summed over ``model``), and the
    combine's sum passes its cotangent through; the router and the aux
    loss stay replicated."""
    b, s, d = x.shape
    t = b * s
    e_local = w_gate.shape[0]
    if rules is not None:
        shard_idx = rules.index
    else:
        shard_idx = mesh.index(model_axis) if model_axis is not None else 0
    e_lo = shard_idx * e_local

    xf = x.reshape(t, d)
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, top_k)                     # (t, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # aux load-balance loss terms (Switch-style)
    me = probs.mean(dim=0)                                  # (E,)
    ce = F.one_hot(top_e, num_experts).float().sum(dim=1).mean(dim=0)
    aux = (me * ce).sum() * num_experts / top_k

    # dispatch: rank of each (token, k) within its expert, local only
    flat_e = top_e.reshape(-1)                              # (t*k,)
    is_local = (flat_e >= e_lo) & (flat_e < e_lo + e_local)
    local_e = torch.where(is_local, flat_e - e_lo,
                          torch.full_like(flat_e, e_local))  # e_local: trash
    onehot = F.one_hot(local_e, e_local + 1)
    pos = torch.cumsum(onehot, dim=0) * onehot              # 1-based rank
    rank = pos.sum(dim=1) - 1                               # (t*k,)
    ok = is_local & (rank < capacity)

    # dispatch table: buf[e, c] = token index + 1 (0 = empty)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    slot = (torch.where(ok, local_e, torch.full_like(local_e, e_local - 1))
            * capacity
            + torch.where(ok, rank, torch.full_like(rank, capacity - 1)))
    buf = torch.zeros(e_local * capacity, dtype=torch.long, device=x.device)
    buf.scatter_reduce_(0, slot, torch.where(ok, tok_idx + 1,
                                             torch.zeros_like(tok_idx)),
                        reduce="amax")
    buf = buf.view(e_local, capacity)

    if rules is not None:
        xf, top_p = rules.enter(xf), rules.enter(top_p)
    src = (buf - 1).clamp(min=0)
    filled = (buf > 0)[..., None]
    gathered = torch.where(filled, xf[src], torch.zeros((), dtype=xf.dtype,
                                                        device=x.device))
    h = _expert_ffn(w_gate, w_up, w_down, gathered.to(w_gate.dtype),
                    activation)                             # (E_l, C, d)

    # combine: weight by router prob, scatter-add back to tokens
    weight = torch.zeros(e_local * capacity, dtype=torch.float32,
                         device=x.device)
    weight.scatter_reduce_(0, slot, torch.where(
        ok, top_p.reshape(-1), torch.zeros_like(top_p.reshape(-1))),
        reduce="amax")
    weight = weight.view(e_local, capacity)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, src.reshape(-1),
                   (h.float() * weight[..., None] * filled).reshape(-1, d))

    if rules is not None:
        out = rules.psum(out.to(psum_dtype))
    elif model_axis is not None:
        out = mesh.all_reduce(out.to(psum_dtype), model_axis)
    return out.reshape(b, s, d).to(x.dtype), aux


def _dense_moe(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor, rules=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token through every expert (exact, no capacity drops).
    Returns (out in x's dtype, the Switch-style aux loss).  With
    ``rules`` the expert weights may be this rank's block of experts or
    of their hidden dim over ``model``; the tokens and the gate then
    enter the rank's block and the partial sums are summed over it."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs, top_p, top_e = route(cfg, p["router"], xf)
    onehot = F.one_hot(top_e, m.num_experts).float()          # (t,k,E)
    me = probs.mean(dim=0)
    ce = onehot.sum(dim=1).mean(dim=0)
    aux = (me * ce).sum() * m.num_experts / m.top_k

    w_gate = cast(p["w_gate"])
    e_l = w_gate.shape[0]
    gate = (onehot * top_p[..., None]).sum(dim=1)              # (t,E)
    split = rules is not None and (e_l < m.num_experts
                                   or w_gate.shape[2] < m.expert_d_ff)
    if split:
        xf, gate = rules.enter(xf), rules.enter(gate)
    h = _expert_ffn(w_gate, cast(p["w_up"]), cast(p["w_down"]),
                    xf.to(w_gate.dtype).expand(e_l, -1, -1),
                    cfg.activation)                            # (E,t,d)
    if e_l < m.num_experts:
        gate = gate.narrow(1, rules.index * e_l, e_l)
    out = torch.einsum("te,etd->td", gate, h.float())
    if split:
        out = rules.psum(out)
    return out.reshape(b, s, d).to(x.dtype), aux


def _capacity(cfg: ModelConfig, pcfg: ParallelConfig, tokens: int) -> int:
    """An expert's slots, as the JAX package sizes them from the step's
    global token count."""
    m = cfg.moe
    cf = pcfg.moe_capacity_factor or m.capacity_factor
    cap = int(math.ceil(tokens * m.top_k / m.num_experts * cf))
    return max(8, min(cap, tokens))


def _psum_dtype(pcfg: ParallelConfig) -> torch.dtype:
    return torch.bfloat16 if pcfg.moe_psum_dtype == "bfloat16" \
        else torch.float32


def _rules_moe(cfg: ModelConfig, pcfg: ParallelConfig,
               p: Dict[str, torch.Tensor], x: torch.Tensor, rules
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts in the rule set's layout: the JAX
    ``moe_layer`` under a mesh.  ``p``'s expert weights are this rank's
    block (its experts where their count divides ``model``); ``x`` this
    rank's batch block, the same on every ``model`` rank.  Where the
    experts divide ``model`` and ``moe_impl`` is ``shard_map`` this is
    the expert-parallel body with the capacity sized from the global
    token count (``x``'s tokens times the batch blocks, one where the
    batch is whole); else the dense form."""
    m = cfg.moe
    if pcfg.moe_impl == "dense" or m.num_experts % rules.model:
        return _dense_moe(cfg, p, x, rules)
    b, s, _ = x.shape
    return _local_moe(
        x, p["router"].float(), cast(p["w_gate"]), cast(p["w_up"]),
        cast(p["w_down"]), top_k=m.top_k, num_experts=m.num_experts,
        capacity=_capacity(cfg, pcfg, b * s * rules.batch_shards),
        activation=cfg.activation, psum_dtype=_psum_dtype(pcfg),
        rules=rules)


def moe_layer(cfg: ModelConfig, pcfg: ParallelConfig,
              p: Dict[str, torch.Tensor],
              x: torch.Tensor, rules=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss): the routed experts densely or expert
    parallel (see the module docstring), the shared experts on every
    token.

    Expert parallel, ``x`` is this rank's batch block (the data axes'
    split of the global batch, replicated over ``model``), so the
    capacity is sized, as the JAX package sizes it, from the global
    token count (the local one times the batch axes' extent).  The
    expert weights are full: each rank takes its own experts.

    ``rules`` (the rule set's layout, :func:`_rules_moe`): the weights
    are this rank's blocks, the shared experts' hidden dim over
    ``model`` where it divides (``x`` entering their block, their
    partial sums summed over it)."""
    m = cfg.moe
    e = env()
    mesh = e.mesh
    if rules is not None:
        out, aux = _rules_moe(cfg, pcfg, p, x, rules)
    elif (pcfg.moe_impl == "dense" or mesh is None
            or m.num_experts % mesh.shape["model"] != 0):
        out, aux = _dense_moe(cfg, p, x)
    else:
        b, s, _ = x.shape
        bsize = math.prod(mesh.shape[a] for a in e.batch_axes
                          if a in mesh.shape)
        e_local = m.num_experts // mesh.shape["model"]
        idx = mesh.index("model")

        def mine(w):
            return cast(w.narrow(0, idx * e_local, e_local))

        out, aux = _local_moe(
            x, p["router"].float(), mine(p["w_gate"]), mine(p["w_up"]),
            mine(p["w_down"]), top_k=m.top_k, num_experts=m.num_experts,
            capacity=_capacity(cfg, pcfg, b * s * bsize),
            activation=cfg.activation, model_axis="model",
            psum_dtype=_psum_dtype(pcfg), mesh=mesh)
    if m.num_shared_experts:
        sff = m.expert_d_ff * m.num_shared_experts
        split = rules is not None and p["shared_down"].shape[0] < sff
        xs = rules.enter(x) if split else x
        g = xs @ cast(p["shared_gate"])
        u = xs @ cast(p["shared_up"])
        sh = (_act(g, cfg.activation) * u) @ cast(p["shared_down"])
        out = out + (rules.psum(sh) if split else sh)
    return out, aux
