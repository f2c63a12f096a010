"""Model assembly for every family: layer groups, the stacked parameter
tree, the dense decode cache and the unified forward.

The port's counterpart of the JAX package's ``models/transformer.py``.
Parameters of a group are stacked along a leading ``layers`` dim; the
forward walks that dim with a Python loop where the JAX package used
``lax.scan``.  The serving engine's paged path runs its own forwards
over the paged arenas and kernels; :func:`forward` is the dense
reference (train, prefill, decode, features), the eager prefill
oracle's forward and the training path's, differentiable for every
family, with the reference's per-layer rematerialisation
(``pcfg.remat``; ``jax.checkpoint`` there, ``torch.utils.checkpoint``
here).

Families -> groups (the JAX package's layouts):
  dense / vlm    [(L, attn+mlp)]
  moe            [(k, attn+mlp), (L-k, attn+moe)]   (k = first dense)
  moe + MLA      same, attention = MLA
  ssm            [(L, mamba)]
  hybrid (jamba) [(L/P, superblock of P pairs: attn mixer at index
                  P/2-1, mamba elsewhere; MoE on odd pairs, MLP on even)]
  encdec         encoder [(Le, attn+mlp non-causal)],
                 decoder [(Ld, self-attn + cross-attn + mlp)]

Caches are nested dicts stacked along the same ``layers`` dim.  Where
the JAX forward returns a new cache, this one writes the caller's cache
tensors in place and returns them.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (RuleLayout, current_layout,
                                              gather_params, gathering,
                                              resolve_spec, sharding_env)
from . import attention as attn_mod
from . import layers as _layers
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import attn_defs
from .layers import (cast, embed, embed_defs, logits_out, mlp, mlp_defs,
                     rmsnorm, rmsnorm_def)
from .params import ParamDef, rule_specs, stacked, tree_leaves, tree_map

CACHE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------- #
# Layer kinds
# --------------------------------------------------------------------- #


def _sublayer_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    if kind in ("attn", "mla", "cross"):
        return {"norm": rmsnorm_def(d), "attn": attn_defs(cfg)}
    if kind == "mamba":
        return {"norm": rmsnorm_def(d), "ssm": ssm_mod.ssm_defs(cfg)}
    if kind == "mlp":
        return {"norm": rmsnorm_def(d),
                "mlp": mlp_defs(d, cfg.d_ff, cfg.activation)}
    if kind == "moe":
        return {"norm": rmsnorm_def(d), "moe": moe_mod.moe_defs(cfg)}
    raise ValueError(kind)


def _layer_defs(cfg: ModelConfig,
                layer_kind: Tuple[str, ...]) -> Dict[str, Any]:
    return {f"{i}_{k}": _sublayer_defs(cfg, k)
            for i, k in enumerate(layer_kind)}


def layer_groups(cfg: ModelConfig
                 ) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """((count, (sublayer kinds...)), ...) per family, as the JAX
    package lays them out."""
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm"):
        return ((L, ("attn", "mlp")),)
    if cfg.family == "moe":
        attn = "mla" if cfg.mla else "attn"
        k = cfg.moe.first_dense_layers
        groups = [(k, (attn, "mlp"))] if k else []
        groups.append((L - k, (attn, "moe")))
        return tuple(groups)
    if cfg.family == "ssm":
        return ((L, ("mamba",)),)
    if cfg.family == "hybrid":
        period = cfg.attn_every
        kinds = []
        for i in range(period):
            mixer = "attn" if i == period // 2 - 1 else "mamba"
            ffn = "moe" if (i % 2 == 1 and cfg.moe) else "mlp"
            kinds.extend([mixer, ffn])
        return ((L // period, tuple(kinds)),)
    if cfg.family == "encdec":
        return ((cfg.enc_layers, ("attn", "mlp")),
                (cfg.dec_layers, ("attn", "cross", "mlp")))
    raise ValueError(cfg.family)


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The stacked parameter tree (``embed``, ``final_norm``,
    ``group0``, ..., and the stub frontends' projections), laid out as
    the JAX package lays it."""
    defs: Dict[str, Any] = {"embed": embed_defs(cfg),
                            "final_norm": rmsnorm_def(cfg.d_model)}
    for gi, (count, kinds) in enumerate(layer_groups(cfg)):
        defs[f"group{gi}"] = stacked(_layer_defs(cfg, kinds), count)
    fd = cfg.frontend_dim or cfg.d_model
    if (cfg.family == "vlm" or cfg.num_patch_tokens) \
            and cfg.family != "encdec":
        defs["patch_proj"] = ParamDef((fd, cfg.d_model), (None, "embed"))
    if cfg.family == "encdec":
        defs["frame_proj"] = ParamDef((fd, cfg.d_model), (None, "embed"))
        defs["enc_final_norm"] = rmsnorm_def(cfg.d_model)
    return defs


# --------------------------------------------------------------------- #
# Caches
# --------------------------------------------------------------------- #


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0, kv_dtype: Optional[torch.dtype] = None
               ) -> Dict[str, Any]:
    """The decode cache's tensors on the ``meta`` device (shape and dtype
    only: the JAX package's ShapeDtypeStructs), stacked per group.
    ``kv_dtype`` overrides the attention caches' dtype; SSM states keep
    theirs."""
    hd = cfg.resolved_head_dim
    kvd = kv_dtype or CACHE_DTYPE

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def attn_cache(count):
        if cfg.mla:
            m = cfg.mla
            return (t((count, batch, max_len, m.kv_lora_rank), kvd),
                    t((count, batch, max_len, m.rope_head_dim), kvd))
        shape = (count, batch, max_len, cfg.num_kv_heads, hd)
        return t(shape, kvd), t(shape, kvd)

    def ssm_cache(count):
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        ch = d_in + 2 * s.state_dim
        return (t((count, batch, s.conv_width - 1, ch), CACHE_DTYPE),
                t((count, batch, d_in // s.head_dim, s.head_dim,
                   s.state_dim), torch.float32))

    def cross_cache(count):
        shape = (count, batch, enc_len, cfg.num_kv_heads, hd)
        return t(shape, CACHE_DTYPE), t(shape, CACHE_DTYPE)

    spec: Dict[str, Any] = {}
    for gi, (count, kinds) in enumerate(layer_groups(cfg)):
        if cfg.family == "encdec" and gi == 0:
            continue                        # the encoder holds no cache
        g: Dict[str, Any] = {}
        for i, k in enumerate(kinds):
            if k in ("attn", "mla"):
                g[f"{i}_{k}"] = attn_cache(count)
            elif k == "mamba":
                g[f"{i}_{k}"] = ssm_cache(count)
            elif k == "cross":
                g[f"{i}_{k}"] = cross_cache(count)
        if g:
            spec[f"group{gi}"] = g
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               *, device: DeviceLike = None,
               kv_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A zeroed decode cache on ``device`` (None: the card)."""
    dev = resolve_device(device)

    def zeros(s):
        if isinstance(s, tuple):
            return tuple(zeros(x) for x in s)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    return tree_map(zeros, cache_spec(cfg, batch, max_len, enc_len,
                                      kv_dtype))


def cache_pspecs(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = 0) -> Dict[str, Any]:
    """Per-dim mesh axes of the decode cache (needs an active
    ``sharding_env``): batch over the data axes, seq over ``model``
    (sequence parallelism for long KV), as the JAX package resolves
    them."""
    def one(s):
        # (layers, batch, seq?, ...): rank-dependent logical axes
        if len(s.shape) == 4 and s.shape[2] in (max_len, enc_len):
            la = ("layers", "batch", "seq", None)
        elif len(s.shape) == 5:
            la = ("layers", "batch", "seq", None, None)
        elif len(s.shape) == 3:
            la = ("layers", "batch", None)
        else:
            la = ("layers", "batch") + (None,) * (len(s.shape) - 2)
        return resolve_spec(s.shape, la)

    return tree_map(lambda pair: tuple(one(s) for s in pair),
                    cache_spec(cfg, batch, max_len, enc_len))


def rule_layout(cfg: ModelConfig, mesh, *,
                global_batch: Optional[int] = None, max_len: int = 0,
                enc_len: int = 0) -> RuleLayout:
    """This rank's share of the JAX rule set's layout on ``mesh``
    (``{"data", "model"}`` or ``{"pod", "data", "model"}``), as the JAX
    dryrun lays out its cells: ``forward(rules=...)``'s argument.  A
    serving step over ``global_batch`` rows with a cache of ``max_len``
    positions (and ``enc_len`` memory positions) also lays out that
    cache; a train step (``max_len`` 0) has none, and its batch is cut
    over the batch axes (``global_batch`` None).  Whole parameters are
    cut to this layout by ``params.rule_params``."""
    with sharding_env(mesh, multi_pod="pod" in mesh.shape, fsdp=True):
        cache = cache_pspecs(cfg, global_batch, max_len, enc_len) \
            if max_len else None
        return RuleLayout(
            mesh, dict(tree_leaves(rule_specs(model_defs(cfg), mesh))),
            cache, global_batch=global_batch, max_len=max_len,
            enc_len=enc_len)


# --------------------------------------------------------------------- #
# Sub-layer dispatch
# --------------------------------------------------------------------- #


def _run_sublayer(cfg, pcfg, kind, p, x, positions, *, mode, cache,
                  write_pos, lengths, memory, causal, tp=None, rules=None):
    """One pre-normed sublayer; returns (x, new cache, aux).  With ``tp``
    (the serving engine's tensor-parallel collectives) ``p`` holds this
    rank's slices: the attention's heads and KV heads (its cache the
    rank's KV-head slice) and the MLP's hidden units, whose row-parallel
    outputs (``wo``, the down projection) are summed over the model
    axis, as in the engine's fused steps.  With ``rules`` (the rule
    set's serving layout, every kind) ``p`` holds this rank's ``model``
    blocks, FSDP-gathered, and each kind sums over ``model`` what it
    split (``attention``, ``moe``, ``ssm``, ``layers.mlp``)."""
    if tp is not None and kind not in ("attn", "mlp"):
        raise NotImplementedError(f"sublayer kind {kind!r} under a mesh: "
                                  "the engine serves dense layers there")
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mla":
        out, new_cache = attn_mod.mla_attention(
            cfg, pcfg, p["attn"], h, positions, mode=mode, cache=cache,
            write_pos=write_pos, lengths=lengths, rules=rules)
    elif kind == "attn":
        out, new_cache = attn_mod.gqa_attention(
            cfg, pcfg, p["attn"], h, positions, mode=mode, causal=causal,
            cache=cache, write_pos=write_pos, lengths=lengths, rules=rules)
    elif kind == "cross":
        out, new_cache = attn_mod.gqa_attention(
            cfg, pcfg, p["attn"], h, positions, mode=mode, causal=False,
            cache=cache, write_pos=write_pos, lengths=None, memory=memory,
            is_cross=True, rules=rules)
    elif kind == "mamba":
        out, new_cache = ssm_mod.ssm_layer(cfg, pcfg, p["ssm"], h, mode=mode,
                                           cache=cache, rules=rules)
    elif kind == "mlp":
        out = mlp(p["mlp"], h, cfg.activation, rules=rules, d_ff=cfg.d_ff)
        new_cache = None
    elif kind == "moe":
        out, aux = moe_mod.moe_layer(cfg, pcfg, p["moe"], h, rules=rules)
        new_cache = None
    else:
        raise ValueError(kind)
    if tp is not None:
        out = tp.psum(out)
    return x + out, new_cache, aux


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products without batch dims (a
    projection's ``mm``, or an einsum's ``bmm`` over a batch of one),
    recompute the rest — ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_group(cfg, pcfg, kinds, gparams, x, positions, *, mode, gcache,
               write_pos, lengths, memory, causal, gname="group0",
               tp=None, rules=None):
    """One stacked layer group (``params[gname]``), a Python loop over
    its layers.  Each layer's cache is a view of the stacked ``gcache``;
    a sublayer that returns new cache tensors (an SSM's final state, a
    cross-attention prefill's memory k/v) has them copied into that
    view.  While autograd records (train, features), each layer's body
    is rematerialised as ``pcfg.remat`` says: "full" saves only its
    inputs, "dots" also its products without batch dims, "none"
    everything.  Under a ZeRO-3 layout (``sharding.gathering``) the body
    first gathers its layer's leaves, so a recompute gathers them again
    and only one layer is ever whole (the rule set's serving layout
    gathers its FSDP slices so, over the batch axes).  ``tp``,
    ``rules``: see :func:`_run_sublayer`.  Returns (x, gcache or None,
    the summed aux loss)."""
    leaf = gparams
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    # one view per layer from one unbind: its backward stacks the layers'
    # gradients once, where a select per layer would add a zero-filled
    # stacked tensor per layer
    layers = tree_map(lambda a: a.unbind(0), gparams)
    records = torch.is_grad_enabled() and not gcache and (
        x.requires_grad
        or any(t.requires_grad for _, t in tree_leaves(gparams)))
    remat = pcfg.remat if records else "none"
    # read while the forward runs: a recompute runs inside the backward,
    # on autograd's device thread for CUDA tensors
    layout = current_layout()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(leaf.shape[0]):
        p_layer = tree_map(lambda t: t[li], layers)

        def body(x, aux_sum, p_layer=p_layer, li=li):
            for i, k in enumerate(kinds):
                key = f"{i}_{k}"
                view = None
                if gcache and key in gcache:
                    view = tuple(c[li] for c in gcache[key])
                # a dense sublayer casts each of its leaves to the compute
                # dtype first (its norm to the stream's), so they gather in it
                p = p_layer[key] if layout is None else layout.gather_tree(
                    p_layer[key], f"{gname}/{key}", lead=1,
                    dtype=(_layers.COMPUTE_DTYPE if k in ("attn", "mlp")
                           else None))
                x, nc, aux = _run_sublayer(
                    cfg, pcfg, k, p, x, positions, mode=mode,
                    cache=view, write_pos=write_pos, lengths=lengths,
                    memory=memory, causal=causal, tp=tp, rules=rules)
                if view is not None and nc is not None:
                    for dst, src in zip(view, nc):
                        if src.data_ptr() != dst.data_ptr():
                            dst.copy_(src)
                aux_sum = aux_sum + aux
            return x, aux_sum

        if remat == "none":
            x, aux_sum = body(x, aux_sum)
        elif remat in ("full", "dots"):
            ctx = (functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots) if remat == "dots"
                   else noop_context_fn)
            x, aux_sum = checkpoint(body, x, aux_sum, use_reentrant=False,
                                    context_fn=ctx)
        else:
            raise ValueError(f"remat {remat!r}")
    return x, (gcache if gcache else None), aux_sum


# --------------------------------------------------------------------- #
# Forward entry points
# --------------------------------------------------------------------- #


def _input_embed(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                 tp=None, rules=None):
    """Token (and stub-frontend patch) embedding, vocab-parallel with
    ``tp`` (and with ``rules`` where the vocab divides ``model``);
    returns (x, positions)."""
    if tp is not None:
        x = tp.embed(params["embed"], batch["tokens"], cfg)
    else:
        # whole, in its own dtype: the lookup's backward sums a token's
        # rows in the table's dtype
        tok = gather_params(params["embed"]["tok"], "embed/tok")
        x = embed({"tok": tok}, batch["tokens"], cfg, rules=rules)
    if cfg.num_patch_tokens and "patch_embeds" in batch \
            and cfg.family != "encdec":
        if tp is not None:
            raise NotImplementedError("patch embeddings under a mesh: the "
                                      "engine serves the vlm family "
                                      "text-only")
        # the JAX einsum promotes the bf16 weights to the embeds' float32
        proj = gather_params(params["patch_proj"], "patch_proj")
        pe = cast(torch.einsum("bpe,ed->bpd", batch["patch_embeds"].float(),
                               cast(proj).float()))
        x = torch.cat([pe, x], dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(x.shape[:2])
    return x, positions


def _encoder(cfg, pcfg, params, batch, rules=None):
    proj = gather_params(params["frame_proj"], "frame_proj")
    frames = cast(torch.einsum("bse,ed->bsd", batch["frames"].float(),
                               cast(proj).float()))
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device).expand(frames.shape[:2])
    _, kinds = layer_groups(cfg)[0]
    h, _, _ = _run_group(cfg, pcfg, kinds, params["group0"], frames, pos,
                         mode="train", gcache=None, write_pos=None,
                         lengths=None, memory=None, causal=False,
                         rules=rules)
    return rmsnorm(h, gather_params(params["enc_final_norm"],
                                    "enc_final_norm"), cfg.norm_eps)


def _logits(cfg: ModelConfig, pcfg: ParallelConfig, params,
            x: torch.Tensor, tp=None, rules=None) -> torch.Tensor:
    """Output logits over the output table (the tied token table where
    there is none), vocab-parallel with ``tp`` (and with ``rules`` where
    the vocab divides ``model``)."""
    if tp is not None:
        return tp.logits(params["embed"], x, cfg, fp32=pcfg.logits_fp32)
    key = "out" if "out" in params["embed"] else "tok"
    table = gather_params(params["embed"][key], f"embed/{key}")
    return logits_out({"tok": table}, x, cfg, fp32=pcfg.logits_fp32,
                      rules=rules)


def forward(cfg: ModelConfig, pcfg: ParallelConfig, params,
            batch: Dict[str, torch.Tensor], *, mode: str,
            cache: Optional[Dict[str, Any]] = None,
            write_pos: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None, tp=None,
            rules: Optional[RuleLayout] = None):
    """The unified forward.

    train:    returns (logits, aux)
    prefill:  returns (logits of the last position (b, 1, V), cache, aux)
    decode:   returns (logits, cache)      [batch tokens are (b, 1)]
    features: returns (final-normed hidden states, aux)

    ``cache`` (from :func:`init_cache`) is written in place and returned;
    ``write_pos`` is the decode token's cache position, ``lengths`` the
    valid lengths (decode: including the token decoded).

    ``params`` may be this rank's slices: under a ZeRO-3 layout
    (``sharding.gathering``) each leaf is gathered where it is used;
    with ``tp`` (the serving engine's tensor-parallel collectives, dense
    layers only) the weights stay sliced, heads and KV heads local (the
    cache holds the rank's KV-head slice), the row-parallel outputs
    summed and the embedding and logits vocab-parallel, as the engine's
    fused steps run them.

    With ``rules`` (:func:`rule_layout`, every family) ``params``,
    ``batch``, ``lengths`` and ``cache`` are this rank's blocks under the
    JAX rule set's serving layout (``params.rule_params``,
    ``RuleLayout.cut_batch``, ``cut_cache``); the forward gathers each
    layer's FSDP slices over the batch axes where they are used,
    computes the function the whole forward computes for its batch
    block, and returns its batch block's logits, whole over the vocab,
    with its cache block written in place."""
    if rules is None:
        return _forward(cfg, pcfg, params, batch, mode=mode, cache=cache,
                        write_pos=write_pos, lengths=lengths, tp=tp)
    with gathering(rules.fsdp):
        return _forward(cfg, pcfg, params, batch, mode=mode, cache=cache,
                        write_pos=write_pos, lengths=lengths, rules=rules)


def _forward(cfg, pcfg, params, batch, *, mode, cache, write_pos, lengths,
             tp=None, rules=None):
    memory = None
    if cfg.family == "encdec" and mode != "decode":
        memory = _encoder(cfg, pcfg, params, batch, rules)
    x, positions = _input_embed(cfg, params, batch, tp, rules)
    if mode == "decode" and lengths is not None:
        # lengths count the context including the token decoded, whose
        # position is therefore lengths - 1
        positions = (lengths[:, None] - 1).to(torch.int32)

    groups = layer_groups(cfg)
    new_cache: Dict[str, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi in range(1 if cfg.family == "encdec" else 0, len(groups)):
        _, kinds = groups[gi]
        gname = f"group{gi}"
        x, ngc, aux = _run_group(
            cfg, pcfg, kinds, params[gname], x, positions, mode=mode,
            gcache=(cache or {}).get(gname), write_pos=write_pos,
            lengths=lengths, memory=memory, causal=True, gname=gname, tp=tp,
            rules=rules)
        if ngc is not None:
            new_cache[gname] = ngc
        aux_total = aux_total + aux

    x = rmsnorm(x, gather_params(params["final_norm"], "final_norm",
                                 dtype=x.dtype), cfg.norm_eps)
    if mode == "features":
        return x, aux_total
    if mode == "train":
        return _logits(cfg, pcfg, params, x, tp, rules), aux_total
    if mode == "prefill":
        return (_logits(cfg, pcfg, params, x[:, -1:], tp, rules), new_cache,
                aux_total)
    return _logits(cfg, pcfg, params, x, tp, rules), new_cache
