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

Under ``sharding_env(mesh, fsdp=True)`` the JAX launcher's parameters
and optimizer state are split over the data axis (ZeRO-3) and GSPMD
gathers them where they are used.  The port does so by hand:
:class:`ZeroLayout` names each leaf's split dim, and a forward run
under :func:`gathering` gathers each leaf where it is used (the
layers' inside their remat body, so the recompute gathers again), its
gradient reduce-scattered back to the slice.

The JAX dryrun's steps run the whole rule set at once: tensor
parallelism over ``model`` (with the divisibility fallback), FSDP over
the batch axes (``("pod", "data")`` on the multi-pod mesh), the batch
over the batch axes and the decode cache's sequence over ``model``.
:class:`RuleLayout` is a rank's share of that: its FSDP gather (a
:class:`ZeroLayout` over the batch axes, whose backward reduce-scatters
a training step's gradients) and the model axis's collectives the
layers call where a dim they contract is split
(``transformer.forward(rules=)``), each with the backward GSPMD gives it
(:meth:`RuleLayout.psum`, :meth:`RuleLayout.enter`,
:meth:`RuleLayout.gather`).  :class:`StateShards` names where every leaf
of a training state lives, for the optimizer, the clip and the
checkpoint.
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


# --------------------------------------------------------------------- #
# The ZeRO-3 layout of a training state (``sharding_env(mesh, fsdp=True)``)
# --------------------------------------------------------------------- #


def batch_dim(spec: Spec, batch_axes: Tuple[str, ...]) -> Optional[int]:
    """The dim a parameter spec splits over the batch axes (the FSDP
    hint's dim), whatever it splits over ``model``, or None."""
    for i, entry in enumerate(spec):
        if _dim_axes(entry) == tuple(batch_axes):
            return i
    return None


class _Gather(torch.autograd.Function):
    """A leaf's slices all-gathered along its dim, cast to ``dtype``
    first when one is given (the cast commutes with the gather, and a
    bf16 gather moves half a float32 one's bytes); the backward
    reduce-scatters the full gradient, in float32, back to the slice in
    the leaf's dtype: each rank's gradient times its token count, summed
    over the axis, divided by the total (:meth:`ZeroLayout.weigh`), as
    the replicated step's ``_sync_grads`` sums it."""

    @staticmethod
    def forward(ctx, x, layout, dim, dtype):
        ctx.layout, ctx.dim, ctx.dtype = layout, dim, x.dtype
        if dtype is not None:
            x = x.to(dtype)
        return layout.mesh.all_gather(x, layout.axis, dim)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.layout
        g32 = g.float()
        if lay.count is not None:
            g32 = g32 * lay.count
        out = lay.mesh.reduce_scatter(g32, lay.axis, ctx.dim)
        if lay.total is not None:
            out = out.div_(lay.total)
        return out.to(ctx.dtype), None, None, None


class ZeroLayout:
    """Where a ZeRO-3 training state lives: every leaf whose parameter
    spec (``param_specs`` with the FSDP hint) splits a dim over the mesh
    axis ``axis`` is held as this rank's slice of that dim, the others
    replicated.  ``dims`` maps a leaf's path (``tree_leaves``' paths, of
    the parameter tree) to its dim or None.

    :meth:`gather` hands the forward a leaf's full tensor (an autograd
    gather whose backward reduce-scatters the gradient); :meth:`psum`
    sums over the axis.  ``count`` and ``total`` (0-d
    float32 tensors, this rank's token count and the axis's) weight the
    gradient sum; :meth:`weigh` sets them before a backward."""

    def __init__(self, mesh, dims: Dict[str, Optional[int]],
                 axis: Union[str, Tuple[str, ...]] = "data") -> None:
        self.mesh = mesh
        self.axis = axis
        self.dims = dict(dims)
        self.count: Optional[torch.Tensor] = None
        self.total: Optional[torch.Tensor] = None

    def weigh(self, count: torch.Tensor,
              total: Optional[torch.Tensor]) -> None:
        self.count, self.total = count, total

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, self.axis)

    def gather(self, x: torch.Tensor, dim: Optional[int],
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``x``'s full tensor (``x`` itself for a replicated leaf), cast
        to ``dtype`` if given (a consumer that casts first)."""
        if dim is None:
            return x
        return _Gather.apply(x, self, dim, dtype)

    def gather_tree(self, tree, prefix: str, lead: int = 0,
                    dtype: Optional[torch.dtype] = None):
        """``tree`` (the parameter subtree at ``prefix``; ``lead`` leading
        dims already indexed away, as a layer's view of a stacked group)
        with every split leaf gathered (cast to ``dtype`` if given)."""
        if isinstance(tree, dict):
            return {k: self.gather_tree(v, f"{prefix}/{k}" if prefix
                                        else k, lead, dtype)
                    for k, v in tree.items()}
        dim = self.dims[prefix]
        return self.gather(tree, None if dim is None else dim - lead, dtype)



def current_layout() -> Optional[ZeroLayout]:
    """The :class:`ZeroLayout` a forward runs under (:func:`gathering`),
    or None: parameters are whole."""
    return getattr(_tls, "zero", None)


@contextlib.contextmanager
def gathering(layout: Optional[ZeroLayout]):
    """Run the ``with`` block's forwards on ``layout``'s slices: the
    model gathers each leaf where it is used."""
    prev = getattr(_tls, "zero", None)
    _tls.zero = layout
    try:
        yield layout
    finally:
        _tls.zero = prev


def gather_params(tree, prefix: str, lead: int = 0,
                  dtype: Optional[torch.dtype] = None):
    """:meth:`ZeroLayout.gather_tree` under the current layout, else
    ``tree`` itself.  ``dtype``: the dtype every consumer of the leaves
    casts them to first, gathered in it."""
    layout = current_layout()
    if layout is None:
        return tree
    return layout.gather_tree(tree, prefix, lead, dtype)


class StateShards:
    """Where every leaf of a training state lives: ``specs`` maps a
    leaf's '/'-joined path to its spec (per dim: None, a mesh axis, or a
    tuple of axes), the block :func:`local_slice` cuts.  ZeRO-3 names
    one data-axis dim a leaf; the rule set's layout a ``model`` dim
    and a dim over the batch axes.

    The optimizer and the clip read which axes split a leaf (or one of
    its dims, :meth:`axes`) and sum over them (:meth:`psum`); a
    checkpoint reads the whole leaf from every rank's block
    (:meth:`whole`, a collective every rank joins) and cuts this rank's
    block of a whole one (:meth:`part`), so it keeps the one-device
    layout."""

    def __init__(self, mesh, specs: Dict[str, Spec]) -> None:
        self.mesh = mesh
        self.specs = {p: tuple(s) for p, s in specs.items()}

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def dims(self) -> Dict[str, Optional[int]]:
        """Each leaf's first split dim, or None for a whole leaf."""
        return {p: next((i for i, e in enumerate(s) if _dim_axes(e)), None)
                for p, s in self.specs.items()}

    def axes(self, path: str, dim: Optional[int] = None
             ) -> Tuple[str, ...]:
        """The mesh axes that split dim ``dim`` of the leaf (every dim
        when None), in its spec's order."""
        spec = self.specs[path]
        if dim is not None:
            return _dim_axes(spec[dim]) if spec else ()
        return tuple(a for e in spec for a in _dim_axes(e))

    def size(self, axes: Tuple[str, ...]) -> int:
        return _axes_size(self.mesh, tuple(axes))

    def psum(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """``x`` summed in place over ``axes``: the batch axes together,
        then ``model``."""
        lead = tuple(a for a in axes if a != "model")
        if lead:
            self.mesh.all_reduce(x, lead)
        if "model" in axes:
            self.mesh.all_reduce(x, "model")
        return x

    def whole(self, path: str, x: torch.Tensor) -> torch.Tensor:
        for dim, entry in enumerate(self.specs[path]):
            if _dim_axes(entry):
                x = self.mesh.all_gather(x, _dim_axes(entry), dim)
        return x

    def part(self, path: str, x: torch.Tensor) -> torch.Tensor:
        return local_slice(x, self.specs[path], self.mesh).clone()

    def whole_shape(self, path: str, shape) -> Tuple[int, ...]:
        spec = self.specs[path] + (None,) * (len(shape) - len(
            self.specs[path]))
        return tuple(int(n) * _axes_size(self.mesh, _dim_axes(e))
                     for n, e in zip(shape, spec))


# --------------------------------------------------------------------- #
# The rule set's layout (the JAX dryrun's train, prefill and decode steps)
# --------------------------------------------------------------------- #


class _Psum(torch.autograd.Function):
    """A rank's partial result summed over ``model`` (out of place): the
    sum is replicated, and each partial's cotangent is the sum's, so the
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """A replicated tensor entering a rank's own computation (a product
    with its block of a split weight, or its heads taken out of a whole
    tensor): the identity, whose backward sums the ranks' partial
    cotangents over ``model``, so the tensor's gradient is whole on
    every rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, "model"), None


class _GatherModel(torch.autograd.Function):
    """A tensor split along ``dim`` over ``model`` gathered whole (a
    replicated result, whose cotangent is whole on every rank): the
    backward keeps this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.n, ctx.index = dim, x.shape[dim], mesh.index("model")
        return mesh.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class RuleLayout:
    """One rank's share of the JAX rule set's layout on a ``(pod x) data
    x model`` mesh (``transformer.rule_layout`` builds it): parameters
    under ``param_specs`` (a dict by leaf path) with the FSDP hint, the
    batch over the batch axes where it divides them (``batch_shards``
    blocks, else whole), and for a serving step the decode cache under
    ``cache_specs`` (``cache_pspecs``: its sequence over ``model`` where
    the length divides it).

    ``fsdp`` is the FSDP gather, a :class:`ZeroLayout` over the batch
    axes whose ``dims`` are each leaf's FSDP dim: a forward under
    ``sharding.gathering(fsdp)`` gathers a layer's leaves where they are
    used, so a leaf then holds its ``model`` block only.  The layers
    read what is split from their leaves' shapes (a dim shorter than the
    config's is this rank's block over ``model``) and call the model
    axis's collectives below where a split dim is contracted or a whole
    one is needed: a path computed whole on every model rank (a dim the
    fallback leaves whole) is never summed over ``model``.
    ``max_len`` and ``enc_len`` are the cache's full sequence lengths
    (0 for a train step, which has no cache).

    Under autograd (a train step) every model rank holds the same batch
    block, so the loss is the same on each, and a replicated tensor's
    gradient must come out whole on each: :meth:`psum` (a partial made
    replicated) passes its cotangent through, :meth:`enter` (a
    replicated tensor used by a rank's own computation) sums its
    cotangent over ``model``, and :meth:`gather` keeps this rank's block
    of it.  A leaf whole over ``model`` that only replicated paths use
    needs no sum; one whose output feeds a rank's own computation is
    entered."""

    def __init__(self, mesh, param_specs: Dict[str, Spec], cache_specs=None,
                 *, global_batch: Optional[int] = None, max_len: int = 0,
                 enc_len: int = 0) -> None:
        self.mesh = mesh
        self.param_specs = dict(param_specs)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in mesh.shape)
        self.fsdp = ZeroLayout(
            mesh, {p: batch_dim(s, self.batch_axes)
                   for p, s in param_specs.items()}, axis=self.batch_axes)
        self.cache_specs = cache_specs
        self.model = int(mesh.shape.get("model", 1))
        self.index = mesh.index("model") if self.model > 1 else 0
        nb = _axes_size(mesh, self.batch_axes)
        #: the batch blocks the global batch is cut into (1: whole; a
        #: train step's batch, ``global_batch`` None, is cut)
        self.batch_shards = nb if nb > 1 and (
            global_batch is None or global_batch % nb == 0) else 1
        self.max_len, self.enc_len = max_len, enc_len

    # -- a rank's blocks of whole inputs --------------------------------- #

    def cut_batch(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """This rank's rows of each whole batch input (``lengths`` too),
        each a tensor of its own."""
        i = self.mesh.index(self.batch_axes) if self.batch_shards > 1 else 0
        n = {k: v.shape[0] // self.batch_shards for k, v in batch.items()}
        return {k: v.narrow(0, i * n[k], n[k]).clone()
                for k, v in batch.items()}

    def cut_cache(self, cache):
        """This rank's blocks of a whole decode cache (``init_cache``'s
        nested dict of tuples), each a tensor of its own."""
        def cut(c, sp):
            if isinstance(c, dict):
                return {k: cut(c[k], sp[k]) for k in c}
            return tuple(local_slice(t, s, self.mesh).clone()
                         for t, s in zip(c, sp))
        return cut(cache, self.cache_specs)

    # -- the model axis ------------------------------------------------ #

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of a partial result (a split dim
        contracted); in place unless autograd records ``x``."""
        if self.model == 1:
            return x
        if _records(x):
            return _Psum.apply(x, self.mesh)
        return self.mesh.all_reduce(x, "model")

    def enter(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``x``, replicated over ``model``, as the input of this rank's
        own computation: the identity, whose backward sums the
        cotangent over ``model`` (nothing without autograd)."""
        if self.model == 1 or x is None or not _records(x):
            return x
        return _Enter.apply(x, self.mesh)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, "model", op="max") \
            if self.model > 1 else x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of a tensor split along ``dim`` over ``model``."""
        dim = dim % x.dim()
        if self.model == 1:
            return x
        if _records(x):
            return _GatherModel.apply(x, self.mesh, dim)
        return self.mesh.all_gather(x, "model", dim)

    def whole(self, x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """``x`` whole along ``dim``: gathered over ``model`` if it is a
        block of a ``full``-long dim, else as it is."""
        return self.gather(x, dim) if x.shape[dim] < full else x

    def block(self, full: int) -> Tuple[int, int]:
        """(first index, length) of this rank's block of a dim of
        ``full`` over ``model``: the whole dim where it does not divide
        (``resolve_spec``'s fallback)."""
        if self.model > 1 and full % self.model == 0:
            n = full // self.model
            return self.index * n, n
        return 0, full

    def seq_block(self, x: torch.Tensor, full: int) -> torch.Tensor:
        """The positions of this rank's cache block, ``[lo, lo + n)`` of
        ``full``, of ``x`` (b, s, heads, ...), whose heads are split over
        ``model`` and whose ``s <= full`` positions start at 0: one
        all-to-all over ``model`` hands each rank every rank's heads of
        its positions (zeros past ``s``).  Returns (b, n, all heads,
        ...)."""
        lo, n = self.block(full)
        if n == full:
            return self.gather(x, 2)
        b, s = x.shape[:2]
        if s < full:
            x = torch.cat([x, x.new_zeros((b, full - s) + x.shape[2:])], 1)
        parts = x.reshape((b, self.model, n) + x.shape[2:]).movedim(1, 0)
        got = self.mesh.all_to_all_single(parts.contiguous(), "model")
        # block i holds coordinate i's heads: heads are i-major
        return got.movedim(0, 2).reshape((b, n, -1) + x.shape[3:])
