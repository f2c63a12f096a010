"""The rule set's serving layout (``transformer.forward(rules=)``)
against the JAX package, on the CPU.

The JAX dryrun lays out every prefill and decode cell with the whole
rule set: tensor parallelism over ``model`` with ``resolve_spec``'s
divisibility fallback, FSDP over the batch axes, the batch over the
batch axes and the cache's sequence over ``model``.  The port runs one
process a rank on exactly the blocks JAX's specs give that device.

* Arguments without a trace: for every serving cell of the dry run at
  both production meshes, the port's rank-0 parameter, cache and batch
  blocks (``dryrun.rank_arguments`` on meta tensors) have, leaf by leaf,
  the shapes the JAX package's own ``param_specs`` / ``cache_pspecs``
  and batch specs give a device (resolved against a stub mesh), and
  their bytes are the record's ``argument_bytes``.
* Parity across ranks: one spawn of four gloo ranks runs, per family,
  ``forward`` in prefill mode and then two decode steps on the rank's
  blocks at ``{"data": 2, "model": 2}`` (and one case at ``{"pod": 2,
  "data": 1, "model": 2}``, the batch over both batch axes); the ranks'
  logits and cache blocks, put back together, equal the JAX
  ``forward`` on one device.  Both packages compute and cache in
  float32 (``layers.COMPUTE_DTYPE`` and ``transformer.CACHE_DTYPE``
  patched), so the tolerance is float32 sums in other orders:
  ``test_torch_forward.py``'s 1e-3, relative and absolute (the largest
  difference, 5.7e-4, is encdec's cache, whose values pass an encoder
  of residual magnitude ~60).  The MoE capacity factor
  makes room for every token, so the expert-parallel body drops none
  and equals the dense form JAX runs without a mesh.
* ``decode_attention`` makes no tensor from a host scalar (its mask is
  a ``masked_fill`` with a Python scalar).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS, ParallelConfig as JPCFG  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro_torch.configs import ARCHS, ParallelConfig, SHAPES, reduced  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

TOL = 1e-3
MESH = {"data": 2, "model": 2}
POD_MESH = {"pod": 2, "data": 1, "model": 2}
B, PROMPT = 4, 10
# name -> (arch, reduced() overrides, mesh); every dim a reduced config
# has divides 2 except where an override makes it odd
CASES = {
    # 4 heads over 2, one KV head and an odd vocab and hidden: whole
    "dense_fallback": ("granite-3-8b", dict(num_layers=2, num_kv_heads=1,
                                            vocab_size=511, d_ff=255), MESH),
    "dense": ("granite-3-8b", dict(num_layers=2), MESH),
    "moe": ("llama4-scout-17b-a16e", dict(num_layers=2), MESH),
    "mla_moe": ("deepseek-v2-236b", dict(num_layers=2), MESH),
    "ssm": ("mamba2-1.3b", dict(num_layers=2), MESH),
    "hybrid": ("jamba-1.5-large-398b", dict(num_layers=4, attn_every=4),
               MESH),
    "encdec": ("seamless-m4t-medium", {}, MESH),
    # 3 heads and one KV head: both whole, as llava's 56 and 8 at 16
    "vlm": ("llava-next-34b", dict(num_layers=2, num_heads=3,
                                   num_kv_heads=1), MESH),
    "multi_pod": ("granite-3-8b", dict(num_layers=2), POD_MESH),
}
JAX_P = JPCFG(remat="none", attention_impl="naive", moe_impl="dense")


def _pcfg(cfg):
    # the dry run's settings, small tiles, and room for every token
    return ParallelConfig(remat="none", attention_impl="chunked",
                          attention_chunk=4, moe_impl="shard_map",
                          moe_capacity_factor=float(
                              cfg.moe.num_experts if cfg.moe else 0))


def _case(name, seed):
    arch, kw, mesh = CASES[name]
    jcfg, cfg = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    if cfg.moe is not None and cfg.family == "moe":
        # a leading dense layer: the two-group layout
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, first_dense_layers=1))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=1))
    jparams = jinit(JT.model_defs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    fd = cfg.frontend_dim or cfg.d_model
    prefill = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT))
               .astype(np.int32)}
    n, enc = PROMPT, 0
    if cfg.family == "vlm":
        prefill["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, fd)).astype(np.float32)
        n += cfg.num_patch_tokens
    if cfg.family == "encdec":
        enc = 8
        prefill["frames"] = rng.normal(size=(B, enc, fd)).astype(np.float32)
    decode = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
              for _ in range(2)]
    # two cache blocks over model: the prompt crosses into the second,
    # which the decode steps write
    max_len = 2 * (n - 2)
    return jcfg, jparams, {
        "cfg": cfg, "pcfg": _pcfg(cfg), "mesh": mesh, "batch": B,
        "params": jax.tree.map(np.asarray, jparams), "prefill": prefill,
        "decode": decode, "prompt_len": n, "max_len": max_len,
        "enc_len": enc}


def _jax_run(jcfg, jparams, c):
    """The JAX forward on one device: prefill, then the decode steps."""
    cache = JT.init_cache(jcfg, B, c["max_len"], enc_len=c["enc_len"])
    n = c["prompt_len"]
    lg, cache, _ = JT.forward(
        jcfg, JAX_P, jparams, {k: jnp.asarray(v) for k, v in
                               c["prefill"].items()}, mode="prefill",
        cache=cache, lengths=jnp.full((B,), n, jnp.int32))
    out = {"prefill": np.asarray(lg), "decode": []}
    for t, tok in enumerate(c["decode"]):
        lg, cache = JT.forward(jcfg, JAX_P, jparams,
                               {"tokens": jnp.asarray(tok)}, mode="decode",
                               cache=cache, write_pos=jnp.asarray(n + t),
                               lengths=jnp.full((B,), n + t + 1, jnp.int32))
        out["decode"].append(np.asarray(lg))
    out["cache"] = {f"{g}/{k}": [np.asarray(a) for a in cache[g][k]]
                    for g in sorted(cache) for k in sorted(cache[g])}
    return out


class StubMesh:
    """A mesh's shape with no devices: all JAX's ``resolve_spec``
    reads."""

    def __init__(self, shape):
        self.shape = dict(shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _whole(blocks, spec, mesh, shape):
    """One ``shape`` leaf put back together from every rank's (coords,
    block) under a JAX spec."""
    out = np.zeros(shape, blocks[0][1].dtype)
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for coords, blk in blocks:
        idx = []
        for d, e in enumerate(spec):
            axes = (e,) if isinstance(e, str) else tuple(e or ())
            i = 0
            for a in axes:
                i = i * mesh[a] + coords[a]
            idx.append(slice(i * blk.shape[d], (i + 1) * blk.shape[d]))
        out[tuple(idx)] = blk
    return out


@pytest.fixture(scope="module")
def parity():
    """Every case on four gloo ranks (one spawn, its own processes, run
    from a thread) and, meanwhile, in JAX."""
    made = {name: _case(name, seed=i) for i, name in enumerate(CASES)}
    cases = {name: c for name, (_, _, c) in made.items()}
    jl, jc = JL.COMPUTE_DTYPE, JT.CACHE_DTYPE
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, R.rule_forward, 4, backend="gloo",
                            args=(cases,), timeout=240.0)
        JL.COMPUTE_DTYPE, JT.CACHE_DTYPE = jnp.float32, jnp.float32
        try:
            want = {name: _jax_run(jcfg, jparams, cases[name])
                    for name, (jcfg, jparams, _) in made.items()}
        finally:
            JL.COMPUTE_DTYPE, JT.CACHE_DTYPE = jl, jc
        return cases, want, ranks.result()


def _check(parity, name):
    cases, want, ranks = parity
    c, w = cases[name], want[name]
    mesh = c["mesh"]
    outs = [r[name] for r in ranks]
    nb = int(np.prod([mesh[a] for a in mesh if a != "model"]))
    per = B // nb
    # each rank's logits are its rows', whole over the vocab
    for o in outs:
        bi = 0
        for a in (a for a in mesh if a != "model"):
            bi = bi * mesh[a] + o["coords"][a]
        rows = slice(bi * per, (bi + 1) * per)
        np.testing.assert_allclose(o["prefill"], w["prefill"][rows],
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{name} prefill")
        for t in range(2):
            np.testing.assert_allclose(o["decode"][t], w["decode"][t][rows],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{name} decode {t}")
    # the cache blocks put back together: JAX's cache after the steps
    jmesh = StubMesh(mesh)
    with JS.sharding_env(jmesh, multi_pod="pod" in mesh, fsdp=True):
        specs = JT.cache_pspecs(c["cfg"], B, c["max_len"], c["enc_len"])
    assert sorted(w["cache"]) == sorted(outs[0]["cache"])
    for path in w["cache"]:
        g, k = path.split("/")
        for i, want_leaf in enumerate(w["cache"][path]):
            spec = tuple(specs[g][k][i])
            got = _whole([(o["coords"], o["cache"][path][i]) for o in outs],
                         spec, mesh, want_leaf.shape)
            np.testing.assert_allclose(got, want_leaf, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} cache {path}/{i}")


@pytest.mark.parametrize("name", [n for n in CASES if n != "multi_pod"])
def test_family_matches_jax_forward(parity, name):
    """Prefill and two decode steps of one family at {"data": 2,
    "model": 2}: logits and the whole cache against JAX's."""
    _check(parity, name)


def test_multi_pod_batch_over_both_batch_axes(parity):
    """At {"pod": 2, "data": 1, "model": 2} the batch and the FSDP
    slices run over ("pod", "data"): each rank holds 2 of the 4 rows,
    and the logits and cache equal JAX's."""
    c = parity[0]["multi_pod"]
    assert c["mesh"] == POD_MESH
    _check(parity, "multi_pod")


def _jax_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _block(shape, spec, mesh):
    """The shape of a device's block of ``shape`` under a JAX spec."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for n, e in zip(shape, spec):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        out.append(n // int(np.prod([mesh[a] for a in axes], dtype=int)))
    return tuple(out)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_serving_arguments_are_jax_blocks(multi_pod):
    """Every serving cell of the dry run at the production mesh: the
    port's rank-0 parameter, cache and batch blocks, built on meta
    tensors without a step, have leaf by leaf the shape (and dtype) of a
    device's block under the JAX package's own specs, so no leaf is
    whole that JAX splits, and the arguments' bytes are their sum."""
    mesh = D.production_mesh_shape(multi_pod).shape
    n = 0
    for arch, shape_name, mp in D.all_cells():
        shape = SHAPES[shape_name]
        if mp != multi_pod or shape.kind == "train":
            continue
        cfg, jcfg = ARCHS[arch], JARCHS[arch]
        a = D.rank_arguments(cfg, shape, multi_pod=mp)
        assert (a["layout"].name, a["layout"].mesh) == ("rules", mesh)
        enc = D.enc_dec_split(cfg, shape)[0] if cfg.family == "encdec" \
            else 0
        B = shape.global_batch
        with JS.sharding_env(StubMesh(mesh), multi_pod=mp, fsdp=True):
            jdefs = JT.model_defs(jcfg)
            pspecs = dict(_jax_leaves(JP.param_specs(jdefs)))
            cshapes = JT.cache_spec(jcfg, B, shape.seq_len, enc)
            cspecs = JT.cache_pspecs(jcfg, B, shape.seq_len, enc)
            inputs = D.input_specs(cfg, shape)
            bspecs = {k: JS.resolve_spec(v.shape, ("batch",) + (None,) * (
                v.dim() - 1)) for k, v in inputs.items()}
            lspec = JS.resolve_spec((B,), ("batch",))
        want = 0
        got_p = dict(tree_leaves(a["params"]))
        assert sorted(got_p) == sorted(pspecs), arch
        for path, d in _jax_leaves(jdefs):
            blk = _block(d.shape, pspecs[path], mesh)
            assert tuple(got_p[path].shape) == blk, (arch, path)
            assert got_p[path].dtype == torch.bfloat16
            want += int(np.prod(blk)) * 2
        got_c = dict(tree_leaves(a["cache"]))
        assert sorted(got_c) == [f"{g}/{k}" for g in sorted(cshapes)
                                 for k in sorted(cshapes[g])], arch
        for path, pair in got_c.items():
            g, k = path.split("/")
            for t, s, sp in zip(pair, cshapes[g][k], cspecs[g][k]):
                blk = _block(s.shape, sp, mesh)
                assert tuple(t.shape) == blk, (arch, shape_name, path)
                assert str(t.dtype).split(".")[-1] == str(s.dtype), path
                want += int(np.prod(blk)) * t.element_size()
        for k, v in inputs.items():
            blk = _block(v.shape, bspecs[k], mesh)
            assert tuple(a["batch"][k].shape) == blk, (arch, k)
            want += int(np.prod(blk)) * v.element_size()
        assert tuple(a["lengths"].shape) == _block((B,), lspec, mesh)
        want += 4 * a["lengths"].numel()
        got = sum(t.numel() * t.element_size() for t in
                  [*got_p.values(), *(x for p in got_c.values() for x in p),
                   *a["batch"].values(), a["lengths"]])
        assert got == want, (arch, shape_name)
        n += 1
    assert n == 22


def test_decode_attention_makes_no_tensor_from_a_host_scalar():
    """``decode_attention`` and ``naive_attention`` mask with a Python
    scalar (``masked_fill``): no op they dispatch makes a tensor from a
    host scalar (``torch.tensor(x, device=...)`` is ``lift_fresh`` and,
    on the card, a pageable host-to-device copy once a layer), and the
    masked positions get no weight."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket)
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 6, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 6, 2, 8)).astype(np.float32))
    lens = torch.tensor([6, 3], dtype=torch.int32)
    with Ops() as mode:
        out = A.decode_attention(q, k, v, lens)
        A.naive_attention(q, k, v, causal=True, lengths=lens, q_offset=5)
    made = {torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy,
            torch.ops.aten.scalar_tensor}
    assert mode.ops and not made & set(mode.ops), \
        sorted(str(o) for o in made & set(mode.ops))
    assert torch.ops.aten.masked_fill in mode.ops
    # row 1 sees 3 positions: its output is the one over k[:, :3]
    np.testing.assert_allclose(
        out[1:].numpy(), A.decode_attention(q[1:], k[1:, :3], v[1:, :3],
                                            lens[1:]).numpy(), rtol=1e-6,
        atol=1e-6)
