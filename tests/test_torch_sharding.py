"""Sharding rules and compressed collectives of the port against JAX's.

Specs: the port's ``resolve_spec``, ``param_specs`` and
``cache_pspecs`` against the JAX package's for every config in
``ARCHS``, at model meshes of 1, 2 and 4, the 2 x 2 data x model mesh
and the multi-pod mesh (2 x 2 x 2, batch axes ``("pod", "data")``).
Both read only ``mesh.shape`` (and ``sharding_env`` enters the mesh),
so a stub with a ``shape`` dict that is a context manager drives them
without devices.

Compression: ``_quantize``/``_dequantize`` bit for bit against JAX's
(ragged lengths, all-zero blocks), and ``psum_compressed`` /
``compressed_grad_sync`` at worlds 2 and 4 over gloo (spawned ranks,
each run under a time limit) against JAX's ``_quantize`` and
``_dequantize`` composed on the stacked per-rank inputs: quantize each
rank's segments, sum every rank's copy of segment r in float32,
re-quantize, dequantize.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks as R  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.distributed import compression as JC  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402


class StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


MESHES = {
    "model1": ({"data": 1, "model": 1}, False),
    "model2": ({"data": 1, "model": 2}, False),
    "model4": ({"data": 1, "model": 4}, False),
    "data2_model2": ({"data": 2, "model": 2}, False),
    "multi_pod": ({"pod": 2, "data": 2, "model": 2}, True),
}


def _jleaves(tree):
    """JAX spec tree leaves in the port's path order, as plain tuples."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        out["/".join(str(k) for k in keys)] = tuple(spec)
    return out


def _pleaves(tree, pairs=False):
    """The port's spec tree by path; ``pairs``: leaves are (k, v)
    pairs (the cache), keyed as JAX's tuple indices."""
    out = {}
    for path, spec in tree_leaves(tree):
        if pairs:
            for i, s in enumerate(spec):
                out[f"{path}/{i}"] = s
        else:
            out[path] = spec
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_and_cache_specs_match_jax_on_every_config(mesh):
    shape, multi_pod = MESHES[mesh]
    for name in ARCHS:
        cfg, jcfg = ARCHS[name], JARCHS[name]
        for fsdp in (True, False):
            with JS.sharding_env(StubMesh(shape), multi_pod=multi_pod,
                                 fsdp=fsdp):
                jspecs = _jleaves(JP.param_specs(JT.model_defs(jcfg)))
                jcache = _jleaves(JT.cache_pspecs(jcfg, 8, 256))
            with S.sharding_env(StubMesh(shape), multi_pod=multi_pod,
                                fsdp=fsdp):
                specs = _pleaves(P.param_specs(T.model_defs(cfg)))
                cache = _pleaves(T.cache_pspecs(cfg, 8, 256), pairs=True)
            assert specs == jspecs, (name, fsdp)
            assert cache == jcache, (name, fsdp)


def test_resolve_spec_matches_jax_on_random_shapes():
    rng = np.random.default_rng(0)
    names = [None, "batch", "seq", "heads", "kv_heads", "ff", "experts",
             "vocab", "embed", "layers", "state"]
    for _ in range(300):
        rank = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24]))
                      for _ in range(rank))
        laxes = tuple(names[int(rng.integers(len(names)))]
                      for _ in range(rank))
        mesh, multi_pod = MESHES[list(MESHES)[int(rng.integers(5))]]
        hint = bool(rng.integers(2))
        with JS.sharding_env(StubMesh(mesh), multi_pod=multi_pod):
            want = tuple(JS.resolve_spec(shape, laxes, fsdp_hint=hint))
        with S.sharding_env(StubMesh(mesh), multi_pod=multi_pod):
            got = S.resolve_spec(shape, laxes, fsdp_hint=hint)
        assert got == want, (shape, laxes, mesh, hint)
    assert S.resolve_spec((4, 4), ("heads", None)) == tuple(
        JS.resolve_spec((4, 4), ("heads", None))) == ()


def test_local_slice_blocks_tile_the_tensor():
    """Every rank's block, placed back at its coordinates, rebuilds the
    full tensor; a dim split over two axes splits major to minor."""
    x = torch.arange(8 * 12 * 2).reshape(8, 12, 2)
    spec = (("pod", "data"), "model", None)
    shape = {"pod": 2, "data": 2, "model": 3}

    class Rank(StubMesh):
        def __init__(self, coords):
            super().__init__(shape)
            self.coords = coords

        def index(self, axis):
            return self.coords[axis]

    rebuilt = torch.zeros_like(x)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                mesh = Rank({"pod": p, "data": d, "model": m})
                blk = S.local_slice(x, spec, mesh)
                assert blk.shape == S.local_shape(x.shape, spec, mesh)
                rebuilt[(2 * p + d) * 2:(2 * p + d + 1) * 2,
                        m * 4:(m + 1) * 4] = blk
    assert torch.equal(rebuilt, x)


@pytest.mark.parametrize("n", [256, 1000, 4097])
def test_quantize_dequantize_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n))
         * 10.0 ** rng.integers(-3, 3, (3, 1))).astype(np.float32)
    x[1, :256] = 0.0                              # an all-zero block
    jcodes, jscale = JC._quantize(jnp.asarray(x))
    codes, scale = C._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = C._dequantize(codes, scale, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        JC._dequantize(jcodes, jscale, n)))
    assert not back[1, :256].any()


def _jax_psum_compressed(stacked):
    """JAX's quantize/dequantize composed on the stacked per-rank inputs:
    the result every rank of ``psum_compressed`` must hold."""
    world = stacked.shape[0]
    flat = jnp.asarray(stacked.reshape(world, -1), jnp.float32)
    n = flat.shape[1]
    seg = -(-n // world)
    flat = jnp.pad(flat, ((0, 0), (0, seg * world - n)))
    flat = flat.reshape(world, world, seg)         # (rank, segment, seg)
    codes, scale = JC._quantize(flat)
    deq = JC._dequantize(codes, scale, seg)        # (rank, segment, seg)
    mine = jnp.sum(jnp.swapaxes(deq, 0, 1), axis=1)   # (segment, seg)
    codes_r, scale_r = JC._quantize(mine)
    full = JC._dequantize(codes_r, scale_r, seg).reshape(-1)[:n]
    return np.asarray(full.reshape(stacked.shape[1:]))


@pytest.mark.parametrize("world", [2, 4])
def test_psum_compressed_and_grad_sync_match_jax(world):
    rng = np.random.default_rng(world)
    xs = rng.standard_normal((world, 5, 300)).astype(np.float32)
    xs[:, 0] = 0.0                     # a zero row: exact zeros back
    grads = [{"w": rng.standard_normal((7, 33)).astype(np.float32),
              "b": rng.standard_normal((513,)).astype(np.float32)}
             for _ in range(world)]
    ranks = run_ranks(R.compression_ranks, world, backend="gloo",
                      timeout=90.0, args=(xs, grads))
    want = _jax_psum_compressed(xs)
    for r in ranks:
        np.testing.assert_array_equal(r["psum"].numpy(), want)
        for k in ("w", "b"):
            stacked = np.stack([g[k] for g in grads])
            np.testing.assert_array_equal(r["sync"][k].numpy(),
                                          _jax_psum_compressed(stacked))
    assert not ranks[0]["psum"][0].any()
