"""The port's sharding rules (repro_torch/dist/sharding.py) against the
reference's (repro/dist/sharding.py) over shape-only meshes of (16, 16),
(2, 1), (1, 2), (2, 2) and (1, 4): `named_pspec` for every parameter
leaf of every registry config (the reference's tree from jax.eval_shape,
the port's from init_params on the meta device, restacked into the
reference's (n_groups, ...) layout), `_qt_pspec` for every packed w3
leaf (per-channel, and group 128 on the ten pool architectures, whose
every K it divides; expert stacks; and draft planes: 2 of
the 3 stored planes' scales), `cache_pspec` for fp, binary-coded, MLA
and Mamba pools and dense caches, `batch_pspec`, and the symbolic-spec
helpers. Specs must be equal entry for entry; the leaves' shapes too.
ckpt/pspec.py holds no rule of its own."""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.dist import sharding as jax_sharding
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_paged_cache as jax_init_paged_cache
from repro.models.model import init_params as jax_init_params
from repro.quant.abstract import quantize_params_abstract as jax_abstract
from repro.quant.spec import QuantSpec as JaxSpec
from repro_torch.ckpt import pspec as port_pspec
from repro_torch.ckpt import stack_params
from repro_torch.configs import ASSIGNED, REGISTRY
from repro_torch.dist import sharding
from repro_torch.models import init_params
from repro_torch.models.model import init_cache, init_paged_cache
from repro_torch.quant.abstract import quantize_params_abstract
from repro_torch.quant.qlinear import QuantizedTensor
from repro_torch.quant.spec import QuantSpec
from torch_threads import one_torch_thread  # noqa: F401

MESH_SHAPES = [(16, 16), (2, 1), (1, 2), (2, 2), (1, 4)]
ARCHS = sorted(REGISTRY)


class FakeMesh:
    """A shape-only mesh both packages' rules accept."""
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.devices = np.empty(shape)


MESHES = [FakeMesh(s) for s in MESH_SHAPES]


def _jax_leaves(tree, path=()):
    """(names, leaf) of a reference tree, QuantizedTensor-like leaves
    kept whole (they carry .codes)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


_trees: dict = {}


def _params(arch):
    """The reference's eval_shape params and the port's meta params
    restacked into the reference's layout, once a process."""
    if arch not in _trees:
        jcfg, cfg = JAX_REGISTRY[arch], REGISTRY[arch]
        jp = jax.eval_shape(functools.partial(
            jax_init_params, jcfg, dtype=jnp.bfloat16),
            jax.random.PRNGKey(0))
        tp = init_params(cfg, dtype="bfloat16", device="meta")
        _trees[arch] = (jp, tp, stack_params(cfg, tp))
    return _trees[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    jp, _, stacked = _params(arch)
    n = 0
    for path, ref in _jax_leaves(jp):
        mine = _at(stacked, path)
        assert tuple(mine.shape) == tuple(ref.shape), path
        for mesh in MESHES:
            for fsdp in (True, False):
                want = jax_sharding.named_pspec(jcfg, list(path), ref, mesh,
                                                fsdp=fsdp)
                got = sharding.named_pspec(cfg, path, mine, mesh, fsdp=fsdp)
                assert got == tuple(want), (path, mesh.devices.shape, fsdp)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch,group", [(a, 0) for a in ARCHS] + [
    (a, 128) for a in ARCHS if a in ASSIGNED])
def test_quantized_specs_equal_the_reference(arch, group):
    """Every packed w3 leaf's codes, alphas and betas (expert stacks
    included), and its draft planes' scales, over every mesh."""
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    jp, tp, _ = _params(arch)
    jq = jax_abstract(jcfg, jp, spec=JaxSpec.from_config(
        jcfg.quant, mode="packed", bits=3, group_size=group))
    tq = stack_params(cfg, quantize_params_abstract(cfg, tp, spec=QuantSpec(
        method="gptqt", mode="packed", bits=3, group_size=group)))
    n_qt = 0
    for path, ref in _jax_leaves(jq):
        if not hasattr(ref, "codes"):
            continue
        mine = _at(tq, path)
        assert isinstance(mine, QuantizedTensor), path
        n_qt += 1
        fields = {f: (getattr(mine, f), getattr(ref, f))
                  for f in ("codes", "alphas", "betas")}
        # a 2-plane draft view: the stored codes, 2 planes' scales
        a, ra = fields["alphas"]
        fields["draft_alphas"] = (a[..., :2], jax.ShapeDtypeStruct(
            ra.shape[:-1] + (2,), ra.dtype))
        for f, (t, r) in fields.items():
            assert tuple(t.shape) == tuple(r.shape), (path, f)
            name = "." + f.replace("draft_", "")
            for mesh in MESHES:
                want = jax_sharding.named_pspec(jcfg, list(path) + [name], r,
                                                mesh, fsdp=True)
                got = sharding.named_pspec(cfg, path + (name,), t, mesh)
                assert got == tuple(want), (path, f, mesh.devices.shape)
    assert n_qt > 0


def _port_cache_leaves(cfg, per_layer):
    """The port's per-layer cache restacked as the reference's {"L{i}":
    (n_groups, ...)} leaves."""
    P = len(cfg.pattern)
    out = {}
    for i in range(P):
        layers = per_layer[i::P]
        out[f"L{i}"] = {k: torch.empty((len(layers), *v.shape),
                                       dtype=v.dtype, device="meta")
                        for k, v in layers[0].items()}
    return out


def _caches(arch):
    """(label, reference cache tree, port cache restacked) of every
    pool a config serves with: fp pages, 4-bit binary-coded pages (not
    MLA), and a dense cache."""
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    out = []
    kw = dict(n_pages=32, page_size=16, max_seqs=4)
    for bits in ((0,) if cfg.mla is not None else (0, 4)):
        ref = jax.eval_shape(functools.partial(
            jax_init_paged_cache, jcfg, kw["n_pages"], kw["page_size"],
            kw["max_seqs"], jnp.float32, kv_bits=bits))
        mine = init_paged_cache(cfg, kw["n_pages"], kw["page_size"],
                                kw["max_seqs"], "float32", kv_bits=bits,
                                device="meta")
        out.append((f"paged{bits}", ref, _port_cache_leaves(cfg, mine)))
    ref = jax.eval_shape(functools.partial(jax_init_cache, jcfg, 4, 64,
                                           jnp.float32))
    mine = init_cache(cfg, 4, 64, "float32", device="meta")
    out.append(("dense", ref, _port_cache_leaves(cfg, mine)))
    return out


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if REGISTRY[a].has_decode])
def test_cache_specs_equal_the_reference(arch):
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    names = set()
    for label, ref, mine in _caches(arch):
        for path, r in _jax_leaves(ref):
            t = _at(mine, path)
            assert tuple(t.shape) == tuple(r.shape), (label, path)
            names.add(path[-1])
            for mesh in MESHES:
                key = jax.tree_util.DictKey
                want = jax_sharding.cache_pspec(
                    jcfg, tuple(key(k) for k in path), r, mesh)
                got = sharding.cache_pspec(cfg, path, t, mesh)
                assert got == tuple(want), (label, path, mesh.devices.shape)
    assert names


def test_cache_specs_cover_every_pool_layout():
    """The cache test above meets fp, binary-coded, MLA-latent and
    Mamba-state leaves."""
    seen = set()
    for arch in ("tiny-lm", "minicpm3-4b", "falcon-mamba-7b"):
        for _, ref, _ in _caches(arch):
            seen |= {p[-1] for p, _ in _jax_leaves(ref)}
    assert {"k_pages", "k_codes", "k_alphas", "k_betas", "ckv_pages",
            "kpe_pages", "ssm", "conv", "k", "c_kv"} <= seen


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_batch_pspec_equals_the_reference(shape):
    mesh = FakeMesh(shape)
    for batch in (1, 2, 3, 4, 16, 32, 256):
        for rest in ((None,), (), ("model",), (None, None)):
            assert sharding.batch_pspec(mesh, batch, rest) == tuple(
                jax_sharding.batch_pspec(mesh, batch, rest)), (batch, rest)


def test_symbolic_helpers_equal_the_reference():
    specs = [(None, "data", "model"), ("model", None), (("data", "model"),),
             (None,), ()]
    for spec in specs:
        want = jax_sharding.P(*spec)
        assert sharding.pspec_to_json(spec) == jax_sharding.pspec_to_json(
            want)
        assert sharding.pspec_from_json(sharding.pspec_to_json(spec)) == spec
        assert sharding.drop_axes(spec, ("data",)) == tuple(
            jax_sharding.drop_axes(want, ("data",)))
        for shape in MESH_SHAPES:
            dims = (32, 6, 8)[:len(spec)]
            assert sharding.guard_pspec(dims, spec, FakeMesh(shape)) == tuple(
                jax_sharding.guard_pspec(dims, want, FakeMesh(shape)))
    sym = sharding.symbolic_mesh()
    assert sharding.mesh_axis_sizes(sym) == jax_sharding.mesh_axis_sizes(
        jax_sharding.symbolic_mesh())
    assert sharding.REPLICATED_LEAVES == jax_sharding.REPLICATED_LEAVES


def test_pspec_module_is_the_rule():
    """ckpt/pspec.py defines no rule: its named_pspec is dist/sharding's
    at the symbolic mesh, and the manifest writer's names are kept."""
    src = inspect.getsource(port_pspec)
    for private in ("def _guard", "def _qt_pspec", "_CONTRACT =",
                    "_MATMUL_EXTRA ="):
        assert private not in src
    assert port_pspec.SYMBOLIC_AXES == sharding.SYMBOLIC_AXES
    assert port_pspec.pspec_to_json is sharding.pspec_to_json
    sym = sharding.symbolic_mesh()
    for names, shape in [(("blocks", "L0", "attn", "wo", ".codes"),
                          (2, 3, 4, 8)),
                         (("blocks", "L0", "moe", "wg", ".alphas"),
                          (2, 4, 1, 8, 3)),
                         (("embed",), (258, 64))]:
        leaf = torch.empty(shape, device="meta")
        assert port_pspec.named_pspec(names, shape) == sharding.named_pspec(
            None, names, leaf, sym)


def test_local_slices_tile_each_leaf():
    """A leaf's blocks under a spec, one a rank, tile it exactly once."""
    mesh = FakeMesh((2, 2))
    for spec in [("data", "model"), (None, ("data", "model")),
                 ("model", None)]:
        x = np.arange(8 * 12).reshape(8, 12)
        seen = np.zeros_like(x)
        for d in range(2):
            for m in range(2):
                sl = sharding.local_slices(x.shape, spec, mesh,
                                           {"data": d, "model": m})
                block = x[sl]
                assert block.shape == sharding.local_shape(x.shape, spec,
                                                           mesh)
                seen[sl] += 1
        reps = int(np.prod([2 for a in ("data", "model")
                            if a not in sharding._axes(spec)]))
        assert (seen == reps).all(), spec
