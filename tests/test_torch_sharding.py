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
import threading
from pathlib import Path

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


# ---------------------------------------------------------------------------
# the local cut plan: M shards of a layer, in one process, compute what
# the single device computes (the all-reduce a sum over the shards)
# ---------------------------------------------------------------------------

class _SumGroup:
    """reduce_model over M threads, one a model rank: every rank gets
    the sum of the M ranks' tensors, added in rank order."""

    def __init__(self, M):
        self.bar = threading.Barrier(M, timeout=120)
        self.parts = [None] * M
        self.me = threading.local()

    def __call__(self, y):
        self.parts[self.me.m] = y
        self.bar.wait()
        out = functools.reduce(torch.add, self.parts)
        self.bar.wait()
        return out


def _on_ranks(M, fn, monkeypatch):
    """fn(m) on each of M model ranks, each in a thread, with Mamba's
    in-layer all-reduce the sum over them; -> the results by rank."""
    from repro_torch.models import mamba as mam
    group = _SumGroup(M)
    monkeypatch.setattr(mam, "reduce_model", group)
    out, errors = [None] * M, []

    def run(m):
        group.me.m = m
        try:
            out[m] = fn(m)
        except BaseException as e:     # noqa: BLE001 - re-raised below
            errors.append(e)
            group.bar.abort()
    threads = [threading.Thread(target=run, args=(m,)) for m in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _shards(cfg, params, M):
    from repro_torch.dist.context import ServeMesh
    return [sharding.shard_params(cfg, params, ServeMesh(
        1, M, ["cpu"] * M, rank=m)) for m in range(M)]


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-6 * float(want.abs().max()),
                               msg=what)


def _channels(t, M, m, dim):
    n = t.shape[dim] // M
    return t.narrow(dim, m * n, n)


@pytest.mark.parametrize("L", [1, 2, 19])
def test_mamba_shards_compute_the_single_device_layer(L, monkeypatch):
    """M = 2 shards of falcon-mamba's smoke layer (in_proj by halves,
    x_proj by rows, the per-channel leaves and the state by d_inner):
    the prefill's summed out_proj partials and each rank's state
    channels, then a decode step from that state, equal the single
    device's; prompts shorter than the conv window (1, 2 tokens: the
    padded conv tail) and one past a scan chunk (19 > 16)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mamba as mam
    from repro_torch.models.model import shard_config
    cfg = smoke_config("falcon-mamba-7b").replace(dtype="float32")
    params = init_params(cfg, seed=3, dtype="float32", device="cpu")
    g = torch.Generator().manual_seed(L)
    x = torch.randn((2, L, cfg.d_model), generator=g)
    x1 = torch.randn((2, 1, cfg.d_model), generator=g)
    p = params["layers"][0]["mamba"]
    y, st = mam.mamba_forward(cfg, p, x, return_state=True)
    y1, st1 = mam.mamba_decode(cfg, p, x1, {k: v.clone()
                                             for k, v in st.items()})
    M = 2
    rcfg = shard_config(cfg, M)
    assert rcfg.d_inner == cfg.d_inner // M
    shards = _shards(cfg, params, M)

    def rank(m):
        pm = shards[m]["layers"][0]["mamba"]
        ym, sm = mam.mamba_forward(rcfg, pm, x, return_state=True)
        ym1, sm1 = mam.mamba_decode(rcfg, pm, x1, {k: v.clone()
                                                   for k, v in sm.items()})
        return ym, sm, ym1, sm1
    out = _on_ranks(M, rank, monkeypatch)
    _close(sum(o[0] for o in out), y, "prefill")
    _close(sum(o[2] for o in out), y1, "decode")
    for m, (_, sm, _, sm1) in enumerate(out):
        for want, got in ((st, sm), (st1, sm1)):
            _close(got["ssm"], _channels(want["ssm"], M, m, 1), "ssm")
            _close(got["conv"], _channels(want["conv"], M, m, 2), "conv")


def test_a_contiguous_in_proj_cut_is_wrong(monkeypatch):
    """in_proj holds [x | z]: cut as one contiguous block of columns
    (rank 0 all of x, rank 1 all of z), the shards no longer compute
    the layer; the two-half cut does (above)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mamba as mam
    from repro_torch.models.model import shard_config
    cfg = smoke_config("falcon-mamba-7b").replace(dtype="float32")
    params = init_params(cfg, seed=3, dtype="float32", device="cpu")
    x = torch.randn((1, 7, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    p = params["layers"][0]["mamba"]
    y = mam.mamba_forward(cfg, p, x)
    M, rcfg, shards = 2, shard_config(cfg, 2), _shards(cfg, params, 2)
    w = p["in_proj"]
    for m, s in enumerate(shards):
        halves = s["layers"][0]["mamba"]["in_proj"]
        assert torch.equal(halves, torch.cat(
            [_channels(h, M, m, 1) for h in w.chunk(2, dim=1)], dim=1))
        s["layers"][0]["mamba"]["in_proj"] = _channels(w, M, m, 1)
    out = _on_ranks(M, lambda m: mam.mamba_forward(
        rcfg, shards[m]["layers"][0]["mamba"], x), monkeypatch)
    assert (sum(out) - y).abs().max() > 0.1 * y.abs().max()


def test_in_proj_halves_cut_a_packed_leaf():
    """shard_qt cuts a packed in_proj's codes and scales by halves: each
    rank's dequant is its d_inner columns of each half of the whole
    dequant (per-channel and group-wise scales)."""
    from repro_torch.dist.context import ServeMesh
    g = torch.Generator().manual_seed(1)
    K, N, bits = 64, 32, 3
    for G in (1, 2):
        qt = QuantizedTensor(
            torch.randint(-2 ** 31, 2 ** 31 - 1, (bits, K // 32, N),
                          generator=g, dtype=torch.int64).to(torch.int32),
            torch.rand((G, N, bits), generator=g),
            torch.randn((G, N), generator=g), K, "float32")
        w = qt.dequant(torch.float32)
        names = ("blocks", "L0", "mamba", "in_proj")
        sym = sharding.symbolic_mesh()
        specs = {f: sharding.named_pspec(None, names + (f".{f}",),
                                         getattr(qt, f)[None], sym)
                 for f in ("codes", "alphas", "betas")}
        for m in range(2):
            c, a, b, k = sharding.shard_qt(
                names, qt.codes[None], qt.alphas[None], qt.betas[None], K,
                specs, ServeMesh(1, 2, ["cpu"] * 2, rank=m))
            got = QuantizedTensor(c[0], a[0], b[0], k, "float32")
            want = torch.cat([_channels(h, 2, m, 1) for h in w.chunk(2, 1)],
                             dim=1)
            assert torch.equal(got.dequant(torch.float32), want)


@pytest.mark.parametrize("S", [1, 9])
def test_mla_shards_compute_the_single_device_layer(S):
    """M = 2 shards of minicpm3's smoke MLA layer (wq_a and wkv_a whole,
    wq_b and wkv_b by heads, wo by rows): every rank's latent equals the
    single device's (the pages replicate), and the summed wo partials
    of the prefill and of a paged decode step equal its output."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mla as mla_mod
    from repro_torch.models.model import shard_config
    cfg = smoke_config("minicpm3-4b").replace(dtype="float32")
    spec = cfg.pattern[0]
    params = init_params(cfg, seed=5, dtype="float32", device="cpu")
    g = torch.Generator().manual_seed(S)
    x = torch.randn((2, S, cfg.d_model), generator=g)
    x1 = torch.randn((2, 1, cfg.d_model), generator=g)
    pos = torch.arange(S)
    page, bt = 4, torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)

    def run(c, p):
        y, ckv, kpe = mla_mod.mla_prefill(c, spec, p, x, pos)
        pool = mla_mod.init_mla_paged(c, 7, page, "float32", "cpu")
        for b in range(2):
            t = torch.arange(S)
            pid = bt[b].long()[t // page]
            pool["ckv_pages"][pid, t % page, 0] = ckv[b]
            pool["kpe_pages"][pid, t % page, 0] = kpe[b]
        y1, pool = mla_mod.mla_decode_paged(
            c, spec, p, x1, pool, bt, torch.full((2,), S))
        return y, ckv, kpe, y1, pool
    y, ckv, kpe, y1, pool = run(cfg, params["layers"][0]["attn"])
    rcfg = shard_config(cfg, 2)
    assert rcfg.n_heads == cfg.n_heads // 2
    out = [run(rcfg, s["layers"][0]["attn"])
           for s in _shards(cfg, params, 2)]
    _close(sum(o[0] for o in out), y, "prefill")
    _close(sum(o[3] for o in out), y1, "decode")
    for _, ckv_m, kpe_m, _, pool_m in out:
        assert torch.equal(ckv_m, ckv) and torch.equal(kpe_m, kpe)
        for k in pool:
            assert torch.equal(pool_m[k], pool[k])


@pytest.mark.parametrize("name", ["w3_pc", "w3_g64_bf16", "w3_moe"])
def test_load_draft_scales_on_a_mesh_cuts_the_whole_block(name, tmp_path):
    """load_draft_scales(mesh=) gives each rank the cut of the whole
    draft block that shard_params makes of the whole draft tree, scale
    for scale (column splits, per-channel and group-wise row splits,
    expert splits)."""
    from repro_torch.ckpt.packed import (load_draft_scales, load_packed,
                                         save_packed)
    from repro_torch.dist.context import ServeMesh
    from repro_torch.quant.draft import make_draft_params
    fixture = Path(__file__).resolve().parent / "data" / "torch_port"
    params, spec, meta = load_packed(fixture / name, device="cpu")
    cfg = REGISTRY[meta["arch"]].replace(dtype="float32",
                                         n_layers=len(params["layers"]))
    d = save_packed(tmp_path / name, params, cfg=cfg, spec=spec, meta=meta,
                    draft_bits=2)
    whole = make_draft_params(params, 2, load_draft_scales(d, device="cpu"))
    n = 0
    for D, M in ((1, 2), (2, 2)):
        for r in range(D * M):
            mesh = ServeMesh(D, M, ["cpu"] * (D * M), rank=r)
            mine, _, _ = load_packed(d, mesh=mesh)
            got = make_draft_params(mine, 2, load_draft_scales(d, mesh=mesh))
            want = sharding.shard_params(cfg, whole, mesh)
            for a, b in zip(_qts(got), _qts(want)):
                assert a.k_in == b.k_in and a.bits == b.bits == 2
                assert torch.equal(a.alphas, b.alphas)
                assert torch.equal(a.betas, b.betas)
                n += 1
    assert n > 0


def _qts(tree):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _qts(tree[k])]
    if isinstance(tree, list):
        return [q for v in tree for q in _qts(v)]
    return [tree] if isinstance(tree, QuantizedTensor) else []


# ---------------------------------------------------------------------------
# FSDP: a rank's data-axis block of every leaf
# ---------------------------------------------------------------------------

def _leaf_fields(leaf):
    """{field: tensor} of a plain, quantized or FSDP leaf."""
    if hasattr(leaf, "fields"):
        return dict(leaf.fields)
    if isinstance(leaf, QuantizedTensor):
        return {f: getattr(leaf, f) for f in ("codes", "alphas", "betas")}
    return {"w": leaf}


def _per_layer(tree, names=()):
    """(reference-style names, leaf) of a per-layer tree, layer i of the
    pattern slot "L{i % P}" (P = 1 for tiny-lm)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _per_layer(tree[k], names + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _per_layer(v, ("blocks", f"L{i}"))
    else:
        yield names, tree


def _data_block(t, spec, D, d):
    """Data rank d's block of `t` along the dim the symbolic `spec` puts
    the data axis on (counted from the end); `t` where it puts none."""
    dims = [i - len(spec) for i, a in enumerate(spec)
            if a == "data" or (isinstance(a, tuple) and "data" in a)]
    if not dims:
        return t
    n = t.shape[dims[0]] // D
    return t.narrow(t.dim() + dims[0], d * n, n)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("name", ["w3_pc", "fp", "zoo/moe_quant",
                                  "zoo/mla_quant", "zoo/mamba-mix_quant",
                                  "zoo/mamba_fp"])
def test_fsdp_blocks_equal_the_reference_specs(shape, name):
    """shard_params(fsdp=True) and load_packed(mesh=, fsdp=True): every
    rank's block of every leaf (fp, and a w3 artifact's codes, alphas
    and betas) is the block the reference's spec with fsdp=True gives on
    the mesh (named_pspec, its guard included), the data axis kept; a
    leaf the data axis cuts is an FSDP block of 1/D of the rank's slice,
    the others plain. The zoo's smoke MoE (mixtral), MLA (minicpm3),
    Mamba (falcon-mamba) and hybrid (jamba: Mamba, attention, MoE)
    configs, whose model-axis cut the port makes its own way on some
    leaves (experts by E, MLA's latent projections whole, Mamba's
    in_proj by halves and its channel leaves by rows): the FSDP block
    is the rank's fsdp=False block cut along the dim where the
    reference's load_packed(mesh=, fsdp=True) puts the data axis (the
    manifest's spec, named_pspec at the symbolic mesh, re-guarded by
    guard_pspec: an expert stack's codes on their packed K, its scales
    whole)."""
    from repro_torch.ckpt.packed import load_packed
    from repro_torch.dist.context import ServeMesh
    from repro_torch.dist.fsdp import FsdpLeaf
    from torch_mesh import _config
    fixture = Path(__file__).resolve().parent / "data" / "torch_port"
    zoo = name.startswith("zoo/")
    if name == "fp":
        cfg = REGISTRY["tiny-lm"].replace(dtype="float32", n_layers=2)
        whole = init_params(cfg, seed=0, dtype="float32", device="cpu")
    else:
        whole, _, meta = load_packed(fixture / name, device="cpu")
        cfg = _config(name, whole, meta)
    jcfg = JAX_REGISTRY["tiny-lm"]
    D, M = shape
    fake, n, cut = FakeMesh(shape), 0, 0
    for r in range(D * M):
        mesh = ServeMesh(D, M, ["cpu"] * (D * M), rank=r)
        coords = dict(zip(("data", "model"), mesh.coords))
        mine = dict(_per_layer(sharding.shard_params(cfg, whole, mesh,
                                                     fsdp=True)))
        plain = dict(_per_layer(sharding.shard_params(cfg, whole, mesh)))
        if name != "fp":
            loaded, _, _ = load_packed(fixture / name, mesh=mesh, fsdp=True)
            loaded = dict(_per_layer(loaded))
        for names, leaf in _per_layer(whole):
            got = _leaf_fields(mine[names])
            stacked = names[0] == "blocks"
            for f, t in _leaf_fields(leaf).items():
                path = list(names) + ([f".{f}"] if f != "w" else [])
                full = t[None] if stacked else t
                if zoo:
                    spec = tuple(jax_sharding.guard_pspec(
                        full.shape, jax_sharding.named_pspec(
                            jcfg, path, full, jax_sharding.symbolic_mesh(),
                            fsdp=True), fake))
                    want = _data_block(_leaf_fields(plain[names])[f], spec,
                                       D, coords["data"])
                else:
                    spec = tuple(jax_sharding.named_pspec(
                        jcfg, path, full, fake, fsdp=True))
                    want = full[sharding.local_slices(full.shape, spec,
                                                      fake, coords)]
                    want = want[0] if stacked else want
                assert torch.equal(got[f], want), (names, f, shape)
                n += 1
            if isinstance(mine[names], FsdpLeaf):
                cut += 1
                assert any(d is not None for d in mine[names].dims.values())
            if name != "fp":
                for f, t in _leaf_fields(loaded[names]).items():
                    assert torch.equal(t, got[f]), (names, f)
    assert n > 0 and cut > 0


@pytest.mark.parametrize("name", ["w3_pc", "w3_g64_bf16"])
def test_fsdp_draft_block_is_cut_as_the_leaves_scales(name, tmp_path):
    """load_draft_scales(mesh=, fsdp=True) gives each rank the draft
    scales shard_params(fsdp=True) makes of the whole draft tree, on (2,
    1) and (2, 2): an FSDP draft leaf shares its target's code block."""
    from repro_torch.ckpt.packed import (load_draft_scales, load_packed,
                                         save_packed)
    from repro_torch.dist.context import ServeMesh
    from repro_torch.quant.draft import make_draft_params
    fixture = Path(__file__).resolve().parent / "data" / "torch_port"
    params, spec, meta = load_packed(fixture / name, device="cpu")
    cfg = REGISTRY[meta["arch"]].replace(dtype="float32",
                                         n_layers=len(params["layers"]))
    d = save_packed(tmp_path / name, params, cfg=cfg, spec=spec, meta=meta,
                    draft_bits=2)
    whole = make_draft_params(params, 2, load_draft_scales(d, device="cpu"))
    n = 0
    for D, M in ((2, 1), (2, 2)):
        for r in range(D * M):
            mesh = ServeMesh(D, M, ["cpu"] * (D * M), rank=r)
            mine, _, _ = load_packed(d, mesh=mesh, fsdp=True)
            got = dict(_per_layer(make_draft_params(
                mine, 2, load_draft_scales(d, mesh=mesh, fsdp=True))))
            want = dict(_per_layer(sharding.shard_params(cfg, whole, mesh,
                                                         fsdp=True)))
            blocks = dict(_per_layer(mine))
            for key, a in got.items():
                fa, fb = _leaf_fields(a), _leaf_fields(want[key])
                if "alphas" not in fa:
                    continue
                assert fa["alphas"].shape[-1] == 2
                for f in ("alphas", "betas"):
                    assert torch.equal(fa[f], fb[f]), (key, f)
                assert fa["codes"] is _leaf_fields(blocks[key])["codes"]
                n += 1
    assert n > 0
