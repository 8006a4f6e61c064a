"""The port's packed stand-ins on the meta device (quant/abstract.py)
against the reference's (repro.quant.abstract over jax.eval_shape), at
full size for the ten pool architectures: uniform bits 2, 3 and 4
per-channel, group 128, and a mixed-precision spec with override
rules. Every packed leaf's code, alpha and beta shapes (the port's
per-layer leaf j against group j // len(pattern) of the reference's
stacked slot) and packed_param_bytes must be equal. Then the reference's
own abstract tests (tests/test_quant_api.py) on the port: the resolver
is the quantizer's, group sizes thread through and charge their
scales."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.models.model import init_params as jax_init_params
from repro.quant.abstract import packed_param_bytes as jax_packed_bytes
from repro.quant.abstract import quantize_params_abstract as jax_abstract
from repro.quant.spec import OverrideRule as JaxRule
from repro.quant.spec import QuantSpec as JaxSpec
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.models import init_params
from repro_torch.quant import QuantizedTensor
from repro_torch.quant.abstract import (packed_param_bytes,
                                        quantize_params_abstract,
                                        quantized_leaf_abstract)
from repro_torch.quant.spec import OverrideRule, QuantSpec

SPECS = {
    "w2": dict(bits=2), "w3": dict(bits=3), "w4": dict(bits=4),
    "w3_g128": dict(bits=3, group_size=128),
    "mixed": dict(bits=3, group_size=128, overrides=(
        ("wv", dict(bits=2)), ("blocks.L0.mlp.*", dict(bits=4)),
        ("*.wd", dict(group_size=0)), ("wo", dict(skip=True)))),
}

_params: dict = {}


def _both(arch):
    """The reference's bf16 eval_shape params and the port's on meta,
    once a process."""
    if arch not in _params:
        jp = jax.eval_shape(functools.partial(
            jax_init_params, JAX_ASSIGNED[arch], dtype=jnp.bfloat16),
            jax.random.PRNGKey(0))
        tp = init_params(ASSIGNED[arch], dtype="bfloat16", device="meta")
        _params[arch] = (jp, tp)
    return _params[arch]


def _specs(cfg, jcfg, kw):
    kw = dict(kw)
    rules = kw.pop("overrides", ())
    return (QuantSpec.from_config(cfg.quant, mode="packed", overrides=tuple(
                OverrideRule(p, **r) for p, r in rules), **kw),
            JaxSpec.from_config(jcfg.quant, mode="packed", overrides=tuple(
                JaxRule(p, **r) for p, r in rules), **kw))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        else:
            yield (*path, k), v


def _port_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_full_size_stand_ins_equal_the_reference(arch):
    cfg, jcfg = ASSIGNED[arch], JAX_ASSIGNED[arch]
    jp, tp = _both(arch)
    assert packed_param_bytes(tp) == jax_packed_bytes(jp)
    P = len(cfg.pattern)
    for name, kw in SPECS.items():
        spec, jspec = _specs(cfg, jcfg, kw)
        jq = jax_abstract(jcfg, jp, spec=jspec)
        tq = quantize_params_abstract(cfg, tp, spec=spec)
        assert packed_param_bytes(tq) == jax_packed_bytes(jq), name
        n_packed = 0
        for path, ref in _leaves(jq):
            if path[0] != "blocks":
                got = [_port_leaf(tq, path)]
                stacked = False
            else:
                slot = int(path[1][1:])
                got = [_port_leaf(tq["layers"][g * P + slot], path[2:])
                       for g in range(cfg.n_groups)]
                stacked = True
            for g, leaf in enumerate(got):
                assert isinstance(leaf, QuantizedTensor) == hasattr(
                    ref, "codes"), (name, path)
                if not hasattr(ref, "codes"):
                    continue
                n_packed += 1
                for field in ("codes", "alphas", "betas"):
                    want = getattr(ref, field).shape[1 if stacked else 0:]
                    t = getattr(leaf, field)
                    assert tuple(t.shape) == tuple(want), (name, path, field)
                    assert t.device.type == "meta"
                assert leaf.codes.dtype == torch.int32
                assert leaf.k_in == ref.k_in and leaf.bits == ref.bits
        assert n_packed > 0, name


# ---------------------------------------------------------------------------
# the reference's abstract tests (tests/test_quant_api.py) on the port
# ---------------------------------------------------------------------------

def _tiny():
    cfg = get_config("tiny-lm").replace(dtype="float32", n_layers=2)
    return cfg, init_params(cfg, device="meta")


def test_abstract_path_uses_same_resolver():
    cfg, p = _tiny()
    spec = QuantSpec.from_config(cfg.quant, mode="packed",
                                 overrides=(OverrideRule("wv", bits=2),))
    q = quantize_params_abstract(cfg, p, spec=spec)
    for layer in q["layers"]:
        assert layer["attn"]["wv"].bits == 2
        assert layer["attn"]["wq"].bits == cfg.quant.bits
    # the uniform-bits call
    q2 = quantize_params_abstract(cfg, p, 2)
    assert q2["layers"][0]["attn"]["wq"].bits == 2
    # the stacked layout resolves the same paths
    from repro_torch.ckpt import stack_params
    qs = quantize_params_abstract(cfg, stack_params(cfg, p), spec=spec)
    assert qs["blocks"]["L0"]["attn"]["wv"].codes.shape[:2] == (2, 2)
    assert packed_param_bytes(qs) == packed_param_bytes(q)


def test_group_size_validation_is_loud():
    with pytest.raises(ValueError, match=">= 0"):
        QuantSpec(group_size=-64)
    with pytest.raises(ValueError, match="int"):
        QuantSpec(group_size=64.0)
    with pytest.raises(ValueError, match=">= 0"):
        OverrideRule("wv", group_size=-1)
    plan = QuantSpec(group_size=48).resolve("blocks.L0.attn.wq", "wq")
    with pytest.raises(ValueError, match="divide"):
        plan.n_groups(256)
    assert plan.n_groups(96) == 2


def test_override_rule_can_set_group_size():
    spec = QuantSpec(method="gptqt", bits=3, group_size=128, overrides=(
        OverrideRule("wv", group_size=64),
        OverrideRule("wd", group_size=0),
    ))
    assert spec.resolve("blocks.L0.attn.wv", "wv").group_size == 64
    assert spec.resolve("blocks.L0.mlp.wd", "wd").group_size == 0
    assert spec.resolve("blocks.L0.attn.wq", "wq").group_size == 128
    assert QuantSpec.from_dict(spec.to_dict()) == spec


def test_abstract_grouped_leaf_sizes_scale_memory():
    leaf = torch.empty((512, 64), device="meta")
    q1 = quantized_leaf_abstract(leaf, 3)
    qg = quantized_leaf_abstract(leaf, 3, group_size=128)
    assert q1.alphas.shape == (1, 64, 3) and qg.alphas.shape == (4, 64, 3)
    assert qg.betas.shape == (4, 64)
    assert q1.codes.shape == (3, 16, 64)
    # the size model charges for the extra scale copies
    assert qg.packed_bytes() - q1.packed_bytes() == 3 * (64 * 3 + 64) * 4
    with pytest.raises(ValueError, match="divide"):
        quantized_leaf_abstract(leaf, 3, group_size=100)


def test_abstract_resolver_threads_group_size():
    cfg, p = _tiny()
    spec = QuantSpec.from_config(cfg.quant, mode="packed", group_size=64)
    q = quantize_params_abstract(cfg, p, spec=spec)
    wq = q["layers"][1]["attn"]["wq"]
    assert wq.alphas.shape[-3] == wq.k_in // 64
    assert wq.orig_dtype == "float32"
