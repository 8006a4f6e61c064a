"""The port's dry-run shapes and analytic parameter counts
(configs/base.py: ShapeSpec, SHAPES, runnable_shapes,
ModelConfig.param_counts) against the reference's, exactly, for every
config of the registry: the same 32 (arch x shape) cells of the ten
pool architectures."""
import dataclasses

import pytest

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import runnable_shapes as jax_runnable_shapes
from repro_torch.configs import (ASSIGNED, REGISTRY, SHAPES, ShapeSpec,
                                 runnable_shapes, smoke_config)


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, s in SHAPES.items():
        assert isinstance(s, ShapeSpec)
        assert dataclasses.astuple(s) == dataclasses.astuple(
            JAX_SHAPES[name])


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_runnable_shapes_and_param_counts_equal_the_reference(name):
    cfg, jcfg = REGISTRY[name], JAX_REGISTRY[name]
    assert [s.name for s in runnable_shapes(cfg)] == [
        s.name for s in jax_runnable_shapes(jcfg)]
    assert cfg.param_counts() == jcfg.param_counts()


def test_the_pool_has_32_cells():
    assert list(ASSIGNED) == list(JAX_ASSIGNED)
    assert sum(len(runnable_shapes(c)) for c in ASSIGNED.values()) == 32
    hubert = ASSIGNED["hubert-xlarge"]
    assert [s.kind for s in runnable_shapes(hubert)] == ["train", "prefill"]
    long = [n for n, c in ASSIGNED.items()
            if "long_500k" in {s.name for s in runnable_shapes(c)}]
    assert sorted(long) == ["falcon-mamba-7b", "jamba-1.5-large-398b",
                            "mixtral-8x7b"]


def test_param_counts_split_active_from_total():
    """MoE layers count top_k experts as active, and a sandwich-normed
    layer's post norms count in the total only (as in the reference);
    otherwise the active count is the total. The smoke configs shrink
    with their widths."""
    for name, cfg in ASSIGNED.items():
        c = cfg.param_counts()
        assert c["total"] == c["embed"] + c.get("lm_head", 0) \
            + c["blocks_total"]
        assert c["active"] <= c["total"]
        assert (c["active"] < c["total"]) == (cfg.moe is not None
                                              or cfg.post_block_norms)
        assert smoke_config(name).param_counts()["total"] < c["total"]
