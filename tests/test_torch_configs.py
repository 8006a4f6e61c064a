"""The port's config registry (repro_torch/configs/) against the
reference's: the same names, and every entry and its smoke config equal
field by field (every field the port keeps, sub-configs included), with
the derived head dim, d_inner and dt rank."""
import dataclasses

import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import smoke_config as jax_smoke_config
from repro_torch.configs import (ASSIGNED, EXTRA, REGISTRY, ModelConfig,
                                 get_config, smoke_config)
from torch_threads import one_torch_thread  # noqa: F401


def assert_same(mine, ref, where=""):
    """Every field of the port's dataclass equals the reference's (sub
    dataclasses and pattern tuples compared the same way)."""
    if dataclasses.is_dataclass(mine):
        assert dataclasses.is_dataclass(ref), where
        for f in dataclasses.fields(mine):
            assert_same(getattr(mine, f.name), getattr(ref, f.name),
                        f"{where}.{f.name}")
    elif isinstance(mine, tuple):
        assert isinstance(ref, tuple) and len(mine) == len(ref), where
        for i, (a, b) in enumerate(zip(mine, ref)):
            assert_same(a, b, f"{where}[{i}]")
    else:
        assert mine == ref and type(mine) is type(ref), (where, mine, ref)


def test_registry_names_match_the_reference():
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    assert len(ASSIGNED) == 10 and len(EXTRA) == 8
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_config_and_smoke_config_match_the_reference(name):
    for mine, ref in ((get_config(name), JAX_REGISTRY[name]),
                      (smoke_config(name), jax_smoke_config(name))):
        assert_same(mine, ref, mine.name)
        assert mine.resolved_head_dim == ref.resolved_head_dim
        assert mine.n_groups == ref.n_groups
        assert len(mine.layer_specs()) == mine.n_layers
        if ref.mamba is not None:
            assert mine.d_inner == ref.d_inner
            assert (mine.mamba.resolved_dt_rank(mine.d_model)
                    == ref.mamba.resolved_dt_rank(ref.d_model))
        else:
            with pytest.raises(ValueError, match="Mamba"):
                mine.d_inner


def test_port_fields_are_the_references():
    """The port keeps a subset of the reference's fields (scan_unroll,
    the unroll flag of the reference's layer scan, is left out: the port
    loops over its layers) and nothing else."""
    from repro.configs.base import ModelConfig as JaxModelConfig
    mine = {f.name for f in dataclasses.fields(ModelConfig)}
    ref = {f.name for f in dataclasses.fields(JaxModelConfig)}
    assert mine <= ref and ref - mine == {"scan_unroll"}
