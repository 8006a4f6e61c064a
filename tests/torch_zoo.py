"""Shared inputs of the port's model-zoo parity tests: an architecture's
config in both packages (the tiny members as registered, the others
as their smoke configs; fp32) and the reference's own init_params,
carried across with params_from_tree once per process. Test modules
import `zoo`."""
import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch.ckpt import params_from_tree
from repro_torch.configs import get_config, smoke_config

KEY = jax.random.PRNGKey(0)

_cache: dict = {}


def calibration(vocab):
    """The reference zoo test's two (2, 32) calibration batches."""
    return [np.asarray(jax.random.randint(jax.random.fold_in(KEY, i),
                                          (2, 32), 0, vocab))
            for i in range(2)]


def zoo(name):
    """{"jcfg", "cfg", "jfp", "fp"}: both packages' configs, the
    reference's init_params(jcfg, PRNGKey(0)) and their copy on the
    CPU."""
    st = _cache.get(name)
    if st is None:
        tiny = name.startswith("tiny-")
        jcfg = (jax_get_config(name) if tiny else jax_smoke_config(name))
        jcfg = jcfg.replace(dtype="float32", remat="none")
        cfg = (get_config(name) if tiny else smoke_config(name)).replace(
            dtype="float32")
        p = jax_init_params(jcfg, KEY)
        st = _cache[name] = {"jcfg": jcfg, "cfg": cfg, "jfp": p,
                             "fp": params_from_tree(jax.tree.map(np.asarray, p),
                                                    device="cpu")}
    return st
