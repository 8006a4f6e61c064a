"""The port's dry run (launch/dryrun.py) on the meta device.

- input_specs covers the 32 (arch x shape) cells;
- each cell's params_bytes_bf16, w3 params_bytes_packed, cache_bytes
  and state_bytes equal the reference's eval-shape values (built from
  the functions its lower_cell calls: jax.eval_shape of init_params,
  init_cache and init_train_state, and repro.quant.abstract; importing
  repro.launch.dryrun would set XLA_FLAGS for 512 host devices);
- on tiny-lm, tiny-moe, tiny-mla and the jamba, falcon-mamba and hubert
  smoke configs, the meta trace of a train step, a prefill and a decode
  step counts the FLOPs that FlopCounterMode counts on the same step run
  for real on the CPU (a w3-packed tiny-lm too: the kernels' own counts
  against the plain versions' matmuls), and its argument bytes are the
  real tensors';
- the 2/3-group extrapolation equals a direct 6-group trace;
- one CLI cell writes its JSON; the pod meshes are refused.
"""
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.quant.abstract import packed_param_bytes as jax_bytes
from repro.quant.abstract import quantize_params_abstract as jax_abstract
from repro.train.optimizer import AdamWConfig as JaxAdamW
from repro.train.train_step import init_train_state as jax_train_state
from repro_torch.configs import (ASSIGNED, ShapeSpec, get_config,
                                 runnable_shapes, smoke_config)
from repro_torch.launch import dryrun as dr
from repro_torch.quant import QuantizedTensor, dequantize_params
from repro_torch.roofline.op_profile import count_step
from torch_threads import one_torch_thread  # noqa: F401


def test_input_specs_cover_all_cells():
    n = 0
    for name, cfg in ASSIGNED.items():
        for s in runnable_shapes(cfg):
            spec = dr.input_specs(cfg, s)
            assert spec and all(t.device.type == "meta"
                                for t in spec.values())
            n += 1
    assert n == 32
    assert len(dr.cells()) == 32
    assert len(dr.cells(quant_bits=3)) == 22      # no train cell packed


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_cell_bytes_equal_the_reference(arch):
    cfg, jcfg = ASSIGNED[arch], JAX_ASSIGNED[arch]
    jp = jax.eval_shape(functools.partial(jax_init_params, jcfg,
                                          dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    for s in runnable_shapes(cfg):
        B, S = s.global_batch, s.seq_len
        _, _, meta = dr.lower_cell(cfg, s)
        assert meta["params_bytes_bf16"] == jax_bytes(jp), s.name
        if s.kind == "train":
            state = jax.eval_shape(functools.partial(
                jax_train_state, jcfg, opt_cfg=JaxAdamW()), jp)
            assert meta["state_bytes"] == jax_bytes(state), s.name
            continue
        cache = jax.eval_shape(functools.partial(
            jax_init_cache, jcfg, B, S, dtype=jnp.bfloat16))
        assert meta["cache_bytes"] == jax_bytes(cache), s.name
        _, _, mq = dr.lower_cell(cfg, s, quant_bits=3)
        assert mq["params_bytes_packed"] == jax_bytes(
            jax_abstract(jcfg, jp, 3)), s.name


SMALL = {"train": ShapeSpec("train", 16, 2, "train"),
         "prefill": ShapeSpec("prefill", 16, 2, "prefill"),
         "decode": ShapeSpec("decode", 16, 2, "decode")}
CONFIGS = ["tiny-lm", "tiny-moe", "tiny-mla", "jamba-1.5-large-398b",
           "falcon-mamba-7b", "hubert-xlarge"]


def _config(name):
    return (get_config(name) if name.startswith("tiny-")
            else smoke_config(name))


def _real_inputs(cfg, s):
    g = torch.Generator().manual_seed(0)
    B, S = s.global_batch, s.seq_len
    if cfg.embed_input == "tokens":
        x = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                          dtype=torch.int32)
    else:
        x = torch.randn((B, S, cfg.d_model), generator=g).bfloat16()
    if s.kind == "train":
        return {"inputs": x, "labels": torch.randint(
            0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)}
    if s.kind == "prefill":
        return {"inputs": x}
    return {"tokens": x[:, :1].contiguous(),
            "pos": torch.full((B,), S // 2, dtype=torch.int32)}


def _real_packed(tree, real, g):
    """The meta stand-ins of `tree` -> random w3 tensors on the CPU
    (uniform code words, alphas ~ K^-0.5), the other leaves from the
    CPU tree `real`."""
    if isinstance(tree, dict):
        return {k: _real_packed(v, real[k], g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_real_packed(v, r, g) for v, r in zip(tree, real)]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(
            torch.randint(-2 ** 31, 2 ** 31, tuple(tree.codes.shape),
                          generator=g, dtype=torch.int32),
            torch.rand(tuple(tree.alphas.shape), generator=g)
            * tree.k_in ** -0.5,
            torch.zeros(tuple(tree.betas.shape)), tree.k_in,
            tree.orig_dtype)
    return real


def _cases():
    out = []
    for name in CONFIGS:
        cfg = _config(name)
        for kind in ("train", "prefill", "decode"):
            if kind == "decode" and not cfg.has_decode:
                continue
            out.append((name, kind, None))
    return out + [("tiny-lm", "prefill", 3), ("tiny-lm", "decode", 3)]


@pytest.mark.parametrize("name,kind,bits", _cases())
def test_meta_trace_counts_what_the_real_step_does(name, kind, bits):
    cfg, s = _config(name), SMALL[kind]
    step, args, meta = dr.lower_cell(cfg, s, quant_bits=bits)
    traced = dr.trace_cell(step, args)
    inputs = _real_inputs(cfg, s)
    rstep, rargs, rmeta = dr.lower_cell(cfg, s, device="cpu",
                                        inputs=inputs)
    if bits:
        # the kernels' own counts against the plain matmuls of the same
        # weights dequantized (the plain BCQ path would add the
        # expansion's own products)
        g = torch.Generator().manual_seed(1)
        packed = _real_packed(args[0], rargs[0], g)
        rargs = (packed, *rargs[1:])
        dense = dequantize_params(packed, "bfloat16")
        cache = rargs[1] if kind == "decode" else None
        rstep = ((lambda: dr.decode_step(cfg, dense, cache,
                                         inputs["tokens"], inputs["pos"]))
                 if kind == "decode" else
                 (lambda: dr.prefill(cfg, dense, inputs["inputs"],
                                     s.seq_len)))
        assert traced["cost"]["kernels"]["calls"] == 7 * cfg.n_layers
    with FlopCounterMode(display=False) as fc:
        out = rstep()
    assert traced["cost"]["flops"] == fc.get_total_flops() > 0
    real = sum(n for n in dr._storages(rargs).values())
    assert traced["memory"]["argument_bytes"] == real
    assert sum(dr._storages(out).values()) == \
        traced["memory"]["output_bytes"]
    assert traced["memory"]["peak_live_bytes_est"] >= real
    assert {k: v for k, v in meta.items() if k != "params_bytes_packed"} \
        == rmeta


@pytest.mark.parametrize("name,kind", [("falcon-mamba-7b", "train"),
                                       ("jamba-1.5-large-398b", "decode"),
                                       ("tiny-moe", "prefill")])
def test_probe_extrapolation_equals_a_direct_trace(name, kind):
    """The cell's cost is base + groups x delta: the 2- and 3-group
    probes extrapolated to 6 groups equal a 6-group trace."""
    base = _config(name)
    cfg = base.replace(n_layers=6 * len(base.pattern))
    s = SMALL[kind]
    c2 = dr._probe_costs(cfg, s, 2)
    c3 = dr._probe_costs(cfg, s, 3)
    ex = dr._extrapolate(c2, c3, cfg.n_groups)
    step, args, _ = dr.lower_cell(cfg, s)
    _, direct = count_step(step, dr.tree_tensors(args))
    assert ex["flops"] == direct["flops"] > c3["flops"]
    assert ex["bytes"] == direct["bytes"] > c3["bytes"]


def test_cli_cell_writes_its_json(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dr, "ARTIFACTS", tmp_path)
    assert dr.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                    "--quant", "3"]) == 0
    assert "1/1 cells OK" in capsys.readouterr().out
    r = json.loads((tmp_path / "qwen3-0.6b__decode_32k__h100__w3.json")
                   .read_text())
    assert r["ok"] and r["n_devices"] == 1 and r["quant_bits"] == 3
    assert r["collectives"]["wire_bytes"] == 0
    assert r["roofline"]["bound"] == "memory"
    assert r["full_depth"]["kernels"]["calls"] > 0
    assert r["roofline"]["flops_per_device"] == r["full_depth"]["flops"]
    # a cache of 128 x 32768 tokens does not fit one card
    assert not r["memory"]["fits_device"]
    for flag in ("--multipod", "--no-fsdp"):
        with pytest.raises(NotImplementedError, match="item 6"):
            dr.main(["--arch", "qwen3-0.6b", "--shape", "train_4k", flag])


def test_chip_smoke_dryrun_phase_rehearses(monkeypatch):
    """chip_smoke.py's phase 11 on a subset, two cells at once in
    spawned workers: a `dryrun` line a cell, fp and w3."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    todo = [("qwen3-0.6b", "decode_32k"), ("mixtral-8x7b", "long_500k")]
    monkeypatch.setattr(dr, "cells",
                        lambda bits=None: todo[:1] if bits else todo)
    out = cs.phase_dryrun(jobs=2)
    assert out == rows and len(rows) == 3
    assert all(r["check"] == "dryrun" and r["ok"] for r in rows)
    assert [r["quant_bits"] for r in rows] == [None, None, 3]
    assert rows[2]["params_bytes_packed"] < rows[0]["params_bytes_bf16"]
    assert rows[0]["flops"] == rows[2]["flops"]      # kernels count 2MKN
    # run_cells hands the heaviest cell out first, results in task order
    assert dr._trace_weight(("mixtral-8x7b", "long_500k", {})) < \
        dr._trace_weight(("jamba-1.5-large-398b", "prefill_32k", {}))
