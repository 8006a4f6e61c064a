"""Regenerate the reference fixture of the PyTorch port's parity tests.

    PYTHONPATH=src python tests/data/torch_port/make_fixture.py [OUT_DIR] [--no-prefix]
    PYTHONPATH=src python tests/data/torch_port/make_fixture.py [OUT_DIR] --zoo

OUT_DIR defaults to this script's directory. `--no-prefix` leaves the
"prefix" section out (tests/test_torch_serve_prefix.py rebuilds that
section on its own, in parallel with the rest). `--zoo` writes only the
model-zoo section, OUT_DIR/zoo/ (see build_zoo). Everything is written
by the JAX package (`repro`) itself:

  w3_pc/        packed artifact: seeded 2-layer tiny-lm, GPTQT w3
                per-channel, fp32 scales (ckpt/packed.py:save_packed)
  w3_g64_bf16/  the same model at w3 group_size=64, scales stored bf16
  w3_moe/       seeded 2-layer tiny-moe (4 experts, top-2), GPTQT w3
                per-channel, expert stacks packed per expert
  reference.json
      per artifact: fixed prompts, the reference paged engine's greedy
      tokens (prefix_sharing=False), the prefill logits and the
      teacher-forced decode logits along each greedy path, and the
      smallest top-1/top-2 logit gap on that path; the same under
      "kv_bits" for the tiny-lm artifacts served with KV_BITS-bit
      binary-coded pages (greedy paths through the paged model
      functions), with each kept prompt's quantizer margin and, under
      "near_tie", the first prompt the margin filter dropped (its
      greedy path and logits, for the witnesses of that filter); plus
      the launcher's demo prompts and the reference's greedy tokens for
      them.

Only prompts (and prefix workloads: every logits row the engine takes a
token from) whose smallest gap is at least GAP_FACTOR times the logits
tolerance (LOGITS_RTOL * max|logit|) are kept, so greedy equality of the
port with the reference cannot hinge on a near-tie. With KV bits, a
prompt is also kept only if the reference's quantize-on-write along its
greedy path has no near-tie: in every write, every entry of a valid
token, in every greedy sign step and every refit round of kv_quantize,
has a margin of at least KV_TIE_MARGIN * max|x| of that write (the
margin: twice |r| for a greedy sign, the gap between the distances to
the two nearest levels for a refit round; an entry flips when x moves by
half of it). A 4-bit prefix workload is kept only if every quantize-on-write
of its engine run has that margin. A flip in a refit round changes
that group's alphas by 0.1 % and more, so on such a prompt any other fp32 summation order of
K/V, an fp64 one included, meets the reference's logits only by chance.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from functools import partial
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

from repro.ckpt.packed import load_packed, save_packed  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import quantize_model  # noqa: E402
from repro.data import ByteTokenizer  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models.model import (decode_step, decode_step_paged,  # noqa: E402
                                init_paged_cache, prefill,
                                scatter_prefill_cache)
from repro.quant import QuantSpec  # noqa: E402
from repro.quant import kv as jkv  # noqa: E402
from repro.serve import Request, ServeEngine, compile_cache  # noqa: E402

SEED = 0
N_LAYERS = 2
MAX_NEW = 8
N_PROMPTS = 4
LOGITS_RTOL = 1e-4
GAP_FACTOR = 10.0
# smallest quantize-on-write margin of a kept KV prompt, relative to
# max|x| of the write: twice 1e-6, the size of the K/V differences fp32
# sums in another order make (read at most 1.3e-6 x max|x| between the
# port's kernels on an H100 and its plain path on the CPU)
KV_TIE_MARGIN = 2e-6
# short candidates drawn after the fixed ones: more writes make a
# near-tie likelier, so the KV selection needs short prompts
N_SHORT = 48
# name -> (arch, group size, scale dtype)
ARTIFACTS = {"w3_pc": ("tiny-lm", 0, None),
             "w3_g64_bf16": ("tiny-lm", 64, "bfloat16"),
             "w3_moe": ("tiny-moe", 0, None)}
# binary-coded KV pages: bits, page size of the paged greedy paths
KV_BITS = 4
KV_ARTIFACTS = ["w3_pc", "w3_g64_bf16"]
PAGE = 16
LAUNCHER_SEEDS = ["the ancient city", "a famous museum", "this railway",
                  "the council", "another region", "the early dynasty"]
LAUNCHER_MAX_NEW = 24
# every greedy path runs in one fixed-size cache (prompt + new tokens fit)
CACHE_LEN = 64
# prefix workloads: PREFIX_LEN-token system prefix, one request per
# suffix length (wave 1 the first, wave 2 the rest, both sharing the
# prefix), wave 3 request 0's prompt + its first FORK_TOKENS tokens,
# whose match ends inside request 0's partial tail page
PREFIX_LEN = 21
SUFFIXES = (3, 7, 12, 1)
FORK_TOKENS = 3
PREFIX_ENGINE = {"batch_size": 2, "max_len": 64, "page_size": 8}
ENGINE_KW = {"share": {"prefix_sharing": True},
             "chunk5": {"prefix_sharing": False, "prefill_chunk": 5},
             "chunk16": {"prefix_sharing": False, "prefill_chunk": 16},
             "share_chunk5": {"prefix_sharing": True, "prefill_chunk": 5},
             "share_chunk16": {"prefix_sharing": True, "prefill_chunk": 16}}
PREFIX_RUNS = {"w3_pc": ("share", "chunk16", "share_chunk5"),
               "w3_g64_bf16": ("share", "share_chunk16"),
               "w3_moe": ("share", "chunk5")}
# 4-bit KV: one request at a time (no inactive decode row quantizes
# garbage), a 11-token prefix and 4 new tokens keep the writes few
# enough for the quantizer-margin filter; (artifact, group size, run)
KV_PREFIX_RUNS = (("w3_pc", 0, "share"), ("w3_g64_bf16", 32, "share_chunk5"))
KV_PREFIX = {"prefix_len": 11, "suffixes": (2, 3), "max_new": 4,
             "engine": {"batch_size": 1, "max_len": 64, "page_size": 8}}
# the sliding-window variant of tiny-lm served on w3_pc's weights
WINDOW = 16
COUNTERS = ("prefill_tokens", "prefix_hits", "prefix_tokens_saved",
            "cow_forks", "pages_allocated", "preemptions",
            "prefix_evictions", "prefix_cached_pages")
N_CANDIDATES = 24


def config(arch="tiny-lm"):
    return get_config(arch).replace(dtype="float32", n_layers=N_LAYERS)


def _round(a) -> list:
    return [float(f"{v:.7g}") for v in np.asarray(a, np.float64).ravel()]


def greedy_path(cfg, params, prompt, max_new, kv_bits=0, record=False):
    """Reference greedy decode through the model functions: tokens, the
    prefill logits and the decode logits (each step fed the previous
    greedy token), and the smallest top-1/top-2 gap relative to the
    logits tolerance. The prompt is padded to CACHE_LEN (its logits row
    picked by last_pos) so every path reuses one compilation. With
    kv_bits the prefill K/V is scattered into a binary-coded page pool
    (pages 1.., PAGE tokens each) and every step decodes through it;
    with `record`, through compilations that hand every quantize-on-
    write's input to _KV_WRITES."""
    L = len(prompt)
    _KV_WRITES.clear()
    padded = np.zeros((1, CACHE_LEN), np.int32)
    padded[0, :L] = prompt
    logits, cache = _jit(cfg, "prefill")(params, jnp.asarray(padded),
                                         jnp.asarray([L - 1], jnp.int32))
    if kv_bits:
        n_pg = CACHE_LEN // PAGE
        pool = init_paged_cache(cfg, n_pg + 1, PAGE, 1, "float32",
                                kv_bits=kv_bits)
        ids = jnp.arange(1, n_pg + 1, dtype=jnp.int32)
        cache = _jit(cfg, "scatter", record)(pool, cache, ids, L)
        bt = ids[None]
    steps = [np.asarray(logits[0])]
    toks = [int(np.argmax(steps[0]))]
    for t in range(max_new - 1):
        tok = jnp.asarray([[toks[-1]]], jnp.int32)
        pos = jnp.asarray([L + t], jnp.int32)
        if kv_bits:
            logits, cache = _jit(cfg, "decode_paged", record)(
                params, cache, tok, pos, bt)
        else:
            logits, cache = _jit(cfg, "decode")(params, cache, tok, pos)
        steps.append(np.asarray(logits[0]))
        toks.append(int(np.argmax(steps[-1])))
    ratio = min(float(np.diff(np.sort(s)[-2:])[0])
                / (LOGITS_RTOL * float(np.abs(s).max())) for s in steps)
    return toks, steps, ratio


_JIT: dict = {}
_KV_WRITES: list = []
_KV_QUANTIZE = jkv.kv_quantize


def _recording_kv_quantize(x, kv_bits, kv_group_size=0, iters=None):
    """The reference's kv_quantize, handing its input (and group size)
    to _KV_WRITES when the compiled function runs."""
    gs = kv_group_size or x.shape[-1]
    jax.debug.callback(lambda v: _KV_WRITES.append((np.asarray(v), gs)), x)
    return _KV_QUANTIZE(x, kv_bits, kv_group_size, iters)


def _jit(cfg, what, record=False):
    """One compilation per (config, entry point, recording or not); a
    recording one is traced with the reference's kv_quantize wrapped by
    _recording_kv_quantize (the model imports it at trace time)."""
    key = (cfg, what, record)
    if key not in _JIT:
        fn = jax.jit({
            "prefill": lambda p, t, lp: prefill(cfg, p, t, CACHE_LEN,
                                                last_pos=lp),
            "decode": lambda p, c, t, s: decode_step(cfg, p, c, t, s),
            "decode_paged": lambda p, c, t, s, bt: decode_step_paged(
                cfg, p, c, t, s, bt),
            "scatter": lambda pool, row, ids, n: scatter_prefill_cache(
                cfg, pool, row, 0, ids, n),
        }[what])
        if record:
            def fn(*args, _fn=fn):
                jkv.kv_quantize = _recording_kv_quantize
                try:
                    return _fn(*args)
                finally:
                    jkv.kv_quantize = _KV_QUANTIZE
        _JIT[key] = fn
    return _JIT[key]


@partial(jax.jit, static_argnames=("bits", "gs"))
def _margins(x, bits, gs):
    """Per-vector smallest margin of kv_quantize on x (..., hd) over its
    greedy sign steps and refit rounds (see the module docstring)."""
    from repro.core.binary_coding import sign_combos
    combos = jnp.asarray(sign_combos(bits))
    xg = x.reshape(*x.shape[:-1], -1, gs)
    r0 = xg - jnp.mean(xg, axis=-1, keepdims=True)
    r, out = r0, []
    for _ in range(bits):
        out.append(2 * jnp.abs(r).min(axis=-1))
        r = r - jnp.mean(jnp.abs(r), axis=-1)[..., None] * jnp.where(
            r >= 0, 1.0, -1.0)
    for it in range(1, jkv.KV_REFINE_ITERS + 1):
        _, a, _ = _KV_QUANTIZE(x, bits, gs, iters=it)
        d = jnp.sort(jnp.abs(r0[..., None, :] - (a @ combos.T)[..., None]),
                     axis=-2)
        out.append((d[..., 1, :] - d[..., 0, :]).min(axis=-1))
    return jnp.stack(out, -1).min(axis=(-1, -2))


def quant_margin(cfg, params, prompt, toks, kv_bits) -> float:
    """Smallest quantize-on-write margin along a prompt's greedy path
    with kv_bits-bit pages, relative to max|x| of each write (only the
    prompt's own tokens of the padded prefill write count)."""
    again, _, _ = greedy_path(cfg, params, prompt, MAX_NEW, kv_bits,
                              record=True)
    if again != toks:
        raise RuntimeError(f"{cfg.name}: the recording compilation's "
                           f"greedy path differs")
    worst = np.inf
    for x, gs in _KV_WRITES:
        if x.ndim == 5:               # prefill: (layers, pages, page, ...)
            x = x.reshape(x.shape[0], -1, *x.shape[3:])[:, :len(prompt)]
        m = _margins(jnp.asarray(x, jnp.float32), kv_bits, gs)
        worst = min(worst, float(m.min()) / float(np.abs(x).max()))
    return worst


def select(cfg, params, candidates, kv_bits=0):
    """The first N_PROMPTS candidates whose greedy path clears the gap
    filter (with kv_bits, the quantizer-margin filter too), and the
    reference paged engine's tokens for them (which must equal the
    model functions' greedy paths)."""
    kept, margins, near_tie = [], [], None
    for prompt in candidates:
        toks, steps, ratio = greedy_path(cfg, params, prompt, MAX_NEW,
                                         kv_bits)
        if ratio < GAP_FACTOR:
            continue
        if kv_bits:
            margin = quant_margin(cfg, params, prompt, toks, kv_bits)
            if margin < KV_TIE_MARGIN:
                if near_tie is None:
                    near_tie = {"prompt": prompt.tolist(), "tokens": toks,
                                "gap_ratio": ratio, "quant_margin": margin,
                                "prefill_logits": _round(steps[0]),
                                "decode_logits": [_round(s)
                                                  for s in steps[1:]]}
                continue
            margins.append(margin)
        kept.append((prompt, toks, steps, ratio))
        if len(kept) == N_PROMPTS:
            break
    if len(kept) < N_PROMPTS:
        raise RuntimeError(f"{cfg.name} kv_bits={kv_bits}: only "
                           f"{len(kept)} prompts clear the greedy gap "
                           f"filter")
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                      dtype="float32", cache_kind="paged", page_size=PAGE,
                      prefix_sharing=False, kv_bits=kv_bits)
    reqs = [Request(prompt=k[0], max_new_tokens=MAX_NEW) for k in kept]
    eng.run(reqs)
    for r, k in zip(reqs, kept):
        if r.out != k[1]:
            raise RuntimeError(f"{cfg.name} kv_bits={kv_bits}: engine and "
                               f"model-function greedy paths differ")
    out = {"prompts": [k[0].tolist() for k in kept],
           "tokens": [r.out for r in reqs],
           "gap_ratio": [k[3] for k in kept],
           "prefill_logits": [_round(k[2][0]) for k in kept],
           "decode_logits": [[_round(s) for s in k[2][1:]] for k in kept]}
    if kv_bits:
        out.update({"quant_margin": margins, "near_tie": near_tie})
    return out


def _gap_ratio(row) -> float:
    row = np.asarray(row, np.float64)
    top = np.sort(row)[-2:]
    return float(top[1] - top[0]) / (LOGITS_RTOL * float(np.abs(row).max()))


class GapEngine(ServeEngine):
    """The reference paged engine, recording the smallest top-1/top-2
    gap (relative to the logits tolerance) of every logits row it takes
    a greedy token from."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.min_gap = np.inf
        decode = self._decode

        def recorded(params, cache, toks, pos, bt, live, null_row):
            logits, cache = decode(params, cache, toks, pos, bt, live,
                                   null_row)
            for row in np.asarray(logits)[np.asarray(live) > 0]:
                self.min_gap = min(self.min_gap, _gap_ratio(row))
            return logits, cache
        self._decode = recorded

    def _emit_first_token(self, e, last_logits, prompt_len):
        self.min_gap = min(self.min_gap, _gap_ratio(last_logits[0]))
        super()._emit_first_token(e, last_logits, prompt_len)


def serve_waves(cfg, params, waves, max_new, engine_kw):
    """Serve `waves` (lists of prompts; None: request 0's prompt + its
    first FORK_TOKENS tokens) in turn through one reference paged
    engine; the run's record (see build_prefix)."""
    eng = GapEngine(cfg, params, dtype="float32", cache_kind="paged",
                    **engine_kw)
    served, tokens = [], []
    for wave in waves:
        if wave is None:
            wave = [list(served[0][0]) + tokens[0][0][:FORK_TOKENS]]
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=max_new) for p in wave]
        eng.run(reqs)
        served.append([list(map(int, p)) for p in wave])
        tokens.append([r.out for r in reqs])
    return {"engine": engine_kw, "max_new": max_new, "waves": served,
            "tokens": tokens,
            "counters": {k: int(eng.stats[k]) for k in COUNTERS},
            "gap_ratio": eng.min_gap}


def kept_run(cfg, params, candidates, max_new, engine_kws, kv_bits=0):
    """The runs of the first candidate workload whose every run clears
    the gap filter (with kv_bits, the quantizer-margin filter too, over
    every quantize-on-write of the run); the engines are traced with a
    recording kv_quantize for that."""
    for waves in candidates:
        runs, margins = [], []
        for kw in engine_kws:
            _KV_WRITES.clear()
            run = serve_waves(cfg, params, waves, max_new, kw)
            if kv_bits:
                gs = _KV_WRITES[0][1]
                margins.append(min(
                    float(_margins(jnp.asarray(x), kv_bits, gs).min())
                    / float(np.abs(x).max()) for x, _ in _KV_WRITES))
                run["quant_margin"] = margins[-1]
            runs.append(run)
        if (min(r["gap_ratio"] for r in runs) >= GAP_FACTOR
                and min(margins, default=np.inf) >= KV_TIE_MARGIN):
            return runs
    raise RuntimeError(f"{cfg.name}: no prefix workload clears the filters")


def build_prefix(out: Path) -> dict:
    """The "prefix" section: every run is a dict with the engine's
    arguments (besides dtype float32 and cache_kind paged), max_new, the
    waves of prompts, their tokens, the counters and the smallest gap
    ratio (and with KV bits the smallest quantizer margin)."""
    rng = np.random.default_rng(SEED + 1)

    def shared(prefix_len, suffixes, fork=True):
        prefix = rng.integers(0, 256, prefix_len)
        prompts = [np.concatenate([prefix, rng.integers(0, 256, n)])
                   for n in suffixes]
        waves = [prompts[:1], prompts[1:]]
        return waves + [None] if fork else waves

    doc = {"engine": PREFIX_ENGINE, "runs": {}}
    params = {name: load_packed(out / name)[0] for name in ARTIFACTS}
    cands = [shared(PREFIX_LEN, SUFFIXES) for _ in range(N_CANDIDATES)]
    for name, runs in PREFIX_RUNS.items():
        cfg = config(ARTIFACTS[name][0])
        kept = kept_run(cfg, params[name], cands, MAX_NEW - 2,
                        [{**PREFIX_ENGINE, **ENGINE_KW[r]} for r in runs])
        doc["runs"].update({f"{name}/{r}": k for r, k in zip(runs, kept)})
    # sliding-window layers on the paged engine: whole-prompt extend
    # prefill, and chunked
    cfg = config().replace(pattern=tuple(
        dataclasses.replace(s, window=WINDOW) for s in config().pattern))
    kept = kept_run(cfg, params["w3_pc"], cands, MAX_NEW,
                    [{**PREFIX_ENGINE, **ENGINE_KW[r]}
                     for r in ("share", "chunk5")])
    doc["runs"].update({"w3_pc_window16/share": kept[0],
                        "w3_pc_window16/chunk5": kept[1]})
    # pool pressure: a 12-page pool of 4-token pages preempts, and the
    # resumed request re-matches its own prompt pages; distinct prompts
    # through a 6-page pool make admission reclaim the index
    pressure = [[[rng.integers(0, 256, 10) for _ in range(2)]]
                for _ in range(N_CANDIDATES)]
    doc["runs"]["w3_pc/preempt"] = kept_run(
        config(), params["w3_pc"], pressure, 16,
        [{"batch_size": 2, "max_len": 64, "page_size": 4, "n_pages": 13,
          "prefix_sharing": True}])[0]
    distinct = [[[rng.integers(0, 256, 10) for _ in range(5)]]
                for _ in range(N_CANDIDATES)]
    doc["runs"]["w3_pc/reclaim"] = kept_run(
        config(), params["w3_pc"], distinct, 4,
        [{"batch_size": 2, "max_len": 48, "page_size": 8, "n_pages": 7,
          "prefix_sharing": True}])[0]
    # 4-bit KV pages, traced with the recording kv_quantize
    kv_cands = [shared(KV_PREFIX["prefix_len"], KV_PREFIX["suffixes"],
                       fork=False) for _ in range(N_CANDIDATES)]
    compile_cache.clear()
    jkv.kv_quantize = _recording_kv_quantize
    try:
        for name, gs, run in KV_PREFIX_RUNS:
            kw = {**KV_PREFIX["engine"], **ENGINE_KW[run],
                  "kv_bits": KV_BITS, "kv_group_size": gs}
            doc["runs"][f"{name}/kv{KV_BITS}_gs{gs}_{run}"] = kept_run(
                config(), params[name], kv_cands, KV_PREFIX["max_new"],
                [kw], kv_bits=KV_BITS)[0]
    finally:
        jkv.kv_quantize = _KV_QUANTIZE
        compile_cache.clear()
    return doc


def build(out: Path, prefix: bool = True) -> dict:
    key = jax.random.PRNGKey(SEED)
    rng = np.random.default_rng(SEED)
    candidates = [rng.integers(0, 256, n).astype(np.int32)
                  for n in (5, 9, 12, 17, 23, 31, 40, 7, 14, 26, 35, 44)]
    candidates += [rng.integers(0, 256, n).astype(np.int32)
                   for n in rng.integers(4, 13, N_SHORT)]
    doc = {"generator": "tests/data/torch_port/make_fixture.py",
           "seed": SEED, "arch": "tiny-lm", "n_layers": N_LAYERS,
           "max_new": MAX_NEW, "logits_rtol": LOGITS_RTOL,
           "gap_factor": GAP_FACTOR, "artifacts": {},
           "kv_bits": {"bits": KV_BITS, "page_size": PAGE,
                       "tie_margin": KV_TIE_MARGIN, "artifacts": {}}}
    models: dict = {}
    for name, (arch, gs, scale_dtype) in ARTIFACTS.items():
        cfg = config(arch)
        if arch not in models:
            p = init_params(cfg, key)
            calib = [jax.random.randint(jax.random.fold_in(key, i), (2, 48),
                                        0, cfg.vocab_size) for i in range(2)]
            models[arch] = (p, calib)
        p, calib = models[arch]
        spec = QuantSpec.from_config(cfg.quant, method="gptqt",
                                     mode="packed", group_size=gs)
        qp, _ = quantize_model(cfg, p, calib, spec=spec)
        save_packed(out / name, qp, spec=spec,
                    meta={"arch": arch, "n_layers": N_LAYERS},
                    scale_dtype=scale_dtype)
        lp, _, _ = load_packed(out / name)
        doc["artifacts"][name] = {
            "arch": arch, "group_size": gs,
            "scale_dtype": scale_dtype or "float32",
            **select(cfg, lp, candidates)}
        if name in KV_ARTIFACTS:
            doc["kv_bits"]["artifacts"][name] = select(cfg, lp, candidates,
                                                       KV_BITS)
    # the launcher's demo prompts on the per-channel artifact (greedy
    # paths of the model functions, which the engine run above matches)
    cfg = config()
    lp, _, _ = load_packed(out / "w3_pc")
    tok = ByteTokenizer()
    paths = [greedy_path(cfg, lp, tok.encode(s), LAUNCHER_MAX_NEW)
             for s in LAUNCHER_SEEDS]
    doc["launcher"] = {
        "artifact": "w3_pc", "max_new": LAUNCHER_MAX_NEW,
        "prompts": LAUNCHER_SEEDS, "tokens": [t for t, _, _ in paths],
        "gap_ratio": [r for _, _, r in paths]}
    if prefix:
        doc["prefix"] = build_prefix(out)
    (out / "reference.json").write_text(
        json.dumps(doc, separators=(",", ":")) + "\n")
    return doc


# ---------------------------------------------------------------------------
# the model zoo (tests/test_torch_model_zoo_serve.py)
# ---------------------------------------------------------------------------

# label -> (registry name, packed bits or None for fp only), the smoke
# configs of tests/test_model_zoo_serve.py plus gemma2 and falcon-mamba
ZOO = {"attention": ("tiny-lm", 3), "mla": ("minicpm3-4b", 3),
       "mamba-mix": ("jamba-1.5-large-398b", 4), "moe": ("mixtral-8x7b", 4),
       "gemma2": ("gemma2-27b", None), "mamba": ("falcon-mamba-7b", None)}
ZOO_ENGINE = {"batch_size": 2, "max_len": 64, "dtype": "float32"}
ZOO_PAGE = 8
ZOO_MAX_NEW = 5


def zoo_config(arch, bits=None):
    from repro.configs import smoke_config
    cfg = smoke_config(arch).replace(dtype="float32", remat="none")
    if bits is not None and cfg.quant.bits != bits:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, bits=bits))
    return cfg


def zoo_requests(cfg, seed, n=3):
    """tests/test_model_zoo_serve.py's prompts (mixed lengths 4/7/10)."""
    return [((np.arange(4 + 3 * ((i + seed) % 3)) * 7 + 11 * i + seed)
             % cfg.vocab_size).astype(np.int32) for i in range(n)]


def zoo_gap_ratio(cfg, params, prompt, toks) -> float:
    """Smallest top-1/top-2 logit gap along a greedy path, relative to
    the logits tolerance: the exact-length prefill, then dense decode
    steps at batch 1 fed the path's tokens."""
    logits, cache = prefill(cfg, params, jnp.asarray(prompt[None]), 64)
    steps = [np.asarray(logits[0])]
    for t, tok in enumerate(toks[:-1]):
        logits, cache = decode_step(cfg, params, cache,
                                    jnp.asarray([[tok]], jnp.int32),
                                    jnp.asarray([len(prompt) + t], jnp.int32))
        steps.append(np.asarray(logits[0]))
    return min(float(np.diff(np.sort(s)[-2:])[0])
               / (LOGITS_RTOL * float(np.abs(s).max())) for s in steps)


def zoo_serve(cfg, params, prompts, max_new, **kw):
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    eng = ServeEngine(cfg, params, **{**ZOO_ENGINE, **kw})
    eng.run(reqs)
    return [r.out for r in reqs], eng


def build_zoo(out: Path) -> dict:
    """OUT/zoo/: per architecture its smoke config's seeded fp params
    (init_params(cfg, PRNGKey(SEED)), saved by save_packed as a packed
    artifact with no quantized leaf) and, where ZOO gives bits, their
    GPTQT-packed quantization (the zoo test's calibration), and zoo.json:
    per artifact the prompts (the first seed whose greedy paths all
    clear GAP_FACTOR), the reference's dense and paged engine tokens and
    the smallest gap ratio; then MLA preemption (5 pages of 8 tokens)
    and prefix attach (a 32-token prefix), with their counters."""
    key = jax.random.PRNGKey(SEED)
    zdir = out / "zoo"
    zdir.mkdir(parents=True, exist_ok=True)
    doc = {"generator": "tests/data/torch_port/make_fixture.py --zoo",
           "seed": SEED, "engine": ZOO_ENGINE, "page_size": ZOO_PAGE,
           "max_new": ZOO_MAX_NEW, "logits_rtol": LOGITS_RTOL,
           "gap_factor": GAP_FACTOR, "artifacts": {}}
    for label, (arch, bits) in ZOO.items():
        cfg = zoo_config(arch, bits)
        p = init_params(cfg, key)
        models = {"fp": p}
        if bits is not None:
            calib = [jax.random.randint(jax.random.fold_in(key, i), (2, 32),
                                        0, cfg.vocab_size) for i in range(2)]
            spec = QuantSpec.from_config(cfg.quant, method="gptqt",
                                         mode="packed")
            models["quant"] = quantize_model(cfg, p, calib, spec=spec)[0]
        for kind, params in models.items():
            name = f"{label}_{kind}"
            save_packed(zdir / name, params,
                        spec=spec if kind == "quant" else None,
                        meta={"arch": arch + "-smoke",
                              "n_layers": cfg.n_layers})
            params, _, _ = load_packed(zdir / name)
            for seed in range(N_CANDIDATES):
                prompts = zoo_requests(cfg, seed)
                dense, _ = zoo_serve(cfg, params, prompts, ZOO_MAX_NEW)
                ratio = min(zoo_gap_ratio(cfg, params, pr, t)
                            for pr, t in zip(prompts, dense))
                if ratio >= GAP_FACTOR:
                    break
            else:
                raise RuntimeError(f"{name}: no seed clears the gap filter")
            paged, _ = zoo_serve(cfg, params, prompts, ZOO_MAX_NEW,
                                 cache_kind="paged", page_size=ZOO_PAGE)
            doc["artifacts"][name] = {
                "arch": arch, "bits": bits if kind == "quant" else None,
                "seed": seed, "prompts": [x.tolist() for x in prompts],
                "dense": dense, "paged": paged, "gap_ratio": ratio}
    # MLA: preemption exactness and prefix attach on the latent cache
    cfg = zoo_config("minicpm3-4b", 3)
    params, _, _ = load_packed(zdir / "mla_fp")
    prompts = [((np.arange(6) * 3 + i) % cfg.vocab_size).astype(np.int32)
               for i in range(2)]
    dense, _ = zoo_serve(cfg, params, prompts, 14)
    paged, eng = zoo_serve(cfg, params, prompts, 14, cache_kind="paged",
                           page_size=ZOO_PAGE, n_pages=5)
    doc["mla_preempt"] = {
        "prompts": [x.tolist() for x in prompts], "max_new": 14,
        "n_pages": 5, "dense": dense, "paged": paged,
        "preemptions": eng.sched.preemptions,
        "gap_ratio": min(zoo_gap_ratio(cfg, params, pr, t)
                         for pr, t in zip(prompts, dense))}
    prefix = (np.arange(4 * ZOO_PAGE, dtype=np.int32) * 3 + 5) % cfg.vocab_size
    prompts = [np.concatenate([prefix, np.arange(100 + i * 7,
                                                 100 + i * 7 + ZOO_PAGE)
                               % cfg.vocab_size]).astype(np.int32)
               for i in range(2)]
    runs = {}
    for sharing in (False, True):
        toks, eng = zoo_serve(cfg, params, prompts, 5, cache_kind="paged",
                              page_size=ZOO_PAGE, prefix_sharing=sharing)
        runs["share" if sharing else "plain"] = {
            "tokens": toks, "prefix_hits": eng.stats["prefix_hits"],
            "prefix_tokens_saved": eng.stats["prefix_tokens_saved"],
            "pages_allocated": eng.kv.pages_allocated,
            "cow_forks": eng.stats["cow_forks"]}
    doc["mla_prefix"] = {
        "prompts": [x.tolist() for x in prompts], "max_new": 5, **runs,
        "gap_ratio": min(zoo_gap_ratio(cfg, params, pr, t)
                         for pr, t in zip(prompts, runs["plain"]["tokens"]))}
    (zdir / "zoo.json").write_text(json.dumps(doc, indent=1) + "\n")
    return doc


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a not in ("--no-prefix", "--zoo")]
    out = Path(args[0]) if args else Path(__file__).parent
    if "--zoo" in sys.argv[1:]:
        build_zoo(out)
    else:
        build(out, prefix="--no-prefix" not in sys.argv[1:])
