"""Model assembly (the reference's `models/model.py`): decoders and
encoders whose layers are attention (GQA or MLA) or Mamba mixers, each
followed by a dense or MoE MLP (or none), with optional post-block
("sandwich") norms; token or frame inputs.

Parameters are plain dicts of tensors with one weight dict per layer
(the reference stacks each pattern position along an (n_groups, ...)
axis and scans it; the port loops over the layers):

    {"embed": (V, D), "final_ln": (D,), ["lm_head": (D, V)],
     "layers": [{"ln",
                 "attn": {"wq","wk","wv","wo"[,"qn","kn"]}     (GQA), or
                 "attn": {"wq_a","q_a_norm","wq_b","wkv_a",
                          "kv_a_norm","wkv_b","wo"}           (MLA), or
                 "mamba": {"in_proj","conv_w","conv_b","x_proj",
                           "dt_w","dt_b","A_log","D","out_proj"},
                 ["post_ln"],
                 ["ln2", "mlp": {"wg","wu","wd"} | "moe": {"router",
                  "wg","wu","wd"}, ["post_ln2"]]}, ...]}

Any weight may be a QuantizedTensor; `layers.linear` dispatches on it.
`forward` and `loss_fn` also take the reference's stacked layout of fp
weights ({"blocks": {"L{i}": (n_groups, ...) leaves}}, what training
keeps and checkpoints hold): each stacked leaf is unbound into
per-layer views, so gradients land on the stacked leaves.
Caches are lists with one dict per layer, updated in place: K/V (or
their pages), MLA latents (or latent pages), or a Mamba layer's
per-slot recurrent state rows (batch / max_seqs rows, never paged).

Entry points:
  init_params(cfg, seed, dtype, device)              -> params
  forward(cfg, params, inputs, remat=)               -> (logits, aux)
  loss_fn(cfg, params, batch, aux_coef=, remat=)     -> (loss, metrics)
  prefill(cfg, params, tokens, max_len, last_pos=)   -> (last logits, cache)
  init_cache / decode_step                            dense caches
  init_paged_cache / decode_step_paged                page pools (fp or
                                                      binary-coded K/V,
                                                      MLA latents) + state
                                                      rows
  scatter_prefill_cache                               dense prefill -> pages
  extend_paged / _extend_scan                         a chunk of prompt
                                                      tokens over the pages
                                                      (attention and MLA)
  copy_pages                                          copy-on-write forks
  draft_propose_paged / verify_paged                  self-speculative
                                                      decoding

MoE layers use the reference's capacities: the train-time capacity
factor in `forward`, the inference capacity factor in prefill (pad
tokens of a bucket route and take capacity like real ones, as in the
reference) and 4.0 in decode and extend. The decode and paged entry
points take token-in decoders only (`require_decoder`); `forward`,
`prefill` and `init_cache` take every config of the registry, frame
inputs and encoders (hubert-xlarge) included, as the reference's do.
With device="meta", `init_params` and `init_cache` make tensors with
shapes and no data (the dry run, launch/dryrun.py).

On a serving mesh (dist/context.py) every rank runs these functions on
its own slice of the weights and a shard-local config (`shard_config`:
its heads, d_inner, MLP width and, through the weights, its experts):
the output of each mixer and each MLP (after wo, out_proj, wd or the
MoE combine) is summed over the model group by `reduce_model` (a Mamba
mixer also sums its x_proj features, models/mamba.py), a vocabulary
split over the model axis is looked up masked and summed, and split
logits are gathered. MLA's latent is whole on every rank. Where the
model axis does not divide the KV heads, a rank computes and caches
every KV head and its query heads read their group's (models/
attention.py:kv_heads); a dense engine's caches the rule splits along
the sequence hold the rank's block of positions (attention.py:
seq_block). Weights sharded over the data axis too (dist/fsdp.py) are
gathered layer by layer, just before the layer runs (`_layers`); the
embedding and head are not gathered: the data ranks' activations are
(`embed_inputs`, `unembed`). Outside a mesh each hook is the
identity. Training on a mesh (train/train_step.py) runs the same code
under autograd: the hooks' backwards sum each rank's gradient of the
replicated input of every column-parallel projection (`copy_to_model`:
the normed input of each mixer and dense MLP, a MoE layer's dispatched
tokens and top-k weights, the head's input; a Mamba mixer's x_proj
features are summed forward and backward) and
reduce-scatter the gathered weights'; `forward` gathers a layer's FSDP
leaves inside its activation checkpoint, so the backward gathers them
again and no layer's stay. Every family trains so: dense, MoE (experts
on the model axis; on a data axis the step routes the whole
microbatch, models/moe.py), MLA (each rank's heads on the whole latent,
whose leaves' gradients train/train_step.py sums over the model group)
and Mamba.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import (copy_to_model, current_mesh,
                                      data_coords, gather_fsdp, gather_model,
                                      model_coords, reduce_fsdp, reduce_model)
from repro_torch.dist.fsdp import FsdpLeaf, gather_tree
from repro_torch.hw import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import (cross_entropy, init_linear,
                                       init_swiglu, linear, rmsnorm, softcap,
                                       swiglu)
from repro_torch.models.moe import init_moe, moe_forward

# decode dispatch capacity of MoE layers (the reference's 4x slack
# instead of fully dropless; exactly dropless at tiny batch)
DECODE_CAPACITY_FACTOR = 4.0


def check_config(cfg) -> None:
    """MoE and Mamba layers need their sub-configs."""
    if any(s.mlp == "moe" for s in cfg.pattern) and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers without a MoE config")
    if any(s.kind == "mamba" for s in cfg.pattern) and cfg.mamba is None:
        raise ValueError(f"{cfg.name}: Mamba layers without a Mamba config")


def require_decoder(cfg) -> None:
    """The decode and paged entry points take token-in decoders. Frame
    inputs and encoder-only models (hubert-xlarge) have no decode step,
    as in the reference: they run through `forward`, `loss_fn`,
    `prefill` and `init_cache` only."""
    if cfg.embed_input != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: frame inputs run through forward, loss_fn and "
            f"prefill only; decoding takes token-in decoders")
    if not cfg.has_decode:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-only model has no decode step; it "
            f"runs through forward, loss_fn and prefill only")
    check_config(cfg)


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """The config one rank of a `model_axis`-way model axis runs
    (shard_config): its heads and MLP width are its fields, and d_inner,
    which the config derives from d_model, is divided here. `kv_whole`:
    its n_kv_heads are all of the model's (wk, wv and the cache whole);
    `dense_len`: the max_len of the dense caches it serves (0: paged),
    which decides the caches the rule splits along the sequence."""
    model_axis: int = 1
    kv_whole: bool = False
    dense_len: int = 0

    @property
    def d_inner(self) -> int:
        return super().d_inner // self.model_axis


def shard_config(cfg, model: int, dense_len: int = 0, train: bool = False):
    """The config one rank of a `model`-way model axis runs: with
    attention layers n_heads divided by `model` (and n_kv_heads where
    the axis divides them; MLA has none in its cache: its latent
    replicates), with Mamba layers d_inner, with dense MLP layers d_ff;
    the experts split through the weights (E / model a rank,
    models/moe.py), each keeping the single-device capacity. Where the
    axis does not divide n_kv_heads but each rank's query heads lie in
    one GQA group, the rank keeps every KV head (`kv_whole`; the rule
    replicates the pool). `dense_len`: a dense engine's max_len. An
    attention-free pattern keeps its (unused) head counts. A dimension
    the axis does not divide, or query heads that straddle two GQA
    groups, raise ValueError naming them; with `train` (the training
    forward, which reads a KV head a query head, attention.py:_rank_kv)
    straddling heads keep every KV head too."""
    if model == 1:
        return cfg
    kinds = {s.kind for s in cfg.pattern}
    dims = {}
    kv_whole = False
    if "attn" in kinds:
        dims["n_heads"] = cfg.n_heads
        if cfg.mla is None and cfg.n_kv_heads % model == 0:
            dims["n_kv_heads"] = cfg.n_kv_heads
        elif cfg.mla is None and cfg.n_heads % model == 0:
            mine, rep = cfg.n_heads // model, cfg.n_heads // cfg.n_kv_heads
            if rep % mine and not train:
                raise ValueError(
                    f"{cfg.name}: a {model}-way model axis gives each rank "
                    f"{mine} of n_heads={cfg.n_heads} query heads, which "
                    f"straddle the GQA groups of n_kv_heads="
                    f"{cfg.n_kv_heads} ({rep} query heads a KV head)")
            kv_whole = True
    if "mamba" in kinds:
        dims["d_inner"] = cfg.d_inner
    if any(s.mlp == "dense" for s in cfg.pattern):
        dims["d_ff"] = cfg.d_ff
    if cfg.moe is not None and any(s.mlp == "moe" for s in cfg.pattern):
        dims["moe.n_experts"] = cfg.moe.n_experts
    for name, n in dims.items():
        if n % model:
            raise ValueError(f"{cfg.name}: a {model}-way model axis does "
                             f"not divide {name}={n}")
    kw = {k: dims[k] // model for k in ("n_heads", "n_kv_heads", "d_ff")
          if k in dims}
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    return RankConfig(**fields, model_axis=model, kv_whole=kv_whole,
                      dense_len=dense_len).replace(
        head_dim=cfg.resolved_head_dim, **kw)


def _unbind_tree(tree):
    """A slot's stacked weight dict -> one dict of views per group (an
    FsdpLeaf's blocks unbound field by field)."""
    if not isinstance(tree, dict):
        return list(tree.unbind(0))
    parts = {k: _unbind_tree(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[g] for k, v in parts.items()} for g in range(n)]


def layer_params(cfg, params) -> list:
    """The per-layer weight dicts of either layout: params["layers"] as
    they are, or views into the reference's stacked params["blocks"]
    (layer g * len(pattern) + i is group g of slot "L{i}")."""
    if "layers" in params:
        return list(params["layers"])
    P = len(cfg.pattern)
    slots = [_unbind_tree(params["blocks"][f"L{i}"]) for i in range(P)]
    return [slots[i][g] for g in range(len(slots[0])) for i in range(P)]


def _layers(cfg, params, gather: bool = True):
    """(spec, layer weights) for every layer, in order; the weights must
    have the config's depth. A layer's FSDP-sharded leaves are gathered
    as it is reached (dist/fsdp.py), so one layer's are whole at a
    time; with gather=False the caller gathers them (the training
    forward, inside the layer's activation checkpoint)."""
    layers = layer_params(cfg, params)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(layers)} "
                         f"layers, the config {cfg.n_layers}")
    for spec, lp in zip(cfg.layer_specs(), layers):
        yield spec, gather_tree(lp) if gather else lp


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_layer(cfg, spec, gen, dtype, device):
    d = cfg.d_model
    dt = torch_dtype(dtype)
    p = {"ln": torch.zeros((d,), dtype=dt, device=device)}
    if spec.kind == "attn":
        p["attn"] = (mla_mod.init_mla(cfg, gen, dtype, device)
                     if cfg.mla is not None
                     else attn.init_attn(cfg, gen, dtype, device))
    else:
        p["mamba"] = mam.init_mamba(cfg, gen, dtype, device)
    if cfg.post_block_norms:
        p["post_ln"] = torch.zeros((d,), dtype=dt, device=device)
    if spec.mlp != "none":
        p["ln2"] = torch.zeros((d,), dtype=dt, device=device)
        if spec.mlp == "moe":
            p["moe"] = init_moe(cfg, gen, dtype, device)
        else:
            p["mlp"] = init_swiglu(gen, d, cfg.d_ff, dtype, device)
        if cfg.post_block_norms:
            p["post_ln2"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def init_params(cfg, seed: int = 0, dtype=None, device=None):
    """Random init from a `torch.Generator` seeded with `seed` on the
    target device (the same distributions as the reference's init; the
    numbers differ, so parity tests carry the reference's weights across
    with ckpt.params_from_tree instead). Frame-input configs get the
    learned (D, D) input projection as "embed". On the meta device no
    number is drawn and no generator is made: the tree holds the leaves'
    shapes and dtypes only."""
    check_config(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d = cfg.d_model
    params = {"final_ln": torch.zeros((d,), dtype=torch_dtype(dtype),
                                      device=dev)}
    if cfg.embed_input == "tokens":
        params["embed"] = (torch.randn((cfg.vocab_size, d), generator=gen,
                                       dtype=torch.float32, device=dev)
                           * 0.02).to(torch_dtype(dtype))
    else:   # precomputed frame embeddings -> learned input projection
        params["embed"] = init_linear(gen, d, d, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, cfg.vocab_size, dtype, dev)
    params["layers"] = [_init_layer(cfg, spec, gen, dtype, dev)
                        for spec in cfg.layer_specs()]
    return params


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def _table_block(leaf):
    """The plain (V, D) or (D, V) table of an FSDP leaf whose D the data
    axis cuts, else None (the leaf is gathered whole instead)."""
    if isinstance(leaf, FsdpLeaf) and not leaf.quantized:
        return leaf.fields["w"]
    return None


def embed_inputs(cfg, params, inputs):
    """Token ids (B, S) -> their embedding rows; frames (B, S, D) ->
    the learned input projection. On a mesh whose model axis splits the
    vocabulary, each rank looks up the ids in its block of rows (zeros
    for the others) and the model group sums them: exactly one rank
    adds each row. A table whose d_model the data axis cuts (FSDP) is
    not gathered: the data ranks' ids are (every data rank runs the
    same-shaped pass), each rank looks them all up in its columns, and
    the columns are gathered back to their rows' rank."""
    if cfg.embed_input != "tokens":
        return linear(inputs, gather_tree(params["embed"]))
    block = _table_block(params["embed"])
    ids = inputs.long()
    if block is not None:
        ids = gather_fsdp(ids, dim=0)                    # every data rank's
    emb = gather_tree(params["embed"]) if block is None else block
    if emb.shape[0] == cfg.vocab_size:
        rows = emb[ids]
    else:
        m, _ = model_coords()
        ids = ids - m * emb.shape[0]
        rows = emb[ids.clamp(0, emb.shape[0] - 1)]
        mine = (ids >= 0) & (ids < emb.shape[0])
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    if block is not None:
        d, _ = data_coords()
        B = inputs.shape[0]
        rows = gather_fsdp(rows, dim=-1)[d * B:(d + 1) * B]
    return rows if emb.shape[0] == cfg.vocab_size else reduce_model(rows)


def unembed(cfg, params, x):
    """Logits in the activation dtype (a vocabulary split over the model
    axis gathered from its ranks). A head whose d_model the data axis
    cuts (FSDP) is not gathered: each rank multiplies every data rank's
    activations (gathered; the ranks run same-shaped passes) by its
    block of d_model, and the partial logits are summed over the data
    group, each rank keeping its rows'."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    if params[name].shape[0 if cfg.tie_embeddings else -1] \
            != cfg.vocab_size:
        x = copy_to_model(x)          # each model rank's vocabulary block
    block = _table_block(params[name])
    if block is None:
        w = gather_tree(params[name])
        xs = x
    else:
        d, _ = data_coords()
        xs = gather_fsdp(x, dim=0)
        n = block.shape[-1 if cfg.tie_embeddings else 0]
        xs, w = xs[..., d * n:(d + 1) * n], block
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", xs, w.to(x.dtype))
    else:
        logits = linear(xs, w)
    if block is not None:
        B = x.shape[0]
        logits = reduce_fsdp(logits)[d * B:(d + 1) * B]
    if logits.shape[-1] != cfg.vocab_size:
        logits = gather_model(logits, dim=-1)
    return softcap(logits, cfg.final_softcap)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _attn_prefill(cfg, spec, p, h, positions, max_len):
    """(y, the layer's dense cache row block: this rank's positions of
    the max_len (or window) K/V, attention.py:seq_block)."""
    y, k, v = attn._attend_sequence(cfg, spec, p, h, positions)
    S = h.shape[1]
    ck = k.transpose(1, 2)          # (B, Hkv, S, hd)
    cv = v.transpose(1, 2)
    if spec.window is None:
        pad = max_len - S
        ck = torch.nn.functional.pad(ck, (0, 0, 0, pad))
        cv = torch.nn.functional.pad(cv, (0, 0, 0, pad))
    else:
        w = min(spec.window, max_len)
        lo = max(0, S - w)
        slots = torch.arange(lo, S, device=h.device) % w
        buf_k = torch.zeros((ck.shape[0], ck.shape[1], w, ck.shape[3]),
                            dtype=ck.dtype, device=h.device)
        buf_v = torch.zeros_like(buf_k)
        buf_k[:, :, slots] = ck[:, :, lo:]
        buf_v[:, :, slots] = cv[:, :, lo:]
        ck, cv = buf_k, buf_v
    start, n, _ = attn.seq_block(cfg, spec, max_len)
    return y, {"k": ck[:, :, start:start + n].contiguous(),
               "v": cv[:, :, start:start + n].contiguous()}


def _mla_prefill(cfg, spec, p, h, positions, max_len):
    y, c_kv, k_pe = mla_mod.mla_prefill(cfg, spec, p, h, positions)
    pad = max_len - h.shape[1]
    start, n, _ = attn.seq_block(cfg, spec, max_len)
    return y, {name: torch.nn.functional.pad(t, (0, 0, 0, pad))[
        :, start:start + n].contiguous()
        for name, t in (("c_kv", c_kv), ("k_pe", k_pe))}


def _mlp(cfg, spec, lp, x, moe_capacity_factor):
    """(x + the layer's MLP, the MoE router's aux loss or None): dense
    SwiGLU or MoE at the given capacity factor, post-normed when the
    config has sandwich norms."""
    if spec.mlp == "none":
        return x, None
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    aux = None
    if spec.mlp == "moe":
        # routing is replicated compute on h; moe_forward copies only its
        # expert path's inputs to the model group
        y, aux = moe_forward(cfg, lp["moe"], h,
                             capacity_factor=moe_capacity_factor)
    else:
        y = swiglu(lp["mlp"], copy_to_model(h))
    y = reduce_model(y)               # after wd / the MoE combine
    if cfg.post_block_norms:
        y = rmsnorm(y, lp["post_ln2"], cfg.norm_eps)
    return x + y, aux


def _apply_layer(cfg, spec, lp, x, mixer, moe_capacity_factor):
    """One layer: norm, the mixer (attention, MLA or Mamba; `mixer(spec,
    lp, h)` -> (y, cache)), post-norm, residual, then the MLP. Returns
    (x, the mixer's cache, the MoE aux loss or None)."""
    h = copy_to_model(rmsnorm(x, lp["ln"], cfg.norm_eps))
    y, c = mixer(spec, lp, h)
    y = reduce_model(y)               # after wo
    if cfg.post_block_norms:
        y = rmsnorm(y, lp["post_ln"], cfg.norm_eps)
    x, aux = _mlp(cfg, spec, lp, x + y, moe_capacity_factor)
    return x, c, aux


# --------------------------------------------------------------------------
# training / scoring forward
# --------------------------------------------------------------------------

# matmul outputs the "dots" policy keeps for the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _remat(fn, policy: str):
    """fn wrapped in the activation checkpoint of `policy`: "none" keeps
    every activation, "full" only the inputs (recomputing the rest in
    the backward), "dots" the inputs and every matmul output."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                list(_DOTS))
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    raise ValueError(f"unknown remat policy {policy!r}; expected none, "
                     f"dots or full")


def forward(cfg, params, inputs, *, remat=None):
    """The training and scoring forward: tokens (B, S) or frames (B, S,
    D) -> (logits (B, S, V), the summed MoE aux loss (fp32 scalar)).
    Every layer in turn (attention causal or bidirectional as the config
    says, MLA or Mamba, sandwich norms), MoE layers at the train-time
    capacity factor, each layer under the activation checkpoint of
    `remat` (default cfg.remat) while autograd records. `params` in
    either layout (`layer_params`)."""
    check_config(cfg)
    x = embed_inputs(cfg, params, inputs)
    positions = torch.arange(x.shape[1], device=x.device)
    cf = cfg.moe.capacity_factor if cfg.moe else None
    policy = remat if remat is not None else cfg.remat

    def mixer(spec, lp, h):
        if spec.kind != "attn":
            return mam.mamba_forward(cfg, lp["mamba"], h), None
        if cfg.mla is not None:
            return mla_mod.mla_forward(cfg, spec, lp["attn"], h,
                                       positions), None
        return attn.attn_forward(cfg, spec, lp["attn"], h, positions), None

    def layer(spec, lp, x, aux):
        # gathered inside the checkpoint: the backward gathers again, so
        # no layer's gathered weights outlive its pass
        x, _, a = _apply_layer(cfg, spec, gather_tree(lp), x, mixer, cf)
        return x, aux if a is None else aux + a
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, lp in _layers(cfg, params, gather=False):
        x, aux = _remat(functools.partial(layer, spec, lp), policy)(x, aux)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x), aux


def loss_fn(cfg, params, batch, *, aux_coef=0.01, remat=None):
    """Next-token (or frame-label) cross-entropy plus `aux_coef` x the
    MoE aux loss. batch = {"inputs": (B, S) or (B, S, D), "labels": (B,
    S)} tensors. -> (loss, {"xent", "aux"})."""
    logits, aux = forward(cfg, params, batch["inputs"], remat=remat)
    loss = cross_entropy(logits, batch["labels"])
    return loss + aux_coef * aux, {"xent": loss, "aux": aux}


def _last_positions(x, last_pos):
    """x (B, S, D) -> (B, 1, D) at per-row index `last_pos` ((B,)), or
    the final position when last_pos is None."""
    if last_pos is None:
        return x[:, -1:]
    b = torch.arange(x.shape[0], device=x.device)
    return x[b, last_pos.long()][:, None]


def prefill(cfg, params, tokens, max_len, *, last_pos=None):
    """Run the prompt, return (last-position logits (B, V), dense cache:
    every attention layer's K/V or MLA latents padded to max_len, every
    Mamba layer's state after the prompt). `last_pos` ((B,)) picks the
    logits row of bucket-padded prompts. `tokens` are frames (B, S, D)
    for a frame-input config; an encoder attends bidirectionally, as in
    `forward`, and its cache holds the K/V of every position."""
    check_config(cfg)
    x = embed_inputs(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    def mixer(spec, lp, h):
        if spec.kind != "attn":
            return mam.mamba_forward(cfg, lp["mamba"], h, return_state=True)
        if cfg.mla is not None:
            return _mla_prefill(cfg, spec, lp["attn"], h, positions, max_len)
        return _attn_prefill(cfg, spec, lp["attn"], h, positions, max_len)
    cache = []
    cf = cfg.moe.inference_capacity_factor if cfg.moe else None
    for spec, lp in _layers(cfg, params):
        x, c, _ = _apply_layer(cfg, spec, lp, x, mixer, cf)
        cache.append(c)
    x = rmsnorm(_last_positions(x, last_pos), params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0], cache


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=None, device=None):
    """Dense caches: per attention layer {"k","v"} (batch, Hkv, max_len
    or window, hd), per MLA layer {"c_kv","k_pe"} (batch, max_len, .),
    per Mamba layer its state rows {"ssm","conv"} (batch, ...). Any
    config, an encoder's included (the cache its prefill returns)."""
    check_config(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    out = []
    for spec in cfg.layer_specs():
        if spec.kind != "attn":
            out.append(mam.init_mamba_cache(cfg, batch, dtype, dev))
        elif cfg.mla is not None:
            out.append(mla_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                              dev, spec))
        else:
            out.append(attn.init_kv_cache(cfg, spec, batch, max_len, dtype,
                                          dev))
    return out


def init_paged_cache(cfg, n_pages, page_size, max_seqs, dtype=None,
                     kv_bits=0, kv_group_size=0, device=None):
    """Paged cache: per attention layer a pool shared by all sequences,
    {"k_pages","v_pages"} (n_pages, page_size, Hkv, hd), or with
    `kv_bits > 0` the binary-coded {"k_codes","k_alphas","k_betas",
    "v_..."} (attention.init_paged_kv); per MLA layer a latent pool
    {"ckv_pages","kpe_pages"} (n_pages, page_size, 1, .); per Mamba
    layer `max_seqs` state rows indexed by slot (recurrent state does not
    page). MLA latents are already compressed and take no kv_bits."""
    require_decoder(cfg)
    if cfg.mla is not None and kv_bits:
        raise NotImplementedError(
            "binary-coded pages code per-head K/V vectors; the MLA latent "
            "cache is already compressed and serves with kv_bits=0")
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    out = []
    for spec in cfg.layer_specs():
        if spec.kind != "attn":
            out.append(mam.init_mamba_cache(cfg, max_seqs, dtype, dev))
        elif cfg.mla is not None:
            out.append(mla_mod.init_mla_paged(cfg, n_pages, page_size, dtype,
                                              dev))
        else:
            out.append(attn.init_paged_kv(cfg, n_pages, page_size, dtype,
                                          dev, kv_bits=kv_bits,
                                          kv_group_size=kv_group_size))
    return out


def is_page_leaf(leaf, n_pages) -> bool:
    """A page-pool leaf: page axis at dim 0 of the per-layer pool. fp
    pages and MLA latent pages (ndim 4) and the binary-coded
    code/alpha/beta leaves (ndim 4-5) match; a Mamba layer's state rows
    (ndim 3, whatever max_seqs is) never do."""
    return leaf.dim() >= 4 and leaf.shape[0] == n_pages


def copy_pages(cache, src, dst, n_pages):
    """Copy-on-write forks: page src[i] -> dst[i] in every layer's pool,
    in place (K/V pages, latent pages; state rows are left alone). On a
    binary-coded pool the codes AND the alpha/beta leaves all copy (a
    fork that missed the scales would decode the old page's magnitudes
    under the new page's signs). src/dst: (n,) page ids; every source is
    read before any destination is written."""
    dev = next(iter(cache[0].values())).device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for layer in cache:
        for leaf in layer.values():
            if is_page_leaf(leaf, n_pages):
                leaf[dst] = leaf[src]
    return cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_layers(cfg, params, cache, x, attn_step):
    """Shared decode / extend pass: every layer with the attention
    flavour injected (dense cache, page pool, extend chunk); Mamba
    layers step their state rows. Returns (logits (B, S, V), cache)."""
    def mixer(spec, lp, h, lc):
        if spec.kind != "attn":
            return mam.mamba_decode(cfg, lp["mamba"], h, lc)
        return attn_step(spec, lp["attn"], h, lc)
    for (spec, lp), lc in zip(_layers(cfg, params), cache):
        x, _, _ = _apply_layer(cfg, spec, lp, x,
                               lambda s, p, h, lc=lc: mixer(s, p, h, lc),
                               DECODE_CAPACITY_FACTOR)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def decode_step(cfg, params, cache, tokens, pos):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions.
    Returns (logits (B, V), cache) with the cache written in place."""
    require_decoder(cfg)
    x = embed_inputs(cfg, params, tokens)
    if cfg.mla is not None:
        step = lambda spec, p, h, c: mla_mod.mla_decode(cfg, spec, p, h, c,
                                                        pos)
    else:
        step = lambda spec, p, h, c: attn.attn_decode(cfg, spec, p, h, c,
                                                      pos)
    logits, cache = _decode_layers(cfg, params, cache, x, step)
    return logits[:, 0], cache


def decode_step_paged(cfg, params, cache, tokens, pos, block_tables):
    """One decode step against a paged cache (init_paged_cache layout).
    block_tables: (B, T) int32 page ids, row b = sequence in slot b."""
    require_decoder(cfg)
    x = embed_inputs(cfg, params, tokens)
    if cfg.mla is not None:
        step = lambda spec, p, h, c: mla_mod.mla_decode_paged(
            cfg, spec, p, h, c, block_tables, pos)
    else:
        step = lambda spec, p, h, c: attn.attn_decode_paged(
            cfg, spec, p, h, c, block_tables, pos)
    logits, cache = _decode_layers(cfg, params, cache, x, step)
    return logits[:, 0], cache


def scatter_prefill_cache(cfg, paged_cache, row_cache, slot, page_ids,
                          n_valid):
    """Write one sequence's dense prefill cache (prefill() on a single
    padded row: {"k","v"} (1, Hkv, S_pad, hd) or {"c_kv","k_pe"} (1,
    S_pad, .) per attention layer) into its pages: token t lands in page
    page_ids[t // page] at offset t % page, for the n_valid real tokens
    only (padding never reaches a page). On a binary-coded pool each
    token's K/V is quantized here (quantize on write), so pages never
    hold raw values. Mamba state rows land at `slot`. Writes in place;
    returns the cache."""
    ids = torch.as_tensor(page_ids, dtype=torch.long)
    n = int(n_valid)
    for spec, pooled, row in zip(cfg.layer_specs(), paged_cache, row_cache):
        if spec.kind != "attn":
            for name, leaf in pooled.items():
                leaf[slot] = row[name][0].to(leaf.dtype)
            continue
        mla = "ckv_pages" in pooled
        quant = not mla and attn.paged_kv_bits(pooled) > 0
        lead = pooled["ckv_pages" if mla else
                      "k_codes" if quant else "k_pages"]
        page = lead.shape[1]
        t = torch.arange(n)
        pid = ids[t // page].to(lead.device)
        off = (t % page).to(lead.device)
        if mla:
            for name, side in (("ckv_pages", "c_kv"), ("kpe_pages", "k_pe")):
                pool = pooled[name]
                pool[pid, off, 0] = row[side][0, :n].to(pool.dtype)
            continue
        rows = [row[side][0, :, :n].transpose(0, 1) for side in ("k", "v")]
        if quant:
            attn._quant_scatter(pooled, torch.stack(rows), pid, off)
            continue
        for side, r in zip(("k", "v"), rows):
            pool = pooled[f"{side}_pages"]
            pool[pid, off] = r.to(pool.dtype)
    return paged_cache


def _extend_scan(cfg, params, cache, tokens, start_pos, block_tables,
                 n_valid):
    """Shared multi-token paged pass: C tokens (tokens (B, C), padded;
    n_valid (B,) counts the real ones) at absolute positions start_pos +
    [0..C) write their K/V (or MLA latents) into the sequences' pages
    and attend over pages + chunk causally. Every layer runs as in
    decode (MoE at the decode capacity factor, so the expert GEMM sees
    B*C rows). Attention and MLA patterns only: recurrent Mamba state
    would need the chunk threaded token by token. Returns the logits at
    every chunk position ((B, C, V), cache)."""
    require_decoder(cfg)
    if any(spec.kind != "attn" for spec in cfg.pattern):
        raise NotImplementedError(
            "multi-token paged passes require an attention-only pattern")
    C = tokens.shape[1]
    chunk_mask = (torch.arange(C, device=tokens.device)[None, :]
                  < n_valid.to(tokens.device)[:, None])
    x = embed_inputs(cfg, params, tokens)
    if cfg.mla is not None:
        step = lambda spec, p, h, c: mla_mod.mla_extend_paged(
            cfg, spec, p, h, c, block_tables, start_pos, chunk_mask)
    else:
        step = lambda spec, p, h, c: attn.attn_extend_paged(
            cfg, spec, p, h, c, block_tables, start_pos, chunk_mask)
    return _decode_layers(cfg, params, cache, x, step)


def extend_paged(cfg, params, cache, tokens, start_pos, block_tables,
                 n_valid):
    """Chunked prefill: _extend_scan reduced to the logits of each row's
    last valid chunk position ((B, V), cache), all a prefill needs to
    seed its first decode token."""
    logits, cache = _extend_scan(cfg, params, cache, tokens, start_pos,
                                 block_tables, n_valid)
    idx = torch.clamp(n_valid.long().to(logits.device) - 1, min=0)
    return logits[torch.arange(logits.shape[0], device=logits.device),
                  idx], cache


def draft_propose_paged(cfg, params, cache, cur, base_pos, block_tables,
                        k_eff, null_row, k):
    """k greedy draft decode steps: the argmax of step j feeds step j+1
    as a device tensor, with no host round trip between steps. cur (B,)
    int32 last tokens, base_pos (B,) their positions, k_eff (B,) int32
    per-row depths: step j routes rows with k_eff <= j to `null_row`'s
    page (B,) and position 0, as any inactive decode row (their K/V
    lands in the null page; their tokens are computed and ignored).
    Returns (draft tokens (B, k) int32, cache written in place).

    `params` is the draft tree (quant/draft.py: leading code planes of
    the target with re-fit scales). Each step runs from the codes: a
    QuantizedTensor with fewer alphas than stored planes goes through
    the same fused GEMV, which reads only its active planes. The
    reference dequantizes every draft leaf once before its steps (its
    expansion dwarfs the matmul on the TPU); at llama2-7b that is ~26 GB
    of fp32 weights written and re-read a tick, so the port does not."""
    toks = []
    for j in range(k):
        live_j = k_eff > j
        bt = torch.where(live_j[:, None], block_tables, null_row[:, None])
        pos_j = torch.where(live_j, base_pos + j, torch.zeros_like(base_pos))
        logits, cache = decode_step_paged(cfg, params, cache, cur[:, None],
                                          pos_j, bt.contiguous())
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(cur)
    return torch.stack(toks, dim=1), cache


def verify_paged(cfg, params, cache, tokens, start_pos, block_tables,
                 n_valid):
    """Speculative verify: score C = k+1 positions in one pass and keep
    the logits at every position ((B, C, V), cache). Position j's row
    decides draft token j+1 (greedy acceptance: accept while the draft
    token is the argmax of the previous row). The pass writes the
    TARGET's K/V at all n_valid positions before attending, overwriting
    what the draft wrote there, which makes greedy speculative decode
    token-identical to target-only decode whatever the draft (the
    engine holds the accept and rollback logic)."""
    return _extend_scan(cfg, params, cache, tokens, start_pos,
                        block_tables, n_valid)
