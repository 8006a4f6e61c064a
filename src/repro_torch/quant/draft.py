"""Draft views: a low-bit model sliced out of a higher-bit one (the
reference's `quant/draft.py`).

GPTQT's greedy residual coding makes each sign plane a refinement of the
previous ones, so the leading `d` planes of a w3/w4 QuantizedTensor are
themselves a valid w`d` coding of the same weight: a draft model for
self-speculative decoding that shares the packed sign words with the
target. The only new tensors a draft needs are its scales. The target's
leading alphas were fit jointly with the trailing planes present, so
`refit_draft_scales` re-solves the per-(group, column) least squares

    min_{a', b'} || S' a' + b' 1 - W ||^2    over each group's gs rows,

where S' is the (gs, d) matrix of leading sign planes and W the
full-bit dequant, with a `_LS_EPS` ridge on the (d+1)x(d+1) normal
equations. A draft leaf costs (G, N, d) alphas and (G, N) betas; its
codes and every unquantized leaf are the target's own tensors
(`draft_extra_bytes` counts by storage to audit that).

The draft is served from its codes: `bcq_apply` sends a QuantizedTensor
with fewer alphas than stored planes through the same fused kernels,
which read only the leading planes (models/model.py:
draft_propose_paged). The reference instead dequantizes every draft
leaf once before its k draft steps; at llama2-7b that would write and
re-read ~26 GB of fp32 weights a tick on the card.

Offline, `ckpt.packed.save_packed(draft_bits=...)` stores the re-fit
scales as the manifest-v4 optional block; `make_draft_params` takes
that block (`ckpt.packed.load_draft_scales`) when present and refits
otherwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.quant.packing import unpack_signs
from repro_torch.quant.qlinear import QuantizedTensor, tree_tensors

# Tikhonov floor for the (d+1)x(d+1) normal equations: sign columns can
# be linearly dependent on tiny groups (gs < d+1), where the system is
# singular without it.
_LS_EPS = 1e-6


def refit_draft_scales(qt: QuantizedTensor, draft_bits: int):
    """LS re-fit (alphas, betas) for the leading `draft_bits` planes of
    `qt` against its full-bit dequant. Returns (alphas (..., G, N, d),
    betas (..., G, N)), fp32, on qt's device. A stack (leading dims,
    e.g. experts or a pattern slot's layers) is refit matrix by matrix,
    so each matrix's scales are bit for bit those of a refit of it
    alone (and the temporaries stay one matrix's size)."""
    d = int(draft_bits)
    if not 1 <= d <= qt.bits:
        raise ValueError(
            f"draft_bits={d} must be in [1, {qt.bits}] (active planes)")
    lead = tuple(qt.codes.shape[:-3])
    if not lead:
        return _refit_matrix(qt, d)
    flat = [QuantizedTensor(*(t.reshape(-1, *t.shape[len(lead):])[i]
                              for t in (qt.codes, qt.alphas, qt.betas)),
                            qt.k_in, qt.orig_dtype)
            for i in range(math.prod(lead))]
    alphas, betas = zip(*(_refit_matrix(m, d) for m in flat))
    return (torch.stack(alphas).reshape(*lead, *alphas[0].shape),
            torch.stack(betas).reshape(*lead, *betas[0].shape))


def _refit_matrix(qt: QuantizedTensor, d: int):
    """refit_draft_scales of one (K, N) matrix."""
    N = qt.n_out
    G = qt.n_groups
    gs = qt.k_in // G if G > 1 else qt.k_in
    w = qt.dequant(torch.float32)                        # (K, N)
    signs = unpack_signs(qt.codes[:d], qt.k_in)          # (d, K, N)
    S = signs.reshape(d, G, gs, N)
    Wg = w.reshape(G, gs, N)
    SS = torch.einsum("igkn,jgkn->gnij", S, S)           # (G, N, d, d)
    S1 = S.sum(dim=-2).movedim(0, -1)                    # (G, N, d)
    Sw = torch.einsum("igkn,gkn->gni", S, Wg)            # (G, N, d)
    w1 = Wg.sum(dim=-2)                                  # (G, N)
    # augmented system [[S'S', S'1], [1'S', gs]] [a'; b'] = [S'W; 1'W]
    top = torch.cat([SS, S1[..., :, None]], dim=-1)
    bot = torch.cat([S1, torch.full((G, N, 1), float(gs),
                                    dtype=torch.float32,
                                    device=S1.device)], dim=-1)[..., None, :]
    A = torch.cat([top, bot], dim=-2)
    A = A + _LS_EPS * torch.eye(d + 1, dtype=torch.float32, device=A.device)
    rhs = torch.cat([Sw, w1[..., None]], dim=-1)
    c = torch.linalg.solve(A, rhs[..., None])[..., 0]    # (G, N, d+1)
    return c[..., :d].contiguous(), c[..., d].contiguous()


def draft_view(qt: QuantizedTensor, draft_bits: int, scales=None):
    """A QuantizedTensor serving the leading `draft_bits` planes of
    `qt`. Its codes are the SAME tensor as the target's: no byte beyond
    the draft scales. `scales=(alphas, betas)` installs precomputed
    (manifest-v4) scales; None refits. `draft_bits == qt.bits` with no
    scales returns `qt` itself."""
    d = int(draft_bits)
    if d == qt.bits and scales is None:
        return qt
    if d > qt.bits:
        raise ValueError(
            f"draft_bits={d} exceeds the target's {qt.bits} active planes")
    if scales is None:
        alphas, betas = refit_draft_scales(qt, d)
    else:
        alphas, betas = scales
    # the target's scale dtype, so one kernel expand path serves both
    # (bf16-scaled artifacts keep bf16 drafts)
    alphas = alphas.to(device=qt.device, dtype=qt.alphas.dtype).contiguous()
    betas = betas.to(device=qt.device, dtype=qt.betas.dtype).contiguous()
    return QuantizedTensor(codes=qt.codes, alphas=alphas, betas=betas,
                           k_in=qt.k_in, orig_dtype=qt.orig_dtype)


def make_draft_params(params, draft_bits: int, scales_tree=None):
    """`draft_view` over a param tree (the port's {"layers": [...]}
    layout: dicts and lists). Unquantized leaves are the same objects.
    `scales_tree`, when given, mirrors the tree with {"bits", "alphas",
    "betas"} dicts at QuantizedTensor positions
    (ckpt.packed.load_draft_scales); an entry whose bits disagree with
    `draft_bits` falls back to the refit. An FSDP block (dist/fsdp.py)
    keeps its code block and takes its entry's scales, cut as its
    own."""
    def walk(node, sc):
        fsdp = getattr(node, "quantized", False)   # dist/fsdp.py FsdpLeaf
        if isinstance(node, QuantizedTensor) or fsdp:
            use = None
            if isinstance(sc, dict) and "alphas" in sc:
                if int(sc.get("bits", -1)) == int(draft_bits):
                    use = (sc["alphas"], sc["betas"])
            if fsdp:
                return node.draft_view(use)
            return draft_view(node, draft_bits, scales=use)
        if isinstance(node, dict):
            return {k: walk(v, sc.get(k) if isinstance(sc, dict) else None)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            sub = sc if isinstance(sc, (list, tuple)) else [None] * len(node)
            return type(node)(walk(v, s) for v, s in zip(node, sub))
        return node
    return walk(params, scales_tree)


def _storage_key(t: torch.Tensor):
    return (t.device, t.untyped_storage().data_ptr())


def draft_extra_bytes(target_params, draft_params) -> int:
    """Bytes the draft tree adds beyond the target: every storage a
    draft tensor lives in that no target tensor shares, counted once.
    For a proper draft view this is exactly the re-fit scales."""
    seen = {_storage_key(t) for t in tree_tensors(target_params)}
    extra = 0
    for t in tree_tensors(draft_params):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            extra += t.untyped_storage().nbytes()
    return extra
