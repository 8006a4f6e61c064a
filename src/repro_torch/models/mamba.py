"""Mamba-1 (S6) block: causal depthwise conv + selective SSM scan (the
reference's `models/mamba.py`).

The full-sequence path runs a chunked selective scan: the sequence is
cut into chunks of `cfg.mamba.chunk`; within a chunk the first-order
recurrence h_t = a_t h_{t-1} + b_t runs as a Hillis-Steele scan over the
(a, b) pairs (log2(chunk) passes), and the chunk's boundary state
carries into the next. Live memory is O(B * chunk * d_inner * d_state).
A = -exp(A_log) is negative, so every decay exp(dt*A) lies in (0, 1]
and products of decays only shrink: the scan combines decays by
multiplication, never through a cumulative sum of logs (up to 256 steps
of dt*A, each as low as -1.6, would give exp(+400) on the way back).
The reference combines each chunk with `jax.lax.associative_scan`,
another tree of the same combine, so the two agree to fp32 rounding.

Shapes: x (B, L, D); state {"ssm": (B, d_inner, d_state) fp32,
"conv": (B, d_conv - 1, d_inner)}, one row per batch slot (recurrent
state does not page), updated in place by decode.

On a model axis (dist/sharding.py) a rank holds d_inner / M channels of
everything: its columns of each half of in_proj, of dt_w and of the
per-channel leaves, its rows of x_proj and out_proj, and its channels
of the state; `cfg` is the rank's (models/model.py:shard_config), whose
d_inner is the rank's. x_proj's features (dt rank + 2 d_state) are
summed over the model group before they split (in training their
gradient too: copy_to_model), and the caller sums the
out_proj partials: two all-reduces a layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.context import copy_to_model, reduce_model
from repro_torch.hw import torch_dtype
from repro_torch.models.layers import init_linear, linear


def init_mamba(cfg, gen, dtype, device):
    """The reference's distributions from `gen`; dt_b, A_log and D stay
    fp32 whatever `dtype` is."""
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    dtr = mc.resolved_dt_rank(d)
    dt = torch_dtype(dtype)
    # bias so that softplus(dt_b) ~ [1e-3, 1e-1] (mamba's default)
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=device)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": init_linear(gen, d, 2 * di, dtype, device),
        "conv_w": (torch.randn((mc.d_conv, di), generator=gen,
                               dtype=torch.float32, device=device)
                   * mc.d_conv ** -0.5).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": init_linear(gen, di, dtr + 2 * mc.d_state, dtype, device),
        "dt_w": init_linear(gen, dtr, di, dtype, device),
        "dt_b": torch.log(torch.expm1(dt0)),
        "A_log": torch.log(torch.arange(
            1, mc.d_state + 1, dtype=torch.float32,
            device=device)).repeat(di, 1),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": init_linear(gen, di, d, dtype, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv by shift-add. x: (B, L, di); w: (K, di)."""
    K, L = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        sh = K - 1 - i
        xi = x if sh == 0 else F.pad(x, (0, 0, sh, 0))[:, :L]
        out = out + xi * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _ssm_features(cfg, p, xc):
    """xc (B, L, di) after conv + silu -> dt (B, L, di) fp32, Bm and Cm
    (B, L, ds) fp32."""
    mc = cfg.mamba
    dtr = mc.resolved_dt_rank(cfg.d_model)
    # a rank's x_proj rows give partial features: summed over the model
    # group before the split (the identity off a model axis); every rank
    # uses the whole features, so in training their gradient is summed
    # over the group too
    feats = copy_to_model(reduce_model(linear(xc, p["x_proj"])))
    dt_r, Bm, Cm = torch.split(feats, [dtr, mc.d_state, mc.d_state], dim=-1)
    dt = linear(dt_r, p["dt_w"])
    dt = F.softplus(dt.float() + p["dt_b"])
    return dt, Bm.float(), Cm.float()


def _scan_chunk(a, b):
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under the
    combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), earlier element
    first: returns (prod of a_0..a_t, the state at t from a zero start)."""
    n = a.shape[1]
    d = 1
    while d < n:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def selective_scan(x, dt, A, Bm, Cm, h0, chunk):
    """Chunked selective scan.
    x, dt: (B, L, di) fp32; A: (di, ds); Bm, Cm: (B, L, ds); h0: (B, di,
    ds). Returns y (B, L, di), hN (B, di, ds). The last chunk is the
    remainder of L (the reference pads it with zero steps, which leave
    the state unchanged)."""
    L = x.shape[1]
    h = h0
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        dtc = dt[:, sl]
        a = torch.exp(dtc[..., None] * A)               # (B, ck, di, ds)
        b = (dtc * x[:, sl])[..., None] * Bm[:, sl, None, :]
        aprod, bsum = _scan_chunk(a, b)
        hseq = aprod * h[:, None] + bsum
        ys.append(torch.einsum("bkds,bks->bkd", hseq, Cm[:, sl]))
        h = hseq[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_forward(cfg, p, x, *, state=None, return_state=False):
    """Full-sequence Mamba block core (no residual or norm). x: (B, L,
    D). With `return_state`, also the decode state after the last
    token: {"ssm": hN, "conv": the last d_conv - 1 inputs of the conv,
    zero rows before position 0 when L < d_conv - 1 (the conv's own
    padding; the reference returns a shorter tail there)}."""
    mc = cfg.mamba
    xz = linear(x, p["in_proj"])
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm = _ssm_features(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    h0 = (torch.zeros((x.shape[0], cfg.d_inner, mc.d_state),
                      dtype=torch.float32, device=x.device)
          if state is None else state)
    y, hN = selective_scan(xc.float(), dt, A, Bm, Cm, h0, mc.chunk)
    y = y + p["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, p["out_proj"])
    if not return_state:
        return out
    K1 = mc.d_conv - 1
    tail = F.pad(xi, (0, 0, K1, 0))[:, -K1:] if K1 else xi[:, :0]
    return out, {"ssm": hN, "conv": tail.contiguous()}


def init_mamba_cache(cfg, batch, dtype, device):
    mc = cfg.mamba
    return {"ssm": torch.zeros((batch, cfg.d_inner, mc.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, mc.d_conv - 1, cfg.d_inner),
                                dtype=torch_dtype(dtype), device=device)}


def mamba_decode(cfg, p, x, cache):
    """Single-token step. x: (B, 1, D); cache {"ssm", "conv"} with one
    row per batch row, updated in place. Returns (y, cache)."""
    xz = linear(x, p["in_proj"])
    xi, z = torch.chunk(xz, 2, dim=-1)                  # (B, 1, di)
    win = torch.cat([cache["conv"].to(xi.dtype), xi], dim=1)  # (B, K, di)
    xc = torch.einsum("bkd,kd->bd", win, p["conv_w"].to(x.dtype))
    xc = F.silu(xc + p["conv_b"].to(x.dtype))[:, None]  # (B, 1, di)
    dt, Bm, Cm = _ssm_features(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)                # (B, di, ds)
    b = (dt[:, 0] * xc[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = a * cache["ssm"] + b
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0])
    y = y + p["D"] * xc[:, 0].float()
    y = y.to(x.dtype)[:, None] * F.silu(z)
    out = linear(y, p["out_proj"])
    cache["ssm"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
