"""Shared building blocks (the reference's `models/layers.py`): plain
functions over tensors and per-layer weight dicts, the training loss,
and the activation tap that calibration reads."""
from __future__ import annotations

import torch

from repro_torch.hw import torch_dtype


def rmsnorm(x, w, eps: float = 1e-6):
    """RMS norm with a zero-centred scale: x * rsqrt(mean x^2) * (1 + w)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x, positions, theta: float):
    """Rotary embedding over split halves with fp32 angles. x: (..., S,
    H, D) or (..., S, D); positions broadcastable to the S axis ((S,) or
    (B, S))."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError("rope dim must be even")
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions.float()[..., None] * freqs   # (S, d/2) / (B, S, d/2)
    if x.dim() == 4:                                # (B, S, H, D)
        angles = angles[..., None, :]
        if angles.dim() == 3:                       # positions were (S,)
            angles = angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# Activation tap: while one is open (calibration), every linear() of a
# plain weight records its input keyed by the weight's object id, and
# the MoE layer its per-expert inputs (models/moe.py).
_TAP = None


class tap_activations:
    """with tap_activations() as rec: ... ; rec[id(w)] -> list of inputs."""

    def __enter__(self):
        global _TAP
        self._outer = _TAP
        self.rec = {}
        _TAP = self.rec
        return self.rec

    def __exit__(self, *exc):
        global _TAP
        _TAP = self._outer
        return False


def record(w, x) -> None:
    """Record x as an input of weight w when a tap is open."""
    if _TAP is not None:
        _TAP.setdefault(id(w), []).append(x)


def linear(x, w):
    """Apply a (possibly quantized) weight: x (..., K) @ w (K, N)."""
    if _TAP is not None and isinstance(w, torch.Tensor):
        _TAP.setdefault(id(w), []).append(x.reshape(-1, x.shape[-1]))
    if hasattr(w, "quantized_matmul"):           # QuantizedTensor
        return w.quantized_matmul(x)
    return x @ w.to(x.dtype)


def swiglu(p, x):
    """Gated MLP: p = {wg:(D,F), wu:(D,F), wd:(F,D)}."""
    h = torch.nn.functional.silu(linear(x, p["wg"])) * linear(x, p["wu"])
    return linear(h, p["wd"])


def init_normal(gen, shape, scale, dtype, device):
    """N(0, scale^2) drawn in fp32 from `gen`, then rounded to `dtype`.
    On the meta device no number is drawn: an empty tensor of the shape
    and dtype (each op on meta costs host time, and the dry run builds
    models of hundreds of billions of weights)."""
    dt = torch_dtype(dtype)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dt, device=device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dt)


def init_linear(gen, d_in, d_out, dtype, device, scale=None):
    """N(0, scale^2) weight (default scale d_in^-0.5) from `gen`."""
    scale = scale if scale is not None else d_in ** -0.5
    return init_normal(gen, (d_in, d_out), scale, dtype, device)


def init_swiglu(gen, d, f, dtype, device):
    return {"wg": init_linear(gen, d, f, dtype, device),
            "wu": init_linear(gen, d, f, dtype, device),
            "wd": init_linear(gen, f, d, dtype, device)}


def cross_entropy(logits, labels, *, final_cap=None, mask=None, z_loss=0.0):
    """Mean token cross-entropy, accumulated in fp32; labels < 0 (and
    positions where `mask` is False) are ignored. The max subtracted for
    stability carries no gradient, as in the reference; the gold logit
    is gathered (the reference's masked vocab reduction picks the same
    value)."""
    logits = softcap(logits, final_cap)
    lmax = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = (logits - lmax).float()
    sumexp = torch.sum(torch.exp(shifted), dim=-1)
    gold = torch.gather(shifted, -1,
                        torch.clamp(labels.long(), min=0)[..., None])[..., 0]
    nll = torch.log(sumexp) - gold
    if z_loss:
        lse = torch.log(sumexp) + lmax[..., 0].float()
        nll = nll + z_loss * lse ** 2
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask
    valid = valid.float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)
