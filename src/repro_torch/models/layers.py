"""Shared building blocks (the reference's `models/layers.py`): plain
functions over tensors and per-layer weight dicts."""
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


def linear(x, w):
    """Apply a (possibly quantized) weight: x (..., K) @ w (K, N)."""
    if hasattr(w, "quantized_matmul"):           # QuantizedTensor
        return w.quantized_matmul(x)
    return x @ w.to(x.dtype)


def swiglu(p, x):
    """Gated MLP: p = {wg:(D,F), wu:(D,F), wd:(F,D)}."""
    h = torch.nn.functional.silu(linear(x, p["wg"])) * linear(x, p["wu"])
    return linear(h, p["wd"])


def init_linear(gen, d_in, d_out, dtype, device, scale=None):
    """N(0, scale^2) weight (default scale d_in^-0.5) from `gen`."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    return w.to(torch_dtype(dtype))


def init_swiglu(gen, d, f, dtype, device):
    return {"wg": init_linear(gen, d, f, dtype, device),
            "wu": init_linear(gen, d, f, dtype, device),
            "wd": init_linear(gen, f, d, dtype, device)}
