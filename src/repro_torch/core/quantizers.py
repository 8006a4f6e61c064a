"""Built-in Quantizer implementations (paper Tab. I/V grid), registered
with the quant/registry.py registry (the reference's
`core/quantizers.py`):

  rtn          round-to-nearest linear grid
  bcq          plain BCQ (no error compensation); packable
  gptq         GPTQ with linear grid
  gptq_minmse  GPTQ with per-row MSE-optimal clipped grid   (Tab. V)
  gptq_bcq     GPTQ with BCQ-fit binary-coding grid         (Tab. V)
  gptqt        the paper's method (two-step + re-explore + fuse); packable

Each wraps a solver of core/; importing this module populates the
registry (quant/registry.py imports it on first lookup). All methods
honour `plan.group_size`: scales (and for the binary-coding methods the
whole alpha/beta coding) are fit per contiguous K-group.
"""
from __future__ import annotations

import torch

from repro_torch.core import binary_coding as bc
from repro_torch.core import rtn as rtn_mod
from repro_torch.core.gptq import gptq_solve
from repro_torch.core.gptqt import gptqt_quantize
from repro_torch.core.rtn import group_rows
from repro_torch.quant.packing import pack_signs
from repro_torch.quant.qlinear import QuantizedTensor
from repro_torch.quant.registry import (QuantResult, Quantizer,
                                        register_quantizer)


@register_quantizer("rtn")
class RTNQuantizer(Quantizer):
    def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16"):
        wq, _ = rtn_mod.quantize_rtn(Wt, plan.bits,
                                     group_size=plan.group_size)
        return QuantResult(wq_t=wq)


class RTNPackedQuantizer(RTNQuantizer):
    """RTN emitted as its exact binary coding (rtn.rtn_binary_coding),
    so an RTN baseline serves through the same kernels as GPTQT. Not in
    the registry, whose names and packability are the reference's (it
    has no packed RTN); install it under a name of your own with
    `register_quantizer("rtn_packed")(RTNPackedQuantizer)`."""
    supports_packed = True

    def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16"):
        wq, qt = rtn_mod.rtn_binary_coding(Wt, plan.bits, plan.group_size,
                                           orig_dtype)
        return QuantResult(wq_t=wq, qt=qt if plan.mode == "packed" else None)


@register_quantizer("bcq")
class BCQQuantizer(Quantizer):
    supports_packed = True

    def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16"):
        N, K = Wt.shape
        wq, alphas, signs = bc.bcq_alternating(Wt, plan.bits,
                                               group_size=plan.group_size)
        qt = None
        if plan.mode == "packed":
            if alphas.dim() == 2:                        # (N, k) -> (1, N, k)
                alphas = alphas[None]
            else:                                        # (N, G, k) -> (G, N, k)
                alphas = alphas.transpose(0, 1).contiguous()
            G = alphas.shape[0]
            codes = pack_signs(signs.transpose(1, 2))    # (k, K/32, N)
            qt = QuantizedTensor(codes, alphas,
                                 torch.zeros((G, N), dtype=torch.float32,
                                             device=Wt.device),
                                 k_in=K, orig_dtype=orig_dtype)
        return QuantResult(wq_t=wq, qt=qt)


class _GPTQBase(Quantizer):
    """GPTQ solver against a per-row (or per-row-group) level grid;
    subclasses pick the grid."""

    def levels(self, Wt, bits, group_size):
        raise NotImplementedError

    def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16"):
        wq, _ = gptq_solve(Wt, H, self.levels(Wt, plan.bits,
                                              plan.group_size))
        return QuantResult(wq_t=wq)


@register_quantizer("gptq")
class GPTQQuantizer(_GPTQBase):
    def levels(self, Wt, bits, group_size):
        Wr, G = group_rows(Wt, group_size)
        S, center = rtn_mod.row_grid(Wr, bits)
        lv = rtn_mod.linear_levels(S, center, bits)      # (N*G, L)
        return lv.reshape(Wt.shape[0], G, -1) if G > 1 else lv


@register_quantizer("gptq_minmse")
class GPTQMinMSEQuantizer(_GPTQBase):
    def levels(self, Wt, bits, group_size):
        Wr, G = group_rows(Wt, group_size)
        S, center = rtn_mod.minmse_grid(Wr, bits)
        lv = rtn_mod.linear_levels(S, center, bits)
        return lv.reshape(Wt.shape[0], G, -1) if G > 1 else lv


@register_quantizer("gptq_bcq")
class GPTQBCQQuantizer(_GPTQBase):
    def levels(self, Wt, bits, group_size):
        return bc.bcq_levels(Wt, bits, group_size=group_size)


@register_quantizer("gptqt")
class GPTQTQuantizer(Quantizer):
    supports_packed = True

    def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16"):
        res = gptqt_quantize(
            Wt, H, bits=plan.bits,
            intermediate_bits=plan.intermediate_bits,
            reexplore_range=plan.reexplore_range,
            reexplore_points=plan.reexplore_points,
            exact=plan.exact_search, group_size=plan.group_size,
            orig_dtype=orig_dtype)
        qt = res.qt if plan.mode == "packed" else None
        return QuantResult(wq_t=res.wq_t, qt=qt)
