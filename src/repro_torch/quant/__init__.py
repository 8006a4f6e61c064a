from repro_torch.quant.draft import (draft_extra_bytes, draft_view,
                                     make_draft_params, refit_draft_scales)
from repro_torch.quant.packing import (codes_from_numpy, codes_to_numpy,
                                       pack_signs, pack_signs_last, padded_k,
                                       unpack_signs, unpack_signs_last)
from repro_torch.quant.qlinear import (QuantizedTensor, dequantize_params,
                                       stack_leaves)
from repro_torch.quant.registry import (QuantResult, Quantizer,
                                        available_quantizers, get_quantizer,
                                        register_quantizer)
from repro_torch.quant.search import (LeafScore, format_overrides,
                                      format_report, sensitivity_sweep,
                                      suggest_overrides)
from repro_torch.quant.spec import (QUANTIZABLE, LeafPlan, OverrideRule,
                                    QuantSpec, is_quantizable)

__all__ = ["pack_signs", "unpack_signs", "pack_signs_last",
           "unpack_signs_last", "padded_k", "codes_from_numpy",
           "codes_to_numpy", "QuantizedTensor", "stack_leaves",
           "dequantize_params",
           "QuantSpec", "OverrideRule", "LeafPlan", "QUANTIZABLE",
           "is_quantizable", "Quantizer", "QuantResult", "register_quantizer",
           "get_quantizer", "available_quantizers", "LeafScore",
           "sensitivity_sweep", "suggest_overrides", "format_overrides",
           "format_report", "refit_draft_scales", "draft_view",
           "make_draft_params", "draft_extra_bytes"]
