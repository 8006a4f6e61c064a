from repro_torch.quant.packing import (codes_from_numpy, codes_to_numpy,
                                       pack_signs, pack_signs_last, padded_k,
                                       unpack_signs, unpack_signs_last)
from repro_torch.quant.qlinear import QuantizedTensor

__all__ = ["pack_signs", "unpack_signs", "pack_signs_last",
           "unpack_signs_last", "padded_k", "codes_from_numpy",
           "codes_to_numpy", "QuantizedTensor"]
