from repro_torch.models.model import (decode_step, decode_step_paged,
                                      embed_inputs, init_cache,
                                      init_paged_cache, init_params,
                                      is_page_leaf, prefill,
                                      scatter_prefill_cache, unembed)

__all__ = ["init_params", "embed_inputs", "unembed", "prefill",
           "init_cache", "init_paged_cache", "is_page_leaf", "decode_step",
           "decode_step_paged", "scatter_prefill_cache"]
