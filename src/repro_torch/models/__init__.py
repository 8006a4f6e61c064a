from repro_torch.models.model import (copy_pages, decode_step,
                                      decode_step_paged, draft_propose_paged,
                                      embed_inputs, extend_paged, forward,
                                      init_cache, init_paged_cache,
                                      init_params, is_page_leaf, loss_fn,
                                      prefill,
                                      require_decoder,
                                      scatter_prefill_cache, unembed,
                                      verify_paged)

__all__ = ["init_params", "embed_inputs", "unembed", "forward", "loss_fn",
           "prefill", "init_cache", "init_paged_cache",
           "is_page_leaf", "decode_step", "decode_step_paged",
           "extend_paged", "copy_pages", "scatter_prefill_cache",
           "draft_propose_paged", "verify_paged", "require_decoder"]
