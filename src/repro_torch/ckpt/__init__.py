from repro_torch.ckpt.packed import (load_draft_scales, load_packed,
                                     params_from_tree, save_packed)

__all__ = ["load_packed", "save_packed", "load_draft_scales",
           "params_from_tree"]
