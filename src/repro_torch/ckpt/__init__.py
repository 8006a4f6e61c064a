from repro_torch.ckpt.checkpoint import CheckpointManager, stack_params
from repro_torch.ckpt.packed import (load_draft_scales, load_packed,
                                     params_from_tree, save_packed,
                                     unstack_blocks)

__all__ = ["CheckpointManager", "stack_params", "unstack_blocks",
           "load_packed", "save_packed", "load_draft_scales",
           "params_from_tree"]
