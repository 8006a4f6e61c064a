from repro_torch.ckpt.packed import load_packed, params_from_tree

__all__ = ["load_packed", "params_from_tree"]
