"""QuantizedTensor: the fused binary-coding weight representation.

W[k, n] = sum_i alphas[g(k), n, i] * s_i[k, n] + betas[g(k), n],
s in {-1,+1} packed as 32-bit bitplanes (quant/packing.py), g(k) =
k // group_size the contiguous K-group of row k.

The G axis invariant is validated at construction exactly as the
reference does: alphas (..., G, N, bits) and betas (..., G, N) must
agree on G and N with the codes, and G > 1 must divide k_in.

A tensor's *active* bit-width is `alphas.shape[-1]` (`bits`), which may
be LESS than the code planes stored (`stored_bits`, `codes.shape[-3]`):
the leading planes plus re-fit alphas form a valid lower-bit view that
shares the packed words byte for byte.

Scales stay in the dtype they were stored in (fp32, or bf16 from packed
v4 artifacts); every consumer expands them in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.hw import dtype_name, torch_dtype
from repro_torch.quant.packing import unpack_signs


class QuantizedTensor:
    """Quantized stand-in for a weight of shape (..., k_in, n_out)."""

    def __init__(self, codes, alphas, betas, k_in, orig_dtype="bfloat16"):
        self.codes = codes        # (..., bits, ceil(K/32), N) int32 words
        self.alphas = alphas      # (..., G, N, bits) fp32 or bf16
        self.betas = betas        # (..., G, N) fp32 or bf16
        self.k_in = int(k_in)
        self.orig_dtype = str(orig_dtype)
        self._validate()

    def _validate(self):
        cs, as_, bs = (tuple(self.codes.shape), tuple(self.alphas.shape),
                       tuple(self.betas.shape))
        if len(cs) < 3 or len(as_) < 3 or len(bs) < 2:
            raise ValueError(f"codes {cs}, alphas {as_}, betas {bs}: want "
                             f"(..., bits, K/32, N), (..., G, N, bits), "
                             f"(..., G, N)")
        bits, KW, N = cs[-3:]
        G = as_[-3]
        if as_[-2] != N or not (1 <= as_[-1] <= bits):
            raise ValueError(
                f"alphas {as_} do not match codes {cs}: want "
                f"(..., G, N={N}, bits<={bits}) — active bits are the "
                f"alpha width and may not exceed the stored code planes")
        if bs[-2:] != (G, N):
            raise ValueError(
                f"betas {bs} do not match alphas {as_}: want "
                f"(..., G={G}, N={N})")
        if not (cs[:-3] == as_[:-3] == bs[:-2]):
            raise ValueError(
                f"leading (stack) dims disagree: codes {cs}, alphas "
                f"{as_}, betas {bs}")
        if G > 1 and self.k_in % G:
            raise ValueError(
                f"G={G} scale groups must divide k_in={self.k_in} "
                f"(group boundaries are contiguous K slices)")
        if self.k_in > KW * 32:
            raise ValueError(
                f"k_in={self.k_in} exceeds packed capacity {KW * 32}")
        if self.codes.dtype != torch.int32:
            raise TypeError(f"codes must be int32 words, got "
                            f"{self.codes.dtype}")

    # ---- metadata ----
    @property
    def bits(self):
        """Active bit-width: planes the scales actually weight."""
        return self.alphas.shape[-1]

    @property
    def stored_bits(self):
        """Code planes physically present in the packed sign words."""
        return self.codes.shape[-3]

    @property
    def n_out(self):
        return self.codes.shape[-1]

    @property
    def n_groups(self):
        return self.alphas.shape[-3]

    @property
    def group_size(self):
        """K entries per scale group; 0 means per-channel (G=1)."""
        G = self.n_groups
        return 0 if G == 1 else self.k_in // G

    @property
    def shape(self):
        return (*self.codes.shape[:-3], self.k_in, self.n_out)

    @property
    def device(self):
        return self.codes.device

    @property
    def scale_dtype(self):
        return dtype_name(self.alphas.dtype)

    def packed_bytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.alphas, self.betas))

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.codes.to(device), self.alphas.to(device),
                               self.betas.to(device), self.k_in,
                               self.orig_dtype)

    def cast_scales(self, dtype):
        """New QuantizedTensor with alphas/betas cast to `dtype` (codes
        are integer bitplanes and never cast)."""
        dt = torch_dtype(dtype)
        return QuantizedTensor(self.codes, self.alphas.to(dt),
                               self.betas.to(dt), self.k_in, self.orig_dtype)

    # ---- numerics ----
    def dequant(self, dtype=None):
        """Materialize W (..., k_in, n_out)."""
        signs = unpack_signs(self.codes, self.k_in)[..., : self.bits, :, :]
        G = self.alphas.shape[-3]
        rep = -(-self.k_in // G)
        a = torch.repeat_interleave(self.alphas.float(), rep,
                                    dim=-3)[..., : self.k_in, :, :]
        b = torch.repeat_interleave(self.betas.float(), rep,
                                    dim=-2)[..., : self.k_in, :]
        w = torch.einsum("...ikn,...kni->...kn", signs, a) + b
        return w.to(torch_dtype(dtype or self.orig_dtype))

    def quantized_matmul(self, x, rows=None):
        """x (..., k_in) @ W -> (..., n_out) through kernels/ops.py
        (`rows`: live leading rows of each expert of a batched stack)."""
        from repro_torch.kernels import ops
        return ops.bcq_apply(x, self, rows)


def stack_leaves(items):
    """Stack equally shaped weights (tensors or QuantizedTensors) along
    a new leading axis: per-expert matrices into an expert stack, or a
    pattern slot's layers into the reference's group axis."""
    if isinstance(items[0], QuantizedTensor):
        return QuantizedTensor(torch.stack([q.codes for q in items]),
                               torch.stack([q.alphas for q in items]),
                               torch.stack([q.betas for q in items]),
                               items[0].k_in, items[0].orig_dtype)
    return torch.stack(items)


def tree_tensors(tree):
    """Every tensor of a tree of dicts, lists and tuples, in order, a
    QuantizedTensor's codes, alphas and betas (an FSDP leaf's blocks)
    included."""
    if isinstance(tree, QuantizedTensor):
        yield from (tree.codes, tree.alphas, tree.betas)
    elif hasattr(tree, "tensors"):              # dist/fsdp.py FsdpLeaf
        yield from tree.tensors()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def dequantize_params(tree, dtype="float32"):
    """A params tree (dicts and lists) with every QuantizedTensor
    replaced by its dequantized weight in `dtype`: the same function in
    plain matmuls (the kernels' reference on a whole model)."""
    if isinstance(tree, dict):
        return {k: dequantize_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantize_params(v, dtype) for v in tree]
    return tree.dequant(dtype) if isinstance(tree, QuantizedTensor) else tree
