"""The port's BCQ GEMM/GEMV (repro_torch/kernels/bcq_matmul.py) and its
dispatch (kernels/ops.py:bcq_apply) against the reference: JAX
`bcq_matmul`/`bcq_gemv` in Pallas interpret mode and `ops.bcq_apply`,
on the same inputs made with numpy.

On the CPU the wrappers run their plain version; the CUDA kernels are
held against that plain version in tests/test_torch_cuda.py.

Tolerances: fp32 outputs rtol 1e-5 with atol 1e-5 * max|y| (sums of up
to a few hundred products in another order); bf16 outputs atol
2^-7 * max|y| (both sides round W to bf16 and multiply exactly in fp32,
so they differ by the final bf16 rounding, one ulp = 2^-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bcq_matmul import bcq_gemv as jax_gemv
from repro.kernels.bcq_matmul import bcq_matmul as jax_matmul
from repro.quant import QuantizedTensor as JaxQT
from repro_torch.kernels import bcq_matmul as tbm
from repro_torch.kernels import ops
from repro_torch.quant import QuantizedTensor, codes_from_numpy

BF16_ATOL = 2.0 ** -7


def make(seed, M, k_in, N, G, bits=3, stored=None, x_dtype=np.float32,
         scale_dtype="float32"):
    """numpy inputs: x (M, k_in), codes (stored, ceil(k_in/32), N),
    alphas (G, N, bits), betas (G, N)."""
    rng = np.random.default_rng(seed)
    stored = stored or bits
    KW = -(-k_in // 32)
    codes = rng.integers(0, 2 ** 32, (stored, KW, N), dtype=np.uint32)
    alphas = (rng.random((G, N, bits)) * 0.2 + 0.01).astype(np.float32)
    betas = (rng.standard_normal((G, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, k_in)).astype(np.float32)
    if scale_dtype == "bfloat16":
        alphas = np.asarray(jnp.asarray(alphas, jnp.bfloat16))
        betas = np.asarray(jnp.asarray(betas, jnp.bfloat16))
    return x, codes, alphas, betas


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return codes_from_numpy(a)
    return torch.from_numpy(a.copy())


def to_jax(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def close(got, want, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_ATOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# kernel entries vs the reference kernel (interpret mode)
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    # (M, K, N, G)
    (1, 256, 96, 1), (3, 256, 96, 4), (8, 256, 130, 2),
    (9, 256, 130, 1), (100, 256, 96, 4), (100, 128, 40, 2),
]


@pytest.mark.parametrize("M,K,N,G", KERNEL_CASES)
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_kernel_entries_match_reference(M, K, N, G, scale_dtype, x_dtype):
    x, codes, alphas, betas = make(M * 1000 + K + N + G, M, K, N, G,
                                   scale_dtype=scale_dtype)
    jfn = jax_gemv if M <= 8 else jax_matmul
    tfn = tbm.bcq_gemv if M <= 8 else tbm.bcq_matmul
    jx = to_jax(x, jnp.bfloat16 if x_dtype == "bfloat16" else None)
    want = jfn(jx, to_jax(codes), to_jax(alphas), to_jax(betas),
               interpret=True)
    tx = to_torch(x)
    if x_dtype == "bfloat16":
        tx = tx.bfloat16()
    before = dict(tbm.LAUNCHES)
    got = tfn(tx, to_torch(codes), to_torch(alphas), to_torch(betas))
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    assert tbm.LAUNCHES == before      # CPU tensors never count a launch
    close(as_np(got), np.asarray(want, np.float32),
          bf16=x_dtype == "bfloat16")


def test_kernel_entries_reject_bad_shapes():
    x, codes, alphas, betas = make(0, 2, 64, 16, 1)
    with pytest.raises(ValueError, match="zero-pad"):
        tbm.bcq_gemv(to_torch(x)[:, :40], to_torch(codes), to_torch(alphas),
                     to_torch(betas))
    x, codes, alphas, betas = make(0, 2, 96, 16, 3)    # gs = 32 ok
    tbm.bcq_matmul(to_torch(x), to_torch(codes), to_torch(alphas),
                   to_torch(betas))
    x, codes, alphas, betas = make(0, 2, 96, 16, 2)    # gs = 48
    with pytest.raises(ValueError, match="multiple of 32"):
        tbm.bcq_matmul(to_torch(x), to_torch(codes), to_torch(alphas),
                       to_torch(betas))


# ---------------------------------------------------------------------------
# bcq_apply dispatch vs the reference's ops.bcq_apply
# ---------------------------------------------------------------------------

APPLY_CASES = [
    # (lead, M, k_in, N, G, bits, stored)
    ((), 1, 256, 64, 1, 3, 3),
    ((2,), 3, 256, 64, 4, 3, 3),         # G = K/64
    ((), 8, 256, 64, 2, 3, 3),           # G = K/128
    ((), 9, 256, 64, 1, 3, 3),
    ((4, 25), 100, 256, 64, 4, 3, 3),
    ((), 5, 250, 48, 1, 3, 3),           # k_in % 32 != 0: pad bits
    ((), 12, 250, 48, 1, 2, 3),          # active bits < stored planes
    ((), 4, 256, 64, 2, 2, 4),
    ((), 6, 250, 48, 5, 3, 3),           # ragged groups -> plain path
    ((), 10, 160, 48, 2, 3, 3),          # gs 80 -> plain path
]


def _qts(codes, alphas, betas, k_in):
    jqt = JaxQT(jnp.asarray(codes), jnp.asarray(alphas), jnp.asarray(betas),
                k_in, "float32")
    tqt = QuantizedTensor(to_torch(codes), to_torch(alphas), to_torch(betas),
                          k_in, "float32")
    return jqt, tqt


@pytest.mark.parametrize("lead,M,k_in,N,G,bits,stored", APPLY_CASES)
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("force_pallas", [False, True])
def test_bcq_apply_matches_reference(lead, M, k_in, N, G, bits, stored,
                                     scale_dtype, force_pallas,
                                     monkeypatch):
    rows = int(np.prod(lead)) if lead else M
    x, codes, alphas, betas = make(k_in + 7 * M + G + bits, rows, k_in, N, G,
                                   bits=bits, stored=stored,
                                   scale_dtype=scale_dtype)
    x = x.reshape(*(lead or (M,)), k_in)
    jqt, tqt = _qts(codes, alphas, betas, k_in)
    monkeypatch.setattr(jops, "FORCE_PALLAS", force_pallas)
    want = jops.bcq_apply(jnp.asarray(x), jqt)
    plain0 = ops.PLAIN_CALLS["bcq_plain"]
    got = ops.bcq_apply(torch.from_numpy(x), tqt)
    ragged = G > 1 and (k_in % G or (k_in // G) % 32)
    assert ops.PLAIN_CALLS["bcq_plain"] - plain0 == (1 if ragged else 0)
    assert tuple(got.shape) == tuple(want.shape)
    close(as_np(got), np.asarray(want))
    # QuantizedTensor.quantized_matmul is the same dispatch
    close(as_np(tqt.quantized_matmul(torch.from_numpy(x))), np.asarray(want))


def test_bcq_apply_bf16_activations():
    x, codes, alphas, betas = make(5, 4, 256, 64, 4)
    jqt, tqt = _qts(codes, alphas, betas, 256)
    want = jops.bcq_apply(jnp.asarray(x, jnp.bfloat16), jqt)
    got = ops.bcq_apply(torch.from_numpy(x).bfloat16(), tqt)
    assert got.dtype == torch.bfloat16
    close(as_np(got), np.asarray(want, np.float32), bf16=True)


def test_dispatch_threshold_and_padding(monkeypatch):
    """<= 8 rows go to the GEMV, more to the GEMM, with x zero-padded to
    the packed K and only the active code planes passed."""
    seen = []

    def spy(name, fn):
        def wrapped(x, codes, alphas, betas):
            seen.append((name, tuple(x.shape), codes.shape[0],
                         float(x[:, 250:].abs().sum())))
            return fn(x, codes, alphas, betas)
        return wrapped
    monkeypatch.setattr(ops, "bcq_gemv", spy("gemv", tbm.bcq_gemv))
    monkeypatch.setattr(ops, "bcq_matmul", spy("gemm", tbm.bcq_matmul))
    x, codes, alphas, betas = make(1, 9, 250, 32, 1, bits=2, stored=3)
    _, tqt = _qts(codes, alphas, betas, 250)
    for m in (1, 8, 9):
        ops.bcq_apply(torch.from_numpy(x[:m]), tqt)
    assert seen == [("gemv", (1, 256), 2, 0.0), ("gemv", (8, 256), 2, 0.0),
                    ("gemm", (9, 256), 2, 0.0)]


def test_expert_stacks_wait_for_the_moe_slice():
    """The MoE slice has come: an expert stack goes to the batched-expert
    path (its plain version on the CPU, no plain-path count) and matches
    the reference's bcq_apply; the full parity tests are in
    tests/test_torch_moe.py."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2 ** 32, (2, 3, 2, 8), dtype=np.uint32)
    alphas = rng.random((2, 1, 8, 3)).astype(np.float32)
    betas = rng.standard_normal((2, 1, 8)).astype(np.float32)
    x = rng.standard_normal((2, 4, 64)).astype(np.float32)
    qt = QuantizedTensor(to_torch(codes), to_torch(alphas), to_torch(betas),
                         64)
    plain = ops.PLAIN_CALLS["bcq_plain"]
    got = ops.bcq_apply(torch.from_numpy(x), qt)
    assert ops.PLAIN_CALLS["bcq_plain"] == plain
    want = jops.bcq_apply(to_jax(x), JaxQT(to_jax(codes), to_jax(alphas),
                                           to_jax(betas), 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_quantized_tensor_validation_and_dequant():
    x, codes, alphas, betas = make(2, 1, 250, 24, 5, bits=2, stored=3)
    jqt, tqt = _qts(codes, alphas, betas, 250)
    assert (tqt.bits, tqt.stored_bits, tqt.n_groups, tqt.group_size) == \
        (jqt.bits, jqt.stored_bits, jqt.n_groups, jqt.group_size)
    np.testing.assert_allclose(as_np(tqt.dequant("float32")),
                               np.asarray(jqt.dequant(jnp.float32)),
                               rtol=1e-6, atol=1e-7)
    b = tqt.cast_scales("bfloat16")
    assert b.alphas.dtype == torch.bfloat16 and b.codes is tqt.codes
    with pytest.raises(ValueError, match="divide k_in"):
        QuantizedTensor(to_torch(codes), to_torch(alphas)[:4],
                        to_torch(betas)[:4], 250)
    with pytest.raises(ValueError, match="active bits"):
        QuantizedTensor(to_torch(codes), torch.ones(5, 24, 4),
                        to_torch(betas), 250)
