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
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bcq_matmul import bcq_expert_matmul as jax_expert
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


# ---------------------------------------------------------------------------
# live rows of an expert stack, and the tensor-core GEMM's launch shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 16])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_expert_rows_match_reference_with_dead_rows_zeroed(M, scale_dtype):
    """`rows` of the expert entry: the plain version given rows against
    the reference's expert kernel (interpret mode) on x with the rows
    past each count zeroed. Experts with 0 rows and with all rows."""
    E, K, N, G = 5, 256, 96, 2
    rng = np.random.default_rng(M)
    codes = rng.integers(0, 2 ** 32, (E, 3, K // 32, N), dtype=np.uint32)
    alphas = np.asarray(jnp.asarray(rng.random((E, G, N, 3)) * 0.2 + 0.01,
                                    scale_dtype))
    betas = np.asarray(jnp.asarray(rng.standard_normal((E, G, N)) * 0.05,
                                   scale_dtype))
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    rows = np.array([0, M, 1, M // 2 + 1, 0], np.int32)
    xz = x * (np.arange(M)[None, :, None] < rows[:, None, None])
    want = np.asarray(jax_expert(*(jnp.asarray(a) for a in
                                   (xz, codes, alphas, betas)),
                                 interpret=True))
    before = dict(tbm.LAUNCHES)
    got = tbm.bcq_expert_matmul(*(to_torch(a) for a in
                                  (x, codes, alphas, betas)),
                                rows=torch.from_numpy(rows))
    assert tbm.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    for e, r in enumerate(rows):
        assert not got[e, r:].any()         # exact zeros past the count
    full = tbm.bcq_expert_matmul(*(to_torch(a) for a in
                                   (x, codes, alphas, betas)))
    assert torch.equal(got[1], full[1])


def test_bcq_apply_passes_rows_to_expert_stacks_only():
    rng = np.random.default_rng(1)
    E, C, k_in, N = 3, 5, 96, 16
    x = torch.from_numpy(rng.standard_normal((E, C, k_in)).astype(np.float32))
    rows = torch.tensor([2, 0, 5], dtype=torch.int32)
    for G in (1, 6):                # kernel path; ragged groups: plain path
        codes = rng.integers(0, 2 ** 32, (E, 3, 3, N), dtype=np.uint32)
        qt = QuantizedTensor(to_torch(codes), torch.rand(E, G, N, 3),
                             torch.zeros(E, G, N), k_in)
        got = qt.quantized_matmul(x, rows)
        want = ops.bcq_apply(tbm.mask_rows(x, rows), qt)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert not got[1].any() and not got[0, 2:].any()
    single = QuantizedTensor(to_torch(codes[0]), torch.rand(1, N, 3),
                             torch.zeros(1, N), k_in)
    with pytest.raises(ValueError, match="expert stack"):
        ops.bcq_apply(x[0], single, rows)


# (M, K, N) of the GEMM on the main paths: llama2-7b's prefill buckets on
# its q/k/v/o, gate/up and down projections; Qwen3-MoE's k/v and q
# projections; its expert stacks at a 16-row prefill capacity; the CUDA
# tests' ragged and multi-tile token counts
GEMM_SHAPES = ([(M, K, N) for M in (16, 64, 128)
                for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]
               + [(M, 4096, N) for M in (16, 64, 128) for N in (512, 8192)]
               + [(16, 4096, 1536), (16, 1536, 4096)]
               + [(M, 4096, 512) for M in (17, 129, 300)])


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_gemm_launch_shape_on_main_path_shapes(M, K, N):
    KW = K // 32
    tile, ntiles, splits = tbm.gemm_launch_shape(M, KW, N, sms=132)
    assert tile % 8 == 0 and 8 <= tile <= tbm.GEMM_TILE_MAX
    # equal tiles hold M with fewer than 8 rows to spare per tile
    assert (ntiles - 1) * tile < M <= ntiles * tile
    assert ntiles * tile - M < 8 * ntiles
    if M <= tbm.GEMM_TILE_MAX:
        assert (tile, ntiles) == (-(-M // 8) * 8, 1)
    # the grid reaches every SM, or the split is at its floor
    floor = max(1, KW // tbm.GEMM_MIN_WORDS_PER_SPLIT)
    blocks = -(-N // tbm.GEMM_COLS) * ntiles * splits
    assert 1 <= splits <= floor
    assert blocks >= 132 or splits == floor
    # every split has words, and they cover K
    wps = -(-KW // splits)
    assert (splits - 1) * wps < KW <= splits * wps


def test_gemm_launch_shape_ignores_the_expert_count(monkeypatch):
    """An expert stack and a single matrix of the same (M, K, N) launch
    the same token tile and K split, so each expert's slice can equal
    the single-matrix kernel bit for bit. The wrapper's C arguments are
    recorded instead of launched (no card here)."""
    assert list(inspect.signature(tbm.gemm_launch_shape).parameters) == \
        ["M", "KW", "N", "sms"]
    seen = []

    def fake_function(lib, name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            seen.append((name, args))
            return 0
        return call

    monkeypatch.setattr(tbm.build, "function", fake_function)
    monkeypatch.setattr(tbm, "_stream", lambda t: 0)
    monkeypatch.setattr(tbm, "sm_count", lambda dev: 132)

    def cpu_launch_args(x, codes, alphas, betas, rows=None):
        """_launch_args without its device check (which wants a card)."""
        E = x.shape[0]
        M, K, nb, KW, N, G = tbm._check(x[0], codes[0], alphas[0], betas[0])
        es = (x.stride(0), codes.stride(0), alphas.stride(0),
              betas.stride(0))
        return E, M, nb, KW, N, 0, codes.stride(1), es

    monkeypatch.setattr(tbm, "_launch_args", cpu_launch_args)
    rng = np.random.default_rng(0)
    for E in (1, 8):
        codes = to_torch(rng.integers(0, 2 ** 32, (E, 3, 128, 512),
                                      dtype=np.uint32))
        x = torch.zeros((E, 16, 4096))
        rows = torch.full((E,), 3, dtype=torch.int32)
        tbm._gemm(x, codes, torch.ones(E, 1, 512, 3), torch.zeros(E, 1, 512),
                  rows)
        tbm._gemv(x[:, :4], codes, torch.ones(E, 1, 512, 3),
                  torch.zeros(E, 1, 512), None)
    (g1, a1), (v1, b1), (g8, a8), (v8, b8) = seen
    assert g1 == g8 == "bcq_gemm_launch" and v1 == v8 == "bcq_gemv_launch"
    # (tile, ntiles, splits) sit after the words-per-group argument
    assert a1[14:17] == a8[14:17] == tbm.gemm_launch_shape(16, 128, 512)
    assert a8[7] != 0 and b8[5] == 0               # rows pointer, or null
    assert b1[12] == b8[12] == tbm.gemv_splits(128, 512)  # the GEMV's split


def test_gemm_tile_constants_reach_the_kernel_from_hw():
    """The GEMM kernel's tile constants are written once, in hw.py: the
    launch arithmetic reads them there and the build hands them to nvcc,
    whose source takes them from those macros (and fails to compile
    without them)."""
    from repro_torch import hw
    src = (tbm.build.CSRC / "bcq_matmul.cu").read_text()
    assert "#error" in src
    for macro, value in (("BCQ_GEMM_COLS", hw.GEMM_COLS),
                         ("BCQ_GEMM_TILE_MAX", hw.GEMM_TILE_MAX),
                         ("BCQ_GEMM_PAIRED_TILE", hw.GEMM_PAIRED_TILE)):
        assert f"-D{macro}={value}" in tbm.build.NVCC_FLAGS
        assert f"= {macro};" in src
    assert tbm.GEMM_PAIRED_TILE is hw.GEMM_PAIRED_TILE


# (K, N) of the GEMV on the main paths: llama2-7b's q/k/v/o, gate/up and
# down projections; Qwen3-MoE's q, k/v, o and expert matrices; the CUDA
# tests' ragged and grouped shapes
GEMV_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 8192),
               (4096, 512), (8192, 4096), (4096, 1536), (1536, 4096),
               (11008, 260), (1536, 1030), (2048, 96), (256, 96), (32, 10)]


@pytest.mark.parametrize("K,N", GEMV_SHAPES)
def test_gemv_splits_cover_every_word_once(K, N):
    """The GEMV's K split is one cluster of 1..GEMV_MAX_SPLITS blocks:
    block r of the kernel takes words [r * wps, min(KW, (r + 1) * wps)),
    wps = ceil(KW / splits); together they take every word exactly once,
    none is empty, and each holds GEMV_MIN_WORDS_PER_SPLIT words unless
    the matrix has too few for two splits."""
    KW = K // 32
    splits = tbm.gemv_splits(KW, N, sms=132)
    assert 1 <= splits <= tbm.GEMV_MAX_SPLITS
    wps = -(-KW // splits)
    ranges = [range(r * wps, min(KW, (r + 1) * wps)) for r in range(splits)]
    words = [w for r in ranges for w in r]
    assert sorted(words) == list(range(KW)) and all(len(r) for r in ranges)
    assert splits == 1 or wps >= tbm.GEMV_MIN_WORDS_PER_SPLIT


def test_gemv_splits_fill_the_card_on_main_path_shapes():
    """A function of (KW, N) and the SM count alone, with no expert
    count; at llama2-7b's shapes the grid reaches every SM."""
    assert list(inspect.signature(tbm.gemv_splits).parameters) == \
        ["KW", "N", "sms"]
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        splits = tbm.gemv_splits(K // 32, N, sms=132)
        assert -(-N // tbm.GEMV_COLS) * splits >= 132, (K, N, splits)


def test_gemv_and_attention_constants_reach_the_kernels_from_hw():
    """The GEMV's block shape and the attention's partition are written
    once, in hw.py: the launch arithmetic reads them there and the build
    hands them to nvcc, whose sources take them from those macros (and
    fail to compile without them)."""
    from repro_torch import hw
    from repro_torch.kernels import paged_attention as tpa
    gemv = (tbm.build.CSRC / "bcq_matmul.cu").read_text()
    attn = (tbm.build.CSRC / "paged_attention.cu").read_text()
    for src, macro, value in ((gemv, "BCQ_GEMV_COLS", hw.GEMV_COLS),
                              (gemv, "BCQ_GEMV_WARPS", hw.GEMV_WARPS),
                              (attn, "PA_TILE", hw.ATTN_TILE),
                              (attn, "PA_MAX_CLUSTER", hw.ATTN_MAX_CLUSTER),
                              (attn, "PA_MAX_REP", hw.ATTN_MAX_REP),
                              (attn, "PA_MAX_STAGES", hw.ATTN_MAX_STAGES),
                              (attn, "PA_QUANT_SCALES_MAX",
                               hw.ATTN_QUANT_SCALES_MAX)):
        assert f"-D{macro}={value}" in tbm.build.NVCC_FLAGS
        assert f"= {macro};" in src and f"defined({macro})" in src
    assert tbm.GEMV_COLS is hw.GEMV_COLS and tbm.GEMV_WARPS is hw.GEMV_WARPS
    assert tpa.ATTN_TILE is hw.ATTN_TILE
    assert tpa.ATTN_MAX_STAGES is hw.ATTN_MAX_STAGES
    assert tpa.ATTN_QUANT_SCALES_MAX is hw.ATTN_QUANT_SCALES_MAX
