"""The port's sign bitplane packing (repro_torch/quant/packing.py) is
bit-exact with the reference's (repro/quant/packing.py), both ways,
including K that is not a multiple of 32 (zero pad bits = -1 signs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import packing as jpk
from repro_torch.quant import packing as tpk


@pytest.mark.parametrize("lead,bits,K,N", [
    ((), 3, 64, 16), ((), 2, 70, 9), ((), 4, 1, 5), ((2,), 3, 33, 7),
    ((), 1, 256, 128), ((2, 3), 2, 95, 4)])
def test_pack_signs_bit_exact(lead, bits, K, N):
    rng = np.random.default_rng(K * 131 + N)
    signs = rng.integers(0, 2, (*lead, bits, K, N)).astype(bool)
    want = np.asarray(jpk.pack_signs(jnp.asarray(signs)))
    got = tpk.codes_to_numpy(tpk.pack_signs(torch.from_numpy(signs)))
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # int input (truthy = +1) packs the same
    pm = np.where(signs, 1, -1).astype(np.int32)
    np.testing.assert_array_equal(
        tpk.codes_to_numpy(tpk.pack_signs(torch.from_numpy(pm))), want)


@pytest.mark.parametrize("bits,KW,N,k_in", [
    (3, 2, 16, 64), (3, 3, 5, 70), (2, 1, 9, 1), (4, 8, 33, 250)])
def test_unpack_signs_bit_exact(bits, KW, N, k_in):
    rng = np.random.default_rng(bits * 7 + KW)
    codes = rng.integers(0, 2 ** 32, (bits, KW, N), dtype=np.uint32)
    want = np.asarray(jpk.unpack_signs(jnp.asarray(codes), k_in))
    got = tpk.unpack_signs(tpk.codes_from_numpy(codes), k_in).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # and back: packing the unpacked signs restores the words where they
    # are defined (pad bits past k_in come back as 0)
    repacked = tpk.codes_to_numpy(tpk.pack_signs(torch.from_numpy(got)))
    np.testing.assert_array_equal(
        repacked, np.asarray(jpk.pack_signs(jnp.asarray(want))))


def test_words_with_the_top_bit_set_round_trip():
    """Bit 31 is the sign bit of the port's int32 words: words >= 2^31
    must survive pack -> numpy -> unpack unchanged."""
    words = np.array([[[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1]]], np.uint32)
    t = tpk.codes_from_numpy(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tpk.codes_to_numpy(t), words)
    np.testing.assert_array_equal(
        tpk.unpack_signs(t, 32).numpy(),
        np.asarray(jpk.unpack_signs(jnp.asarray(words), 32)))


@pytest.mark.parametrize("shape", [(32,), (3, 64), (2, 2, 128)])
def test_pack_signs_last_bit_exact(shape):
    rng = np.random.default_rng(sum(shape))
    signs = rng.integers(0, 2, shape).astype(bool)
    want = np.asarray(jpk.pack_signs_last(jnp.asarray(signs)))
    got = tpk.codes_to_numpy(tpk.pack_signs_last(torch.from_numpy(signs)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpk.unpack_signs_last(tpk.codes_from_numpy(want)).numpy(),
        np.asarray(jpk.unpack_signs_last(jnp.asarray(want))))


def test_pack_signs_last_rejects_ragged_k():
    with pytest.raises(ValueError, match="K % 32"):
        tpk.pack_signs_last(torch.ones(33, dtype=torch.bool))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 4096, 11008])
def test_padded_k(k):
    assert tpk.padded_k(k) == jpk.padded_k(k)
