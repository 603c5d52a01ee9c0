"""The numpy host oracles of the PyTorch port's codecs and the hard-decision
Viterbi wrapper, against the JAX package's: conv.encode_host and
decode_hard, the block codes' encode_host / decode_host (syndrome tables up
to each code's correction radius), rs.encode_host, and the bits host
helpers, all exactly equal on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.ops import bits as jbits
from liquiddsp_tpu.ops.fec import block as jblock
from liquiddsp_tpu.ops.fec import conv as jconv
from liquiddsp_tpu.ops.fec import rs as jrs
from liquiddsp_tpu_torch.ops import bits
from liquiddsp_tpu_torch.ops.fec import block, conv, rs

CODES = ("hamming74", "hamming128", "secded2216", "secded3932", "secded7264", "golay2412")


@pytest.mark.parametrize("inner", range(7))
def test_conv_encode_host_equals_jax(inner):
    msg = np.random.default_rng(inner).integers(0, 2, 150, dtype=np.uint8)
    np.testing.assert_array_equal(conv.encode_host(msg, inner), jconv.encode_host(msg, inner))


@pytest.mark.parametrize("inner", range(7))
def test_decode_hard_equals_jax(inner):
    """Hard decisions with a few flipped coded bits, two rows."""
    rng = np.random.default_rng(20 + inner)
    msg = rng.integers(0, 2, (2, 120), dtype=np.uint8)
    coded = np.stack([jconv.encode_host(m, inner) for m in msg])
    coded[:, 5::23] ^= 1
    ref = np.asarray(jconv.decode_hard(jnp.asarray(coded, dtype=jnp.int8), 120, inner))
    got = conv.decode_hard(torch.from_numpy(coded.astype(np.int8)), 120, inner).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    if inner == 1:
        np.testing.assert_array_equal(got, msg)  # rate 1/2 corrects these flips


@pytest.mark.parametrize("name", CODES)
def test_block_host_oracle_equals_jax(name):
    code, ref = getattr(block, name)(), getattr(jblock, name)()
    assert code.max_correct == ref.max_correct
    np.testing.assert_array_equal(code._syndrome_table, ref._syndrome_table)
    rng = np.random.default_rng(len(name))
    data = rng.integers(0, 2, (6, code.k), dtype=np.uint8)
    enc = code.encode_host(data)
    np.testing.assert_array_equal(enc, ref.encode_host(data))
    # errors up to the code's radius, one pattern a block
    bad = enc.copy()
    for b in range(6):
        bad[b, rng.choice(code.n, size=1 + b % code.max_correct, replace=False)] ^= 1
    np.testing.assert_array_equal(code.decode_host(bad), ref.decode_host(bad))
    np.testing.assert_array_equal(code.decode_host(bad), data)
    # the device decoder agrees with the oracle
    dev = code.decode(torch.from_numpy(bad.reshape(1, -1).astype(np.int8))).numpy()
    np.testing.assert_array_equal(dev.reshape(6, code.k), data)


@pytest.mark.parametrize("length", [1, 64, 223, 300, 700])
def test_rs_encode_host_equals_jax(length):
    msg = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8)
    np.testing.assert_array_equal(rs.encode_host(msg), jrs.encode_host(msg))


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 2, 4)])
def test_bits_host_helpers_equal_jax(shape):
    b = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    unpacked = bits.bytes_to_bits_host(b)
    np.testing.assert_array_equal(unpacked, jbits.bytes_to_bits_host(b))
    np.testing.assert_array_equal(bits.bits_to_bytes_host(unpacked), jbits.bits_to_bytes_host(unpacked))
    np.testing.assert_array_equal(bits.bits_to_bytes_host(unpacked), b)
    np.testing.assert_array_equal(unpacked, bits.bytes_to_bits(torch.from_numpy(b)).numpy())
