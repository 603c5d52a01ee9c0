"""CRC-16 and CRC-32 of the PyTorch port against the JAX package: the
batched product forms and the host references, at several message lengths
(exact)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.ops import crc as jcrc
from liquiddsp_tpu_torch.ops import crc as tcrc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them (alone, these tests run as fast on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LENGTHS = [1, 7, 22, 67, 259]


def messages(length):
    rng = np.random.default_rng(length)
    m = rng.integers(0, 256, (5, length), dtype=np.uint8)
    m[0] = 0  # the all-zero message: the init value alone
    m[1] = 255
    return m


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("name", ["crc16", "crc32"])
def test_batched_crc_equals_jax(name, length):
    m = messages(length)
    ref = np.asarray(getattr(jcrc, name)(jnp.asarray(m))).astype(np.int64)
    got = getattr(tcrc, name)(torch.from_numpy(m))
    assert got.dtype == (torch.int32 if name == "crc16" else torch.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ref)
    host = [getattr(tcrc, name + "_host")(bytes(r)) for r in m]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), host)


@pytest.mark.parametrize("length", LENGTHS)
def test_host_crcs_equal_jax_and_zlib(length):
    for r in messages(length):
        assert tcrc.crc16_host(bytes(r)) == jcrc.crc16_host(bytes(r))
        assert tcrc.crc32_host(bytes(r)) == jcrc.crc32_host(bytes(r)) == zlib.crc32(bytes(r))


def test_known_check_values():
    """The catalogue's check values on b"123456789": CRC-16/CCITT-FALSE
    0x29B1, CRC-32 0xCBF43926, CRC-24/OPENPGP 0x21CF02."""
    msg = torch.tensor([list(b"123456789")], dtype=torch.uint8)
    assert int(tcrc.crc16(msg)[0]) == 0x29B1 == tcrc.crc16_host(b"123456789")
    assert int(tcrc.crc32(msg)[0]) == 0xCBF43926 == tcrc.crc32_host(b"123456789")
    assert int(tcrc.crc24(msg)[0]) == 0x21CF02 == tcrc.crc24_host(b"123456789")
