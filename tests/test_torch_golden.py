"""The PyTorch port's ops against the native golden oracle (golden/golden.cpp)
through the port's own binding (liquiddsp_tpu_torch.golden, built with g++
into liquiddsp_tpu_torch/_build/): tests/test_golden.py's cases, bit-exact
(float tables within 2e-7), and the port's binding returning what the JAX
package's binding returns on the same inputs."""

import numpy as np
import pytest
import torch

from liquiddsp_tpu import golden as jgolden
from liquiddsp_tpu_torch import golden
from liquiddsp_tpu_torch.ops import crc, modem, msequence, rrc
from liquiddsp_tpu_torch.ops.fec import block, conv, rs

CODES = {1: block.golay2412, 3: block.hamming74, 4: block.hamming128,
         5: block.secded2216, 6: block.secded3932, 7: block.secded7264}


@pytest.fixture(scope="module", autouse=True)
def _build():
    golden.lib()  # builds on first use


def i8(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int8))


class TestGoldenParity:
    def test_msequence(self):
        np.testing.assert_array_equal(
            golden.msequence(7, 0x0089, 1, 254), msequence.msequence_bits(7, 0x0089, 1, 254))

    def test_preamble(self):
        np.testing.assert_allclose(golden.preamble(), msequence.preamble_symbols(), atol=0)

    @pytest.mark.parametrize("n", [1, 3, 22, 67])
    def test_crc24(self, n):
        data = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
        assert golden.crc24(data) == crc.crc24_host(data)
        dev = int(crc.crc24(torch.tensor(list(data), dtype=torch.uint8)[None])[0])
        assert dev == golden.crc24(data)

    def test_crc24_check_value(self):
        assert golden.crc24(b"123456789") == 0x21CF02

    def test_crc16(self):
        assert golden.crc16(b"123456789") == 0x29B1 == crc.crc16_host(b"123456789")

    @pytest.mark.parametrize("dt", [0.0, 0.25, -0.4])
    def test_rrc_taps(self, dt):
        np.testing.assert_allclose(golden.rrc_taps(dt=dt), rrc.rrcos_taps(dt=dt), atol=2e-7)

    def test_matched_taps(self):
        np.testing.assert_allclose(golden.rrc_taps(), rrc.matched_taps(), atol=2e-7)

    @pytest.mark.parametrize("mod", range(11))
    def test_constellations(self, mod):
        np.testing.assert_allclose(golden.constellation(mod), modem.constellation(mod), atol=2e-7)

    @pytest.mark.parametrize("outer", sorted(CODES))
    def test_block_codes(self, outer):
        code = CODES[outer]()
        rng = np.random.default_rng(outer)
        bits = rng.integers(0, 2, 4 * code.k, dtype=np.uint8)
        g_enc = golden.block_encode(outer, bits, code.k)
        np.testing.assert_array_equal(g_enc, code.encode(i8(bits[None])).numpy()[0])
        np.testing.assert_array_equal(g_enc, code.encode_host(bits.reshape(4, code.k)).reshape(-1))
        # one error a block, decoded alike by the oracle, the port and its host oracle
        bad = g_enc.copy()
        for b in range(4):
            bad[b * code.n + int(rng.integers(0, code.n))] ^= 1
        g_dec = golden.block_decode(outer, bad, code.n)
        np.testing.assert_array_equal(g_dec, bits)
        np.testing.assert_array_equal(code.decode(i8(bad[None])).numpy()[0], g_dec)
        np.testing.assert_array_equal(code.decode_host(bad.reshape(4, code.n)).reshape(-1), g_dec)

    @pytest.mark.parametrize("inner", [1, 2, 3, 4, 5, 6])
    def test_conv(self, inner):
        rng = np.random.default_rng(10 + inner)
        bits = rng.integers(0, 2, 96, dtype=np.uint8)
        g_enc = golden.conv_encode(inner, bits)
        np.testing.assert_array_equal(g_enc, conv.encode(i8(bits[None]), inner).numpy()[0])
        np.testing.assert_array_equal(g_enc, conv.encode_host(bits, inner))
        g_dec = golden.viterbi_decode(inner, g_enc, 96)
        np.testing.assert_array_equal(g_dec, bits)
        np.testing.assert_array_equal(conv.decode_hard(i8(g_enc[None]), 96, inner).numpy()[0], g_dec)

    def test_rs(self):
        rng = np.random.default_rng(20)
        msg = rng.integers(0, 256, 64, dtype=np.uint8)
        g_enc = golden.rs_encode_block(msg)
        np.testing.assert_array_equal(g_enc, rs.encode_block(torch.from_numpy(msg[None])).numpy()[0])
        np.testing.assert_array_equal(g_enc, rs.encode_host(msg))
        bad = g_enc.copy()
        pos = rng.choice(len(bad), size=10, replace=False)
        bad[pos] ^= rng.integers(1, 256, size=10).astype(np.uint8)
        np.testing.assert_array_equal(golden.rs_decode_block(bad, 64), msg)
        np.testing.assert_array_equal(rs.decode_block(torch.from_numpy(bad[None]), 64).numpy()[0], msg)


class TestBindingsAgree:
    """The port's binding and the JAX package's, on the same inputs."""

    def test_tables(self):
        np.testing.assert_array_equal(golden.msequence(7, 0x0089, 3, 300),
                                      jgolden.msequence(7, 0x0089, 3, 300))
        np.testing.assert_array_equal(golden.preamble(32), jgolden.preamble(32))
        np.testing.assert_array_equal(golden.rrc_taps(2, 5, 0.25, 0.1), jgolden.rrc_taps(2, 5, 0.25, 0.1))
        for mod in range(11):
            np.testing.assert_array_equal(golden.constellation(mod), jgolden.constellation(mod))
        data = bytes(range(50))
        assert golden.crc24(data) == jgolden.crc24(data) and golden.crc16(data) == jgolden.crc16(data)

    @pytest.mark.parametrize("outer", sorted(CODES))
    def test_block(self, outer):
        code = CODES[outer]()
        bits = np.random.default_rng(30 + outer).integers(0, 2, 3 * code.k, dtype=np.uint8)
        enc = golden.block_encode(outer, bits, code.k)
        np.testing.assert_array_equal(enc, jgolden.block_encode(outer, bits, code.k))
        enc[1] ^= 1
        np.testing.assert_array_equal(golden.block_decode(outer, enc, code.n),
                                      jgolden.block_decode(outer, enc, code.n))

    @pytest.mark.parametrize("inner", [1, 4, 6])
    def test_conv_and_rs(self, inner):
        rng = np.random.default_rng(40 + inner)
        bits = rng.integers(0, 2, 120, dtype=np.uint8)
        enc = golden.conv_encode(inner, bits)
        np.testing.assert_array_equal(enc, jgolden.conv_encode(inner, bits))
        enc[::17] ^= 1
        np.testing.assert_array_equal(golden.viterbi_decode(inner, enc, 120),
                                      jgolden.viterbi_decode(inner, enc, 120))
        msg = rng.integers(0, 256, 100, dtype=np.uint8)
        code = golden.rs_encode_block(msg)
        np.testing.assert_array_equal(code, jgolden.rs_encode_block(msg))
        code[:5] ^= 0x33
        np.testing.assert_array_equal(golden.rs_decode_block(code, 100), jgolden.rs_decode_block(code, 100))

    def test_library_is_the_ports_own(self):
        import pathlib

        path = pathlib.Path(golden._find_or_build())
        assert path.name == "libgolden.so" and path.parent.name == "_build"
        assert path.parent.parent.name == "liquiddsp_tpu_torch"
        with pytest.raises(ValueError):
            golden.constellation(99)
