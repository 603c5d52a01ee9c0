"""Ops of the PyTorch port against the JAX package on the same numpy inputs.

Everything here is integer or table arithmetic and must agree exactly, except
the soft demodulator, whose float32 distances may round differently
(rtol 1e-5, atol 1e-5 on LLRs of order 10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.ops import bits as jbits
from liquiddsp_tpu.ops import crc as jcrc
from liquiddsp_tpu.ops import fir as jfir
from liquiddsp_tpu.ops import modem as jmodem
from liquiddsp_tpu.ops import rrc as jrrc
from liquiddsp_tpu.ops.fec import block as jblock
from liquiddsp_tpu.ops.fec import conv as jconv
from liquiddsp_tpu.ops.fec import registry as jreg
from liquiddsp_tpu_torch.ops import bits as tbits
from liquiddsp_tpu_torch.ops import crc as tcrc
from liquiddsp_tpu_torch.ops import fir as tfir
from liquiddsp_tpu_torch.ops import modem as tmodem
from liquiddsp_tpu_torch.ops.fec import block as tblock
from liquiddsp_tpu_torch.ops.fec import conv as tconv
from liquiddsp_tpu_torch.ops.fec import registry as treg

COHERENT_MODS = [0, 1, 2, 3, 7, 8, 9, 10]


def t(a):
    return torch.from_numpy(np.array(a))


def test_bits_roundtrip_and_equal():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 256, (3, 5, 11), dtype=np.uint8)
    bits_j = np.asarray(jbits.bytes_to_bits(jnp.asarray(b)))
    bits_t = tbits.bytes_to_bits(t(b))
    assert bits_t.dtype == torch.int8
    np.testing.assert_array_equal(bits_j, bits_t.numpy())
    back = tbits.bits_to_bytes(bits_t)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), b)


@pytest.mark.parametrize("length", [1, 19, 67, 200])
def test_crc24_equal_and_matches_host(length):
    rng = np.random.default_rng(length)
    msg = rng.integers(0, 256, (4, 3, length), dtype=np.uint8)
    cj = np.asarray(jcrc.crc24(jnp.asarray(msg))).astype(np.int64)
    ct = tcrc.crc24(t(msg)).numpy().astype(np.int64)
    np.testing.assert_array_equal(cj, ct)
    assert int(ct[0, 0]) == tcrc.crc24_host(msg[0, 0].tobytes())
    app_j = np.asarray(jcrc.crc24_append(jnp.asarray(msg)))
    app_t = tcrc.crc24_append(t(msg))
    np.testing.assert_array_equal(app_j, app_t.numpy())
    assert bool(tcrc.crc24_check(app_t).all())
    bad = app_t.clone()
    bad[..., 0] ^= 1
    assert not bool(tcrc.crc24_check(bad).any())


@pytest.mark.parametrize("mod", COHERENT_MODS)
def test_modulate_and_hard_demod_equal(mod):
    rng = np.random.default_rng(mod)
    bps = tmodem.MOD_BPS[mod]
    bits = rng.integers(0, 2, (3, 40 * bps)).astype(np.int8)
    idx_j = np.asarray(jmodem.bits_to_indices(jnp.asarray(bits), bps))
    idx_t = tmodem.bits_to_indices(t(bits), bps)
    np.testing.assert_array_equal(idx_j, idx_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jmodem.indices_to_bits(jnp.asarray(idx_j), bps)),
        tmodem.indices_to_bits(idx_t, bps).numpy())
    s_j = np.asarray(jmodem.modulate(jnp.asarray(idx_j), mod))
    s_t = tmodem.modulate(idx_t, mod)
    assert s_t.dtype == torch.complex64
    np.testing.assert_array_equal(s_j, s_t.numpy())
    noisy = (s_j + 0.15 * (rng.standard_normal(s_j.shape) + 1j * rng.standard_normal(s_j.shape))
             ).astype(np.complex64)
    h_j = np.asarray(jmodem.demod_hard(jnp.asarray(noisy), mod))
    h_t = tmodem.demod_hard(t(noisy), mod)
    assert h_t.dtype == torch.int32
    np.testing.assert_array_equal(h_j, h_t.numpy())


@pytest.mark.parametrize("mod", COHERENT_MODS)
def test_soft_demod_equal(mod):
    rng = np.random.default_rng(100 + mod)
    table = tmodem.constellation(mod)
    s = table[rng.integers(0, len(table), (2, 3, 50))]
    noisy = (s + 0.2 * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape))
             ).astype(np.complex64)
    nv = rng.uniform(0.05, 0.5, (2, 3, 1)).astype(np.float32)
    l_j = np.asarray(jmodem.demod_soft_bits(jnp.asarray(noisy), mod, jnp.asarray(nv)))
    l_t = tmodem.demod_soft_bits(t(noisy), mod, t(nv)).numpy()
    assert l_t.shape == (2, 3, 50 * tmodem.MOD_BPS[mod])
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5, atol=1e-5)


def test_golay_encode_equal():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (5, 12 * 15)).astype(np.int8)
    cj = np.asarray(jblock.golay2412().encode(jnp.asarray(bits)))
    ct = tblock.golay2412().encode(t(bits))
    assert ct.dtype == torch.int8
    np.testing.assert_array_equal(cj, ct.numpy())


@pytest.mark.parametrize("n_err", [0, 1, 2, 3, 4])
def test_golay_decode_equal_with_errors(n_err):
    """0-3 errors per block are corrected; 4 are not, and both packages
    then return the same (uncorrected) data."""
    rng = np.random.default_rng(10 + n_err)
    nblk = 40
    bits = rng.integers(0, 2, (3, 12 * nblk)).astype(np.int8)
    coded = tblock.golay2412().encode(t(bits)).numpy().reshape(3, nblk, 24).copy()
    for a in range(3):
        for b in range(nblk):
            pos = rng.choice(24, n_err, replace=False)
            coded[a, b, pos] ^= 1
    coded = coded.reshape(3, nblk * 24)
    dj = np.asarray(jblock.golay2412().decode(jnp.asarray(coded)))
    dt = tblock.golay2412().decode(t(coded)).numpy()
    np.testing.assert_array_equal(dj, dt)
    if n_err <= 3:
        np.testing.assert_array_equal(dt, bits)


def test_golay_packed_decoder_equal_on_every_syndrome():
    s = np.arange(4096, dtype=np.int32)
    ej = np.asarray(jblock._decode_golay_packed(jnp.asarray(s)))
    et = tblock._decode_golay_packed(t(s)).numpy()
    np.testing.assert_array_equal(ej, et)


@pytest.mark.parametrize("inner", range(7))
def test_conv_encode_equal(inner):
    rng = np.random.default_rng(20 + inner)
    bits = rng.integers(0, 2, (3, 2, 137)).astype(np.int8)
    cj = np.asarray(jconv.encode(jnp.asarray(bits), inner))
    ct = tconv.encode(t(bits), inner)
    assert ct.dtype == torch.int8
    np.testing.assert_array_equal(cj, ct.numpy())
    if inner:
        np.testing.assert_array_equal(
            ct.numpy()[0, 0], tconv.encode_host(bits[0, 0].astype(np.uint8), inner))


@pytest.mark.parametrize("outer", [0, 1])
def test_outer_codec_equal(outer):
    rng = np.random.default_rng(30 + outer)
    msg = rng.integers(0, 256, (4, 67), dtype=np.uint8)
    cj = np.asarray(jreg.outer_encode(jnp.asarray(msg), outer))
    ct = treg.outer_encode(t(msg), outer)
    np.testing.assert_array_equal(cj, ct.numpy())
    flip = ct.clone()
    flip[:, ::29] ^= 1  # sparse errors: at most one per Golay block
    dj = np.asarray(jreg.outer_decode(jnp.asarray(flip.numpy()), 67, outer))
    dt = treg.outer_decode(flip, 67, outer).numpy()
    np.testing.assert_array_equal(dj, dt)
    if outer:
        np.testing.assert_array_equal(dt, msg)


@pytest.mark.parametrize("n", [16, 536, 2172, 1000])
def test_interleaver_roundtrip(n):
    from liquiddsp_tpu_torch.phy import frame_spec as tfs

    perm, inv = tfs.interleave_perm(n), tfs.interleave_inv(n)
    x = torch.arange(n)
    np.testing.assert_array_equal(x[t(perm.astype(np.int64))][t(inv.astype(np.int64))].numpy(),
                                  np.arange(n))


def test_interp_full_equal():
    """TX pulse shaping: 29 float32 multiply-adds per output in both
    packages, summed in another order: atol 1e-6 on samples of order 1."""
    rng = np.random.default_rng(4)
    syms = (rng.standard_normal((3, 90)) + 1j * rng.standard_normal((3, 90))).astype(np.complex64)
    h = jrrc.matched_taps()
    yj = np.asarray(jfir.interp_full(jnp.asarray(syms), h, 2))
    yt = tfir.interp_full(t(syms), h, 2)
    assert yt.dtype == torch.complex64 and yt.shape == (3, 2 * 90 + 28)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-6)
