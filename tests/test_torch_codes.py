"""The differential modems, Reed-Solomon and the Hamming / SEC-DED codes of
the PyTorch port against the JAX package on the same numpy inputs.

Everything here is integer or table arithmetic and must agree exactly, except
the DPSK transmit symbols (the port reads the M phases from a float64-made
table, the JAX package takes a float32 ``exp``: atol 1e-6 on unit symbols) and
the soft demodulator's float32 distances (rtol 1e-5, atol 1e-5 on LLRs of
order 10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.ops import modem as jmodem
from liquiddsp_tpu.ops.fec import block as jblock
from liquiddsp_tpu.ops.fec import registry as jreg
from liquiddsp_tpu.ops.fec import rs as jrs
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.ops import modem as tmodem
from liquiddsp_tpu_torch.ops.fec import block as tblock
from liquiddsp_tpu_torch.ops.fec import registry as treg
from liquiddsp_tpu_torch.ops.fec import rs as trs
from liquiddsp_tpu_torch.phy import framegen as tframegen
from liquiddsp_tpu_torch.phy import framesync as tsync

DPSK_MODS = [4, 5, 6]
BLOCK_CODES = ["hamming74", "hamming128", "secded2216", "secded3932", "secded7264"]


def t(a):
    return torch.from_numpy(np.array(a))


def noisy(rng, s, sigma):
    return (s + sigma * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape))
            ).astype(np.complex64)


# -- differential modems --------------------------------------------------------


@pytest.mark.parametrize("mod", DPSK_MODS)
def test_dpsk_modulate_and_hard_demod_equal(mod):
    rng = np.random.default_rng(mod)
    bps = tmodem.MOD_BPS[mod]
    idx = rng.integers(0, 1 << bps, (3, 2, 60)).astype(np.int32)
    s_j = np.asarray(jmodem.modulate(jnp.asarray(idx), mod))
    s_t = tmodem.modulate(t(idx), mod)
    assert s_t.dtype == torch.complex64 and s_t.shape == idx.shape
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-6)
    # the accumulation runs over the last axis only: rows are independent
    assert s_t[0, 0].equal(tmodem.modulate(t(idx[0, 0]), mod))
    r = noisy(rng, s_j * np.exp(1j * 0.7) * 1.3, 0.05)  # a common phase and gain drop out
    h_j = np.asarray(jmodem.demod_hard(jnp.asarray(r), mod))
    h_t = tmodem.demod_hard(t(r), mod)
    assert h_t.dtype == torch.int32
    np.testing.assert_array_equal(h_j, h_t.numpy())
    # the first symbol steps from 1, so only it sees the common phase
    np.testing.assert_array_equal(h_t.numpy()[..., 1:], idx[..., 1:])


@pytest.mark.parametrize("mod", DPSK_MODS)
def test_dpsk_soft_demod_equal(mod):
    rng = np.random.default_rng(100 + mod)
    bps = tmodem.MOD_BPS[mod]
    idx = rng.integers(0, 1 << bps, (2, 3, 50)).astype(np.int32)
    r = noisy(rng, np.asarray(jmodem.modulate(jnp.asarray(idx), mod)), 0.04)
    nv = rng.uniform(0.05, 0.5, (2, 3, 1)).astype(np.float32)
    l_j = np.asarray(jmodem.demod_soft_bits(jnp.asarray(r), mod, jnp.asarray(nv)))
    l_t = tmodem.demod_soft_bits(t(r), mod, t(nv)).numpy()
    assert l_t.shape == (2, 3, 50 * bps)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5, atol=1e-5)
    bits = tmodem.indices_to_bits(t(idx), bps).numpy()
    np.testing.assert_array_equal((l_t < 0).astype(np.int8)[..., bps:], bits[..., bps:])


@pytest.mark.parametrize("mod", DPSK_MODS)
def test_dd_phase_track_passes_differential_symbols_through(mod):
    rng = np.random.default_rng(mod)
    pay = t(noisy(rng, np.ones((2, 3, 70), np.complex64), 0.3))
    assert tsync._dd_phase_track(pay, mod, seg=32) is pay
    out, w = tsync._dd_phase_track(pay, mod, seg=32, return_weight=True)
    assert out is pay and w.dtype == torch.float32 and w.shape == pay.shape and bool((w == 1).all())


@pytest.mark.parametrize("cfg", [(4, 0, 0, 32), (5, 0, 0, 64), (6, 1, 0, 40), (10, 0, 2, 64),
                                 (1, 0, 3, 20), (8, 1, 5, 33), (2, 0, 7, 64)])
def test_framegen_equal_for_the_new_codes(cfg):
    """TX of configs with a differential modem, Reed-Solomon or a Hamming /
    SEC-DED outer code: float32 pulse shaping in another order, and for DPSK
    the phase table: atol 2e-6 on samples of order 1."""
    rng = np.random.default_rng(sum(cfg))
    payload = rng.integers(0, 256, (3, cfg[3]), dtype=np.uint8)
    yj = np.asarray(jframegen.framegen(jnp.asarray(payload), JFrameConfig(*cfg)))
    yt = tframegen.framegen(t(payload), FrameConfig(*cfg), device="cpu")
    assert yt.dtype == torch.complex64 and yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, atol=2e-6)


# -- Reed-Solomon (255,223) ------------------------------------------------------


def test_rs_tables_and_lengths_equal():
    ej, lj = jrs._tables()
    et, lt = trs._tables()
    np.testing.assert_array_equal(ej, et)
    np.testing.assert_array_equal(lj, lt)
    np.testing.assert_array_equal(jrs._genpoly(), trs._genpoly())
    for n in (1, 67, 223, 224, 446, 447, 1000):
        assert jrs.block_sizes(n) == trs.block_sizes(n)
        assert jrs.encoded_len(n) == trs.encoded_len(n)
    assert (trs.NN, trs.KK, trs.NROOTS, trs.T) == (jrs.NN, jrs.KK, jrs.NROOTS, jrs.T)


@pytest.mark.parametrize("length", [1, 67, 223, 300])
def test_rs_encode_bit_exact(length):
    rng = np.random.default_rng(length)
    msg = rng.integers(0, 256, (2, 3, length), dtype=np.uint8)
    ct = trs.encode(t(msg))
    assert ct.dtype == torch.uint8 and ct.shape == (2, 3, trs.encoded_len(length))
    np.testing.assert_array_equal(np.asarray(jrs.encode(jnp.asarray(msg))), ct.numpy())
    np.testing.assert_array_equal(jrs.encode_host(msg[1, 2]), ct.numpy()[1, 2])
    np.testing.assert_array_equal(trs.encode_host(msg[1, 2]), ct.numpy()[1, 2])


def corrupt(rng, code, length, n_err):
    """``n_err`` byte errors in every block of every row."""
    code = code.copy()
    pos0 = 0
    for k in trs.block_sizes(length):
        for row in code:
            pos = rng.choice(k + trs.NROOTS, n_err, replace=False)
            row[pos0 + pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        pos0 += k + trs.NROOTS
    return code


@pytest.mark.parametrize("length,n_err", [(67, 0), (67, 1), (67, 16), (67, 17), (67, 40), (300, 16)])
def test_rs_decode_exact_with_byte_errors(length, n_err):
    """Up to 16 byte errors a block are corrected; beyond that both packages
    return the same bytes, corrected or not."""
    rng = np.random.default_rng(1000 * length + n_err)
    msg = rng.integers(0, 256, (6, length), dtype=np.uint8)
    code = corrupt(rng, trs.encode(t(msg)).numpy(), length, n_err)
    dt = trs.decode(t(code), length)
    assert dt.dtype == torch.uint8 and dt.shape == msg.shape
    np.testing.assert_array_equal(np.asarray(jrs.decode(jnp.asarray(code), length)), dt.numpy())
    if n_err <= trs.T:
        np.testing.assert_array_equal(dt.numpy(), msg)
    else:
        assert (dt.numpy() != msg).any()


def test_rs_decode_keeps_leading_batch_axes():
    rng = np.random.default_rng(9)
    msg = rng.integers(0, 256, (2, 3, 40), dtype=np.uint8)
    code = trs.encode(t(msg))
    code[..., 7] ^= 0x21
    np.testing.assert_array_equal(trs.decode(code, 40).numpy(), msg)


# -- Hamming and SEC-DED ----------------------------------------------------------


@pytest.mark.parametrize("name", BLOCK_CODES)
def test_block_code_matrices_equal(name):
    cj, ct = getattr(jblock, name)(), getattr(tblock, name)()
    assert (cj.n, cj.k, cj.r) == (ct.n, ct.k, ct.r)
    np.testing.assert_array_equal(cj.p, ct.p)
    assert getattr(tblock, name)() is ct  # built once


@pytest.mark.parametrize("n_err", [0, 1, 2])
@pytest.mark.parametrize("name", BLOCK_CODES)
def test_block_code_encode_decode_equal_with_bit_errors(name, n_err):
    """One bit error a block is corrected wherever it falls; with two, both
    packages return the same (wrong or right) data."""
    cj, ct = getattr(jblock, name)(), getattr(tblock, name)()
    rng = np.random.default_rng(len(name) + n_err)
    nblk = 30
    bits = rng.integers(0, 2, (3, ct.k * nblk)).astype(np.int8)
    coded = ct.encode(t(bits))
    assert coded.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(cj.encode(jnp.asarray(bits))), coded.numpy())
    np.testing.assert_array_equal(
        cj.encode_host(bits[0].reshape(nblk, ct.k)).reshape(-1), coded.numpy()[0])
    rx = coded.numpy().reshape(3, nblk, ct.n).copy()
    for a in range(3):
        for b in range(nblk):
            rx[a, b, rng.choice(ct.n, n_err, replace=False)] ^= 1
    rx = rx.reshape(3, nblk * ct.n)
    dt = ct.decode(t(rx))
    assert dt.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(cj.decode(jnp.asarray(rx))), dt.numpy())
    if n_err <= 1:
        np.testing.assert_array_equal(dt.numpy(), bits)


@pytest.mark.parametrize("outer", [2, 3, 4, 5, 6, 7])
def test_outer_codec_equal_through_the_registry(outer):
    """Bytes in, coded bits out and back, pad bits included; sparse bit
    errors (one in 97 bits: at most one a block of up to 72) are corrected."""
    rng = np.random.default_rng(30 + outer)
    msg = rng.integers(0, 256, (4, 67), dtype=np.uint8)
    ct = treg.outer_encode(t(msg), outer)
    assert ct.dtype == torch.int8 and ct.shape[-1] == treg.outer_encoded_bits(67, outer)
    np.testing.assert_array_equal(np.asarray(jreg.outer_encode(jnp.asarray(msg), outer)), ct.numpy())
    flip = ct.clone()
    flip[:, 5::97] ^= 1
    dt = treg.outer_decode(flip, 67, outer)
    assert dt.dtype == torch.uint8
    np.testing.assert_array_equal(
        np.asarray(jreg.outer_decode(jnp.asarray(flip.numpy()), 67, outer)), dt.numpy())
    np.testing.assert_array_equal(dt.numpy(), msg)
