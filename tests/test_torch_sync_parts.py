"""Building blocks of the PyTorch receiver against the JAX package on random
inputs: equalizer training and the CG solve, carrier fit, the payload carrier
tracker for PSK and QAM, the header decoder. Float32 chains of sums and small
solves in another order: tolerances of 1e-4 relative unless noted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.ops import modem as jmodem
from liquiddsp_tpu.ops import msequence as jmseq
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch.phy import framesync as tsync


def t(a):
    return torch.from_numpy(np.array(a))


def cnoise(rng, shape, s=1.0):
    return (s * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


def test_solve_hermitian_matches_and_solves():
    rng = np.random.default_rng(0)
    a = cnoise(rng, (3, 4, 8, 8))
    g = (a @ np.conj(np.swapaxes(a, -1, -2)) + 4 * np.eye(8)).astype(np.complex64)
    rhs = cnoise(rng, (3, 4, 8))
    wj = np.asarray(jsync._solve_hermitian(jnp.asarray(g), jnp.asarray(rhs)))
    wt = tsync._solve_hermitian(t(g), t(rhs)).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-3, atol=1e-4)
    # eight float32 CG steps on a random 8x8 system: residual of order 1e-3
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", g, wt), rhs, atol=5e-3)
    z = tsync._solve_hermitian(t(np.zeros_like(g)), t(np.zeros_like(rhs)))
    assert not bool(z.abs().any())  # degenerate slots stay at zero, no NaN


@pytest.mark.parametrize("static_ref", [True, False])
@pytest.mark.parametrize("echo", [0.0, 0.35])
def test_eq_train_matches(echo, static_ref):
    """Taps to atol 2e-3: the Gram statistics carry bf16-rounded operands in
    both packages (identical rounding), the CG solves differ in float32 sum
    order."""
    rng = np.random.default_rng(1)
    pre = jmseq.preamble_symbols()
    n_ref = 64 if static_ref else 244
    ref = pre if static_ref else np.concatenate(
        [pre, jmodem.constellation(1)[rng.integers(0, 4, 180)]])
    tx = np.concatenate([ref, jmodem.constellation(1)[rng.integers(0, 4, 56)]])
    rx = tx[None, None, :] * np.ones((2, 3, 1))
    rx = rx + echo * np.roll(rx, 1, axis=-1) * np.exp(0.7j)
    rx = (rx + cnoise(rng, rx.shape, 0.05)).astype(np.complex64)
    if static_ref:
        wj = jsync._eq_train(jnp.asarray(rx), jnp.asarray(pre), static_ref=pre)
        wt = tsync._eq_train(t(rx), None)
    else:
        refs = np.broadcast_to(ref, (2, 3, n_ref)).astype(np.complex64)
        wj = jsync._eq_train(jnp.asarray(rx), jnp.asarray(refs))
        wt = tsync._eq_train(t(rx), t(refs))
    wj = np.asarray(wj)
    assert wt.dtype == torch.complex64 and wt.shape == (2, 3, 8)
    np.testing.assert_allclose(wt.numpy(), wj, atol=2e-3)
    zj = np.asarray(jsync._eq_apply(jnp.asarray(wj), jnp.asarray(rx), n_out=200))
    zt = tsync._eq_apply(t(wj), t(rx), n_out=200).numpy()
    np.testing.assert_allclose(zt, zj, atol=1e-5)
    if echo:  # the trained equalizer does remove the echo
        err = np.mean(np.abs(zt[..., 8:100] - tx[8:100]) ** 2)
        assert err < 0.02


def test_carrier_fit_matches():
    rng = np.random.default_rng(2)
    pre = jmseq.preamble_symbols()
    tx = np.concatenate([pre, jmodem.constellation(1)[rng.integers(0, 4, 300)]])
    n = np.arange(len(tx))
    ph = rng.uniform(-3, 3, (4, 5, 1)) + rng.uniform(-2e-3, 2e-3, (4, 5, 1)) * n
    rx = (tx * np.exp(1j * ph) + cnoise(rng, ph.shape[:-1] + (len(tx),), 0.1)).astype(np.complex64)
    pj, dj = jsync._carrier_fit(jnp.asarray(rx))
    pt, dt = tsync._carrier_fit(t(rx), t(pre))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    aj = np.asarray(jsync._apply_carrier(jnp.asarray(rx), pj, dj))
    at = tsync._apply_carrier(t(rx), pt, dt).numpy()
    np.testing.assert_allclose(at, aj, atol=1e-3)


# (modulation, symbols, segment): QPSK header and payloads (trajectory chain,
# even and odd segment counts), PSK8, QAM16 long (weak-moment linear fit),
# QAM16 short and BPSK short (no V&V stage)
TRACK_CASES = [(1, 180, 18), (1, 268, 32), (1, 1086, 32), (2, 724, 32),
               (8, 1200, 32), (8, 140, 32), (0, 100, 64)]


@pytest.mark.parametrize("mod,n,seg", TRACK_CASES)
def test_dd_phase_track_matches(mod, n, seg):
    rng = np.random.default_rng(mod * 1000 + n)
    table = jmodem.constellation(mod)
    tx = table[rng.integers(0, len(table), (3, 4, n))]
    k = np.arange(n)
    ph = rng.uniform(-0.1, 0.1, (3, 4, 1)) + rng.uniform(-3e-4, 3e-4, (3, 4, 1)) * k
    rx = (tx * np.exp(1j * ph) * rng.uniform(0.8, 1.2, (3, 4, 1))
          + cnoise(rng, tx.shape, 0.04)).astype(np.complex64)
    anchor = rng.uniform(-0.05, 0.05, (3, 4)).astype(np.float32)
    slope = rng.uniform(-1e-4, 1e-4, (3, 4)).astype(np.float32)
    yj, wj = jsync._dd_phase_track(
        jnp.asarray(rx), mod, seg=seg, anchor=jnp.asarray(anchor),
        anchor_slope=jnp.asarray(slope), return_weight=True)
    yt, wt = tsync._dd_phase_track(
        t(rx), mod, seg=seg, anchor=t(anchor), anchor_slope=t(slope), return_weight=True)
    assert yt.shape == (3, 4, n) and wt.shape == (3, 4, n)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4)
    # default anchors, no weights: the other call form the receiver uses
    y2 = tsync._dd_phase_track(t(rx), mod, seg=seg)
    np.testing.assert_allclose(
        y2.numpy(), np.asarray(jsync._dd_phase_track(jnp.asarray(rx), mod, seg=seg)), atol=2e-4)


@pytest.mark.parametrize("n", [9, 10, 34])
def test_median_averages_the_middle_pair(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((5, n)).astype(np.float32)
    np.testing.assert_allclose(
        tsync._median_last(t(a)).numpy(), np.median(a, axis=-1, keepdims=True), rtol=1e-6)
    np.testing.assert_array_equal(
        tsync._median_last(t(a)).numpy(), np.asarray(jnp.median(jnp.asarray(a), axis=-1, keepdims=True)))


def test_decode_header_multi_matches():
    from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
    from liquiddsp_tpu.phy import framegen as jframegen

    rng = np.random.default_rng(4)
    user = rng.integers(0, 256, (6, 14), dtype=np.uint8)
    hdr = np.asarray(jframegen.header_symbols(JFrameConfig(8, 3, 1, 300), 6, jnp.asarray(user)))
    regions = [(hdr + cnoise(rng, hdr.shape, s)).astype(np.complex64) for s in (0.05, 0.3, 0.6)]
    (fj, hj) = jsync.decode_header_multi([jnp.asarray(r) for r in regions])
    (ft, ht) = tsync.decode_header_multi([t(r) for r in regions])
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(hj), ht.numpy())
    assert ft[0].numpy()[:, 0].all()  # the clean branch passes its CRC
    assert (ft[2].numpy()[:, 0] == 300).all() and (ft[3].numpy()[:, 0] == 8).all()
    from liquiddsp_tpu_torch.phy.framegen import header_bytes_to_symbols

    np.testing.assert_array_equal(header_bytes_to_symbols(ht[:, 0]).numpy(), hdr)


def test_long_frames_raise_until_sfo_path_is_ported():
    """The sample-clock-drift path is ported: a buffer of SFO_AUTO_SYMS
    symbols takes it ("auto") instead of raising, and hands back finite
    symbols of the buffer's length."""
    x = torch.zeros((1, 8192), dtype=torch.complex64)
    det, syms, fields, evm = tsync.sync_common(x, tsync.SFO_AUTO_SYMS, 2, device="cpu")
    assert syms.shape == (1, 2, tsync.SFO_AUTO_SYMS) and syms.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(syms)).all())
    assert not bool(det.mask.any()) and not bool(fields[0].any())
