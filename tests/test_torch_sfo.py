"""The sample-clock-drift (SFO) path of the PyTorch port against the JAX
package: the extended timing bank (exact), the segment recovery (1e-5 x
max|ref|) and the trajectory fit (bank rows exact) on +-50 ppm streams, the
four cases of tests/test_sfo.py through the port's framesync_fixed, with
payloads equal to the JAX package's and to what was sent, and the payload
tracker's slip on a QAM16 payload shown to be the JAX package's own.

SFO is injected with the JAX package's arbitrary-ratio resampler, an
actually stretched waveform. One small stream a case (B = 1, T = 16,384);
the JAX receiver compiles once a config for the module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.kernels.extract import extract_windows as jextract
from liquiddsp_tpu.ops import resample as jresample
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.phy import framesync as tsync
from liquiddsp_tpu_torch.phy.detector import Detections
from liquiddsp_tpu_torch.phy.tables import phy_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them (alone, these tests run as fast on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LONG_QPSK = (1, 0, 0, 800)
LONG_BPSK_FEC = (0, 1, 2, 200)
QAM16 = (8, 0, 0, 1200)
T = 16384
DET_FIELDS = ("mask", "start", "rho", "gamma", "dphi", "phi", "tau")


def make_sfo_block(payload, cfg, ppm, offset=300, snr_db=None, cfo=0.004, phase=0.7, seed=0):
    """tests/test_sfo.py's stream: one frame, stretched by ``ppm``, with a
    carrier offset and AWGN, as numpy [1, T] complex64."""
    frame = np.asarray(jframegen.framegen(jnp.asarray(payload), JFrameConfig(*cfg)))
    x = np.zeros((1, T), dtype=np.complex64)
    x[:, offset : offset + frame.shape[1]] = frame
    if ppm:
        x = np.asarray(jresample.arbitrary(jnp.asarray(x), 1.0 / (1.0 + ppm * 1e-6), T))
    x = x * np.exp(1j * (cfo * np.arange(T) + phase))
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(np.mean(np.abs(frame) ** 2) / (2 * 10 ** (snr_db / 10)))
        x = x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def payload_of(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, n), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def jax_rx(cfg):
    """The JAX receiver with tracking on, compiled once a config."""
    return jax.jit(functools.partial(
        jsync.framesync_fixed, cfg=JFrameConfig(*cfg), max_frames=2, track_sfo=True))


def port_rx(x, cfg, track_sfo):
    return tsync.framesync_fixed(torch.from_numpy(x), FrameConfig(*cfg), 2,
                                 track_sfo=track_sfo, device="cpu").to_numpy()


def both(x, cfg, track_sfo):
    """(JAX result as numpy dict, port result as numpy dict). Every frame of
    these tests is longer than SFO_AUTO_SYMS, so the JAX package's "auto"
    is its True."""
    ref = jax_rx(cfg)(jnp.asarray(x))
    got = port_rx(x, cfg, track_sfo)
    return {f: np.asarray(getattr(ref, f)) for f in got}, got


def decode_ok(res, payload):
    ok = res["payload_valid"][0]
    return bool(ok.any()) and bool((res["payload"][0, int(np.argmax(ok))] == payload[0]).all())


def assert_same_frames(ref, got):
    """Discrete fields exact, payloads where valid exact, symbols to the
    framesync tests' 2e-3 x max|ref|."""
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["start"], ref["start"])
    m = ref["mask"]
    for f in ("header_valid", "payload_valid", "modulation", "payload_len"):
        np.testing.assert_array_equal(got[f][m], ref[f][m], err_msg=f)
    v = ref["payload_valid"]
    np.testing.assert_array_equal(got["payload"][v], ref["payload"][v])
    np.testing.assert_allclose(got["symbols"][m], ref["symbols"][m],
                               atol=2e-3 * np.abs(ref["symbols"][m]).max())


def test_timing_bank65_equals_jax():
    np.testing.assert_array_equal(tsync._timing_bank65(), jsync._timing_bank65())
    np.testing.assert_array_equal(phy_tables(None, "cpu").timing_bank65.numpy(),
                                  jsync._timing_bank65())
    assert tsync.SFO_AUTO_SYMS == jsync.SFO_AUTO_SYMS and tsync.SFO_SEG == jsync.SFO_SEG


@pytest.mark.parametrize("ppm", [50.0, -50.0])
def test_segment_recover_and_fit_equal_jax(ppm):
    """On the reference's detections and windows: the coarse x fine
    derotation (1e-5 x max), the trajectory's bank rows (exact) and the
    per-segment recovery at those rows (1e-5 x max|ref|)."""
    x = make_sfo_block(payload_of(1200, 31), QAM16, ppm, snr_db=28.0, seed=4)
    n_syms = jfs.FrameSpec(JFrameConfig(*QAM16)).frame_syms
    seg = jsync.SFO_SEG
    nseg = -(-n_syms // seg)
    det = jsync.detect(jnp.asarray(x), 2, fine=False)
    win = jextract(jnp.asarray(x), det.start, 2 * n_syms + 28)
    wd = jsync._derotate_window(win, det)
    q_ref = np.array(jsync._sfo_fit(wd, det.tau, nseg, seg))
    y_ref = np.asarray(jsync._segment_recover(wd, jnp.asarray(q_ref), n_syms, seg))

    tdet = Detections.from_numpy({f: np.asarray(getattr(det, f)) for f in DET_FIELDS}, "cpu")
    wd_t = tsync._derotate_window(torch.from_numpy(np.array(win)), tdet)
    np.testing.assert_allclose(wd_t.numpy(), np.asarray(wd), atol=1e-5 * np.abs(wd).max())
    bank = phy_tables(None, "cpu").timing_bank65
    windows = tsync._segment_windows(torch.from_numpy(np.array(wd)), nseg, seg)
    q = tsync._sfo_fit(windows, tdet.tau, seg, bank).numpy()
    np.testing.assert_array_equal(q, q_ref)
    assert q[0, 0, -1] - q[0, 0, 0] == pytest.approx(np.sign(ppm) * 9, abs=2)  # ~0.27 sample of drift
    y = tsync._segment_recover(windows, bank[torch.from_numpy(q_ref)], n_syms).numpy()
    np.testing.assert_allclose(y, y_ref, atol=1e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("ppm", [50.0, -50.0])
def test_long_frame_decodes_at_50ppm(ppm):
    """Long QPSK frame (~6900 samples): the default ("auto") path tracks and
    decodes bit-exactly, as the JAX package does (whose "auto" is True for
    this frame)."""
    payload = payload_of(800, 21)
    x = make_sfo_block(payload, LONG_QPSK, ppm, snr_db=25.0, seed=int(abs(ppm)))
    ref, got = both(x, LONG_QPSK, "auto")
    assert decode_ok(got, payload) and decode_ok(ref, payload)
    assert_same_frames(ref, got)


def test_tracking_is_load_bearing():
    """QAM16, 1200 bytes, +50 ppm: decodes with tracking, as the JAX package
    does, and FAILS without (tests/test_sfo.py holds the JAX package's
    static failure)."""
    payload = payload_of(1200, 31)
    x = make_sfo_block(payload, QAM16, 50.0, snr_db=28.0, seed=4)
    ref, got = both(x, QAM16, "auto")
    assert decode_ok(got, payload) and decode_ok(ref, payload)
    assert_same_frames(ref, got)
    static = port_rx(x, QAM16, False)
    assert static["mask"].any() and not decode_ok(static, payload)


def test_payload_tracker_slip_is_the_references_own():
    """Why chip_smoke.py's SFO phase decodes without the payload carrier
    tracker: with no noise and no drift, the tracker slips on the QAM16
    payload of seed 0 and its CRC fails, in the JAX package as in the port,
    while the port without the tracker (track=False) decodes what was sent."""
    payload = payload_of(1200, 0)
    x = make_sfo_block(payload, QAM16, 0.0)
    ref, got = both(x, QAM16, "auto")
    assert ref["header_valid"][0].any() and got["header_valid"][0].any()
    assert not ref["payload_valid"].any() and not got["payload_valid"].any()
    assert_same_frames(ref, got)
    untracked = tsync.framesync_fixed(torch.from_numpy(x), FrameConfig(*QAM16), 2, track=False,
                                      device="cpu").to_numpy()
    assert decode_ok(untracked, payload)


def test_auto_threshold_engages():
    for cfg in (LONG_QPSK, LONG_BPSK_FEC, QAM16):
        assert jfs.FrameSpec(JFrameConfig(*cfg)).frame_syms >= tsync.SFO_AUTO_SYMS


def test_tail_evm_improvement():
    """Noiseless +50 ppm on the long BPSK+V27+RS class: tracking recovers
    >= 8 dB of tail-symbol EVM over the static path and decodes what was
    sent (tests/test_sfo.py holds the same of the JAX package)."""
    payload = payload_of(200, 5)
    spec = jfs.FrameSpec(JFrameConfig(*LONG_BPSK_FEC))
    tx = np.asarray(jframegen.assemble_symbols(jnp.asarray(payload), JFrameConfig(*LONG_BPSK_FEC)))[0]
    x = make_sfo_block(payload, LONG_BPSK_FEC, 50.0)

    def tail_evm(res, n=400):
        k = int(np.argmax(res["mask"][0]))
        e = res["symbols"][0, k, : spec.frame_syms][-n:] - tx[-n:]
        return 10 * np.log10(np.mean(np.abs(e) ** 2) / np.mean(np.abs(tx[-n:]) ** 2) + 1e-12)

    tracked = port_rx(x, LONG_BPSK_FEC, True)
    assert decode_ok(tracked, payload)
    static = port_rx(x, LONG_BPSK_FEC, False)
    assert tail_evm(tracked) <= tail_evm(static) - 8.0


def test_no_regression_at_zero_ppm():
    payload = payload_of(800, 23)
    x = make_sfo_block(payload, LONG_QPSK, 0.0, snr_db=20.0, seed=9)
    ref, got = both(x, LONG_QPSK, True)
    assert decode_ok(got, payload) and decode_ok(ref, payload)
    assert_same_frames(ref, got)
